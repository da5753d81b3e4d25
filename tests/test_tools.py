"""OBJ loader, PPM IO, compare CLI, camera controller, USE_MIS=0 path."""

import numpy as np
import pytest

from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.utils.image import read_ppm, ssim, write_ppm


def test_obj_loader(tmp_path):
    from raytracer_tpu.scene.loaders import load_scene

    path = "/root/reference/objects/quad.obj"
    import os

    if not os.path.exists(path):
        pytest.skip("reference objects not mounted")
    scene = load_scene(path)
    assert len(scene.objects) >= 3  # Quad1..Quad4 groups
    # Quads triangulate into 2 tris each.
    assert all(
        scene.meshes[o.mesh_index].num_triangles == 2 for o in scene.objects
    )


def test_obj_negative_indices(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    from raytracer_tpu.scene.obj import load_scene_from_obj

    scene = load_scene_from_obj(str(p))
    assert scene.meshes[0].num_triangles == 1


def test_ppm_roundtrip(tmp_path, rng_np):
    img = rng_np.integers(0, 255, (12, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "x.ppm")
    write_ppm(path, img)
    back = read_ppm(path)
    np.testing.assert_array_equal(img, back)


def test_compare_cli(tmp_path, rng_np, capsys):
    from raytracer_tpu.compare import main
    from raytracer_tpu.utils.image import write_png

    img = rng_np.integers(0, 255, (32, 32, 3), dtype=np.uint8)
    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.ppm")
    write_png(a, img)
    write_ppm(b, img)
    assert main([a, b]) == 0
    out = capsys.readouterr().out
    assert "SSIM: 1.000000" in out
    # Threshold failure path.
    noisy = np.clip(
        img.astype(int) + rng_np.integers(-60, 60, img.shape), 0, 255
    ).astype(np.uint8)
    c = str(tmp_path / "c.png")
    write_png(c, noisy)
    assert main([a, c, "--threshold", "0.99"]) == 1


def test_camera_controller_parity():
    cam = Camera.create(position=(0, 0, -3), aspect=1.0)
    f0 = cam.forward.copy()
    cam.move_direction("forward", delta_time=0.1)
    np.testing.assert_allclose(cam.position, [0, 0, -3 + 0.5], atol=1e-6)
    cam.process_mouse(dx=100.0, dy=0.0)
    assert not np.allclose(cam.forward, f0)
    assert abs(np.linalg.norm(cam.forward) - 1.0) < 1e-5
    # Pure yaw keeps forward.y fixed.
    assert abs(cam.forward[1] - f0[1]) < 1e-6


def test_use_mis_false_renders():
    from raytracer_tpu.api import render
    from raytracer_tpu.scene.model import create_cornell_box
    from raytracer_tpu.utils.config import RenderConfig

    cfg = RenderConfig(width=24, height=24, use_mis=False)
    img = render(create_cornell_box(), None, cfg, num_frames=3)
    assert np.isfinite(img).all()
    assert img.max() > 0.01

    # Both estimators target the same radiance; loose agreement at low spp.
    cfg_mis = RenderConfig(width=24, height=24, use_mis=True)
    img_mis = render(create_cornell_box(), None, cfg_mis, num_frames=32)
    img_no = render(create_cornell_box(), None, cfg.replace(), num_frames=32)
    m1, m2 = img_mis.mean(), img_no.mean()
    assert abs(m1 - m2) / max(m1, 1e-6) < 0.25, (m1, m2)


def test_use_direct_lighting_false_renders():
    from raytracer_tpu.api import render
    from raytracer_tpu.scene.model import create_cornell_box
    from raytracer_tpu.utils.config import RenderConfig

    cfg = RenderConfig(width=16, height=16, use_direct_lighting=False,
                       max_depth=4)
    img = render(create_cornell_box(), None, cfg, num_frames=4)
    assert np.isfinite(img).all()
    assert img.max() > 0.001  # BRDF-sampled emission only


def test_phase_timer():
    import jax.numpy as jnp

    from raytracer_tpu.utils.profiling import PhaseTimer, sync

    t = PhaseTimer()
    x = jnp.ones((8, 8))
    with t.phase("mul", result_holder=[x]):
        x = x * 2.0
    assert "mul" in t.totals
    assert float(sync(x * 0 + 3.0)[0, 0]) == 3.0
    assert "ms total" in t.report()
