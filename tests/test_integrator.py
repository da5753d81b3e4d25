"""End-to-end integrator tests: furnace, Cornell box, determinism,
accumulation and checkpoint semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer_tpu.api import ProgressiveRenderer, render
from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.scene.model import Material, Scene, create_sphere
from raytracer_tpu.utils.config import RenderConfig


def _furnace_scene():
    """A white diffuse unit sphere floating in a uniform white background.
    Every camera ray hits the sphere, bounces until it escapes, and picks up
    the background radiance: pixels must converge near 1 (energy
    conservation of the diffuse BRDF + RR + miss plumbing)."""
    scene = Scene()
    white = scene.add_material(
        Material(name="white", albedo=(1.0, 1.0, 1.0), roughness=1.0)
    )
    sphere = scene.add_mesh(create_sphere(24, 24))
    scene.add_object("Ball", sphere, white)
    return scene


def test_white_furnace():
    cfg = RenderConfig(
        width=32, height=32, max_depth=24, rr_start_depth=3,
        background=(1.0, 1.0, 1.0), radiance_clamp=100.0, accel="bvh",
    )
    # Close enough that the sphere fills the whole 45-degree frustum.
    cam = Camera.create(position=(0, 0, -1.5), aspect=1.0)
    img = render(_furnace_scene(), cam, cfg, num_frames=48)
    mean = img.mean()
    # Fresnel-damped Lambert loses a few percent per bounce by design
    # (the (1-F) factor, simple.rchit:146).
    assert 0.70 < mean < 1.02, mean
    assert np.isfinite(img).all()


def test_cornell_smoke():
    cfg = RenderConfig(width=64, height=64, accel="bvh")
    from raytracer_tpu.scene.model import create_cornell_box

    img = render(create_cornell_box(), None, cfg, num_frames=4)
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.01  # something got lit
    assert img.min() >= 0.0


def test_brute_vs_bvh_same_image():
    """The acceleration structure must not change the image (same RNG, same
    hits): SSIM ~ 1 and near-bitwise match."""
    from raytracer_tpu.scene.model import create_cornell_box

    imgs = {}
    for accel in ("brute", "bvh"):
        cfg = RenderConfig(width=48, height=48, accel=accel)
        imgs[accel] = render(create_cornell_box(), None, cfg, num_frames=2)
    np.testing.assert_allclose(imgs["brute"], imgs["bvh"], rtol=1e-3, atol=1e-3)


def test_deterministic():
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=32, height=32)
    a = render(create_cornell_box(), None, cfg, num_frames=3)
    b = render(create_cornell_box(), None, cfg, num_frames=3)
    np.testing.assert_array_equal(a, b)


def test_accumulation_mean_semantics():
    """Progressive accumulation = running mean of per-frame radiance
    (simple.rgen:127-136)."""
    from raytracer_tpu.integrator.wavefront import render_wavefront
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=16, height=16)
    ds, _ = bake_scene(create_cornell_box())
    cam = Camera.create(position=(0, 0, -3), aspect=1.0)
    mats = cam.matrices()
    ubo = {
        "inverse_view": jnp.asarray(mats["inverse_view"]),
        "inverse_proj": jnp.asarray(mats["inverse_proj"]),
    }
    frames = [
        np.asarray(render_wavefront(ds, ubo, jnp.uint32(i), cfg))
        for i in range(3)
    ]
    r = ProgressiveRenderer(create_cornell_box(), cam, cfg)
    for _ in range(3):
        r.step()
    want = np.mean(frames, axis=0).reshape(16, 16, 3)
    np.testing.assert_allclose(r.image(), want, rtol=1e-4, atol=1e-5)


def test_accumulation_limit():
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=16, height=16, accumulation_limit=2)
    r = ProgressiveRenderer(create_cornell_box(), None, cfg)
    assert r.step() and r.step()
    assert not r.step()  # limit reached -> frame skipped
    assert r.frame == 2


def test_camera_dirty_resets_accumulation():
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=16, height=16)
    r = ProgressiveRenderer(create_cornell_box(), None, cfg)
    r.step()
    r.step()
    assert r.frame == 2
    r.camera.move((0.1, 0, 0))
    r.step()
    assert r.frame == 1  # reset happened before the new frame


def test_material_edit_resets_and_changes_image():
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=24, height=24)
    scene = create_cornell_box()
    r = ProgressiveRenderer(scene, None, cfg)
    r.step()
    before = r.image().copy()
    scene.update_material(
        1, Material(name="red", albedo=(0.05, 0.05, 0.9), roughness=1.0)
    )
    r.step()
    assert r.frame == 1
    after = r.image()
    assert np.abs(after - before).max() > 1e-3


def test_checkpoint_roundtrip(tmp_path):
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=16, height=16)
    r = ProgressiveRenderer(create_cornell_box(), None, cfg)
    r.step()
    r.step()
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    img_direct = ProgressiveRenderer(
        create_cornell_box(), None, cfg
    ).render(4)

    r2 = ProgressiveRenderer(create_cornell_box(), None, cfg)
    r2.load_checkpoint(path)
    assert r2.frame == 2
    r2.step()
    r2.step()
    np.testing.assert_allclose(r2.image(), img_direct, rtol=1e-5, atol=1e-6)


def test_background_miss_color():
    """A scene with nothing in front of the camera shows the clear color."""
    scene = Scene()
    m = scene.add_material(Material(name="d", albedo=(1, 1, 1), roughness=1.0))
    sphere = scene.add_mesh(create_sphere(8, 8))
    scene.add_object("far", sphere, m, position=(0, 0, 500.0))
    cfg = RenderConfig(width=8, height=8, background=(0.2, 0.4, 0.6))
    img = render(scene, None, cfg, num_frames=1)
    corner = img[0, 0]
    np.testing.assert_allclose(corner, [0.2, 0.4, 0.6], atol=1e-5)


def test_transform_edit_uses_refit_and_changes_image():
    """Transform edits take the TLAS-UPDATE (refit) path: the host BVH
    topology is reused and the image reflects the move."""
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=24, height=24)
    scene = create_cornell_box()
    r = ProgressiveRenderer(scene, None, cfg)
    bvh_before = r._host_bvh
    r.step()
    before = r.image().copy()
    scene.update_object_position(6, (0.5, 1.5, -1.0))  # move Metal Sphere
    r.step()
    assert r.frame == 1  # accumulation reset
    assert r._host_bvh is bvh_before  # topology reused (refit, not rebuild)
    after = r.image()
    assert np.abs(after - before).max() > 1e-3


def test_refit_render_matches_fresh_build():
    """A refit bake must produce the same image as a fresh SAH build for
    the same scene state (different tree, identical hits)."""
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=24, height=24)
    scene = create_cornell_box()
    _, bvh = bake_scene(scene)
    scene.objects[6].transform.position = (0.4, 1.2, -0.8)
    scene.objects[6].transform.update_matrices()

    r_fresh = ProgressiveRenderer(create_cornell_box(), None, cfg)
    r_fresh.scene.update_object_position(6, (0.4, 1.2, -0.8))

    ds_refit, _ = bake_scene(scene, reuse_bvh=bvh)
    ds_fresh, _ = bake_scene(scene)

    import jax.numpy as jnp

    from raytracer_tpu.integrator.wavefront import render_wavefront
    from raytracer_tpu.ops.camera import Camera

    cam = Camera.create(position=(0, 0, -3), aspect=1.0)
    mats = cam.matrices()
    ubo = {
        "inverse_view": jnp.asarray(mats["inverse_view"]),
        "inverse_proj": jnp.asarray(mats["inverse_proj"]),
    }
    a = np.asarray(render_wavefront(ds_refit, ubo, jnp.uint32(1), cfg))
    b = np.asarray(render_wavefront(ds_fresh, ubo, jnp.uint32(1), cfg))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_light_sampling_only_mode():
    """USE_LIGHT_SAMPLING_ONLY semantics: direct light exclusively via
    deterministic NEE (weight 1); emissive surfaces contribute only on
    first-bounce/specular paths. Both estimators target the same radiance,
    so means agree loosely; images must differ (different estimator)."""
    import numpy as np

    from raytracer_tpu.api import render
    from raytracer_tpu.scene.model import create_cornell_box
    from raytracer_tpu.utils.config import RenderConfig

    spp = 24
    base = render(create_cornell_box(), None,
                  RenderConfig(width=32, height=32), num_frames=spp)
    lso = render(create_cornell_box(), None,
                 RenderConfig(width=32, height=32,
                              use_light_sampling_only=True), num_frames=spp)
    assert np.isfinite(lso).all()
    assert not np.allclose(base, lso)
    m1, m2 = base.mean(), lso.mean()
    assert abs(m1 - m2) / max(m1, 1e-6) < 0.2, (m1, m2)


def test_pixel_indices_strided_and_batched_bit_identity():
    """render_wavefront(pixel_indices=...) must make each lane bit-identical
    to the same (pixel, frame) lane of a full contiguous render: strided
    subsets (the tile-size lab / interleaved sharding shape) and repeated
    pixels with a per-lane frame vector (spp batching) both reduce to the
    per-pixel-independent lane contract."""
    import jax

    from raytracer_tpu.integrator.wavefront import render_wavefront
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=32, height=32, accel="bvh")
    ds, _ = bake_scene(create_cornell_box())
    cam = Camera.create(position=(0, 0, -3), aspect=1.0)
    mats = cam.matrices()
    ubo = {"inverse_view": jnp.asarray(mats["inverse_view"]),
           "inverse_proj": jnp.asarray(mats["inverse_proj"])}

    full1 = np.asarray(render_wavefront(ds, ubo, jnp.uint32(1), cfg))
    full2 = np.asarray(render_wavefront(ds, ubo, jnp.uint32(2), cfg))

    # Strided subset: every 4th pixel of frame 1.
    idx = jnp.arange(0, cfg.num_pixels, 4, dtype=jnp.uint32)
    sub = np.asarray(
        render_wavefront(ds, ubo, jnp.uint32(1), cfg, pixel_indices=idx))
    np.testing.assert_array_equal(sub, full1[::4])

    # Batched: the same strided tile twice in one launch, frames 1 and 2.
    idx2 = jnp.concatenate([idx, idx])
    frames = jnp.concatenate([
        jnp.full((idx.shape[0],), 1, jnp.uint32),
        jnp.full((idx.shape[0],), 2, jnp.uint32),
    ])
    both = np.asarray(
        render_wavefront(ds, ubo, frames, cfg, pixel_indices=idx2))
    np.testing.assert_array_equal(both[: idx.shape[0]], full1[::4])
    np.testing.assert_array_equal(both[idx.shape[0]:], full2[::4])
