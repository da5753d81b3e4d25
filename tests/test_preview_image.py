"""preview_image: the scaled, denoised, upscaled side-channel render for
interactive cadence (the reference's live viewport is its raw accumulating
image, ui.odin:491-571; this build trades 1/k^2 of the rays for a
filtered full-size preview). Must never touch progressive state."""

import os

import numpy as np
import pytest

CORNELL_JSON = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "scenes", "cornell_box.json")


def _renderer(width=32, height=32, mesh=None, **cfg_kwargs):
    from raytracer_tpu.api import ProgressiveRenderer
    from raytracer_tpu.scene.model import create_cornell_box
    from raytracer_tpu.utils.config import RenderConfig

    return ProgressiveRenderer(
        create_cornell_box(), None,
        RenderConfig(width=width, height=height, **cfg_kwargs), mesh=mesh,
    )


def test_preview_shape_and_state_untouched():
    r = _renderer()
    r.step()
    accum_before = np.asarray(r.accum).copy()
    frame_before = r.frame
    img = r.preview_image(scale=4, denoise=True)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0
    assert r.frame == frame_before
    assert np.array_equal(np.asarray(r.accum), accum_before)


def test_preview_deterministic_and_decorrelated():
    r = _renderer()
    r.step()
    a = r.preview_image(scale=2)
    b = r.preview_image(scale=2)
    # Same frame index => same RNG streams => identical preview.
    assert np.array_equal(a, b)
    r.step()
    c = r.preview_image(scale=2)
    # Advancing the frame decorrelates the preview sample.
    assert not np.array_equal(a, c)


def test_preview_scale_one_no_denoise_is_a_raw_sample():
    r = _renderer(width=16, height=16)
    img = r.preview_image(scale=1, denoise=False)
    assert img.shape == (16, 16, 3)
    # frame 0 preview = frame 0 radiance = what step() would accumulate.
    r.step()
    assert np.allclose(img, np.asarray(r.accum).reshape(16, 16, 3),
                       atol=1e-6)


def test_preview_brightness_tracks_full_render():
    r = _renderer()
    full = r.preview_image(scale=1, denoise=False)
    quarter = r.preview_image(scale=4, denoise=True)
    # Not the same pixels, but the same scene: mean luminance agrees.
    assert abs(quarter.mean() - full.mean()) / full.mean() < 0.35


def test_preview_denoise_smooths():
    r = _renderer()
    raw = r.preview_image(scale=2, denoise=False)
    den = r.preview_image(scale=2, denoise=True)
    # The a-trous filter reduces high-frequency energy on 1-spp noise.
    def hf(img):
        return np.abs(np.diff(img, axis=0)).mean()

    assert hf(den) < hf(raw)


def test_preview_sharded_matches_across_meshes():
    import jax

    from raytracer_tpu.parallel.sharding import make_pixel_mesh

    # 32x32 previews at scale 2 -> 16x16 = 256 px, divisible by 8.
    r8 = _renderer(mesh=make_pixel_mesh(jax.devices()[:8]))
    r1m = _renderer(mesh=make_pixel_mesh(jax.devices()[:1]))
    a = r8.preview_image(scale=2, denoise=True)
    b = r1m.preview_image(scale=2, denoise=True)
    # Seam-free tiling with global seeds: mesh sizes agree to float
    # reassociation (a seed/tile bug would change the noise by O(1)) —
    # the suite's sharded-vs-single standard (test_sharding.py).
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    c = _renderer().preview_image(scale=2, denoise=True)
    np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-6)


def test_preview_sharded_indivisible_raises():
    import jax

    from raytracer_tpu.parallel.sharding import make_pixel_mesh

    mesh = make_pixel_mesh(jax.devices()[:8])
    r = _renderer(width=24, height=24, mesh=mesh)
    with pytest.raises(ValueError, match="does not tile"):
        # 24//7 x 24//7 = 3x3 = 9 px, 9 % 8 != 0.
        r.preview_image(scale=7)


def test_preview_reflects_pending_camera_and_scene_edits():
    """The edit->preview loop must not require an interleaved step():
    preview_image replays the change journal / camera dirty flag itself
    (it IS the editor-facing readback)."""
    import dataclasses

    from raytracer_tpu.ops.camera import Camera

    r = _renderer()
    a = r.preview_image(scale=2, denoise=False)
    # Camera move, then preview WITHOUT step(): must show the new view.
    r.set_camera(Camera.create(position=(0.4, 0.2, -2.5), aspect=1.0))
    b = r.preview_image(scale=2, denoise=False)
    assert not np.array_equal(a, b)
    # Scene edit (repaint every wall emissive off->on would be drastic;
    # brighten the light instead), then preview WITHOUT step().
    li = next(i for i, m in enumerate(r.scene.materials)
              if m.emission_power > 0)
    m = r.scene.materials[li]
    r.scene.update_material(
        li, dataclasses.replace(m, emission_power=m.emission_power * 8))
    c = r.preview_image(scale=2, denoise=False)
    assert c.mean() > b.mean() * 1.5  # visibly brighter scene


def test_preview_gbuffer_cache_invalidated_on_edit():
    import dataclasses

    r = _renderer()
    r.preview_image(scale=2, denoise=True)
    assert r._preview_gbuffers
    # A material edit must drop the cached preview G-buffers (albedo feeds
    # the filter's demodulation).
    mat = dataclasses.replace(r.scene.materials[0], albedo=(0.9, 0.1, 0.1))
    r.scene.update_material(0, mat)
    r.step()
    assert r._preview_gbuffers == {}


def test_cli_preview_scale(tmp_path):
    from raytracer_tpu.cli import main
    from raytracer_tpu.utils.image import read_png

    out = str(tmp_path / "p.png")
    rc = main([CORNELL_JSON,
               "--width", "32", "--height", "32", "--accel", "bvh",
               "--spp", "2", "--out", out,
               "--preview", "1", "--preview-scale", "2"])
    assert rc == 0
    # Final write is the full-resolution accumulated image.
    assert read_png(out).shape == (32, 32, 3)


def test_aovs_shapes_and_semantics():
    from raytracer_tpu.integrator.denoise import MISS_DEPTH

    r = _renderer()
    aov = r.aovs()
    assert set(aov) == {"normal", "depth", "albedo"}
    assert aov["normal"].shape == (32, 32, 3)
    assert aov["depth"].shape == (32, 32)
    assert aov["albedo"].shape == (32, 32, 3)
    hit = aov["depth"] < MISS_DEPTH
    assert hit.any()
    # Hit normals are unit; miss normals are zero (denoise.py contract).
    n = np.linalg.norm(aov["normal"], axis=-1)
    assert np.allclose(n[hit], 1.0, atol=1e-4)
    assert np.allclose(n[~hit], 0.0)
    assert np.allclose(aov["albedo"][~hit], 1.0)
    # The AOV pass shares the denoiser G-buffer cache.
    assert r._gbuffer is not None


def test_preview_no_upscale_native_resolution():
    """upscale=False returns the 1/scale-resolution image (the small-
    transfer editor path) with the same content the upscaled preview is
    built from."""
    r = _renderer()
    r.step()
    small = r.preview_image(scale=4, denoise=True, upscale=False)
    assert small.shape == (8, 8, 3)
    assert np.isfinite(small).all() and small.max() > 0
    big = r.preview_image(scale=4, denoise=True, upscale=True)
    assert big.shape == (32, 32, 3)
    # The upscaled image is the bilinear expansion of the small one:
    # sampled at the small grid's aligned corners they agree.
    from raytracer_tpu.integrator.denoise import upscale_bilinear
    import jax.numpy as jnp

    up = np.asarray(upscale_bilinear(
        jnp.asarray(small.reshape(-1, 3)), 8, 8, 32, 32
    )).reshape(32, 32, 3)
    np.testing.assert_allclose(up, big, rtol=1e-5, atol=1e-6)


def test_prebake_async_matches_sync_object_add():
    """prebake_async after a topology edit must produce the SAME render the
    synchronous replay produces (the bake just moves off the critical
    path)."""
    from raytracer_tpu.scene.model import Material, create_sphere

    def add(scene):
        m = scene.add_mesh(create_sphere(4, 4))
        mat = scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
        scene.add_object("added", m, mat, position=(0.0, -0.3, 0.2),
                         scale=(0.25, 0.25, 0.25))

    r_sync = _renderer()
    r_sync.step()
    add(r_sync.scene)
    r_sync.step()
    img_sync = np.asarray(r_sync.accum).copy()

    r_pre = _renderer()
    r_pre.step()
    add(r_pre.scene)
    r_pre.prebake_async()
    r_pre.step()
    img_pre = np.asarray(r_pre.accum).copy()
    np.testing.assert_array_equal(img_sync, img_pre)
    assert r_pre._prebake is None  # consumed


def test_prebake_stale_after_second_edit_falls_back():
    """An edit landing after prebake_async invalidates the prebake; the
    replay re-bakes synchronously and the image reflects BOTH edits."""
    import dataclasses

    from raytracer_tpu.scene.model import Material, create_sphere

    r = _renderer()
    r.step()
    m = r.scene.add_mesh(create_sphere(4, 4))
    mat = r.scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
    r.scene.add_object("added", m, mat, position=(0.0, -0.3, 0.2),
                       scale=(0.25, 0.25, 0.25))
    r.prebake_async()
    # Second edit AFTER the prebake launched: prebake is stale.
    r.scene.update_material(
        0, dataclasses.replace(r.scene.materials[0], albedo=(0.9, 0.1, 0.1))
    )
    r.step()
    img = np.asarray(r.accum)

    r2 = _renderer()
    r2.step()
    m2 = r2.scene.add_mesh(create_sphere(4, 4))
    mat2 = r2.scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
    r2.scene.add_object("added", m2, mat2, position=(0.0, -0.3, 0.2),
                        scale=(0.25, 0.25, 0.25))
    r2.scene.update_material(
        0, dataclasses.replace(r2.scene.materials[0], albedo=(0.9, 0.1, 0.1))
    )
    r2.step()
    np.testing.assert_array_equal(img, np.asarray(r2.accum))


def test_prebake_with_no_pending_edits_is_discarded():
    r = _renderer()
    r.step()
    r.prebake_async()
    before = np.asarray(r.accum).copy()
    r.step()  # no edits: prebake dropped, accumulation continues
    assert r._prebake is None
    assert r.frame == 2
    assert not np.array_equal(np.asarray(r.accum), before)
