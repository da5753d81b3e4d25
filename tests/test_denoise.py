"""Preview denoiser (integrator/denoise.py): the a-trous filter must cut
noise (closer to a converged reference) without losing energy or touching
the accumulation state."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.utils.config import RenderConfig

CORNELL_JSON = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "scenes", "cornell_box.json")


@pytest.fixture(scope="module")
def cornell_renders():
    from raytracer_tpu.api import ProgressiveRenderer
    from raytracer_tpu.scene.model import create_cornell_box

    cfg = RenderConfig(width=32, height=32)
    r = ProgressiveRenderer(create_cornell_box(), None, cfg)
    r.render(2)
    noisy = r.image(denoise=False)
    denoised = r.image(denoise=True)
    ref = ProgressiveRenderer(create_cornell_box(), None, cfg).render(48)
    return noisy, denoised, ref, r


def test_denoise_reduces_error(cornell_renders):
    noisy, denoised, ref, _ = cornell_renders
    err_noisy = float(np.mean((noisy - ref) ** 2))
    err_denoised = float(np.mean((denoised - ref) ** 2))
    assert err_denoised < err_noisy * 0.7, (err_noisy, err_denoised)


def test_denoise_preserves_energy(cornell_renders):
    # At 2 spp the luminance edge-stop is driven by noise, which biases the
    # filtered mean slightly upward (dim pixels borrow from fireflies);
    # measured ~11% here. The gate catches gross energy bugs (demodulation,
    # weight normalization), not shot-noise redistribution.
    noisy, denoised, _, _ = cornell_renders
    assert abs(denoised.mean() - noisy.mean()) < 0.2 * noisy.mean()


def test_denoise_never_touches_accumulation(cornell_renders):
    noisy, _, _, r = cornell_renders
    # image(denoise=True) already ran in the fixture; the raw accumulation
    # readback must be unchanged.
    np.testing.assert_array_equal(r.image(denoise=False), noisy)


def test_gbuffer_miss_lanes():
    from raytracer_tpu.api import ProgressiveRenderer
    from raytracer_tpu.integrator.denoise import MISS_DEPTH, gbuffer_pass
    from raytracer_tpu.scene.model import Material, Scene, create_plane

    # A single quad in the lower half of frame: the upper rows miss.
    scene = Scene()
    mat = scene.add_material(Material(albedo=(0.5, 0.5, 0.5)))
    mesh = scene.add_mesh(create_plane(2.0, 2.0))
    scene.add_object("quad", mesh, mat, position=(0.0, -1.0, 1.0))
    cfg = RenderConfig(width=16, height=16)
    r = ProgressiveRenderer(scene, None, cfg)
    r.begin_frame()
    nrm, depth, albedo = gbuffer_pass(r.device_scene, r._camera_ubo_dev,
                                      r.config)
    miss = np.asarray(depth) >= MISS_DEPTH
    assert miss.any() and (~miss).any()
    np.testing.assert_allclose(np.asarray(albedo)[miss], 1.0)
    np.testing.assert_allclose(np.asarray(nrm)[miss], 0.0)


def test_denoise_keeps_background_sharp():
    """Surface-vs-background boundaries carry zero filter weight: a
    background pixel must stay exactly the background color even when its
    neighbors are bright geometry."""
    from raytracer_tpu.integrator.denoise import MISS_DEPTH, atrous_denoise

    h = w = 16
    n = h * w
    # Left half: bright surface (normal +z, depth 1). Right half: miss.
    surface = (np.arange(n) % w) < (w // 2)
    img = np.where(surface[:, None], 5.0,
                   0.25).astype(np.float32) * np.ones((1, 3), np.float32)
    nrm = np.where(surface[:, None],
                   np.asarray([[0.0, 0.0, 1.0]], np.float32),
                   np.zeros((1, 3), np.float32))
    depth = np.where(surface, 1.0, MISS_DEPTH).astype(np.float32)
    albedo = np.ones((n, 3), np.float32)
    out = np.asarray(atrous_denoise(
        jnp.asarray(img), jnp.asarray(nrm), jnp.asarray(depth),
        jnp.asarray(albedo), h, w, iterations=3,
    ))
    np.testing.assert_allclose(out[~surface], 0.25, rtol=1e-5)


def test_cli_denoise_flag(tmp_path):
    import sys

    from raytracer_tpu.cli import main

    out = tmp_path / "d.png"
    rc = main([
        CORNELL_JSON, "--width", "16",
        "--height", "16", "--spp", "2", "--denoise", "--out", str(out),
    ])
    assert rc == 0 and out.exists()


def test_black_albedo_channels_survive():
    """Demodulation and remodulation must use the SAME clamped albedo: a
    specular highlight or emission on a material whose albedo is 0 in some
    channel (e.g. pure-red metal, black glossy) must be filtered, not
    erased (raw-albedo remodulation multiplied those channels by ~0)."""
    from raytracer_tpu.integrator.denoise import atrous_denoise

    h = w = 8
    n = h * w
    img = np.full((n, 3), 2.0, np.float32)  # flat radiance, all channels
    nrm = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    depth = np.ones((n,), np.float32)
    albedo = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    out = np.asarray(atrous_denoise(
        jnp.asarray(img), jnp.asarray(nrm), jnp.asarray(depth),
        jnp.asarray(albedo), h, w, iterations=2,
    ))
    # A flat image must pass through the edge-aware filter unchanged in
    # EVERY channel, whatever the albedo.
    np.testing.assert_allclose(out, 2.0, rtol=1e-4)
