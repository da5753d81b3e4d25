"""Golden-image gate: the committed Cornell render must stay reproducible.

The analog of the reference's offline SSIM validation path
(ssim_compare.py, SURVEY.md §3.5) with the BASELINE threshold of 0.98;
the golden was generated by this same code on the CPU backend, so
regressions in RNG streams, sampling, shading constants, traversal, or
accumulation all trip this gate.
"""

import os

import numpy as np
import pytest

CORNELL_JSON = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "scenes", "cornell_box.json")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "golden")


@pytest.fixture(scope="module")
def cornell_render():
    from raytracer_tpu.api import render
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.utils.config import RenderConfig

    path = CORNELL_JSON
    if not os.path.exists(path):
        pytest.skip("reference scenes not mounted")
    cfg = RenderConfig(width=64, height=64)
    return render(load_scene(path), None, cfg, num_frames=16)


def test_golden_ssim(cornell_render):
    from raytracer_tpu.utils.image import read_png, ssim, tonemap

    golden = read_png(os.path.join(GOLDEN_DIR, "cornell_64.png"))
    got = tonemap(cornell_render)
    score = ssim(golden, got)
    assert score >= 0.98, f"SSIM vs golden = {score}"


def test_golden_float_close(cornell_render):
    golden = np.load(os.path.join(GOLDEN_DIR, "cornell_64_f32.npy"))
    # Cross-platform fp drift tolerance; exactness on the same backend.
    np.testing.assert_allclose(cornell_render, golden, rtol=1e-3, atol=2e-3)


def test_golden_cornell_pbr():
    """BASELINE config 2: cornell_pbr.glb GGX/metallic-roughness + NEE."""
    from raytracer_tpu.api import render
    from raytracer_tpu.ops.camera import Camera
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.utils.config import RenderConfig
    from raytracer_tpu.utils.image import read_png, ssim, tonemap

    path = "/root/reference/scenes/cornell_pbr.glb"
    if not os.path.exists(path):
        pytest.skip("reference scenes not mounted")
    scene = load_scene(path)
    cam = Camera.create(position=(0, 1.0, 3.2), aspect=1.0,
                        target=(0, 1.0, 0))
    img = render(scene, cam, RenderConfig(width=64, height=64),
                 num_frames=16)
    golden = read_png(os.path.join(GOLDEN_DIR, "cornell_pbr_64.png"))
    score = ssim(golden, tonemap(img))
    assert score >= 0.98, f"SSIM vs cornell_pbr golden = {score}"
