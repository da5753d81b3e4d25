"""Independent-oracle gate: the fast path must match brute-force renders.

golden/oracle/* were generated by tools/make_oracle_goldens.py with
accel="brute" (the dense O(N*T) Moller-Trumbore intersector — no BVH
builder, no traversal walk in that code path) at 1024 spp.
Rendering the same configs through the production accelerated path and
gating at SSIM >= 0.98 validates CORRECTNESS against an independent
implementation, not just reproducibility — the analog of the reference
validating against another renderer via ssim_compare.py
(the reference's ssim_compare.py:6-21)."""

import os

import numpy as np
import pytest

CORNELL_JSON = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "scenes", "cornell_box.json")

ORACLE_DIR = os.path.join(os.path.dirname(__file__), "..", "golden",
                          "oracle")
SPP = 256


def _gate(name, scene_path, camera, cfg_kwargs):
    from raytracer_tpu.api import render
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.utils.config import RenderConfig
    from raytracer_tpu.utils.image import ssim, tonemap

    if not os.path.exists(scene_path):
        pytest.skip("reference scenes not mounted")
    img = render(
        load_scene(scene_path), camera,
        RenderConfig(width=64, height=64, **cfg_kwargs), num_frames=SPP,
    )
    # Matched-spp oracle: identical deterministic RNG streams, brute-force
    # intersection — a correct fast path reproduces it near-exactly.
    matched = np.load(os.path.join(ORACLE_DIR, f"{name}_{SPP}spp_f32.npy"))
    score = ssim(tonemap(matched), tonemap(img))
    assert score >= 0.98, f"{name}: SSIM vs matched brute oracle = {score}"
    # Converged oracle: estimator-level consistency of the mean.
    oracle = np.load(os.path.join(ORACLE_DIR, f"{name}_f32.npy"))
    mean_err = abs(img.mean() - oracle.mean()) / max(oracle.mean(), 1e-6)
    assert mean_err < 0.05, f"{name}: mean off by {100 * mean_err:.1f}%"


def _gate_fullres(name, scene_path, camera, size, spp):
    """BASELINE-config-resolution gate: same matched-spp
    oracle discipline as _gate, at the resolution BASELINE.md specifies for
    the config (256x256 cornell / 512x512 cornell_pbr), so low-frequency
    shading bugs and tree/traversal artifacts that only manifest at scale
    are caught. Goldens from tools/make_oracle_goldens.py --fullres."""
    from raytracer_tpu.api import render
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.utils.config import RenderConfig
    from raytracer_tpu.utils.image import ssim, tonemap

    golden = os.path.join(ORACLE_DIR, f"{name}_{spp}spp_f32.npy")
    if not os.path.exists(scene_path):
        pytest.skip("reference scenes not mounted")
    if not os.path.exists(golden):
        pytest.skip(f"full-res oracle golden not generated yet ({golden}); "
                    "run tools/make_oracle_goldens.py --fullres")
    img = render(
        load_scene(scene_path), camera,
        RenderConfig(width=size, height=size), num_frames=spp,
    )
    matched = np.load(golden)
    score = ssim(tonemap(matched), tonemap(img))
    assert score >= 0.98, f"{name}: SSIM vs matched brute oracle = {score}"
    mean_err = abs(img.mean() - matched.mean()) / max(matched.mean(), 1e-6)
    assert mean_err < 0.05, f"{name}: mean off by {100 * mean_err:.1f}%"


@pytest.mark.slow
def test_oracle_cornell():
    _gate("cornell", CORNELL_JSON, None, {})


@pytest.mark.slow
def test_oracle_cornell_256_config_resolution():
    # BASELINE config 1: Cornell at 256x256. 4 spp on CPU (matched RNG
    # streams keep low spp strict — the noise is identical on both sides,
    # only intersection differences remain; a 1-core CPU pays ~100-160 s
    # per frame at this size). The 32-spp golden is for a gate on the card.
    _gate_fullres("cornell_256", CORNELL_JSON,
                  None, 256, 4)


@pytest.mark.slow
def test_oracle_cornell_pbr_512_config_resolution():
    # BASELINE config 2: cornell_pbr at 512x512 (2 spp on CPU; the 16-spp
    # golden is for a gate on the card — see above).
    from raytracer_tpu.ops.camera import Camera

    _gate_fullres(
        "cornell_pbr_512", "/root/reference/scenes/cornell_pbr.glb",
        Camera.create(position=(0, 1.0, 3.2), aspect=1.0, target=(0, 1.0, 0)),
        512, 2,
    )


@pytest.mark.slow
def test_oracle_cornell_pbr():
    from raytracer_tpu.ops.camera import Camera

    _gate(
        "cornell_pbr", "/root/reference/scenes/cornell_pbr.glb",
        Camera.create(position=(0, 1.0, 3.2), aspect=1.0,
                      target=(0, 1.0, 0)),
        {},
    )


@pytest.mark.slow
def test_oracle_dispersion():
    from raytracer_tpu.ops.camera import Camera

    _gate(
        "dispersion", "/root/reference/scenes/multi-dispersion.gltf",
        Camera.create(position=(0.32, 0.28, -0.65), aspect=1.0,
                      target=(-0.08, 0.07, -0.12)),
        {"max_depth": 8},
    )


@pytest.mark.slow
def test_oracle_conference():
    from raytracer_tpu.ops.camera import Camera

    _gate(
        "conference", "/root/reference/models/conference.glb",
        Camera.create(position=(-3.6, -1.6, 1.5), aspect=1.0,
                      target=(3.0, 1.5, 1.0)),
        {},
    )


@pytest.mark.slow
def test_oracle_restir_cornell():
    """ReSTIR estimates the same radiance as plain NEE: gate it against the
    brute NEE oracle (independent of both the accelerated traversal AND the
    direct-lighting estimator)."""
    from raytracer_tpu.api import render
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.utils.config import RenderConfig
    from raytracer_tpu.utils.image import ssim, tonemap

    path = CORNELL_JSON
    if not os.path.exists(path):
        pytest.skip("reference scenes not mounted")
    oracle = np.load(os.path.join(ORACLE_DIR, "cornell_f32.npy"))
    img = render(
        load_scene(path), None,
        RenderConfig(width=64, height=64, use_restir=True),
        num_frames=SPP,
    )
    # ReSTIR consumes different RNG draws than NEE, so matched-noise
    # comparison is impossible; gate statistically against the CONVERGED
    # oracle (a shadows-off regression measures ~2x the true mean, far
    # outside these bounds). Measured: +0.2% with spatial reuse off
    # (unbiased), +3.7% full pipeline (the documented M-sum spatial-reuse
    # bias of the real-time variant).
    score = ssim(tonemap(oracle), tonemap(img))
    assert score >= 0.90, f"restir: SSIM vs brute NEE oracle = {score}"
    mean_err = abs(img.mean() - oracle.mean()) / max(oracle.mean(), 1e-6)
    assert mean_err < 0.06, f"restir: mean off by {100 * mean_err:.1f}%"
