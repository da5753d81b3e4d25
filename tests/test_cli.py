"""End-to-end CLI tests (the product surface a reference user drives).

Tiny renders of the in-repo Cornell scene (examples/scenes/cornell_box.json,
the reference's JSON format, identical to create_cornell_box) through
`raytracer_tpu.cli.main`, covering the flag plumbing the unit tests
don't: PNG/PPM output, checkpoint/resume, preview + stats loops, and
the accel override.
"""

import os

import numpy as np

from raytracer_tpu.cli import main
from raytracer_tpu.utils.image import read_png

SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "scenes",
                     "cornell_box.json")
BASE = ["--width", "16", "--height", "16", "--accel", "bvh"]


def test_cli_renders_png(tmp_path):
    out = str(tmp_path / "r.png")
    rc = main([SCENE, *BASE, "--spp", "2", "--out", out])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (16, 16, 3)
    assert img.max() > 0


def test_cli_renders_ppm(tmp_path):
    from raytracer_tpu.utils.image import read_ppm

    out = str(tmp_path / "r.ppm")
    rc = main([SCENE, *BASE, "--spp", "1", "--out", out])
    assert rc == 0
    img = read_ppm(out)
    assert img.shape == (16, 16, 3)


def test_cli_checkpoint_resume(tmp_path, caplog):
    out = str(tmp_path / "r.png")
    ck = str(tmp_path / "ck.npz")
    assert main([SCENE, *BASE, "--spp", "2", "--out", out,
                 "--checkpoint", ck]) == 0
    data = np.load(ck)
    assert int(data["frame"]) == 2
    # Second run resumes at frame 2 and extends to 4.
    assert main([SCENE, *BASE, "--spp", "4", "--out", out,
                 "--checkpoint", ck]) == 0
    data = np.load(ck)
    assert int(data["frame"]) == 4
    # Resumed accumulation must equal an uninterrupted 4-frame render.
    direct = str(tmp_path / "d.png")
    assert main([SCENE, *BASE, "--spp", "4", "--out", direct]) == 0
    assert np.array_equal(read_png(out), read_png(direct))


def test_cli_png_output_ssim_gated(tmp_path):
    """SSIM-gate the ACTUAL CLI PNG output path (VERDICT r3 #4): the same
    render that test_golden.py gates in-memory, driven through the CLI and
    read back from the PNG it wrote — so tonemap, quantization, file
    encoding and flag plumbing are all inside the gate, with the
    reference's ssim_compare.py semantics and the BASELINE 0.98 bar."""
    import os

    from raytracer_tpu.utils.image import ssim

    golden_path = os.path.join(os.path.dirname(__file__), "..", "golden",
                               "cornell_64.png")
    out = str(tmp_path / "cli.png")
    rc = main([SCENE, "--width", "64", "--height", "64", "--spp", "16",
               "--out", out])
    assert rc == 0
    score = ssim(read_png(golden_path), read_png(out))
    assert score >= 0.98, f"CLI PNG output SSIM vs golden = {score}"


def test_cli_preview_and_stats(tmp_path, capsys):
    out = str(tmp_path / "r.png")
    rc = main([SCENE, *BASE, "--spp", "2", "--out", out,
               "--preview", "1", "--stats-every", "1"])
    assert rc == 0
    assert read_png(out).shape == (16, 16, 3)
    # The stats table (ImGui Performance-window analog) printed something.
    assert "frame" in capsys.readouterr().out.lower()


def test_cli_writes_aovs(tmp_path):
    prefix = str(tmp_path / "r")
    rc = main([SCENE, *BASE, "--spp", "1", "--out", str(tmp_path / "r.png"),
               "--aovs", prefix])
    assert rc == 0
    for kind in ("albedo", "normal", "depth"):
        img = read_png(f"{prefix}_{kind}.png")
        assert img.shape == (16, 16, 3)
    # The normal AOV encodes n*0.5+0.5: a flat miss-free Cornell view has
    # non-trivial normal variation.
    assert read_png(f"{prefix}_normal.png").std() > 0
