"""chip_smoke.py: its contract on a machine without a GPU, and each phase at
a tiny size on the CPU (the full sizes run only on the card)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(tris=4000, width=32, height=16, warmup=2, timed=2,
            pass_repeats=2, oracle_width=16, oracle_height=8,
            oracle_frames=1, ray_stride=4, cpu_width=16, cpu_height=8,
            feature_width=32, feature_height=16, cli_width=32,
            cli_height=24, cli_spp=2, mesh_steps=2)


def _smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _sizes(**kw):
    cs = _smoke()
    return cs.Sizes(**{**TINY, **kw})


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py"), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def _has_ok_line(stdout):
    return any('"ok"' in line for line in stdout.splitlines())


@pytest.mark.parametrize("args", [(), ("--cards", "4")])
def test_cpu_run_exits_nonzero_without_result_line(args):
    proc = _run_script(REPO, *args)
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)
    assert "no GPU" in proc.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path))
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)


def test_result_line_has_exactly_the_contract_keys():
    cs = _smoke()

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = json.loads(cs.result_line([Dev()] * 4))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_cards_4_selects_only_the_mesh_phase():
    cs = _smoke()
    assert cs.select_phases(4) == ["device", "mesh"]
    single = cs.select_phases(1)
    assert "mesh" not in single
    assert single == ["device", "main_path", "oracle", "cpu", "features",
                      "cli"]


def test_phase_device():
    cs = _smoke()
    rep = {}
    cs.phase_device(rep)
    assert rep["devices"] and rep["compile_cache_dir"]
    assert "nvidia_smi" not in rep  # only read on a GPU


def test_phase_main_path():
    cs = _smoke()
    rep = {}
    cs.phase_main_path(rep, _sizes())
    for leaf in ("16", "8"):
        r = rep["main_path"][leaf]
        assert r["total_rays"] >= 32 * 16
        assert r["median_ms"] > 0 and r["mean_radiance"] > 0
        assert len(r["frame_times_ms"]) == 2
    assert rep["xla_walk_passes"]["bounce1_live_rays"] > 0


def test_phase_oracle():
    cs = _smoke()
    rep = {}
    cs.phase_oracle(rep, _sizes())
    assert rep["oracle"]["rays"]["rays"] == 32 * 16 // 4
    assert rep["oracle"]["rays"]["hit_mismatch"] == 0


def test_phase_cpu():
    cs = _smoke()
    rep = {}
    cs.phase_cpu(rep, _sizes())
    assert rep["card_vs_cpu"]["fraction_within_1e-3"] == 1.0


def test_phase_features(tmp_path):
    cs = _smoke()
    rep = {}
    cs.phase_features(rep, _sizes(), str(tmp_path))
    f = rep["features"]
    assert f["checkpoint_roundtrip_equal"]
    assert all(f[k]["finite"] for k in ("restir", "adaptive", "spp_batch4",
                                        "preview_scale4_denoised"))


def test_phase_cli(tmp_path):
    cs = _smoke()
    rep = {}
    cs.phase_cli(rep, _sizes(), str(tmp_path))
    assert rep["cli"]["rc"] == 0
    assert rep["cli"]["shape"] == [24, 32, 3]


def test_phase_mesh_on_4_of_8_virtual_devices():
    """The ReSTIR tile of each of the 4 devices must hold the spatial halo
    (radius 16 -> 17 rows), so the image is 68 rows high."""
    import jax

    cs = _smoke()
    assert len(jax.devices()) == 8
    rep = {}
    cs.phase_mesh(rep, _sizes(width=8, height=68), 4)
    for name in ("path_tracing", "restir"):
        assert rep["mesh"][name]["max_diff_beyond_rtol"] <= cs.MESH_TOL


def test_run_records_a_failed_phase(tmp_path, monkeypatch):
    """A failing phase is reported and the run's status says so; later
    phases still run."""
    cs = _smoke()

    def boom(rep, sizes=None):
        raise RuntimeError("broken phase")

    monkeypatch.setattr(cs, "phase_oracle", boom)
    rep = cs.run(["oracle", "device"], _sizes(), str(tmp_path), 1)
    assert rep["phases"]["oracle"]["status"] == "failed"
    assert rep["phases"]["device"]["status"] == "ok"
