"""bench.py helper machinery: its pure parts get CPU tests (the datapoints
themselves only mean something on the card, and bench.py refuses to run
without one)."""

import logging
import os
import sys
import time

import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench

    return bench


def test_timed_frames_outlier_flag():
    bench = _bench()

    def make_step(straggler_frame):
        def step(ds, ubo, frame, cfg):
            if int(frame) == straggler_frame:
                time.sleep(0.25)
            else:
                time.sleep(0.005)
            return jnp.zeros((4,), jnp.float32), jnp.int32(7)

        return step

    # Straggler present: flag set, ray total still accumulates all frames.
    rad, total, times, outlier = bench.timed_frames(
        make_step(3), None, None, None, 5, "t")
    assert outlier is True
    assert total == 35 and len(times) == 5

    # No straggler: flag clear.
    _, _, _, outlier = bench.timed_frames(
        make_step(-1), None, None, None, 4, "t")
    assert outlier is False


def test_compile_log_tap_parses_hit_and_compile_time():
    bench = _bench()
    tap = bench._CompileLogTap.install()
    try:
        logger = logging.getLogger("jax._src.compiler")
        logger.debug(
            "Persistent compilation cache hit for 'jit_step' with key "
            "'jit_step-abc123'")
        logger.debug("'jit_frame' took at least 0.00 seconds to compile "
                     "(12.34s)")
    finally:
        tap.remove()
    assert "jit_step" in tap.hits
    assert tap.compile_s["jit_frame"] == 12.34
    # Removal restores the handler-free state (no leak into later tests).
    assert tap._handler not in logging.getLogger(
        "jax._src.compiler").handlers


def test_main_refuses_cpu_backend(capsys):
    """No GPU: exit non-zero before any work, and print no result line."""
    bench = _bench()
    assert bench.main() == 2
    assert capsys.readouterr().out == ""


def test_card_info_queries_name_and_power_limit(monkeypatch):
    bench = _bench()
    calls = []

    class Proc:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return Proc()

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    assert bench.card_info() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]


def test_atrium_camera_ubo_shapes():
    bench = _bench()
    ubo = bench.atrium_camera_ubo(64, 36)
    assert set(ubo) == {"inverse_view", "inverse_proj"}
    assert ubo["inverse_view"].shape == (4, 4)
    assert ubo["inverse_proj"].shape == (4, 4)
    assert np.isfinite(np.asarray(ubo["inverse_proj"])).all()


def test_times_list_is_unrounded_floats():
    bench = _bench()
    out = bench.times_list(np.asarray([0.123456789, 1.5]))
    assert out == [0.123456789, 1.5]
    assert all(type(t) is float for t in out)
