"""Entry-hook routing: dryrun_multichip must never initialize a jax backend
in the calling process unless the env already pins a big-enough virtual CPU
mesh (a process that has opened an accelerator cannot switch to the forced
CPU backend) — so the decision is env-only and the real work happens in a
forced-CPU child."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import __graft_entry__ as g

    return g


def test_forced_cpu_device_count_parses_env(monkeypatch):
    g = _mod()
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    assert g._forced_cpu_device_count() == 8
    monkeypatch.setenv(
        "XLA_FLAGS",
        "--foo=1 --xla_force_host_platform_device_count=4 --bar=2")
    assert g._forced_cpu_device_count() == 4
    # Plain CPU backend without the flag = one device.
    monkeypatch.setenv("XLA_FLAGS", "")
    assert g._forced_cpu_device_count() == 1
    # Unparseable count: treat as not-forced (the re-exec will fix the env).
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=oops")
    assert g._forced_cpu_device_count() == 0


@pytest.mark.parametrize("platforms", ["", "gpu", "cuda,cpu"])
def test_forced_cpu_device_count_zero_off_cpu(monkeypatch, platforms):
    g = _mod()
    if platforms:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    else:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    assert g._forced_cpu_device_count() == 0


def test_dryrun_routes_inline_when_env_is_forced_cpu(monkeypatch):
    g = _mod()
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    calls = []
    monkeypatch.setattr(g, "_dryrun_body", lambda n: calls.append(("b", n)))
    monkeypatch.setattr(
        g, "_reexec_on_virtual_cpu_mesh",
        lambda n: calls.append(("re", n)))
    g.dryrun_multichip(8)
    assert calls == [("b", 8)]


def test_dryrun_routes_to_reexec_otherwise(monkeypatch):
    # The parent's env does not pin a big-enough CPU mesh: the ONLY allowed
    # action is the re-exec (no jax API may run in this process).
    g = _mod()
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    calls = []
    monkeypatch.setattr(
        g, "_dryrun_body",
        lambda n: (_ for _ in ()).throw(AssertionError("inline forbidden")))
    monkeypatch.setattr(
        g, "_reexec_on_virtual_cpu_mesh", lambda n: calls.append(n))
    g.dryrun_multichip(8)
    assert calls == [8]

    # Forced to fewer devices than requested: still re-exec.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=4")
    g.dryrun_multichip(8)
    assert calls == [8, 8]


def test_reexec_child_env_pins_cpu_mesh(monkeypatch):
    """The re-exec child env must pin the CPU platform with the requested
    device count, keep prior XLA flags, and mark itself so it never
    re-execs again (checked without running the expensive child)."""
    g = _mod()
    monkeypatch.setenv("XLA_FLAGS", "--prior_flag=1")
    captured = {}

    class FakeProc:
        returncode = 0

    def fake_run(cmd, **kw):
        captured["cmd"] = cmd
        captured["env"] = kw["env"]
        captured["cwd"] = kw["cwd"]
        return FakeProc()

    import subprocess as sp

    monkeypatch.setattr(sp, "run", fake_run)
    g._reexec_on_virtual_cpu_mesh(8)
    env = captured["env"]
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["_GRAFT_DRYRUN_CHILD"] == "1"  # child must never re-exec
    assert env["XLA_FLAGS"].startswith("--prior_flag=1 ")
    assert env["XLA_FLAGS"].endswith(
        "--xla_force_host_platform_device_count=8")
    assert "g._dryrun_body(8)" in captured["cmd"][2]
    assert os.path.samefile(captured["cwd"], REPO)


def test_dryrun_passes_under_simulated_driver_env():
    """End-to-end: run dryrun_multichip(8) in a subprocess with the env shape
    a test run uses — JAX_PLATFORMS=cpu + the force-8 XLA flag set. The
    routing runs the dry run inline on the virtual mesh and must PASS."""
    import subprocess

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=8"])
    env.pop("_GRAFT_DRYRUN_CHILD", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        cwd=REPO, env=env, timeout=2700,
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, (
        f"dryrun under simulated driver env failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr ---\n{proc.stderr[-4000:]}"
    )
    assert "dryrun PASS" in proc.stderr
