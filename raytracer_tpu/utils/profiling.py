"""Profiling helpers — the aux-subsystem analog of the reference's live
ImGui frame-time plot (SURVEY.md §5): `jax.profiler` trace capture plus a
simple wall-clock phase timer that waits for the device with
`jax.block_until_ready`."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (viewable in TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(value):
    """Wait until every array in `value` is computed; returns `value`."""
    return jax.block_until_ready(value)


class PhaseTimer:
    """Accumulates wall time per named phase with forced device sync."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result_holder: Optional[List] = None):
        t0 = time.perf_counter()
        yield
        if result_holder:
            sync(result_holder[0])
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k, _ in rows), default=1)
        return "\n".join(
            f"{k.ljust(width)}  {v * 1e3:8.1f} ms total  "
            f"({v / max(self.counts[k], 1) * 1e3:.1f} ms/call x{self.counts[k]})"
            for k, v in rows
        )
