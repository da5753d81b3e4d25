"""Benchmark: ray throughput (Mrays/s) of the path tracer on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "device"},
where "device" carries the JAX platform, device kind, device count and the
card's name and power limit from nvidia-smi. Progress and the secondary
datapoints go to stderr.

Workload mirrors the reference's headline config: 1080p, 1 path/pixel/frame,
MAX_DEPTH=3 + NEE shadow rays, progressive accumulation, on a
~300k-triangle scene. The geometry is the deterministic procedural atrium
(raytracer_tpu/scene/benchmark.py) at Sponza scale. Ray counts are measured
(alive rays per bounce + shadow rays), not estimated. The traversal path is
the one `RenderConfig.resolve_accel()` picks.

Exits non-zero when JAX finds no GPU: a CPU run measures nothing a user
of the card would see.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

WIDTH, HEIGHT = 1920, 1080
TARGET_TRIS = 300_000
WARMUP_FRAMES = 2  # frame 0 pays compile + scene upload
BENCH_FRAMES = 8


def atrium_camera_ubo(width=WIDTH, height=HEIGHT):
    from raytracer_tpu.ops.camera import Camera

    cam = Camera.create(position=(-16.0, 6.5, -7.5), aspect=width / height,
                        target=(8.0, 3.0, 4.0))
    mats = cam.matrices()
    return {"inverse_view": jnp.asarray(mats["inverse_view"]),
            "inverse_proj": jnp.asarray(mats["inverse_proj"])}


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class _CompileLogTap:
    """Listen to jax._src.compiler's DEBUG records to learn, per jitted
    program, whether the persistent compilation cache hit and how long an
    actual XLA compile took. This is the only honest way to separate
    "compile" from "upload + first-readback stall" inside warmup."""

    def __init__(self):
        import logging
        import re

        self.hits = set()
        self.compile_s = {}
        outer = self

        class _H(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                m = re.search(
                    r"[Cc]ompilation cache hit for '([^']+)'", msg)
                if m:
                    outer.hits.add(m.group(1))
                m = re.search(
                    r"'([^']+)' took at least .*? to compile "
                    r"\(([0-9.]+)s\)", msg)
                if m:
                    outer.compile_s[m.group(1)] = float(m.group(2))

        self._handler = _H(0)
        self._logger = logging.getLogger("jax._src.compiler")
        self._old_level = self._logger.level

    @classmethod
    def install(cls):
        tap = cls()
        import logging

        tap._logger.setLevel(logging.DEBUG)
        tap._logger.addHandler(tap._handler)
        return tap

    def remove(self):
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._old_level)


def timed_frames(step, ds, ubo, cfg, frames, label):
    """Per-frame timed loop with the 2x-median outlier guard applied to
    EVERY datapoint (round-1's corrupted headline came from silently
    averaging a straggler frame; round 2 guarded only the headline)."""
    total = 0
    times = []
    for f in range(2, 2 + frames):
        t0 = time.perf_counter()
        rad, nrays = jax.block_until_ready(step(ds, ubo, jnp.uint32(f), cfg))
        times.append(time.perf_counter() - t0)
        total += int(nrays)
    ft = np.asarray(times)
    outlier = bool(ft.max() > 2.0 * np.median(ft))
    if outlier:
        log(f"WARNING: {label}: frame-time outlier {ft.max():.2f}s vs "
            f"median {np.median(ft):.2f}s — times: "
            f"{times_list(times)}")
    return rad, total, times, outlier


def atrium_1m_datapoint(step):
    """1080p render of a 1M-triangle atrium (the large-scene datapoint)."""
    from raytracer_tpu.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.utils.config import RenderConfig

    scene = create_benchmark_atrium(1_000_000)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                       max_depth=3).resolve_accel()
    ds, _ = bake_scene(scene, leaf_size=cfg.bvh_leaf_size)
    ubo = atrium_camera_ubo()
    for f in range(2):
        jax.block_until_ready(step(ds, ubo, jnp.uint32(f), cfg))
    frames = 5
    rad, total, times, outlier = timed_frames(step, ds, ubo, cfg, frames,
                                              "atrium_1m")
    dt = sum(times)
    return {
        "triangles": scene.num_triangles,
        "mrays_per_sec": total / dt / 1e6,
        "ms_per_frame": 1e3 * dt / frames,
        "frame_times_s": times_list(times),
        "outlier_frames": outlier,
        "mean_radiance": float(np.asarray(rad).mean()),
    }


def hall_datapoint(step):
    """1080p render of the Sponza-geometry-class stress hall
    (scene/benchmark.py:create_benchmark_hall): long thin drapes/beams,
    >100:1 triangle-scale mix, occlusion corridor lit end-on — SAH split
    quality off the atrium's sphere-lattice happy path. Camera looks down
    the corridor."""
    from raytracer_tpu.ops.camera import Camera
    from raytracer_tpu.scene.benchmark import create_benchmark_hall
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.utils.config import RenderConfig

    scene = create_benchmark_hall(TARGET_TRIS)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                       max_depth=3).resolve_accel()
    ds, _ = bake_scene(scene, leaf_size=cfg.bvh_leaf_size)
    cam = Camera.create(position=(-27.0, 5.0, 0.0), aspect=WIDTH / HEIGHT,
                        target=(30.0, 5.0, 0.0))
    mats = cam.matrices()
    ubo = {"inverse_view": jnp.asarray(mats["inverse_view"]),
           "inverse_proj": jnp.asarray(mats["inverse_proj"])}
    for f in range(2):
        jax.block_until_ready(step(ds, ubo, jnp.uint32(f), cfg))
    frames = 5
    rad, total, times, outlier = timed_frames(step, ds, ubo, cfg, frames,
                                              "hall_sponza_class")
    dt = sum(times)
    return {
        "triangles": scene.num_triangles,
        "mrays_per_sec": total / dt / 1e6,
        "ms_per_frame": 1e3 * dt / frames,
        "frame_times_s": times_list(times),
        "outlier_frames": outlier,
        "mean_radiance": float(np.asarray(rad).mean()),
    }


def preview_datapoint(step, ds, ubo):
    """Interactive-preview rate on the HEADLINE scene: 512x288 is the
    resolution examples/interactive_session.py edits against (the
    reference's editor loop is its whole UX, ui.odin:491-501). The 1080p
    camera ubo is reused (identical aspect ratio); only the pixel grid
    shrinks, so this measures how frame time scales down to preview size."""
    from raytracer_tpu.utils.config import RenderConfig

    cfg = RenderConfig(width=512, height=288, max_depth=3).resolve_accel()
    for f in range(2):
        jax.block_until_ready(step(ds, ubo, jnp.uint32(f), cfg))
    frames = 10
    rad, total, times, outlier = timed_frames(step, ds, ubo, cfg, frames,
                                              "preview_512x288")
    dt = sum(times)
    return {
        "resolution": "512x288",
        "mrays_per_sec": total / dt / 1e6,
        "ms_per_frame": 1e3 * dt / frames,
        "fps": frames / dt,
        "frame_times_s": times_list(times),
        "outlier_frames": outlier,
        "mean_radiance": float(np.asarray(rad).mean()),
    }


def restir_datapoint(ds, ubo):
    """1080p ReSTIR DI on the same atrium (BASELINE config 5): the reference
    ships restir.rgen scaffolding for a performance win
    (shaders/restir.rgen:17-92); this records ours — with
    and without the step-3 initial-visibility pass (each toggle is a
    separate compile; the toggle consumes no RNG draws)."""
    import functools

    from raytracer_tpu.integrator.restir import (
        Reservoir,
        render_wavefront_restir,
    )
    from raytracer_tpu.integrator.wavefront import accumulate
    from raytracer_tpu.utils.config import RenderConfig

    out = {}
    for iv in (True, False):
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3,
                           use_restir=True,
                           restir_initial_visibility=iv).resolve_accel()

        @functools.partial(jax.jit, static_argnames=("cfg",),
                           donate_argnums=(2, 3))
        def step(ds, ubo, accum, res, frame, cfg):
            rad, new_res, stats = render_wavefront_restir(
                ds, ubo, res, frame, cfg, with_stats=True)
            return (accumulate(accum, rad, frame), new_res,
                    stats["total_rays"])

        accum = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
        res = Reservoir.empty(cfg.num_pixels)
        for f in range(2):
            accum, res, nrays = jax.block_until_ready(
                step(ds, ubo, accum, res, jnp.uint32(f), cfg))
        frames = 5
        total = 0
        times = []
        for f in range(2, 2 + frames):
            t0 = time.perf_counter()
            accum, res, nrays = jax.block_until_ready(
                step(ds, ubo, accum, res, jnp.uint32(f), cfg))
            times.append(time.perf_counter() - t0)
            total += int(nrays)
        ft = np.asarray(times)
        outlier = bool(ft.max() > 2.0 * np.median(ft))
        if outlier:
            log(f"WARNING: restir(iv={iv}) outlier {ft.max():.2f}s vs "
                f"median {np.median(ft):.2f}s")
        key = "restir" if iv else "restir_no_initial_visibility"
        out[key] = {
            "mrays_per_sec": total / sum(times) / 1e6,
            "ms_per_frame": 1e3 * sum(times) / frames,
            "rays_per_frame": total // frames,
            "frame_times_s": times_list(times),
            "outlier_frames": outlier,
            "mean_radiance": float(np.asarray(accum).mean()),
        }
    return out


def main():
    from raytracer_tpu.integrator.wavefront import render_wavefront
    from raytracer_tpu.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu.scene.device_scene import bake_scene
    from raytracer_tpu.utils.compile_cache import enable_persistent_cache
    from raytracer_tpu.utils.config import RenderConfig

    if jax.default_backend() != "gpu":
        log(f"bench: no GPU (JAX backend is {jax.default_backend()!r})")
        return 2
    devices = jax.devices()
    card = card_info()
    log(f"devices: {[str(d) for d in devices]}; card: {card}")
    cache_dir = enable_persistent_cache()

    t0 = time.perf_counter()
    scene = create_benchmark_atrium(TARGET_TRIS)
    log(f"scene: {scene.num_triangles} tris, {len(scene.objects)} objects "
        f"({time.perf_counter() - t0:.1f}s)")

    cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                       max_depth=3).resolve_accel()
    t0 = time.perf_counter()
    ds, bvh = bake_scene(scene, leaf_size=cfg.bvh_leaf_size)
    jax.block_until_ready(ds)
    bake_s = time.perf_counter() - t0
    log(f"bake: {bake_s:.1f}s, {bvh.num_nodes} BVH nodes")
    ubo = atrium_camera_ubo()

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def step(ds, ubo, frame, cfg):
        rad, stats = render_wavefront(ds, ubo, frame, cfg, with_stats=True)
        return rad, stats["total_rays"]

    # Warm-start decomposition: trace+lower is Python/StableHLO work that
    # every process pays; the XLA compile is what the persistent cache
    # (utils/compile_cache.py) eliminates — measured by tapping the
    # compiler's own log during warmup (an explicit lower().compile() would
    # use AOT compile options whose cache key differs from the jit dispatch
    # path and spuriously miss).
    t0 = time.perf_counter()
    step.lower(ds, ubo, jnp.uint32(0), cfg)
    lower_s = time.perf_counter() - t0
    tap = _CompileLogTap.install()
    t0 = time.perf_counter()
    for f in range(WARMUP_FRAMES):
        jax.block_until_ready(step(ds, ubo, jnp.uint32(f), cfg))
        log(f"warmup {f}: {time.perf_counter() - t0:.1f}s cumulative")
    warmup_s = time.perf_counter() - t0
    tap.remove()
    cache_hit = "jit_step" in tap.hits
    xla_compile_s = tap.compile_s.get("jit_step", 0.0)
    log(f"trace+lower: {lower_s:.1f}s; jit_step persistent-cache "
        f"{'HIT' if cache_hit else 'miss'}, xla compile "
        f"{xla_compile_s:.1f}s")

    rad, total_rays, frame_times, headline_outlier = timed_frames(
        step, ds, ubo, cfg, BENCH_FRAMES, "atrium_1080p")
    elapsed = sum(frame_times)
    mrays = total_rays / elapsed / 1e6

    # Secondary datapoints: a failure fails the run.
    big = atrium_1m_datapoint(step)
    log(json.dumps({"atrium_1m": big}))
    hall = hall_datapoint(step)
    log(json.dumps({"hall_sponza_class": hall}))
    restir = restir_datapoint(ds, ubo)
    log(json.dumps(restir))
    preview = preview_datapoint(step, ds, ubo)
    log(json.dumps({"preview_512x288": preview}))

    ft = np.asarray(frame_times)
    detail = {
        "scene": "procedural_atrium",
        "triangles": scene.num_triangles,
        "resolution": f"{WIDTH}x{HEIGHT}",
        "accel": cfg.accel,
        "frames": BENCH_FRAMES,
        "rays": total_rays,
        "ms_per_frame": 1e3 * elapsed / BENCH_FRAMES,
        "frame_times_s": times_list(frame_times),
        "median_frame_s": float(np.median(ft)),
        "outlier_frames": headline_outlier,
        "bake_s": bake_s,
        "trace_lower_s": lower_s,
        "xla_compile_s": xla_compile_s,
        "persistent_cache_hit": cache_hit,
        "compile_cache_dir": cache_dir,
        "warmup_s": warmup_s,
        "mean_radiance": float(np.asarray(rad).mean()),
    }
    log(json.dumps({"detail": detail}))
    print(json.dumps({
        "metric": "mrays_per_sec_per_card",
        "value": mrays,
        "unit": "Mrays/s",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices), "card": card},
    }), flush=True)
    return 0


def times_list(times):
    return [float(t) for t in times]


if __name__ == "__main__":
    sys.exit(main())
