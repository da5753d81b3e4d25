#!/usr/bin/env python3
"""On-card smoke test: drive the path tracer's main path once on the GPU.

Usage (from the repository root):

    python chip_smoke.py              # every single-card phase
    python chip_smoke.py --cards 4    # only the 4-card mesh path vs one card

Single-card phases, all in this one process (a second JAX process could
not get the card's memory):

  1. device     jax devices and version, XLA_FLAGS, compile-cache dir, and
                the card's name and power limit from nvidia-smi
  2. main_path  ProgressiveRenderer on the 300k-triangle atrium at 1920x1080,
                max_depth 3: bake, compile, first frame, median frame time,
                rays/frame and Mrays/s — at BVH leaf size 16 and 8 (the
                default) — plus one closest-hit and one occlusion pass of
                the BVH walk on the frame's bounce-1 wavefront
  3. oracle     accel="bvh" against accel="brute" (ops/intersect.py) on the
                same atrium: images at 320x180, and intersect_bvh against
                intersect_brute on every 16th primary ray at 1080p
  4. cpu        one 160x90 atrium frame on the card against the CPU backend
  5. features   ReSTIR, adaptive sampling, spp_batch=4, denoised preview,
                AOVs, checkpoint save/load, one step each at 480x270
  6. cli        raytracer_tpu.cli.main on examples/scenes/cornell_box.json at
                1280x1020, 4 spp; the PNG is read back

With --cards 4 only the mesh phase runs: ProgressiveRenderer over a 1-D
pixel mesh of 4 devices against the same render on one device, and one
sharded ReSTIR step (halo exchange by ppermute) against one device.

The script exits non-zero, and prints no result line, when JAX finds no
GPU or any phase fails. On success the last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Longer output goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.accel import native_builder
from raytracer_tpu.api import ProgressiveRenderer
from raytracer_tpu.integrator import wavefront as wf
from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.ops.intersect import intersect_brute
from raytracer_tpu.ops.traverse import intersect_bvh, occlusion_bvh
from raytracer_tpu.scene.benchmark import create_benchmark_atrium
from raytracer_tpu.utils.compile_cache import enable_persistent_cache
from raytracer_tpu.utils.config import RenderConfig

REPO = os.path.dirname(os.path.abspath(__file__))
CORNELL_JSON = os.path.join(REPO, "examples", "scenes", "cornell_box.json")

# Image tolerances, each with its reason:
#  - bvh vs brute on one device: the CPU suite's standard
#    (tests/test_integrator.py::test_brute_vs_bvh_same_image). A pixel may
#    still differ when a ray passes within f32 rounding of a triangle edge
#    and the two compiled programs (which contract multiply-adds
#    differently) disagree on it; such a path then diverges. At most
#    ORACLE_OUTLIER_FRAC of the pixels may do so.
ORACLE_TOL = 1e-3
ORACLE_OUTLIER_FRAC = 1e-3
#  - card vs CPU: the same program compiled for two backends rounds
#    differently (FMA contraction, transcendental implementations, reduction
#    order). Most pixels agree to ORACLE_TOL; a path whose bounce direction
#    or NEE lottery flips on a last-bit difference diverges completely.
CPU_MIN_FRAC_WITHIN = 0.98
CPU_MAX_MEAN_ABS = 5e-3
#  - mesh vs one device: the repo's sharded-vs-single standard, in the form
#    tests/test_sharding.py asserts it: |diff| <= MESH_TOL * (1 + |ref|).
#    The two programs fuse differently, and float reassociation drift is
#    relative to the radiance (up to the 5.0 clamp), so a purely absolute
#    1e-6 bound fails on bright pixels by a few ULP.
MESH_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload sizes. FULL is what the script runs; tests use a tiny one."""

    tris: int = 300_000
    width: int = 1920
    height: int = 1080
    warmup: int = 2
    timed: int = 6
    pass_repeats: int = 5
    oracle_width: int = 320
    oracle_height: int = 180
    oracle_frames: int = 2
    ray_stride: int = 16
    cpu_width: int = 160
    cpu_height: int = 90
    feature_width: int = 480
    feature_height: int = 270
    cli_width: int = 1280
    cli_height: int = 1020
    cli_spp: int = 4
    mesh_steps: int = 4


FULL = Sizes()


def log(msg: str) -> None:
    print(msg, flush=True)


def atrium_camera(width: int, height: int) -> Camera:
    return Camera.create(position=(-16.0, 6.5, -7.5), aspect=width / height,
                         target=(8.0, 3.0, 4.0))


_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


def compile_seconds(fn) -> float:
    """Run fn() and return the seconds JAX itself reports spending on
    tracing, lowering and compiling during it (jax.monitoring events), so
    compile time is reported apart from run time."""
    total = [0.0]

    def on_event(event, duration, **_):
        if event in _COMPILE_EVENTS:
            total[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        fn()
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    return total[0]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_device(report: dict) -> None:
    devs = jax.devices()
    report["jax_version"] = jax.__version__
    report["devices"] = [str(d) for d in devs]
    report["device_kind"] = devs[0].device_kind
    report["xla_flags"] = os.environ.get("XLA_FLAGS", "")
    report["compile_cache_dir"] = enable_persistent_cache()
    log(f"[device] jax {jax.__version__}; devices {report['devices']}")
    log(f"[device] XLA_FLAGS={report['xla_flags']!r}")
    log(f"[device] compile cache {report['compile_cache_dir']}")
    if jax.default_backend() == "gpu":
        report["nvidia_smi"] = nvidia_smi_line()
        log(f"[device] card: {report['nvidia_smi']}")


def _timed_steps(renderer, n: int):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        renderer.step()
        jax.block_until_ready(renderer.accum)
        times.append(time.perf_counter() - t0)
    return times


def _rays_per_frame(renderer, frame: int):
    cfg = renderer.config

    @jax.jit
    def stats(ds, ubo, frame):
        _, st = wf.render_wavefront(ds, ubo, frame, cfg, with_stats=True)
        return st

    st = jax.device_get(stats(renderer.device_scene,
                              renderer._ensure_camera_ubo(),
                              jnp.uint32(frame)))
    return {k: int(v) for k, v in st.items()}


def main_path_once(sizes: Sizes, leaf: int, scene) -> dict:
    """Bake, compile and time the progressive frame at one leaf size."""
    out = {"leaf_size": leaf}
    cfg = RenderConfig(width=sizes.width, height=sizes.height, max_depth=3,
                       bvh_leaf_size=leaf)
    camera = atrium_camera(sizes.width, sizes.height)
    built_before = native_builder.build_seconds
    t0 = time.perf_counter()
    renderer = ProgressiveRenderer(scene, camera, cfg)
    jax.block_until_ready(renderer.device_scene)
    out["bake_s"] = time.perf_counter() - t0
    out["native_build_s"] = native_builder.build_seconds - built_before
    out["builder"] = f"native C++ ({native_builder.LIBRARY_PATH})"
    t1 = time.perf_counter()
    out["compile_s"] = compile_seconds(lambda: _timed_steps(renderer, 1))
    out["first_frame_s"] = time.perf_counter() - t1
    out["time_to_first_image_s"] = time.perf_counter() - t0
    _timed_steps(renderer, sizes.warmup - 1)
    times = _timed_steps(renderer, sizes.timed)
    med = statistics.median(times)
    out["frame_times_ms"] = [1e3 * t for t in times]
    out["median_ms"] = 1e3 * med
    out["spread_ms"] = 1e3 * (max(times) - min(times))
    rays = _rays_per_frame(renderer, renderer.frame)
    out.update(rays)
    out["mrays_per_s"] = rays["total_rays"] / med / 1e6
    img = renderer.image()
    out["mean_radiance"] = float(img.mean())
    if not np.isfinite(img).all():
        raise AssertionError("main-path image has non-finite pixels")
    if not img.max() > 0.0:
        raise AssertionError("main-path image is black")
    out["renderer"] = renderer
    return out


def xla_walk_passes(renderer, sizes: Sizes) -> dict:
    """Time one closest-hit and one occlusion pass of the BVH walk on the
    bounce-1 wavefront of frame 0 (the rays the second bounce traces and
    shadow rays from their origins to the lights)."""
    ds = renderer.device_scene
    cfg = renderer.config

    @jax.jit
    def bounce1(ds, ubo):
        pix = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
        state = wf.primary_state(ubo, jnp.uint32(0), cfg, pix)
        state, _, _ = wf.trace_bounce(ds, state, 0, cfg)
        n_l = ds.light_center.shape[0]
        k = jnp.arange(cfg.num_pixels) % max(n_l, 1)
        to_l = ds.light_center[k] - state.origin
        dist = jnp.linalg.norm(to_l, axis=-1)
        return (state.origin, state.direction, state.alive,
                to_l / jnp.maximum(dist, 1e-20)[:, None], dist * 0.999,
                ds.light_object[k])

    o, d, alive, sd, st, skip = bounce1(ds, renderer._ensure_camera_ubo())

    closest = jax.jit(lambda ds, o, d, a: intersect_bvh(
        o, d, ds, cfg.t_min, cfg.t_max, active_mask=a).t)
    occl = jax.jit(lambda ds, o, d, tm, s, a: occlusion_bvh(
        o, d, cfg.t_min, tm, ds, s, active_mask=a))

    def timed(fn, *args):
        jax.block_until_ready(fn(*args))  # compile
        ts = []
        for _ in range(sizes.pass_repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(ts), 1e3 * (max(ts) - min(ts))

    live = int(jnp.sum(alive))
    c_ms, c_spread = timed(closest, ds, o, d, alive)
    o_ms, o_spread = timed(occl, ds, o, sd, st, skip, alive)
    return {"bounce1_live_rays": live,
            "closest_hit_ms": c_ms, "closest_hit_spread_ms": c_spread,
            "occlusion_ms": o_ms, "occlusion_spread_ms": o_spread}


def phase_main_path(report: dict, sizes: Sizes = FULL) -> None:
    scene = create_benchmark_atrium(sizes.tris)
    report["triangles"] = scene.num_triangles
    log(f"[main_path] atrium: {scene.num_triangles} triangles, "
        f"{sizes.width}x{sizes.height}, max_depth 3")
    runs = {}
    for leaf in (16, 8):
        r = main_path_once(sizes, leaf, scene)
        renderer = r.pop("renderer")
        runs[leaf] = r
        log(f"[main_path] leaf {leaf}: bake {r['bake_s']:.3f} s "
            f"(builder {r['builder']}, library build "
            f"{r['native_build_s']:.3f} s), compile {r['compile_s']:.3f} s, "
            f"first frame {r['first_frame_s']:.3f} s, time to first image "
            f"{r['time_to_first_image_s']:.3f} s")
        log(f"[main_path] leaf {leaf}: median {r['median_ms']:.3f} ms/frame "
            f"(spread {r['spread_ms']:.3f} ms over {sizes.timed} frames: "
            f"{', '.join(f'{t:.3f}' for t in r['frame_times_ms'])}), "
            f"{r['total_rays']} rays/frame ({r['rays_traced']} path + "
            f"{r['shadow_rays']} shadow), {r['mrays_per_s']:.3f} Mrays/s, "
            f"mean radiance {r['mean_radiance']:.6f}")
        if leaf == RenderConfig().bvh_leaf_size:
            passes = xla_walk_passes(renderer, sizes)
            report["xla_walk_passes"] = passes
            log(f"[main_path] BVH walk on the bounce-1 wavefront "
                f"({passes['bounce1_live_rays']} live rays, leaf {leaf}): "
                f"closest-hit {passes['closest_hit_ms']:.3f} ms (spread "
                f"{passes['closest_hit_spread_ms']:.3f}), occlusion "
                f"{passes['occlusion_ms']:.3f} ms (spread "
                f"{passes['occlusion_spread_ms']:.3f})")
        del renderer
    report["main_path"] = {str(k): v for k, v in runs.items()}


def phase_oracle(report: dict, sizes: Sizes = FULL) -> None:
    scene = create_benchmark_atrium(sizes.tris)
    imgs = {}
    for accel in ("bvh", "brute"):
        cfg = RenderConfig(width=sizes.oracle_width,
                           height=sizes.oracle_height, max_depth=3,
                           accel=accel)
        r = ProgressiveRenderer(
            scene, atrium_camera(cfg.width, cfg.height), cfg)
        imgs[accel] = r.render(sizes.oracle_frames)
    a, b = imgs["bvh"], imgs["brute"]
    bad_px = ~np.all(np.isclose(a, b, rtol=ORACLE_TOL, atol=ORACLE_TOL),
                     axis=-1)
    frac_bad = float(bad_px.mean())
    img = {"pixels_outside_tol": int(bad_px.sum()),
           "fraction_outside_tol": frac_bad,
           "max_abs_diff": float(np.abs(a - b).max()),
           "mean_abs_diff": float(np.abs(a - b).mean())}
    log(f"[oracle] image bvh vs brute {sizes.oracle_width}x"
        f"{sizes.oracle_height}, {sizes.oracle_frames} frames: "
        f"{img['pixels_outside_tol']} pixels outside rtol=atol="
        f"{ORACLE_TOL} (fraction {frac_bad:.2e}, allowed "
        f"{ORACLE_OUTLIER_FRAC:.0e}); max |diff| {img['max_abs_diff']:.3e}, "
        f"mean |diff| {img['mean_abs_diff']:.3e}")

    # Ray level: every ray_stride-th primary ray of the full-size frame.
    cfg = RenderConfig(width=sizes.width, height=sizes.height)
    r = ProgressiveRenderer(scene, atrium_camera(cfg.width, cfg.height), cfg)
    ds = r.device_scene

    @jax.jit
    def compare(ds, ubo):
        pix = jnp.arange(0, cfg.num_pixels, sizes.ray_stride,
                         dtype=jnp.uint32)
        st = wf.primary_state(ubo, jnp.uint32(0), cfg, pix)
        h1 = intersect_bvh(st.origin, st.direction, ds, cfg.t_min, cfg.t_max)
        h2 = intersect_brute(st.origin, st.direction, ds.tri_v0, ds.tri_e1,
                             ds.tri_e2, cfg.t_min, cfg.t_max)
        return h1.t, h1.tri, h2.t, h2.tri

    t1, tri1, t2, tri2 = jax.device_get(compare(ds, r._ensure_camera_ubo()))
    hit1, hit2 = tri1 >= 0, tri2 >= 0
    both = hit1 & hit2
    rel = np.abs(t1 - t2) / np.maximum(np.abs(t2), 1e-30)
    t_agree = rel <= 1e-6
    tri_diff = both & (tri1 != tri2)
    ties = tri_diff & t_agree
    hit_mismatch = int((hit1 != hit2).sum())
    rays = {"rays": int(len(t1)), "hits": int(both.sum()),
            "hit_mismatch": hit_mismatch,
            "tri_differs": int(tri_diff.sum()), "tri_differs_at_tie":
            int(ties.sum()),
            "t_outside_1e-6_rel": int((both & ~t_agree).sum()),
            "max_rel_t_diff": float(rel[both].max()) if both.any() else 0.0}
    log(f"[oracle] rays intersect_bvh vs intersect_brute (every "
        f"{sizes.ray_stride}th primary ray at {sizes.width}x{sizes.height}): "
        f"{rays['rays']} rays, {rays['hits']} hits, hit/miss mismatches "
        f"{hit_mismatch}, tri differs {rays['tri_differs']} (at t ties "
        f"{rays['tri_differs_at_tie']}), t beyond 1e-6 rel "
        f"{rays['t_outside_1e-6_rel']}, max rel t diff "
        f"{rays['max_rel_t_diff']:.3e}")
    report["oracle"] = {"image": img, "rays": rays}
    if frac_bad > ORACLE_OUTLIER_FRAC:
        raise AssertionError("bvh vs brute images differ beyond tolerance")
    edge = hit_mismatch + rays["tri_differs"] - rays["tri_differs_at_tie"]
    if edge > ORACLE_OUTLIER_FRAC * rays["rays"]:
        raise AssertionError("intersect_bvh disagrees with intersect_brute")
    if rays["t_outside_1e-6_rel"] > ORACLE_OUTLIER_FRAC * rays["rays"]:
        raise AssertionError("hit distances differ beyond 1e-6 relative")


def phase_cpu(report: dict, sizes: Sizes = FULL) -> None:
    scene = create_benchmark_atrium(sizes.tris)
    cfg = RenderConfig(width=sizes.cpu_width, height=sizes.cpu_height,
                       max_depth=3)
    imgs = {}
    for name, dev in (("card", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            r = ProgressiveRenderer(
                scene, atrium_camera(cfg.width, cfg.height), cfg)
            imgs[name] = r.render(1)
    diff = np.abs(imgs["card"] - imgs["cpu"])
    within = np.all(diff <= ORACLE_TOL + ORACLE_TOL * np.abs(imgs["cpu"]),
                    axis=-1)
    out = {"fraction_within_1e-3": float(within.mean()),
           "mean_abs_diff": float(diff.mean()),
           "max_abs_diff": float(diff.max())}
    report["card_vs_cpu"] = out
    log(f"[cpu] {cfg.width}x{cfg.height} frame, card vs CPU: fraction of "
        f"pixels within 1e-3 {out['fraction_within_1e-3']:.6f} (gate >= "
        f"{CPU_MIN_FRAC_WITHIN}), mean |diff| {out['mean_abs_diff']:.3e} "
        f"(gate <= {CPU_MAX_MEAN_ABS:.0e}), max |diff| "
        f"{out['max_abs_diff']:.3e}")
    if (out["fraction_within_1e-3"] < CPU_MIN_FRAC_WITHIN
            or out["mean_abs_diff"] > CPU_MAX_MEAN_ABS):
        raise AssertionError("card and CPU images differ beyond tolerance")


def _finite(name: str, arr, report: dict) -> None:
    arr = np.asarray(arr)
    ok = bool(np.isfinite(arr).all())
    report[name] = {"shape": list(arr.shape), "finite": ok,
                    "mean": float(np.nanmean(arr))}
    log(f"[features] {name}: shape {arr.shape}, finite {ok}, mean "
        f"{report[name]['mean']:.6f}")
    if not ok:
        raise AssertionError(f"{name} produced non-finite values")


def phase_features(report: dict, sizes: Sizes = FULL,
                   out_dir: str = "") -> None:
    scene = create_benchmark_atrium(sizes.tris)
    base = RenderConfig(width=sizes.feature_width,
                        height=sizes.feature_height, max_depth=3)
    cam = atrium_camera(base.width, base.height)
    out = {}
    for name, kw in (("restir", {"use_restir": True}),
                     ("adaptive", {"adaptive_tol": 0.05}),
                     ("spp_batch4", {"spp_batch": 4})):
        r = ProgressiveRenderer(scene, cam, base.replace(**kw))
        r.step()
        _finite(name, r.image(), out)
    r = ProgressiveRenderer(scene, cam, base)
    r.step()
    _finite("preview_scale4_denoised",
            r.preview_image(scale=4, denoise=True), out)
    aov = r.aovs()
    for k in ("normal", "depth", "albedo"):
        _finite(f"aov_{k}", aov[k], out)
    path = os.path.join(out_dir or REPO, "chip_smoke_checkpoint.npz")
    r.save_checkpoint(path)
    r2 = ProgressiveRenderer(scene, cam, base)
    r2.load_checkpoint(path)
    os.remove(path)
    same = bool(np.array_equal(r2.image(), r.image()))
    log(f"[features] checkpoint save/load: frame {r2.frame}, image equal "
        f"{same}")
    out["checkpoint_roundtrip_equal"] = same
    report["features"] = out
    if not same or r2.frame != r.frame:
        raise AssertionError("checkpoint round trip changed the render")


def phase_cli(report: dict, sizes: Sizes = FULL, out_dir: str = "") -> None:
    from raytracer_tpu import cli
    from raytracer_tpu.utils.image import read_png

    out = os.path.join(out_dir or REPO, "chip_smoke_cornell.png")
    t0 = time.perf_counter()
    rc = cli.main([CORNELL_JSON, "--width", str(sizes.cli_width),
                   "--height", str(sizes.cli_height), "--spp",
                   str(sizes.cli_spp), "--out", out])
    dt = time.perf_counter() - t0
    img = read_png(out)
    report["cli"] = {"rc": rc, "seconds": dt, "png": out,
                     "shape": list(img.shape), "mean": float(img.mean())}
    log(f"[cli] rc {rc}, {dt:.3f} s, wrote {out} {img.shape}, mean u8 "
        f"{img.mean():.3f}")
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    if img.shape != (sizes.cli_height, sizes.cli_width, 3):
        raise AssertionError(f"PNG has shape {img.shape}")
    if not img.max() > 0:
        raise AssertionError("CLI PNG is black")


def phase_mesh(report: dict, sizes: Sizes = FULL, n_cards: int = 4) -> None:
    from raytracer_tpu.parallel.sharding import make_pixel_mesh

    devices = jax.devices()[:n_cards]
    if len(devices) < n_cards:
        raise RuntimeError(f"need {n_cards} devices, found {len(devices)}")
    scene = create_benchmark_atrium(sizes.tris)
    cfg = RenderConfig(width=sizes.width, height=sizes.height, max_depth=3)
    cam = atrium_camera(cfg.width, cfg.height)
    out = {}
    for name, c, steps in (("path_tracing", cfg, sizes.mesh_steps),
                           ("restir", cfg.replace(use_restir=True), 1)):
        mesh_r = ProgressiveRenderer(scene, cam, c,
                                     mesh=make_pixel_mesh(devices))
        t0 = time.perf_counter()
        got = mesh_r.render(steps)
        t_mesh = time.perf_counter() - t0
        with jax.default_device(devices[0]):
            single = ProgressiveRenderer(scene, cam, c)
            t0 = time.perf_counter()
            ref = single.render(steps)
            t_single = time.perf_counter() - t0
        d = float(np.abs(got - ref).max())
        excess = float((np.abs(got - ref) - MESH_TOL * np.abs(ref)).max())
        out[name] = {"steps": steps, "max_abs_diff": d,
                     "max_diff_beyond_rtol": excess,
                     "mesh_s_incl_compile": t_mesh,
                     "single_s_incl_compile": t_single,
                     "finite": bool(np.isfinite(got).all())}
        log(f"[mesh] {name}: {n_cards} cards vs 1, {cfg.width}x{cfg.height},"
            f" {steps} step(s): max |diff| {d:.3e}, max |diff| - "
            f"{MESH_TOL:.0e}*|ref| {excess:.3e} (gate <= {MESH_TOL:.0e}); "
            f"wall incl. compile {t_mesh:.3f} s on {n_cards} vs "
            f"{t_single:.3f} s on 1")
        if not out[name]["finite"] or excess > MESH_TOL:
            raise AssertionError(f"{name}: mesh render differs from one "
                                 f"device")
    report["mesh"] = out


def result_line(devices) -> str:
    """The contract's last line: only these keys."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def select_phases(cards: int):
    """Phase names to run: --cards 4 runs the mesh path and nothing else."""
    if cards == 1:
        return ["device", "main_path", "oracle", "cpu", "features", "cli"]
    return ["device", "mesh"]


def run(phases, sizes: Sizes, out_dir: str, cards: int) -> dict:
    """Run the phases in order; returns the report with each phase's
    status. A failed phase is recorded and the next one still runs."""
    fns = {
        "device": lambda rep: phase_device(rep),
        "main_path": lambda rep: phase_main_path(rep, sizes),
        "oracle": lambda rep: phase_oracle(rep, sizes),
        "cpu": lambda rep: phase_cpu(rep, sizes),
        "features": lambda rep: phase_features(rep, sizes, out_dir),
        "cli": lambda rep: phase_cli(rep, sizes, out_dir),
        "mesh": lambda rep: phase_mesh(rep, sizes, cards),
    }
    os.makedirs(out_dir, exist_ok=True)
    report = {"phases": {}}
    for name in phases:
        t0 = time.perf_counter()
        try:
            fns[name](report)
            status = "ok"
        except Exception:  # noqa: BLE001 — reported, and fails the run
            status = "failed"
            traceback.print_exc()
        dt = time.perf_counter() - t0
        report["phases"][name] = {"status": status, "seconds": dt}
        log(f"[{name}] {status} in {dt:.3f} s")
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4: run only the 4-card mesh path and its "
                        "one-card comparison")
    p.add_argument("--out-dir", default=os.path.join(REPO, "chiprun_out"))
    args = p.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r}); nothing was run",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    report = run(select_phases(args.cards), FULL, args.out_dir, args.cards)
    report["total_s"] = time.perf_counter() - t0
    with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    failed = [k for k, v in report["phases"].items() if v["status"] != "ok"]
    log(f"[summary] {len(report['phases'])} phases in "
        f"{report['total_s']:.3f} s; failed: {failed or 'none'}")
    if "nvidia_smi" in report:
        log(report["nvidia_smi"])
    if failed:
        return 1
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
