"""Timed interactive editing session — the reference's editor workflow,
headless, with per-edit latency asserts.

The reference's UX is its ImGui editor loop (src/raytracer/ui.odin:262-484):
drag the camera, drag an object transform, repaint a material, watch the
progressive render restart live. This drives the SAME edit pipeline through
the public API and *measures* every edit-to-visible-frame latency:

  - camera move        -> dirty-camera accumulation reset
  - transform drag     -> BVH refit (TLAS UPDATE parity) + re-upload
  - material repaint   -> material-table fast path
  - light dim/brighten -> material fast path incl. packed light tables
  - object add         -> full re-bake into capacity-padded tables
                          (stable_bake, the default): identical jit
                          signature, so the edit costs bake+upload, not an
                          XLA re-compile (the reference also rebuilds its
                          AS on add, gpu_scene.odin:430-455); the bake runs
                          on a background thread (prebake_async) so it
                          overlaps the in-flight frame

What "visible frame" means depends on the resolution, exactly like a real
editor:

  - at preview resolutions (default 512x288) the editor displays the
    accumulating render itself: the gate times edit -> full step + readback
  - at 1080p (--1080p) the editor interacts against the denoised scaled
    preview (preview_image(scale=4, denoise=True, upscale=False) — native
    1/scale resolution, because the full-res f32 readback alone costs
    ~600 ms of transfer; the UI toolkit scales the image up for display)
    and full-resolution accumulation resumes between edits. The gate times
    edit -> preview-on-host; the full-res resume cost is printed too.

Pass --assert-interactive to enforce the <1 s per-edit gate (meant for a
run on the GPU; CPU times say nothing about it).

Run from the repo root:  python examples/interactive_session.py [--1080p]
"""

import dataclasses
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from raytracer_tpu.api import ProgressiveRenderer
from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.scene.model import (
    Material,
    create_cornell_box,
    create_sphere,
)
from raytracer_tpu.utils.compile_cache import enable_persistent_cache
from raytracer_tpu.utils.config import RenderConfig
from raytracer_tpu.utils.stats import RenderStats


def main():
    enable_persistent_cache()
    hi = "--1080p" in sys.argv
    w, h = (1920, 1080) if hi else (512, 288)
    gate = "--assert-interactive" in sys.argv
    pscale = 4
    if "--preview-scale" in sys.argv:
        pscale = int(sys.argv[sys.argv.index("--preview-scale") + 1])
    # The 1080p editor loop is served from the scaled preview (see module
    # docstring); at 512x288 the full accumulating frame IS the display.
    preview_loop = hi
    scene = create_cornell_box()
    cfg = RenderConfig(width=w, height=h)
    t0 = time.perf_counter()
    r = ProgressiveRenderer(scene, None, cfg)
    stats = RenderStats()
    stats.set_scene_counts(scene)
    print(f"startup (bake): {time.perf_counter()-t0:.2f}s", flush=True)

    def frame():
        stats.frame_begin()
        r.step()
        np.asarray(r.accum[:1])  # force (preview readback surrogate)
        stats.frame_end()

    def visible():
        """The editor's visible next frame after an edit."""
        if preview_loop:
            r.preview_image(scale=pscale, denoise=True, upscale=False)
        else:
            frame()

    # Warm: first frame compiles (persistent cache -> seconds when warm).
    t0 = time.perf_counter()
    frame()
    print(f"first frame (compile or cache hit): "
          f"{time.perf_counter()-t0:.2f}s", flush=True)
    for _ in range(4):
        frame()
    if preview_loop:
        visible()  # warm the preview trace/denoise programs

    # Warm each edit PATH once: the first edit of a kind compiles its small
    # device-update program (seconds, cached across sessions by the
    # persistent compile cache); a drag's steady-state tick is the
    # interactive metric, so the timed round below measures the warm path.
    r.set_camera(Camera.create(position=(0.0, 0.05, -2.9), aspect=w / h))
    visible()
    frame()
    scene.update_object_position(
        0, tuple(np.asarray(scene.objects[0].transform.position)))
    visible()
    frame()
    m0 = scene.materials[0]
    scene.update_material(0, dataclasses.replace(m0))
    visible()
    frame()
    # Warm the topology-edit path too (first add pays the one-time
    # device_put/transfer program for the re-bake path; under stable_bake
    # the render jit itself cache-hits): add-and-frame once untimed.
    warm_mesh = scene.add_mesh(create_sphere(4, 4))
    warm_obj = scene.add_object("warmup", warm_mesh, 0,
                                position=(0.0, 0.4, 0.3),
                                scale=(0.05, 0.05, 0.05))
    visible()
    frame()
    scene.delete_object(warm_obj)
    visible()
    frame()
    # Fresh stats for the timed session (the compile frame would otherwise
    # dominate the table's ms/frame).
    stats = RenderStats()
    stats.set_scene_counts(scene)

    latencies = {}
    resume_latencies = {}

    def edit(tag, fn, expect_reset=True, prebake=False):
        before = r.frame
        t0 = time.perf_counter()
        fn()
        if prebake:
            # Topology edits: bake on a background thread; the visible
            # frame below joins it inside begin_frame (api.prebake_async).
            r.prebake_async()
        visible()
        dt = time.perf_counter() - t0
        latencies[tag] = dt
        if preview_loop:
            # Full-resolution accumulation resumes after the interaction
            # (untimed for the gate; recorded for honesty).
            t1 = time.perf_counter()
            frame()
            resume_latencies[tag] = time.perf_counter() - t1
        if expect_reset:
            assert r.frame <= before, (
                f"{tag}: edit must reset accumulation (frame {before} -> "
                f"{r.frame})"
            )
        extra = (f"  (+{resume_latencies[tag]*1e3:7.1f} ms full-res resume)"
                 if preview_loop else "")
        print(f"edit [{tag:16s}]: {dt*1e3:7.1f} ms to visible frame{extra}",
              flush=True)

    # 1. camera move (ui.odin camera controller drag)
    edit("camera_move", lambda: r.set_camera(Camera.create(
        position=(0.25, 0.1, -2.8), aspect=w / h)))

    # 2. transform drag (refit path)
    obj_idx = 0
    tr = scene.objects[obj_idx].transform
    def drag():
        scene.update_object_position(
            obj_idx, tuple(np.asarray(tr.position) + [0.05, 0.0, 0.0]))
    edit("transform_drag", drag)

    # 3. material repaint
    mat_idx = scene.objects[obj_idx].material_index
    def repaint():
        m = scene.materials[mat_idx]
        scene.update_material(
            mat_idx, dataclasses.replace(m, albedo=(0.85, 0.15, 0.1)))
    edit("material_paint", repaint)

    # 4. light brighten (packed light-table refresh path)
    li = next(i for i, m in enumerate(scene.materials)
              if m.emission_power > 0)
    def brighten():
        m = scene.materials[li]
        scene.update_material(
            li, dataclasses.replace(m, emission_power=m.emission_power * 2))
    edit("light_brighten", brighten)

    # 5. object add — under stable_bake (capacity-padded tables, the
    # default) the re-bake lands in the SAME jit signature, so this is
    # bake+upload, not an XLA re-compile, and joins the 1 s gate. The bake
    # itself runs on a background thread (prebake=True).
    def add_obj():
        mesh_idx = scene.add_mesh(create_sphere(6, 6))
        mat = scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
        scene.add_object("added_sphere", mesh_idx, mat,
                         position=(0.0, -0.3, 0.2),
                         scale=(0.25, 0.25, 0.25))
    edit("object_add", add_obj, prebake=True)

    # settle: accumulate a few frames post-edit
    for _ in range(5):
        frame()
    print(stats.format_table(), flush=True)

    # Denoised preview (integrator/denoise.py): the editor-facing readback.
    # First call pays the G-buffer pass + filter compile; the warm call is
    # the interactive cost.
    r.image(denoise=True)
    t0 = time.perf_counter()
    r.image(denoise=True)
    print(f"denoised full-image readback (warm): "
          f"{(time.perf_counter()-t0)*1e3:7.1f} ms", flush=True)

    # Scaled preview cadence (api.preview_image): trace at 1/scale
    # resolution, denoise. With --1080p the native-resolution variant
    # (upscale=False) is THE editor-loop cadence — the full-res f32
    # transfer dominates the upscaled variant.
    for up in ((True, False) if preview_loop else (True,)):
        r.preview_image(scale=pscale, denoise=True, upscale=up)
        pt = []
        for _ in range(5):
            t0 = time.perf_counter()
            r.preview_image(scale=pscale, denoise=True, upscale=up)
            pt.append(time.perf_counter() - t0)
        kind = ("upscaled to full res" if up
                else f"native {w//pscale}x{h//pscale}")
        print(f"preview_image(scale={pscale}, denoised, {kind}) cadence: "
              f"{1e3 * min(pt):.1f} ms best / "
              f"{1e3 * float(np.median(pt)):.1f} ms median "
              f"({1.0 / float(np.median(pt)):.1f} fps)", flush=True)

    worst = max(latencies.values())
    print(f"worst edit latency (object_add included): {worst*1e3:.1f} ms "
          f"(object_add: {latencies['object_add']*1e3:.1f} ms)", flush=True)
    if resume_latencies:
        worst_resume = max(resume_latencies.values())
        print(f"worst full-res resume after edit: {worst_resume*1e3:.1f} ms",
              flush=True)
    if gate:
        assert worst < 1.0, (
            f"edit latency {worst:.2f}s breaches the 1 s gate"
        )
        print("PASS: all edits (incl. object add) under 1 s", flush=True)


if __name__ == "__main__":
    main()
