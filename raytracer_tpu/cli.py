"""Command-line renderer — the headless analog of `src/main.odin`.

Usage:
  python -m raytracer_tpu.cli <scene_file> [--width W] [--height H]
      [--spp N] [--out image.png] [--camera X Y Z] [--target X Y Z] ...

The reference CLI is `pathtracer <scene_file> [-f|--fullscreen]`
(src/main.odin:28-46) with a live window; headless rendering replaces the
swapchain with a PNG dump and `--spp` replaces "wait for accumulation".
"""

from __future__ import annotations

import argparse
import logging
import time

from raytracer_tpu.api import ProgressiveRenderer
from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.scene.loaders import load_scene
from raytracer_tpu.utils.config import RenderConfig
from raytracer_tpu.utils.image import write_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene", help="scene file (.json, .gltf, .glb)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=1020)
    p.add_argument("--spp", type=int, default=64,
                   help="progressive frames to accumulate")
    p.add_argument("--out", default="render.png")
    p.add_argument("--camera", type=float, nargs=3, default=(0.0, 0.0, -3.0),
                   metavar=("X", "Y", "Z"))
    p.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("X", "Y", "Z"))
    p.add_argument("--max-depth", type=int, default=3)
    p.add_argument("--background", type=float, nargs=3,
                   default=(0.53, 0.81, 0.92))
    p.add_argument("--accel", choices=("auto", "bvh", "brute"),
                   default="auto")
    p.add_argument("--no-transmission", action="store_true")
    p.add_argument("--light-sampling-only", action="store_true",
                   help="direct light via NEE only (USE_LIGHT_SAMPLING_ONLY,"
                        " simple.rchit:10)")
    p.add_argument("--restir", action="store_true",
                   help="use ReSTIR DI for direct lighting")
    p.add_argument("--adaptive", type=float, default=0.0, metavar="TOL",
                   help="adaptive sampling: a pixel stops once the relative "
                        "standard error of its mean luminance drops under "
                        "TOL (0 = off). Retired pixels save their traversal "
                        "cost, not the frame's fixed floor — meant for long "
                        "converging renders of traversal-heavy scenes")
    p.add_argument("--denoise", action="store_true",
                   help="edge-aware a-trous denoise of the output (and "
                        "previews); accumulation itself is untouched")
    p.add_argument("--checkpoint", default=None,
                   help="save/resume accumulation state at this .npz path")
    p.add_argument("--preview", type=int, default=0, metavar="N",
                   help="live preview: rewrite --out (plus a stats table) "
                        "every N frames while accumulating — the headless "
                        "analog of the reference's live viewport "
                        "(ui.odin:491-571)")
    p.add_argument("--aovs", default=None, metavar="PREFIX",
                   help="also write AOV images from one coherent primary "
                        "trace: PREFIX_albedo/_normal/_depth.png (normal "
                        "encoded n*0.5+0.5; depth normalized to the scene "
                        "range) — for compositing or external denoisers")
    p.add_argument("--preview-scale", type=int, default=1, metavar="K",
                   help="with --preview: write previews from a fresh 1/K-"
                        "resolution sample (denoised per --denoise, "
                        "bilinearly upscaled to the output size) instead of "
                        "reading back the full accumulation — a 1080p edit "
                        "loop at K=4 traces 1/16 of the rays per preview")
    p.add_argument("--spp-batch", type=int, default=1, metavar="S",
                   help="render S progressive samples per launch (one "
                        "wavefront of S x pixels lanes). Restores the "
                        "wavefront width a small per-device tile loses on "
                        "a mesh; latency per step rises ~S-fold. --spp "
                        "must divide by S")
    p.add_argument("--stats-every", type=int, default=0, metavar="N",
                   help="print the stats table every N frames (the ImGui "
                        "Performance-window analog)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.restir and args.adaptive > 0:
        parser.error("--restir and --adaptive are mutually exclusive "
                     "(ReSTIR carries its own temporal state)")
    if args.spp_batch > 1:
        if args.restir or args.adaptive > 0:
            parser.error("--spp-batch requires the plain progressive path "
                         "(no --restir / --adaptive)")
        if args.spp % args.spp_batch != 0:
            parser.error("--spp must be a multiple of --spp-batch")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("raytracer_tpu.cli")

    from raytracer_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    scene = load_scene(args.scene)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        max_depth=args.max_depth,
        background=tuple(args.background),
        accel=args.accel,
        enable_transmission=not args.no_transmission,
        use_light_sampling_only=args.light_sampling_only,
        use_restir=args.restir,
        adaptive_tol=args.adaptive,
        denoise_preview=args.denoise,
        spp_batch=args.spp_batch,
    )
    camera = Camera.create(
        position=tuple(args.camera),
        aspect=cfg.width / cfg.height,
        target=tuple(args.target),
    )
    renderer = ProgressiveRenderer(scene, camera, cfg)
    if args.checkpoint:
        import os

        if os.path.exists(args.checkpoint):
            renderer.load_checkpoint(args.checkpoint)
            log.info("resumed at frame %d", renderer.frame)

    from raytracer_tpu.utils.stats import RenderStats

    stats = RenderStats()
    stats.set_scene_counts(scene)
    start = time.perf_counter()
    first_launch = True
    while renderer.frame < args.spp:
        stats.frame_begin()
        if not renderer.step():
            break
        stats.frame_end()
        i = renderer.frame - 1  # samples accumulated, 0-based last sample
        if args.verbose or (i + 1) % 16 == 0 or first_launch:
            elapsed = time.perf_counter() - start
            log.info("frame %d/%d (%.2f s)", i + 1, args.spp, elapsed)
        first_launch = False
        if args.stats_every and (i + 1) % args.stats_every == 0:
            print(stats.format_table())
        if args.preview and (i + 1) % args.preview == 0:
            if args.preview_scale > 1:
                write_image(args.out,
                            renderer.preview_image(args.preview_scale))
            else:
                write_image(args.out, renderer.image())
            print(stats.format_table())
            log.info("preview updated: %s (%d spp)", args.out,
                     renderer.frame)
        if args.adaptive > 0 and (i + 1) % 8 == 0:
            frac = renderer.adaptive_converged_fraction()
            if frac >= 0.999:
                log.info("adaptive: %.1f%% of pixels converged — stopping "
                         "at %d/%d frames", frac * 100, i + 1, args.spp)
                break
    elapsed = time.perf_counter() - start

    write_image(args.out, renderer.image())
    if args.aovs:
        import numpy as np

        from raytracer_tpu.integrator.denoise import MISS_DEPTH

        aov = renderer.aovs()
        write_image(f"{args.aovs}_albedo.png", aov["albedo"])
        write_image(f"{args.aovs}_normal.png", aov["normal"] * 0.5 + 0.5)
        d = aov["depth"]
        hit = d < MISS_DEPTH
        dmax = float(d[hit].max()) if hit.any() else 1.0
        depth_img = np.where(hit, d / max(dmax, 1e-6), 1.0)
        write_image(f"{args.aovs}_depth.png",
                    np.repeat(depth_img[..., None], 3, axis=-1))
        log.info("wrote AOVs: %s_{albedo,normal,depth}.png", args.aovs)
    log.info(
        "wrote %s: %d spp in %.2f s (%.2f spp/s, %d triangles)",
        args.out, renderer.frame, elapsed,
        renderer.frame / max(elapsed, 1e-9), scene.num_triangles,
    )
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
