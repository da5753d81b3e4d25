"""Prewarm the persistent XLA compile cache — the reference's ahead-of-time
shader compile.

The reference renders instantly at launch because its build compiled the
GLSL to SPIR-V ahead of time (build.py:59-75); here the first run of a
(resolution, feature-flag) signature pays the XLA compile instead, and
cache keys change when the sources do. Run this once after install (or
after editing raytracer_tpu sources): it drives ONE tiny frame through each
standard program signature via the normal jit dispatch path — an explicit
lower().compile() would use AOT compile options whose cache key differs
from jit dispatch and would NOT warm it — so later processes load the
compiled programs instead of compiling them. The cache directory is the one
utils/compile_cache.py picks (JAX_COMPILATION_CACHE_DIR, else
<repo>/.jax_cache).

Usage (from the repository root):
    python tools/prewarm_cache.py [--sizes 1920x1080,512x288] [--fast]

--fast warms only the plain progressive step (the CLI default path).
Signatures warmed per size: plain, ReSTIR DI, adaptive sampling, denoised
preview (G-buffer + a-trous + upscale).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_SIZES = "1920x1080,512x288"


def parse_sizes(spec):
    out = []
    for tok in spec.split(","):
        w, h = tok.lower().split("x")
        out.append((int(w), int(h)))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sizes = DEFAULT_SIZES
    if "--sizes" in argv:
        sizes = argv[argv.index("--sizes") + 1]
    fast = "--fast" in argv

    from raytracer_tpu.api import ProgressiveRenderer
    from raytracer_tpu.scene.model import create_cornell_box
    from raytracer_tpu.utils.compile_cache import enable_persistent_cache
    from raytracer_tpu.utils.config import RenderConfig

    cache_dir = enable_persistent_cache()
    print(f"prewarming {cache_dir}", flush=True)
    scene = create_cornell_box()
    total0 = time.perf_counter()
    for w, h in parse_sizes(sizes):
        variants = [("plain", {})]
        if not fast:
            variants += [
                ("restir", {"use_restir": True}),
                ("adaptive", {"adaptive_tol": 0.05}),
            ]
        for name, kw in variants:
            t0 = time.perf_counter()
            r = ProgressiveRenderer(
                scene, None, RenderConfig(width=w, height=h, **kw)
            )
            r.step()
            r.image()
            if not fast and name == "plain":
                # Denoiser (G-buffer + filter) and the scaled preview
                # (filter at w//4 x h//4 + bilinear upscale).
                r.image(denoise=True)
                if (w // 4) > 4 and (h // 4) > 4:
                    r.preview_image(scale=4, denoise=True)
            print(f"  {w}x{h} {name}: {time.perf_counter() - t0:.1f}s",
                  flush=True)
    print(f"prewarm done in {time.perf_counter() - total0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
