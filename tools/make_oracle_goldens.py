"""Generate INDEPENDENT oracle goldens for the BASELINE configs.

Renders each config at 64x64 with accel="brute" — the dense O(N*T)
Moller-Trumbore intersector, a code path sharing nothing with the
BVH builder or the traversal walk — at high spp, and commits the converged
images under golden/oracle/. The golden gate (tests/test_oracle.py) then
validates the FAST path against these, turning the SSIM gate from
"reproducible" into "correct" (the reference's own validation is SSIM
against another renderer's output, its ssim_compare.py:6-21).

The Cornell config reads the in-repo examples/scenes/cornell_box.json; the
other configs read the reference checkout's scene files and run only when
the REFERENCE_DIR environment variable points at that checkout.

--fullres generates the BASELINE-config-resolution matched goldens instead
(the 64x64 gates pass low-frequency shading bugs and tree artifacts that
only manifest at scale): cornell at 256x256 (BASELINE config 1's
resolution) and cornell_pbr at 512x512 (config 2's). Matched-spp comparison
keeps low spp honest — the gate render consumes IDENTICAL RNG streams (pure
functions of pixel/frame), so both images carry the same noise and SSIM
differences come only from intersection disagreements.

Usage (from the repository root):
    python tools/make_oracle_goldens.py [--fullres]
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CORNELL_JSON = os.path.join(REPO, "examples", "scenes", "cornell_box.json")
REFERENCE_DIR = os.environ.get("REFERENCE_DIR")

SPP = 1024
GATE_SPP = 256  # matched-spp oracle: same deterministic RNG streams as the
# gate render (streams are pure functions of pixel/frame), so a correct fast
# path reproduces it almost exactly — intersection code is the only diff.
SIZE = 64
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "golden", "oracle")

# (name, scene, camera, size, [spp...]) for --fullres; the gate tests
# (tests/test_oracle.py) use the LOW spp (matched streams keep low spp
# just as strict, and a CPU pays minutes per fast-path frame at 256^2).
FULLRES = [
    ("cornell_256", CORNELL_JSON, None, 256, (4, 32)),
    ("cornell_pbr_512",
     (os.path.join(REFERENCE_DIR, "scenes", "cornell_pbr.glb")
      if REFERENCE_DIR else None),
     "pbr_cam", 512, (2, 16)),
]


def configs():
    from raytracer_tpu.ops.camera import Camera
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.utils.config import RenderConfig

    base = dict(width=SIZE, height=SIZE, accel="brute")
    yield (
        "cornell",
        load_scene(CORNELL_JSON),
        Camera.create(position=(0, 0, -3), aspect=1.0),
        RenderConfig(**base),
    )
    if not REFERENCE_DIR:
        return
    yield (
        "cornell_pbr",
        load_scene(os.path.join(REFERENCE_DIR, "scenes", "cornell_pbr.glb")),
        Camera.create(position=(0, 1.0, 3.2), aspect=1.0, target=(0, 1.0, 0)),
        RenderConfig(**base),
    )
    yield (
        # The glass-sphere cluster sits sub-unit-scale at the origin of a
        # 136-unit sky-lit plane; the camera frames it close-up.
        "dispersion",
        load_scene(os.path.join(REFERENCE_DIR, "scenes",
                                "multi-dispersion.gltf")),
        Camera.create(position=(0.32, 0.28, -0.65), aspect=1.0,
                      target=(-0.08, 0.07, -0.12)),
        RenderConfig(max_depth=8, rr_start_depth=3, **base),
    )
    yield (
        # Interior view along the room's long axis (z is up in this asset).
        "conference",
        load_scene(os.path.join(REFERENCE_DIR, "models", "conference.glb")),
        Camera.create(position=(-3.6, -1.6, 1.5), aspect=1.0,
                      target=(3.0, 1.5, 1.0)),
        RenderConfig(**base),
    )


def main_fullres():
    from raytracer_tpu.api import ProgressiveRenderer
    from raytracer_tpu.ops.camera import Camera
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.utils.config import RenderConfig

    os.makedirs(OUT_DIR, exist_ok=True)
    for name, path, cam_kind, size, spps in FULLRES:
        if path is None:
            continue
        cam = None
        if cam_kind == "pbr_cam":
            cam = Camera.create(position=(0, 1.0, 3.2), aspect=1.0,
                                target=(0, 1.0, 0))
        cfg = RenderConfig(width=size, height=size, accel="brute")
        targets = sorted(spps)
        missing = [s for s in targets if not os.path.exists(
            os.path.join(OUT_DIR, f"{name}_{s}spp_f32.npy"))]
        if not missing:
            print(f"{name}: all goldens present", flush=True)
            continue
        t0 = time.perf_counter()
        r = ProgressiveRenderer(load_scene(path), cam, cfg)
        done = 0
        for spp in targets:
            if spp > max(missing):
                break
            img = r.render(spp - done)  # accumulation continues: frame
            done = spp                  # streams stay matched per spp
            if spp not in missing:
                continue
            np.save(os.path.join(OUT_DIR, f"{name}_{spp}spp_f32.npy"),
                    np.asarray(img, np.float32))
            print(f"{name}: {size}x{size} {spp} spp brute at "
                  f"{time.perf_counter() - t0:.0f}s, mean {img.mean():.4f}",
                  flush=True)


def main():
    from raytracer_tpu.api import ProgressiveRenderer
    from raytracer_tpu.utils.image import tonemap, write_png

    os.makedirs(OUT_DIR, exist_ok=True)
    for name, scene, cam, cfg in configs():
        t0 = time.perf_counter()
        r = ProgressiveRenderer(scene, cam, cfg)
        gate_img = r.render(GATE_SPP)
        np.save(os.path.join(OUT_DIR, f"{name}_{GATE_SPP}spp_f32.npy"),
                np.asarray(gate_img, np.float32))
        img = r.render(SPP - GATE_SPP)  # continue accumulating to converged
        dt = time.perf_counter() - t0
        np.save(os.path.join(OUT_DIR, f"{name}_f32.npy"),
                np.asarray(img, np.float32))
        write_png(os.path.join(OUT_DIR, f"{name}.png"), tonemap(img))
        print(f"{name}: {SPP} spp in {dt:.0f}s, mean {img.mean():.4f}",
              flush=True)


if __name__ == "__main__":
    if "--fullres" in sys.argv:
        main_fullres()
    else:
        main()
