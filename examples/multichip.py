"""Multi-device rendering demo: pixel-tile data parallelism over a device
mesh, with and without ReSTIR DI.

The reference is strictly single-GPU (SURVEY.md §2.7); here the scene
pytree is replicated, the accumulation buffer (and the ReSTIR reservoir)
shard over a 1-D "pixels" mesh, and the only in-loop collective is ReSTIR's
spatial-reuse halo ppermute. Sharded images match single-device ones
(global seeds/camera indices).

Run from the repo root on a machine with two or more devices:

  python examples/multichip.py

It uses every device JAX finds. To try it without accelerators, give the
CPU backend virtual devices:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python examples/multichip.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from raytracer_tpu.api import ProgressiveRenderer  # noqa: E402
from raytracer_tpu.parallel.sharding import make_pixel_mesh  # noqa: E402
from raytracer_tpu.scene.model import create_cornell_box  # noqa: E402
from raytracer_tpu.utils.config import RenderConfig  # noqa: E402
from raytracer_tpu.utils.image import write_image  # noqa: E402


def main():
    devices = jax.devices()
    if len(devices) < 2:
        sys.exit(f"need >= 2 devices, found {len(devices)} "
                 f"({devices[0].platform})")
    n_dev = len(devices)
    frames = 4

    cfg = RenderConfig(width=64, height=64 * n_dev)
    mesh = make_pixel_mesh(devices)
    img = ProgressiveRenderer(create_cornell_box(), None, cfg,
                              mesh=mesh).render(frames)
    ref = ProgressiveRenderer(create_cornell_box(), None, cfg).render(frames)
    print(f"path tracing on {n_dev} devices: max |sharded - single| = "
          f"{np.abs(img - ref).max():.2e}")
    write_image("multichip.png", img)

    # ReSTIR DI sharded: the reservoir tiles with the pixels; radius 2 keeps
    # the halo exact at this tile height (see restir_direct docs).
    cfg_r = cfg.replace(use_restir=True, restir_spatial_radius=2.0,
                        restir_spatial_neighbors=2)
    img_r = ProgressiveRenderer(create_cornell_box(), None, cfg_r,
                                mesh=mesh).render(frames)
    ref_r = ProgressiveRenderer(create_cornell_box(), None, cfg_r).render(
        frames)
    print(f"ReSTIR DI on {n_dev} devices:     max |sharded - single| = "
          f"{np.abs(img_r - ref_r).max():.2e}")
    write_image("multichip_restir.png", img_r)


if __name__ == "__main__":
    main()
