"""Multi-chip rendering: pixel-tile data parallelism over a device mesh.

The reference's only parallelism is per-pixel SPMD within one GPU
(`vkCmdTraceRaysKHR(width, height, 1)`, command_buffer.odin:261-273); it has
no multi-device code at all (SURVEY.md §2.7). The scaling story here:

  - 1-D `jax.sharding.Mesh` over all devices, axis "pixels".
  - The accumulation buffer f32[N,3] is sharded on its pixel dim; the scene
    pytree is fully replicated (scenes are small; rays are embarrassingly
    parallel, so this is pure DP — no TP/PP/EP analog exists or is invented).
  - `shard_map` gives each chip a contiguous pixel tile; per-tile pixel
    offsets keep seeds/camera rays GLOBAL, so the sharded image is
    bit-identical to the single-chip one.
  - There are NO collectives in the hot loop: tiles are disjoint, the scene
    is read-only. The only cross-chip traffic is the final tile gather when
    the host assembles the image (jax.device_get on the sharded array
    rides the device interconnect via XLA's gather), exactly as SURVEY.md
    §2.7 prescribes.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytracer_tpu.integrator.wavefront import accumulate, render_wavefront
from raytracer_tpu.utils.config import RenderConfig

AXIS = "pixels"


def make_pixel_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (AXIS,))


def shard_accum(accum, mesh: Mesh):
    """Place the accumulation buffer sharded over pixels."""
    return jax.device_put(accum, NamedSharding(mesh, P(AXIS, None)))


def shard_reservoir(reservoir, mesh: Mesh):
    """Place a ReSTIR reservoir pytree sharded over its pixel dim."""
    return jax.device_put(reservoir, NamedSharding(mesh, P(AXIS)))


def replicate(tree, mesh: Mesh):
    """Replicate the scene pytree / camera UBO on every chip."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh"), donate_argnums=(2,)
)
def render_frame_sharded(scene, camera_ubo, accum, frame_number,
                         cfg: RenderConfig, mesh: Mesh):
    """One progressive sample with pixel tiles sharded over `mesh`.

    Requires cfg.num_pixels % mesh.size == 0 (pad the height if needed)."""
    n_dev = mesh.size
    n = cfg.num_pixels
    assert n % n_dev == 0, (
        f"pixel count {n} not divisible by mesh size {n_dev}"
    )
    n_local = n // n_dev

    def tile_fn(scene, camera_ubo, accum_tile, frame_number):
        tile = jax.lax.axis_index(AXIS)
        start = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        if cfg.spp_batch > 1:
            # S jittered samples of this tile in ONE launch restore the
            # wavefront width a small per-device tile loses.
            from raytracer_tpu.integrator.wavefront import (
                render_tile_spp_batched,
            )

            return render_tile_spp_batched(
                scene, camera_ubo, accum_tile, frame_number, cfg,
                pixel_start=start, n_local=n_local,
            )
        radiance = render_wavefront(
            scene, camera_ubo, frame_number, cfg,
            pixel_start=start, num_pixels=n_local,
        )
        return accumulate(accum_tile, radiance, frame_number)

    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS, None), P()),
        out_specs=P(AXIS, None),
        # The bounce-loop carry mixes tile-varying lanes with initially
        # replicated values (frame counters); skip the varying-axes check.
        check_vma=False,
    )
    return fn(scene, camera_ubo, accum, frame_number)


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh"), donate_argnums=(2, 3)
)
def render_frame_restir_sharded(scene, camera_ubo, accum, reservoir,
                                frame_number, cfg: RenderConfig, mesh: Mesh):
    """One ReSTIR DI progressive sample with pixel tiles sharded over `mesh`.

    The reservoir state is sharded alongside the accumulation buffer; spatial
    reuse crosses tile boundaries through per-iteration halo exchanges
    (ppermute of the (radius+1)·width boundary rows — the ONLY in-loop
    collective in the framework). Bit-identical to the single-chip ReSTIR
    path whenever each tile is at least one halo tall (see
    integrator/restir.py:restir_direct)."""
    from raytracer_tpu.integrator.restir import render_frame_restir

    n_dev = mesh.size
    n = cfg.num_pixels
    assert n % n_dev == 0, (
        f"pixel count {n} not divisible by mesh size {n_dev}"
    )
    n_local = n // n_dev

    def tile_fn(scene, camera_ubo, accum_tile, res_tile, frame_number):
        tile = jax.lax.axis_index(AXIS)
        start = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        return render_frame_restir(
            scene, camera_ubo, accum_tile, res_tile, frame_number, cfg,
            pixel_start=start, num_pixels=n_local,
            num_tiles=n_dev, axis_name=AXIS,
        )

    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS, None), P(AXIS), P()),
        out_specs=(P(AXIS, None), P(AXIS)),
        check_vma=False,
    )
    return fn(scene, camera_ubo, accum, reservoir, frame_number)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_radiance_sharded(scene, camera_ubo, frame_number,
                            cfg: RenderConfig, mesh: Mesh):
    """One RAW radiance sample (no accumulation) with pixel tiles sharded
    over `mesh` — the preview path (api.ProgressiveRenderer.preview_image):
    a preview frame is a throwaway sample, never blended into state.
    Same global-seed tiling as render_frame_sharded, so the result is
    bit-identical across mesh sizes (and matches the unsharded
    render_wavefront to float reassociation, ~1e-9)."""
    n_dev = mesh.size
    n = cfg.num_pixels
    assert n % n_dev == 0, (
        f"pixel count {n} not divisible by mesh size {n_dev}"
    )
    n_local = n // n_dev

    def tile_fn(scene, camera_ubo, frame_number):
        tile = jax.lax.axis_index(AXIS)
        start = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        return render_wavefront(
            scene, camera_ubo, frame_number, cfg,
            pixel_start=start, num_pixels=n_local,
        )

    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(AXIS, None),
        check_vma=False,
    )
    return fn(scene, camera_ubo, frame_number)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def gbuffer_sharded(scene, camera_ubo, cfg: RenderConfig, mesh: Mesh):
    """Denoiser G-buffer (normal, depth, albedo) with pixel tiles sharded
    over `mesh` — one coherent primary trace, zero collectives."""
    from raytracer_tpu.integrator.denoise import gbuffer_pass

    n_dev = mesh.size
    n = cfg.num_pixels
    assert n % n_dev == 0, (
        f"pixel count {n} not divisible by mesh size {n_dev}"
    )
    n_local = n // n_dev

    def tile_fn(scene, camera_ubo):
        tile = jax.lax.axis_index(AXIS)
        start = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        return gbuffer_pass(
            scene, camera_ubo, cfg,
            pixel_start=start, num_pixels=n_local,
        )

    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(AXIS, None), P(AXIS), P(AXIS, None)),
        check_vma=False,
    )
    return fn(scene, camera_ubo)


def shard_adaptive(state, mesh: Mesh):
    """Place an AdaptiveState sharded over its pixel dim (trailing dims
    replicated — P(AXIS) is a prefix spec, like shard_reservoir)."""
    return jax.device_put(state, NamedSharding(mesh, P(AXIS)))


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh"), donate_argnums=(2,)
)
def render_frame_adaptive_sharded(scene, camera_ubo, state,
                                  cfg: RenderConfig, mesh: Mesh):
    """One adaptive-sampling step with pixel tiles sharded over `mesh`.
    Convergence is per-pixel local, so tiles need no communication at all
    (same zero-collective structure as render_frame_sharded)."""
    from raytracer_tpu.integrator.adaptive import render_frame_adaptive

    n_dev = mesh.size
    n = cfg.num_pixels
    assert n % n_dev == 0, (
        f"pixel count {n} not divisible by mesh size {n_dev}"
    )
    n_local = n // n_dev

    def tile_fn(scene, camera_ubo, state_tile):
        tile = jax.lax.axis_index(AXIS)
        start = tile.astype(jnp.uint32) * jnp.uint32(n_local)
        return render_frame_adaptive(
            scene, camera_ubo, state_tile, cfg,
            pixel_start=start, num_pixels=n_local,
        )

    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )
    return fn(scene, camera_ubo, state)


def _progressive_renderer_cls():
    from raytracer_tpu.api import ProgressiveRenderer

    return ProgressiveRenderer


class ShardedProgressiveRenderer:
    """Thin convenience front for `api.ProgressiveRenderer(mesh=...)` —
    the multi-chip logic now lives in the ONE renderer class (one reset
    path re-places accum *and* reservoir; round-1 weak #6). Kept as a
    distinct name so `from ...sharding import ShardedProgressiveRenderer`
    keeps working; it defaults the mesh to all devices."""

    def __new__(cls, scene, camera=None,
                config: Optional[RenderConfig] = None,
                mesh: Optional[Mesh] = None):
        inst = _progressive_renderer_cls()(
            scene, camera, config, mesh=mesh or make_pixel_mesh()
        )
        # Legacy alias from the pre-unification wrapper: r._inner is r.
        inst._inner = inst
        return inst
