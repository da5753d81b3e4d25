"""Adaptive sampling (BEYOND-REFERENCE): per-pixel variance-driven
progressive rendering.

The reference accumulates one sample per pixel per frame until a GLOBAL
accumulation limit (raytracing_renderer.odin:204-205,347-350) — easy
pixels (sky, flat walls) get exactly as many samples as the hardest
penumbra. Here each pixel tracks a Welford variance estimate of its
luminance and stops sampling once the relative half-width of its mean
estimate falls under `RenderConfig.adaptive_tol`; the freed lanes enter
the traversal already finished, so they cost no BVH steps.

Exactness: each pixel's sample stream is indexed by its OWN count (seeds
= tea(pixel, count), frame-0 centered jitter per pixel), so a pixel's
first k samples are bit-identical to the non-adaptive renderer's first k
frames — adaptive_tol=0 reproduces the plain accumulation exactly
(tested). The running mean uses the same `accum + (radiance-accum) * a`
formula as integrator/wavefront.accumulate.

State: mean f32[N,3] (the image), m2 f32[N] (luminance sum of squared
deviations), count u32[N] (samples taken).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from raytracer_tpu.integrator.wavefront import (
    accumulate,
    luminance_rec709,
    render_wavefront,
)
from raytracer_tpu.utils.config import RenderConfig


class AdaptiveState(NamedTuple):
    mean: jnp.ndarray  # f32[N,3]
    m2: jnp.ndarray  # f32[N]
    count: jnp.ndarray  # u32[N]

    @staticmethod
    def empty(n: int) -> "AdaptiveState":
        return AdaptiveState(
            mean=jnp.zeros((n, 3), jnp.float32),
            m2=jnp.zeros((n,), jnp.float32),
            count=jnp.zeros((n,), jnp.uint32),
        )


def active_mask(state: AdaptiveState, cfg: RenderConfig) -> jnp.ndarray:
    """bool[N]: pixels still sampling. A pixel retires once it has at
    least `adaptive_min_frames` samples and the relative standard error
    of its mean luminance drops under `adaptive_tol` (tol 0 never
    retires: rel >= 0 is never < 0)."""
    cf = state.count.astype(jnp.float32)
    var_of_mean = state.m2 / jnp.maximum(cf * (cf - 1.0), 1.0)
    rel = jnp.sqrt(jnp.maximum(var_of_mean, 0.0)) / jnp.maximum(
        luminance_rec709(state.mean), 1e-3
    )
    converged = (
        (state.count >= jnp.uint32(cfg.adaptive_min_frames))
        & (rel < cfg.adaptive_tol)
    )
    return ~converged


def render_frame_adaptive(scene, camera_ubo, state: AdaptiveState,
                          cfg: RenderConfig, pixel_start=0, num_pixels=None):
    """One adaptive progressive step: sample only the unconverged pixels
    (each at its own per-pixel frame index) and fold them into the Welford
    state. Returns the new AdaptiveState."""
    active = active_mask(state, cfg)
    radiance = render_wavefront(
        scene, camera_ubo, state.count, cfg,
        pixel_start=pixel_start, num_pixels=num_pixels, active=active,
    )

    # Running mean: THE accumulation formula (wavefront.accumulate), with
    # each pixel's count as its own frame index; inactive lanes keep their
    # mean (their radiance is garbage by contract).
    blended = accumulate(state.mean, radiance, state.count)
    mean_new = jnp.where(active[:, None], blended, state.mean)

    # Welford m2 over luminance (luminance is linear, so the luminance of
    # the running mean IS the running mean of luminances).
    lum = luminance_rec709(radiance)
    delta = lum - luminance_rec709(state.mean)
    delta2 = lum - luminance_rec709(mean_new)
    m2_new = jnp.where(active, state.m2 + delta * delta2, state.m2)

    count_new = state.count + active.astype(jnp.uint32)
    return AdaptiveState(mean=mean_new, m2=m2_new, count=count_new)
