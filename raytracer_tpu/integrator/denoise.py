"""Edge-aware preview denoiser (SVGF-style a-trous wavelet filter).

BEYOND-REFERENCE component: the reference renders its editor viewport raw
and relies on progressive accumulation for convergence (ui.odin displays
the accumulating image as-is). Here the same progressive loop runs at
preview resolutions (examples/interactive_session.py), and a denoised
preview makes 1-4 spp frames visually usable during edits. The filter is
applied ONLY at image()-time — the accumulation buffer itself is never
touched, so convergence and checkpoints are bit-identical with or without
denoising.

Design (the SVGF a-trous core, without the temporal moments — progressive
accumulation already plays that role):

  - a G-buffer from ONE extra coherent primary-ray trace (center rays,
    no jitter): normal, depth, albedo. Primary rays are the cheapest rays
    the tracer has (~4x faster than bounce wavefronts); at preview
    resolution this pass is milliseconds and it is cached until the
    camera moves.
  - demodulate albedo, filter irradiance, remodulate: keeps texture
    detail out of the filter.
  - 5x5 B3-spline a-trous taps at power-of-two strides; per-tap weights
    stop at normal edges (dot^phi_n), depth edges (exp(-|dz|/sigma_z)),
    and luminance edges (exp(-|dl|/sigma_l)). Everything is elementwise
    + static shifts — XLA fuses the whole filter into a handful of
    kernels; there is no data-dependent control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytracer_tpu.utils.config import RenderConfig

MISS_DEPTH = 1e30


@functools.partial(jax.jit, static_argnames=("cfg", "num_pixels"))
def gbuffer_pass(scene, camera_ubo, cfg: RenderConfig,
                 pixel_start=0, num_pixels=None):
    """Primary-hit G-buffer for the denoiser: (normal [N,3], depth [N],
    albedo [N,3]). Center rays (the frame-0 jitter), full resolution.
    Miss lanes: normal 0, depth MISS_DEPTH, albedo 1 (demodulation
    no-ops so the background passes through the filter unchanged).
    `pixel_start`/`num_pixels` carve out a tile for multi-chip sharding
    (parallel/sharding.py:gbuffer_sharded), like render_wavefront."""
    from raytracer_tpu.integrator.wavefront import (
        _camera_rays, _trace, fetch_surface,
    )

    cfg = cfg.resolve_accel()
    n = cfg.num_pixels if num_pixels is None else num_pixels
    pixel_idx = jnp.uint32(pixel_start) + jnp.arange(n, dtype=jnp.uint32)
    jitter = jnp.full((n, 2), 0.5, jnp.float32)
    origin, direction = _camera_rays(
        camera_ubo["inverse_view"], camera_ubo["inverse_proj"],
        cfg.width, cfg.height, jitter, pixel_idx,
    )
    hit = _trace(scene, origin, direction, cfg,
                 jnp.ones((n,), bool))
    surf = fetch_surface(scene, hit, direction, hit.hit)
    m = hit.hit[:, None]
    normal = jnp.where(m, surf.world_nrm, 0.0)
    depth = jnp.where(hit.hit, hit.t, MISS_DEPTH)
    albedo = jnp.where(m, surf.albedo, 1.0)
    return normal, depth, albedo


def _shift2d(a, dy, dx, pad):
    """Static shift of an edge-padded [H+2p, W+2p, C] array: the (dy, dx)
    tap of the padded stack, restricted back to [H, W, C]."""
    h = a.shape[0] - 2 * pad
    w = a.shape[1] - 2 * pad
    return a[pad + dy: pad + dy + h, pad + dx: pad + dx + w]


# 5-tap B3-spline, outer-product 2-D kernel (the SVGF choice).
_H1 = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "iterations", "phi_n"),
)
def atrous_denoise(img, normal, depth, albedo, height, width,
                   iterations: int = 4, sigma_z: float = 1.0,
                   sigma_l: float = 4.0, phi_n: int = 64):
    """Edge-aware a-trous filter of a linear-radiance image.

    img/normal/albedo: f32[N,3], depth: f32[N] (flat pixel-major, as the
    accumulation buffer). Returns f32[N,3]. Pure function of its inputs —
    the caller owns G-buffer caching."""
    img = img.reshape(height, width, 3)
    nrm = normal.reshape(height, width, 3)
    z = depth.reshape(height, width, 1)
    alb = albedo.reshape(height, width, 3)

    miss = z >= MISS_DEPTH  # [H,W,1]
    # Demodulate and remodulate with the SAME clamped albedo: a raw-albedo
    # remodulation would multiply any channel with albedo < 1e-3 by
    # alb/1e-3 ~ 0 and erase highlights/emission on black or fully
    # saturated materials instead of filtering them.
    alb = jnp.maximum(alb, 1e-3)
    s = img / alb  # demodulate

    for it in range(iterations):
        step = 1 << it
        pad = 2 * step
        sp = jnp.pad(s, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        np_ = jnp.pad(nrm, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        zp = jnp.pad(z, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        mp = jnp.pad(miss, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        lum = jnp.sum(s * jnp.asarray([0.2126, 0.7152, 0.0722]), axis=-1,
                      keepdims=True)

        acc = jnp.zeros_like(s)
        wsum = jnp.zeros_like(lum)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                h = _H1[ky] * _H1[kx]
                s_t = _shift2d(sp, dy, dx, pad)
                n_t = _shift2d(np_, dy, dx, pad)
                z_t = _shift2d(zp, dy, dx, pad)
                m_t = _shift2d(mp, dy, dx, pad)
                # Normal edge-stop; two miss pixels agree by definition.
                ndot = jnp.maximum(
                    jnp.sum(nrm * n_t, axis=-1, keepdims=True), 0.0
                )
                w_n = jnp.where(miss & m_t, 1.0, ndot ** phi_n)
                # Depth edge-stop (stride-scaled); miss pairs agree.
                dz = jnp.abs(z - z_t)
                w_z = jnp.where(
                    miss & m_t, 1.0,
                    jnp.exp(-dz / (sigma_z * step + 1e-6)),
                )
                # Surface-vs-background boundaries get zero weight.
                w_z = jnp.where(miss ^ m_t, 0.0, w_z)
                lum_t = jnp.sum(
                    s_t * jnp.asarray([0.2126, 0.7152, 0.0722]),
                    axis=-1, keepdims=True,
                )
                w_l = jnp.exp(-jnp.abs(lum - lum_t) / sigma_l)
                w = h * w_n * w_z * w_l
                acc = acc + w * s_t
                wsum = wsum + w
        s = acc / jnp.maximum(wsum, 1e-8)

    out = s * alb  # remodulate
    return out.reshape(-1, 3)


@functools.partial(
    jax.jit, static_argnames=("h", "w", "out_h", "out_w")
)
def upscale_bilinear(img, h, w, out_h, out_w):
    """Bilinear upscale of a flat [h*w, 3] linear-radiance image to
    [out_h*out_w, 3] — the preview-scale path (api.preview_image): trace at
    1/k resolution, filter, then upscale to the display size. Static
    shapes; XLA lowers jax.image.resize to fused gather/matmul work."""
    out = jax.image.resize(
        img.reshape(h, w, 3), (out_h, out_w, 3), method="bilinear"
    )
    return out.reshape(-1, 3)
