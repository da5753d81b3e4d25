"""Ray-triangle intersection: Möller–Trumbore, batched.

The software replacement for fixed-function `traceRayEXT` triangle tests. Two
entry points:

  - `intersect_brute`: O(T) scan of every triangle against every ray — the
    correctness oracle (SURVEY.md §7 step 2) and the fast path for tiny
    scenes. Chunked with lax.scan so the [R, CHUNK] broadcast stays within
    a bounded memory footprint while XLA fuses the arithmetic.
  - `occlusion_brute`: boolean visibility variant for NEE shadow rays
    (isVisibleRQ, simple.rchit:350-385), with an object-id skip mask so
    hitting the sampled light itself doesn't count as occlusion.

BVH-accelerated versions live in ops/traverse.py with the same interfaces.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

EPS_DET = 1e-10


class HitRecord(NamedTuple):
    t: jnp.ndarray  # f32[R] hit distance (t_max when missed)
    tri: jnp.ndarray  # i32[R] triangle index (-1 when missed)
    u: jnp.ndarray  # f32[R] barycentric of v1
    v: jnp.ndarray  # f32[R] barycentric of v2
    hit: jnp.ndarray  # bool[R]


def moller_trumbore(origin, direction, v0, e1, e2, t_min, t_max):
    """Double-sided Möller–Trumbore. All args broadcast; returns (t, u, v,
    valid). `t_max` may be per-ray (current closest) for early rejection."""
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > EPS_DET, 1.0 / det, 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, u, v, valid


def _chunk(arrays, chunk_size):
    """Reshape [T, ...] arrays to [T//C, C, ...]; T must be padded already."""
    return [a.reshape(-1, chunk_size, *a.shape[1:]) for a in arrays]


def _pick_chunk(t_total: int, preferred: int) -> int:
    """Largest divisor of t_total that is <= preferred (bake pads triangle
    counts to a multiple of 128, so 128 always qualifies)."""
    c = min(preferred, t_total)
    while c > 1 and t_total % c:
        c -= 1
    return c


def intersect_brute(origin, direction, tri_v0, tri_e1, tri_e2,
                    t_min: float, t_max: float,
                    chunk_size: int = 512) -> HitRecord:
    """Closest-hit over all triangles. origin/direction f32[R,3]; triangle
    arrays f32[T,3] with T a multiple of chunk_size (bake pads)."""
    r = origin.shape[0]
    t_total = tri_v0.shape[0]
    chunk_size = _pick_chunk(t_total, chunk_size)
    v0c, e1c, e2c = _chunk([tri_v0, tri_e1, tri_e2], chunk_size)

    def scan_body(carry, inputs):
        best_t, best_tri, best_u, best_v = carry
        chunk_idx, v0, e1, e2 = inputs
        t, u, v, valid = moller_trumbore(
            origin[:, None, :], direction[:, None, :],
            v0[None, :, :], e1[None, :, :], e2[None, :, :],
            t_min, best_t[:, None],
        )
        t = jnp.where(valid, t, jnp.inf)
        k = jnp.argmin(t, axis=1)
        rows = jnp.arange(r)
        tk = t[rows, k]
        improved = tk < best_t
        best_t = jnp.where(improved, tk, best_t)
        best_u = jnp.where(improved, u[rows, k], best_u)
        best_v = jnp.where(improved, v[rows, k], best_v)
        best_tri = jnp.where(
            improved, chunk_idx * chunk_size + k.astype(jnp.int32), best_tri
        )
        return (best_t, best_tri, best_u, best_v), None

    init = (
        jnp.full((r,), t_max, jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    n_chunks = v0c.shape[0]
    (best_t, best_tri, best_u, best_v), _ = jax.lax.scan(
        scan_body, init,
        (jnp.arange(n_chunks, dtype=jnp.int32), v0c, e1c, e2c),
    )
    return HitRecord(
        t=best_t, tri=best_tri, u=best_u, v=best_v, hit=best_tri >= 0
    )


def occlusion_brute(origin, direction, t_min, t_max, tri_v0, tri_e1, tri_e2,
                    tri_object, skip_object, chunk_size: int = 512):
    """Any-hit test: True where the segment [t_min, t_max] is blocked by any
    triangle NOT belonging to `skip_object` (i32[R], the sampled light; the
    reference treats hitting the light instance as visible,
    simple.rchit:373-384). t_max is per-ray f32[R]."""
    t_total = tri_v0.shape[0]
    chunk_size = _pick_chunk(t_total, chunk_size)
    v0c, e1c, e2c, objc = _chunk(
        [tri_v0, tri_e1, tri_e2, tri_object], chunk_size
    )

    def scan_body(occluded, tris):
        v0, e1, e2, obj = tris
        _, _, _, valid = moller_trumbore(
            origin[:, None, :], direction[:, None, :],
            v0[None, :, :], e1[None, :, :], e2[None, :, :],
            t_min, t_max[:, None],
        )
        relevant = valid & (obj[None, :] != skip_object[:, None])
        return occluded | jnp.any(relevant, axis=1), None

    occluded0 = jnp.zeros(origin.shape[0], bool)
    occluded, _ = jax.lax.scan(scan_body, occluded0, (v0c, e1c, e2c, objc))
    return occluded
