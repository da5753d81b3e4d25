"""Vectorized stackless BVH traversal — the software `traceRayEXT`.

Replaces the hardware traversal of `traceRayEXT`/`rayQueryEXT`
(simple.rgen:92-104, simple.rchit:362-371) with a lockstep walk of the
flattened skip-link BVH (accel/bvh.py) over the whole ray wavefront. This
is plain jnp/lax left to XLA, and the only compiled traversal path;
ops/intersect.py (brute force) is its oracle.

Memory layout (scene/device_scene.py `_pack_traversal_arrays`):
  - one [N] gather of nodes_packed f32[NN,8] fetches AABB + links per step,
  - one [N] gather of tris_packed f32[NB,LEAF,12] fetches a WHOLE leaf block
    (padding rows are degenerate and never intersect, so no count masking),
  - the LEAF-wide Möller–Trumbore runs batched on [N,LEAF] with a single
    min-reduction — one fused kernel instead of LEAF sequential tests.

Each `lax.while_loop` iteration is a launch sequence whose count is the
MAXIMUM per-ray visit count (lockstep), so each iteration advances UNROLL
micro-steps: same total gather traffic, 1/UNROLL the iterations. Rays that
finish idle until the wavefront drains; the SAH tree keeps the spread of
visit counts down.

Two variants: `intersect_bvh` (closest hit) and `occlusion_bvh` (any hit
with an object-id skip mask, terminating each lane at first accepted hit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer_tpu.ops.intersect import HitRecord

UNROLL = 4


def _safe_inv(direction):
    """1/d with sign-preserving clamp to avoid 0*inf NaNs in the slab test."""
    d = jnp.where(
        jnp.abs(direction) < 1e-20,
        jnp.where(direction >= 0, 1e-20, -1e-20),
        direction,
    )
    return 1.0 / d


def _node_step(scene, cur, origin, inv_d, t_min, best_t, nn):
    """One traversal micro-step: fetch node, slab test, compute next cursor.
    Returns (next_cur, leaf_block_or_minus1)."""
    node = scene.nodes_packed[jnp.minimum(cur, nn - 1)]  # [N,8] one gather
    nmin = node[:, 0:3]
    nmax = node[:, 3:6]
    skip = jax.lax.bitcast_convert_type(node[:, 6], jnp.int32)
    meta = jax.lax.bitcast_convert_type(node[:, 7], jnp.int32)

    t0 = (nmin - origin) * inv_d
    t1 = (nmax - origin) * inv_d
    t_near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), t_min)
    t_far = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1), best_t)
    active = cur < nn
    hit_box = (t_near <= t_far) & active

    is_leaf = meta < 0  # meta = ~block for leaves, right-child for internal
    descend = hit_box & ~is_leaf
    nxt = jnp.where(descend, cur + 1, skip)
    cur = jnp.where(active, nxt, cur)
    leaf = jnp.where(hit_box & is_leaf, ~meta, -1)
    return cur, leaf


def _leaf_test(scene, leaf, origin, direction, t_min, best):
    """Batched Möller–Trumbore over one leaf block per ray.

    best = (t, tri, u, v); lanes with leaf < 0 keep their state."""
    best_t, best_tri, best_u, best_v = best
    nb = scene.tris_packed.shape[0]
    block = scene.tris_packed[jnp.clip(leaf, 0, nb - 1)]  # [N,LEAF,12]
    v0 = block[:, :, 0:3]
    e1 = block[:, :, 3:6]
    e2 = block[:, :, 6:9]
    tri_idx = jax.lax.bitcast_convert_type(block[:, :, 9], jnp.int32)

    o = origin[:, None, :]
    d = direction[:, None, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-10, 1.0 / det, 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > 1e-10)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < best_t[:, None])
        & (leaf >= 0)[:, None]
    )
    t = jnp.where(valid, t, jnp.inf)
    k = jnp.argmin(t, axis=1)
    rows = jnp.arange(t.shape[0])
    tk = t[rows, k]
    improved = tk < best_t
    return (
        jnp.where(improved, tk, best_t),
        jnp.where(improved, tri_idx[rows, k], best_tri),
        jnp.where(improved, u[rows, k], best_u),
        jnp.where(improved, v[rows, k], best_v),
    )


def intersect_bvh(origin, direction, scene, t_min: float, t_max,
                  leaf_size: int = 8, active_mask=None) -> HitRecord:
    """Closest-hit traversal. origin/direction f32[R,3]; `scene` is a
    SceneOnDevice (only packed traversal arrays are touched). `t_max` may be
    scalar or f32[R]. `active_mask` (bool[R], optional) skips dead lanes."""
    del leaf_size  # leaf width comes from tris_packed.shape[1]
    r = origin.shape[0]
    nn = scene.nodes_packed.shape[0]
    inv_d = _safe_inv(direction)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))

    def cond(state):
        return jnp.any(state[0] < nn)

    def body(state):
        cur, best_t, best_tri, best_u, best_v = state
        for _ in range(UNROLL):
            cur, leaf = _node_step(
                scene, cur, origin, inv_d, t_min, best_t, nn
            )
            best_t, best_tri, best_u, best_v = _leaf_test(
                scene, leaf, origin, direction, t_min,
                (best_t, best_tri, best_u, best_v),
            )
        return cur, best_t, best_tri, best_u, best_v

    start = jnp.zeros((r,), jnp.int32)
    if active_mask is not None:
        start = jnp.where(active_mask, 0, nn)
    init = (
        start,
        t_max,
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, init)
    return HitRecord(
        t=best_t, tri=best_tri, u=best_u, v=best_v, hit=best_tri >= 0
    )


def occlusion_bvh(origin, direction, t_min, t_max, scene, skip_object,
                  leaf_size: int = 8, active_mask=None):
    """Any-hit traversal for shadow rays: returns bool[R] `occluded`.

    Hits on `skip_object` (i32[R], the sampled light object) are ignored —
    the lockstep equivalent of isVisibleRQ treating the light instance as
    visible (simple.rchit:373-384). Lanes terminate at their first accepted
    hit. `active_mask` (bool[R], optional) pre-terminates lanes."""
    del leaf_size
    r = origin.shape[0]
    nn = scene.nodes_packed.shape[0]
    nb = scene.tris_packed.shape[0]
    inv_d = _safe_inv(direction)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,))

    def leaf_any_hit(leaf):
        block = scene.tris_packed[jnp.clip(leaf, 0, nb - 1)]
        v0 = block[:, :, 0:3]
        e1 = block[:, :, 3:6]
        e2 = block[:, :, 6:9]
        obj = jax.lax.bitcast_convert_type(block[:, :, 10], jnp.int32)
        o = origin[:, None, :]
        d = direction[:, None, :]
        pvec = jnp.cross(d, e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-10, 1.0 / det, 0.0)
        tvec = o - v0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(d * qvec, axis=-1) * inv_det
        t = jnp.sum(e2 * qvec, axis=-1) * inv_det
        valid = (
            (jnp.abs(det) > 1e-10)
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > t_min) & (t < t_max[:, None])
            & (obj != skip_object[:, None])
            & (leaf >= 0)[:, None]
        )
        return jnp.any(valid, axis=1)

    def cond(state):
        return jnp.any(state[0] < nn)

    def body(state):
        cur, occluded = state
        for _ in range(UNROLL):
            cur, leaf = _node_step(
                scene, cur, origin, inv_d, t_min, t_max, nn
            )
            found = leaf_any_hit(leaf)
            occluded = occluded | found
            cur = jnp.where(found, nn, cur)  # early exit on first hit
        return cur, occluded

    start = jnp.zeros((r,), jnp.int32)
    if active_mask is not None:
        start = jnp.where(active_mask, 0, nn)
    init = (start, jnp.zeros((r,), bool))
    _, occluded = jax.lax.while_loop(cond, body, init)
    return occluded
