"""ReSTIR DI — reservoir-based direct-light resampling (BASELINE config 5).

The reference *sketches* this: an RTXDI-style reservoir struct
(shaders/restir/restir_structs.glsl:1-23), a G-buffer fill pass
(shaders/restir.rgen:17-92: albedo, normal+roughness, position+metallic,
emission), and a non-compiling rgen stub (restir/restir_di.rgen) that nothing
dispatches. We implement the real algorithm
(Bitterli et al. 2020, "Spatiotemporal reservoir resampling for real-time ray
tracing with dynamic direct lighting") on those data layouts:

  reservoir SoA over pixels: weight_sum (w_sum), target_pdf (p̂ of the kept
  sample), M (candidates seen), light_index, uv (triangle barycentrics),
  distance, W (unbiased contribution weight) — field-for-field the
  RTXDI_DIReservoir struct.

Per frame (all lockstep over the pixel wavefront, fused under one jit):
  1. G-buffer: primary hit position/normal/material via the shared BVH
     traversal (the restir.rgen pass).
  2. Initial candidates: RIS over `restir_initial_candidates` area-light
     samples; target p̂ = luminance of the unshadowed contribution.
  3. Visibility: one shadow ray for the surviving sample (kills W, biased-
     mode visibility reuse as in the paper's basic variant).
  4. Temporal reuse: merge the previous frame's reservoir at the same pixel,
     M clamped to `restir_max_m`. Valid exactly when progressive
     accumulation is valid (static camera — accumulation resets on motion,
     raytracing_renderer.odin:196-199 semantics — so no reprojection needed).
  5. Spatial reuse: `restir_spatial_neighbors` random neighbors within
     `restir_spatial_radius` pixels, merged with p̂ re-evaluated at the
     receiver. With cfg.restir_unbiased_spatial the contribution
     weight divides by the paper's Z-count — the M-mass of only those
     participants whose own surface could have produced the chosen sample
     (Bitterli et al. 2020 Alg. 6) — instead of the biased M-sum.
  6. Shade: direct = f(x, wi)·Le·G · W, plus emission on directly visible
     emitters; indirect continues through the standard path-traced bounces
     with NEE disabled at the first bounce (ReSTIR replaces it there).
     With cfg.restir_final_visibility_feedback the step-6
     occlusion result also invalidates the reservoir handed to the next
     frame, so spatially imported samples that are occluded HERE cannot
     persist through temporal reuse shading black for ~M frames.

Both reuse "fixes" (steps 5/6 options) default OFF: on the atrium and the
64-light grid each one raised long-run error on at least one scene and
BOTH together were the worst variant on both scenes, while early frames —
the real-time regime ReSTIR is for — are identical across variants. The
energy divergence that motivated them is radiance-clamp interplay (plain's
spikier MIS estimator loses more to the 5.0 clamp), not reuse bias:
without the clamp the ReSTIR/plain energy ratio falls below 1.

RNG: ReSTIR draws come from a dedicated third stream seeded with
tea(pixel, frame ^ 0x9E3779B9) so the base integrator's stream parity with
the reference is untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.ops import brdf, rng
from raytracer_tpu.ops.math3d import (
    cos_theta,
    cross,
    dot,
    dot_k,
    length,
    luminance_rec601,
    make_basis,
    normalize,
    world_to_local,
)
from raytracer_tpu.utils.config import RenderConfig


class Reservoir(NamedTuple):
    """RTXDI_DIReservoir SoA (restir_structs.glsl:1-11)."""

    weight_sum: jnp.ndarray  # f32[N]
    target_pdf: jnp.ndarray  # f32[N]
    m: jnp.ndarray  # f32[N] (float so temporal clamping is exact)
    light_index: jnp.ndarray  # i32[N] (-1 invalid)
    uv: jnp.ndarray  # f32[N,2] (triangle pick u, sqrt-bary seed v) — see below
    distance: jnp.ndarray  # f32[N]
    w: jnp.ndarray  # f32[N] final contribution weight

    @staticmethod
    def empty(n: int) -> "Reservoir":
        """RTXDI_EmptyDIReservoir (restir_structs.glsl:13-23)."""
        return Reservoir(
            weight_sum=jnp.zeros(n, jnp.float32),
            target_pdf=jnp.zeros(n, jnp.float32),
            m=jnp.zeros(n, jnp.float32),
            light_index=jnp.full(n, -1, jnp.int32),
            uv=jnp.zeros((n, 2), jnp.float32),
            distance=jnp.zeros(n, jnp.float32),
            w=jnp.zeros(n, jnp.float32),
        )


class GBuffer(NamedTuple):
    """The restir.rgen G-buffer images as SoA (restir.rgen:20-28)."""

    position: jnp.ndarray  # f32[N,3]
    normal: jnp.ndarray  # f32[N,3]
    albedo: jnp.ndarray  # f32[N,3]
    roughness: jnp.ndarray  # f32[N]
    metallic: jnp.ndarray  # f32[N]
    emission: jnp.ndarray  # f32[N,3]  (color*power)
    hit: jnp.ndarray  # bool[N]
    object: jnp.ndarray  # i32[N]


def _reservoir_update(res: Reservoir, cand_light, cand_uv, cand_dist,
                      cand_target, cand_weight, r):
    """Streaming RIS update: keep candidate with prob weight/weight_sum."""
    weight_sum = res.weight_sum + cand_weight
    take = (cand_weight > 0.0) & (
        r * weight_sum <= cand_weight
    )
    return Reservoir(
        weight_sum=weight_sum,
        target_pdf=jnp.where(take, cand_target, res.target_pdf),
        m=res.m + 1.0,
        light_index=jnp.where(take, cand_light, res.light_index),
        uv=jnp.where(take[:, None], cand_uv, res.uv),
        distance=jnp.where(take, cand_dist, res.distance),
        w=res.w,  # finalized later
    )


def _reservoir_merge(res: Reservoir, other: Reservoir, other_target_here, r,
                     valid):
    """Merge `other` (with target pdf re-evaluated at the receiver) into
    `res`. `valid` masks lanes where `other` contributes."""
    m_other = jnp.where(valid, other.m, 0.0)
    w_other = jnp.where(valid, other_target_here * other.w * m_other, 0.0)
    weight_sum = res.weight_sum + w_other
    take = (w_other > 0.0) & (r * weight_sum <= w_other)
    return Reservoir(
        weight_sum=weight_sum,
        target_pdf=jnp.where(take, other_target_here, res.target_pdf),
        m=res.m + m_other,
        light_index=jnp.where(take, other.light_index, res.light_index),
        uv=jnp.where(take[:, None], other.uv, res.uv),
        distance=jnp.where(take, other.distance, res.distance),
        w=res.w,
    )


def _finalize(res: Reservoir, z=None) -> Reservoir:
    """W = w_sum / (M * p̂). With `z` (the Alg.-6 Z-count: total M of only
    the participants whose surface could have produced the chosen sample)
    the denominator uses Z instead of M, removing the M-sum combination
    bias."""
    denom_m = res.m if z is None else z
    w = jnp.where(
        (res.target_pdf > 0.0) & (denom_m > 0.0),
        res.weight_sum / jnp.maximum(denom_m * res.target_pdf, 1e-20),
        0.0,
    )
    return res._replace(w=w)


def _sample_light_point(scene, tri_global, r1, r2, cfg):
    """Area-sample the GLOBAL light-triangle `tri_global` at barycentric
    randoms (r1, r2). Returns (pos, normal_raw, area, num_tris, emission,
    light_idx). Mirrors sampleLight's sqrt-barycentric sampling
    (simple.rchit:266-282). The sample is a pure function of
    (tri_global, r1, r2) — the reservoir's stored identity — with (r1, r2)
    GENUINELY uniform on the unit square. (An earlier version stored
    (u_tri, r1) and derived r2 via a deterministic fold of the two, which
    confines samples to a 1-D curve while the pdf assumes uniform area
    sampling: measured +8% energy bias on Cornell.)"""
    ti = jnp.clip(tri_global, 0, scene.light_tri_packed.shape[0] - 1)
    # ONE wide row gather, period: vertices, owning light, triangle count AND
    # the light's emission (cols 12:15) all ride in the light_tri_packed row
    # (gathers are row-throughput-bound; width is free).
    trow = scene.light_tri_packed[ti]
    v0 = trow[:, 0:3]
    e1 = trow[:, 3:6]
    e2 = trow[:, 6:9]
    light_idx = trow[:, 10].astype(jnp.int32)
    num_tris = trow[:, 11].astype(jnp.int32)
    sqrt_r1 = jnp.sqrt(r1)
    bu = 1.0 - sqrt_r1
    bv = sqrt_r1 * (1.0 - r2)
    bw = sqrt_r1 * r2
    pos = bu[:, None] * v0 + bv[:, None] * (v0 + e1) + bw[:, None] * (v0 + e2)
    face_n = cross(e1, e2)
    area = 0.5 * length(face_n)
    emission = trow[:, 12:15]
    return pos, face_n, area, num_tris, emission, light_idx


def _target_pdf(scene, gbuf: GBuffer, tri_global, uv, cfg):
    """p̂ = luminance(f·Le·G) of the unshadowed contribution at the G-buffer
    surface, plus the geometry needed for shading. The reservoir sample is
    (tri_global, uv=(r1, r2)) — field-for-field the RTXDI reservoir with
    lightIndex holding the global light-PRIMITIVE id (the standard encoding
    for mesh lights) and uv the point on it."""
    r1 = uv[:, 0]
    r2 = uv[:, 1]
    pos, face_n, area, num_tris, emission, light_idx = _sample_light_point(
        scene, tri_global, r1, r2, cfg
    )
    to_light = pos - gbuf.position
    dist = jnp.maximum(length(to_light), 0.01)
    wi = to_light / dist[:, None]
    n_light = normalize(face_n)
    cos_l = jnp.abs(dot(n_light, -wi))

    basis = make_basis(gbuf.normal)
    # View direction: G-buffer stores the camera-ray direction implicitly via
    # position; reconstruct wo from the camera in the caller — here we accept
    # precomputed wo_local lanes instead.
    return pos, dist, wi, cos_l, area, num_tris, emission, basis, light_idx


def _unshadowed_radiance(scene, gbuf, wo_world, tri_global, uv, cfg):
    """Returns (radiance f32[N,3], dist, wi_world, valid) for the sample
    identified by (tri_global, uv): f·Le·cosθ·cosL·area·numTris/dist² — the
    area-measure contribution whose luminance is the ReSTIR target p̂."""
    (pos, dist, wi, cos_l, area, num_tris, emission, basis, light_idx
     ) = _target_pdf(scene, gbuf, tri_global, uv, cfg)
    wo_local = world_to_local(-wo_world, basis)
    wi_local = world_to_local(wi, basis)
    f = brdf.evaluate_full(
        wo_local, wi_local, gbuf.albedo, gbuf.roughness, gbuf.metallic
    )
    cos_surf = jnp.maximum(cos_theta(wi_local), 0.0)
    geom = cos_surf * cos_l / (dist * dist)
    # Area-measure: multiply by the sampled area (pdf_area = 1/(area*numTris)
    # is divided out by using contribution per unit sample probability).
    scale = geom * area * jnp.maximum(num_tris.astype(jnp.float32), 1.0)
    radiance = f * emission * scale[:, None]
    valid = (
        (tri_global >= 0) & (light_idx >= 0)
        & (cos_l > 1e-6) & (cos_surf > 0.0) & gbuf.hit
    )
    radiance = jnp.where(valid[:, None], radiance, 0.0)
    return radiance, dist, pos, wi, valid


def _exchange_halo(tree, h: int, axis_name: str, num_tiles: int):
    """Extend each [n_local, ...] array with `h` boundary rows from the
    previous and next tile over `axis_name` (one ppermute pair per direction
    — the ICI halo exchange for cross-tile spatial reuse). Edge tiles get
    zero rows on their missing side, which deserialize as empty reservoirs /
    degenerate normals and are masked off by the callers' validity gates."""

    def ex(a):
        if num_tiles <= 1:
            pad = jnp.zeros((h,) + a.shape[1:], a.dtype)
            return jnp.concatenate([pad, a, pad], axis=0)
        down = a[-h:]  # tile i's last rows -> tile i+1's leading halo
        up = a[:h]  # tile i's first rows -> tile i-1's trailing halo
        perm_fwd = [(i, i + 1) for i in range(num_tiles - 1)]
        perm_bwd = [(i + 1, i) for i in range(num_tiles - 1)]
        from_prev = jax.lax.ppermute(down, axis_name, perm_fwd)
        from_next = jax.lax.ppermute(up, axis_name, perm_bwd)
        return jnp.concatenate([from_prev, a, from_next], axis=0)

    return jax.tree_util.tree_map(ex, tree)


def restir_direct(scene, gbuf: GBuffer, wo_world, prev_reservoir, frame_number,
                  cfg: RenderConfig, occlusion_fn, pixel_start=0,
                  num_tiles: int = 1, axis_name=None):
    """Full ReSTIR DI pipeline steps 2-6. Returns (direct_radiance f32[N,3],
    reservoir for the next frame).

    With `axis_name` set (shard_map tile context), lanes cover the GLOBAL
    pixel range [pixel_start, pixel_start+N) and step 5's spatial taps
    crossing the tile boundary are served from halo rows ppermute'd from the
    neighboring tiles — bit-identical to the single-chip pass whenever the
    halo (min((radius+1)·width, N) rows) covers the tap radius."""
    n = gbuf.position.shape[0]
    l_used = min(scene.num_lights, cfg.max_lights)
    if l_used == 0:
        return (jnp.zeros((n, 3), jnp.float32), Reservoir.empty(n),
                jnp.int32(0))

    pixel_idx = (
        jnp.asarray(pixel_start, jnp.uint32) + jnp.arange(n, dtype=jnp.uint32)
    )
    seed = rng.tea(
        pixel_idx,
        jnp.asarray(frame_number, jnp.uint32) ^ jnp.uint32(0x9E3779B9),
    )

    # --- light-selection weights (power/dist², as the base integrator;
    # column form — see wavefront._light_weights_base) ---
    from raytracer_tpu.integrator.wavefront import _light_weights_base

    weights = _light_weights_base(scene, gbuf.position, cfg)
    weights = jnp.where(
        scene.light_object[None, :l_used] == gbuf.object[:, None], 0.0, weights
    )
    total_w = jnp.sum(weights, axis=-1)
    cdf = jnp.cumsum(weights, axis=1)

    # --- 2. initial candidates (RIS) ---
    res = Reservoir.empty(n)
    lt_count = scene.light_tri_v0.shape[0]
    for _ in range(cfg.restir_initial_candidates):
        r_sel, seed = rng.rnd(seed)
        r_tri, seed = rng.rnd(seed)
        r1, seed = rng.rnd(seed)
        r2, seed = rng.rnd(seed)
        r_keep, seed = rng.rnd(seed)
        pick = r_sel * total_w
        light = jnp.argmax(cdf >= pick[:, None], axis=1).astype(jnp.int32)
        found = jnp.any(cdf >= pick[:, None], axis=1) & (total_w > 0.0)
        sel_c = jnp.clip(light, 0, l_used - 1)
        sel_w = jnp.take_along_axis(weights, sel_c[:, None], axis=1)[:, 0]
        # Uniform triangle pick within the light -> global light-tri id (the
        # reservoir's sample identity, with uv = the point on it). One meta
        # row gather serves first_tri + num_tris.
        meta = scene.light_meta_packed[sel_c]
        num_tris = meta[:, 1].astype(jnp.int32)
        tri_local = jnp.minimum(
            (r_tri * num_tris.astype(jnp.float32)).astype(jnp.int32),
            num_tris - 1,
        )
        tri_global = jnp.where(
            found,
            jnp.clip(meta[:, 0].astype(jnp.int32) + tri_local, 0,
                     lt_count - 1),
            -1,
        )
        source_pdf = jnp.where(
            found, sel_w / jnp.maximum(total_w, 1e-20), 0.0
        )
        uv = jnp.stack([r1, r2], axis=-1)
        radiance, dist, _pos, _wi, valid = _unshadowed_radiance(
            scene, gbuf, wo_world, tri_global, uv, cfg
        )
        target = luminance_rec601(radiance)
        # RIS weight = p̂ / p_source (the triangle+area pdfs are folded into
        # the area-measure radiance; p_source is the light-selection pdf).
        cand_weight = jnp.where(
            valid & (source_pdf > 0.0), target / jnp.maximum(source_pdf, 1e-20),
            0.0,
        )
        res = _reservoir_update(res, tri_global, uv, dist, target,
                                cand_weight, r_keep)
    res = _finalize(res)

    # --- 3. visibility for the survivor (optional, see
    # cfg.restir_initial_visibility; consumes no RNG draws) ---
    eps = 0.001
    shadow_rays = jnp.int32(0)
    if cfg.restir_initial_visibility:
        radiance, dist, lpos, wi, valid = _unshadowed_radiance(
            scene, gbuf, wo_world, res.light_index, res.uv, cfg
        )
        light_obj = scene.light_tri_object[
            jnp.clip(res.light_index, 0, lt_count - 1)
        ]
        offset_from = gbuf.position + gbuf.normal * (
            eps * jnp.sign(dot_k(gbuf.normal, wi))
        )
        sr = lpos - offset_from
        sr_dist = length(sr)
        sr_dir = sr / jnp.maximum(sr_dist, 1e-20)[:, None]
        occ_active = valid & (sr_dist > 0.0)
        occ = occlusion_fn(offset_from, sr_dir, sr_dist * 0.999, light_obj,
                           occ_active)
        shadow_rays = shadow_rays + jnp.sum(occ_active.astype(jnp.int32))
        # Visibility reuse (Bitterli et al. 2020, Alg. 5): a killed reservoir
        # must contribute nothing downstream. Zeroing only `w` is
        # insufficient — the _finalize calls after temporal/spatial reuse
        # recompute w = weight_sum/(M·p̂) from weight_sum, which would
        # resurrect the occluded sample — so the sample payload itself is
        # invalidated (M is kept, as the candidate count remains part of the
        # RIS history).
        killed = occ | ~valid
        res = res._replace(
            w=jnp.where(killed, 0.0, res.w),
            weight_sum=jnp.where(killed, 0.0, res.weight_sum),
            target_pdf=jnp.where(killed, 0.0, res.target_pdf),
            light_index=jnp.where(killed, -1, res.light_index),
        )

    # --- 4. temporal reuse ---
    if prev_reservoir is not None:
        r_t, seed = rng.rnd(seed)
        prev = prev_reservoir
        prev = prev._replace(m=jnp.minimum(prev.m, float(cfg.restir_max_m)))
        prev_rad, _, _, _, prev_valid = _unshadowed_radiance(
            scene, gbuf, wo_world, prev.light_index, prev.uv, cfg
        )
        prev_target_here = luminance_rec601(prev_rad)
        res = _reservoir_merge(res, prev, prev_target_here, r_t,
                               prev_valid & (prev.w > 0.0))
        res = _finalize(res)

    # --- 5. spatial reuse ---
    # ALL taps read a SNAPSHOT of the post-temporal reservoir buffer (the
    # paper's ping-pong input buffer, Bitterli et al. 2020 Alg. 5 /
    # RTXDI's separate in/out reservoir textures). Reading the evolving
    # buffer instead lets tap k import a neighbor that already merged THIS
    # pixel's sample at tap k-1 — a positive feedback loop that temporal
    # reuse then compounds across frames (measured on the 64-light grid:
    # M grows ~2x per tap to ~1770 despite restir_max_m=128, and the
    # accumulated image brightens 0.47 -> 0.91 mean by frame 16, ~2x the
    # oracle). Snapshot taps + clamping the neighbor's M to restir_max_m
    # restore the expected small-bias behavior (tests/test_restir.py
    # many-light gate).
    width = cfg.width
    src = res  # post-temporal snapshot: every tap reads this, never `res`
    m_canonical = res.m  # the receiver's own M-mass (initial RIS + temporal)
    unbiased = cfg.restir_unbiased_spatial and cfg.restir_spatial_neighbors > 0
    halo = 0
    normal_ext = None
    src_ext = None
    surf_ext = None
    if axis_name is not None:
        # A tap moves at most `radius` rows plus one partial row in the
        # flattened index, so (radius+1)·width halo rows give exact coverage;
        # clamping to the tile size keeps tiny tiles legal (taps beyond the
        # clamped halo are dropped by `reach`, the documented bias case).
        # The snapshot is fixed, so ONE halo exchange (2 ppermutes of 5
        # small arrays) serves every tap.
        halo = min((int(cfg.restir_spatial_radius) + 1) * width, n)
        normal_ext = _exchange_halo(gbuf.normal, halo, axis_name, num_tiles)
        src_ext = _exchange_halo(
            {"m": src.m, "w": src.w, "light_index": src.light_index,
             "uv": src.uv, "distance": src.distance},
            halo, axis_name, num_tiles,
        )
        if unbiased:
            # The Z-count re-evaluates the FINAL sample's p̂ at each tap's
            # surface, so the taps' surface attributes ride the same halo.
            surf_ext = _exchange_halo(
                {"position": gbuf.position, "albedo": gbuf.albedo,
                 "roughness": gbuf.roughness, "metallic": gbuf.metallic,
                 "hit": gbuf.hit, "object": gbuf.object, "wo": wo_world},
                halo, axis_name, num_tiles,
            )
    taps = []  # (tap surface gather index, M-mass actually merged)
    start_i32 = jnp.asarray(pixel_start, jnp.uint32).astype(jnp.int32)
    for _ in range(cfg.restir_spatial_neighbors):
        r_a, seed = rng.rnd(seed)
        r_b, seed = rng.rnd(seed)
        r_m, seed = rng.rnd(seed)
        ang = 2.0 * 3.14159265 * r_a
        rad = cfg.restir_spatial_radius * jnp.sqrt(r_b)
        dx = (jnp.cos(ang) * rad).astype(jnp.int32)
        dy = (jnp.sin(ang) * rad).astype(jnp.int32)
        px = (pixel_idx.astype(jnp.int32) % width) + dx
        py = (pixel_idx.astype(jnp.int32) // width) + dy
        in_bounds = (
            (px >= 0) & (px < width) & (py >= 0) & (py < cfg.height)
        )
        if axis_name is None:
            nbr = jnp.clip(py * width + px, 0, n - 1)
            nbr_res = jax.tree_util.tree_map(lambda a: a[nbr], src)
            nbr_normal = gbuf.normal[nbr]
            reach = in_bounds
        else:
            ext_idx = py * width + px - start_i32 + halo
            reach = in_bounds & (ext_idx >= 0) & (ext_idx < n + 2 * halo)
            idx = jnp.clip(ext_idx, 0, n + 2 * halo - 1)
            nbr_res = Reservoir(
                weight_sum=jnp.zeros(n, jnp.float32),  # not read by merge
                target_pdf=jnp.zeros(n, jnp.float32),  # not read by merge
                m=src_ext["m"][idx],
                light_index=src_ext["light_index"][idx],
                uv=src_ext["uv"][idx],
                distance=src_ext["distance"][idx],
                w=src_ext["w"][idx],
            )
            nbr_normal = normal_ext[idx]
        nbr_res = nbr_res._replace(
            m=jnp.minimum(nbr_res.m, float(cfg.restir_max_m))
        )
        # Geometric similarity gate (normal + depth proximity) to limit bias.
        nrm_ok = dot(nbr_normal, gbuf.normal) > 0.9
        nbr_rad, _, _, _, nbr_valid = _unshadowed_radiance(
            scene, gbuf, wo_world, nbr_res.light_index, nbr_res.uv, cfg
        )
        target_here = luminance_rec601(nbr_rad)
        participate = reach & nrm_ok & nbr_valid & (nbr_res.w > 0.0) & gbuf.hit
        res = _reservoir_merge(res, nbr_res, target_here, r_m, participate)
        if unbiased:
            gather_idx = nbr if axis_name is None else idx
            taps.append((gather_idx, jnp.where(participate, nbr_res.m, 0.0)))
    if unbiased:
        # Alg.-6 Z-count for the FINAL sample: the receiver always covers its
        # own choice (it was selected with p̂ > 0 here); each tap contributes
        # its merged M-mass iff the sample's p̂ evaluated at the TAP's surface
        # is positive (i.e. that pixel could have produced it).
        z = m_canonical
        for gather_idx, m_mass in taps:
            if axis_name is None:
                tap_gbuf = GBuffer(
                    position=gbuf.position[gather_idx],
                    normal=gbuf.normal[gather_idx],
                    albedo=gbuf.albedo[gather_idx],
                    roughness=gbuf.roughness[gather_idx],
                    metallic=gbuf.metallic[gather_idx],
                    emission=gbuf.emission,  # unread by _unshadowed_radiance
                    hit=gbuf.hit[gather_idx],
                    object=gbuf.object[gather_idx],
                )
                tap_wo = wo_world[gather_idx]
            else:
                tap_gbuf = GBuffer(
                    position=surf_ext["position"][gather_idx],
                    normal=normal_ext[gather_idx],
                    albedo=surf_ext["albedo"][gather_idx],
                    roughness=surf_ext["roughness"][gather_idx],
                    metallic=surf_ext["metallic"][gather_idx],
                    emission=gbuf.emission,  # unread by _unshadowed_radiance
                    hit=surf_ext["hit"][gather_idx],
                    object=surf_ext["object"][gather_idx],
                )
                tap_wo = surf_ext["wo"][gather_idx]
            tap_rad, _, _, _, tap_valid = _unshadowed_radiance(
                scene, tap_gbuf, tap_wo, res.light_index, res.uv, cfg
            )
            covered = tap_valid & (luminance_rec601(tap_rad) > 0.0)
            z = z + jnp.where(covered, m_mass, 0.0)
        res = _finalize(res, z=z)
    else:
        res = _finalize(res)

    # --- 6. shade the final sample ---
    # A final visibility ray is still required: spatial reuse can import a
    # neighbor's sample that was visible *there* but is occluded *here*, and
    # the step-3 test only covered this pixel's own initial survivor.
    radiance, dist, lpos, wi, valid = _unshadowed_radiance(
        scene, gbuf, wo_world, res.light_index, res.uv, cfg
    )
    light_obj = scene.light_tri_object[
        jnp.clip(res.light_index, 0, lt_count - 1)
    ]
    offset_from = gbuf.position + gbuf.normal * (
        eps * jnp.sign(dot_k(gbuf.normal, wi))
    )
    sr = lpos - offset_from
    sr_dist = length(sr)
    sr_dir = sr / jnp.maximum(sr_dist, 1e-20)[:, None]
    shadeable = valid & (res.w > 0.0)
    occ_final_active = shadeable & (sr_dist > 0.0)
    occ_final = occlusion_fn(offset_from, sr_dir, sr_dist * 0.999, light_obj,
                             occ_final_active)
    shadow_rays = shadow_rays + jnp.sum(occ_final_active.astype(jnp.int32))
    direct = radiance * res.w[:, None]
    direct = jnp.where((shadeable & ~occ_final)[:, None], direct, 0.0)
    if cfg.restir_final_visibility_feedback:
        # The step-6 ray is already paid for: feed its verdict back so an
        # occluded-here sample (typically a spatial import from across a
        # shadow boundary) cannot ride next frame's temporal reuse with
        # M up to restir_max_m, shading black for ~M frames. Same
        # invalidation pattern as step 3 — zeroing only w would let the
        # next frame's _finalize resurrect it from weight_sum.
        killed = occ_final_active & occ_final
        res = res._replace(
            w=jnp.where(killed, 0.0, res.w),
            weight_sum=jnp.where(killed, 0.0, res.weight_sum),
            target_pdf=jnp.where(killed, 0.0, res.target_pdf),
            light_index=jnp.where(killed, -1, res.light_index),
        )
    return direct, res, shadow_rays


def render_wavefront_restir(scene, camera_ubo, prev_reservoir, frame_number,
                            cfg: RenderConfig, pixel_start=0, num_pixels=None,
                            num_tiles: int = 1, axis_name=None,
                            with_stats: bool = False):
    """One progressive sample with ReSTIR DI at the primary vertex and
    path-traced indirect bounces. Returns (radiance f32[N,3], reservoir)
    (plus a measured-ray-count stats dict with with_stats=True).

    The primary trace doubles as the G-buffer pass (restir.rgen); the
    standard _shade machinery runs with suppress_nee=True at the primary
    vertex (emission of directly visible emitters still adds, exactly like
    simple.rchit's firstBounce path) and normally afterwards.

    `pixel_start`/`num_pixels`/`num_tiles`/`axis_name` carve out a shard_map
    tile (parallel/sharding.py): seeds and camera rays stay GLOBAL, and
    spatial reuse crosses the tile boundary via halo exchange."""
    from raytracer_tpu.integrator import wavefront as wf

    cfg = cfg.resolve_accel()
    n = cfg.num_pixels if num_pixels is None else num_pixels
    pixel_idx = (
        jnp.asarray(pixel_start, jnp.uint32) + jnp.arange(n, dtype=jnp.uint32)
    )
    state = wf.primary_state(camera_ubo, frame_number, cfg, pixel_idx)
    origin, direction = state.origin, state.direction

    # --- primary trace + G-buffer (restir.rgen) ---
    hit = wf._trace(scene, origin, direction, cfg, state.alive)
    lane = state.alive & hit.hit
    surf = wf.fetch_surface(scene, hit, direction, lane)
    # Dielectric lanes handle their own light transport (the plain path
    # skips NEE on them too); ReSTIR covers opaque-surface lanes only.
    if cfg.enable_transmission:
        restir_lane = lane & ~(surf.transmission > 0.0)
    else:
        restir_lane = lane
    gbuf = GBuffer(
        position=surf.world_pos,
        normal=surf.world_nrm,
        albedo=surf.albedo,
        roughness=surf.roughness,
        metallic=surf.metallic,
        emission=surf.emission_color * surf.emission_power[:, None],
        hit=restir_lane,
        object=surf.obj,
    )

    def occlusion_fn(o, d, t_max, skip_obj, active):
        return wf._occluded(scene, o, d, t_max, skip_obj, cfg, active)

    direct, reservoir, restir_shadow_rays = restir_direct(
        scene, gbuf, direction, prev_reservoir, frame_number, cfg,
        occlusion_fn, pixel_start=pixel_start, num_tiles=num_tiles,
        axis_name=axis_name,
    )

    # --- primary shading (BRDF sample + emission, NEE suppressed) ---
    state, payload_hit, _ = wf._shade(scene, state, hit, cfg,
                                      suppress_nee=True)
    state = state._replace(
        color=state.color + jnp.where(restir_lane[:, None], direct, 0.0)
    )
    # ReSTIR's direct at this vertex is FULL (weight 1, no MIS split), so
    # the next bounce's emissive-hit handling must stay suppressed even on
    # specular-lobe lanes — the reference's isSpecular full-emission add
    # (simple.rchit:644) assumes the MIS-weighted NEE estimator and would
    # double-count glossy direct light here (measured +8% on Cornell).
    state = state._replace(
        is_specular=jnp.where(restir_lane, False, state.is_specular)
    )

    state = wf.end_of_bounce(state, payload_hit, cfg)

    # --- indirect bounces (standard path tracing with NEE) ---
    def bounce(depth, carry):
        state, rays, shadows = carry
        state, r, sh = wf.trace_bounce(scene, state, depth, cfg)
        return state, rays + r, shadows + sh

    state, indirect_rays, indirect_shadows = jax.lax.fori_loop(
        1, cfg.max_depth, bounce, (state, jnp.int32(0), jnp.int32(0))
    )

    radiance = wf.finish_radiance(state, cfg)
    if with_stats:
        total = (jnp.int32(n) + restir_shadow_rays + indirect_rays
                 + indirect_shadows)
        return radiance, reservoir, {
            "primary_rays": jnp.int32(n),
            "restir_shadow_rays": restir_shadow_rays,
            "indirect_rays": indirect_rays,
            "indirect_shadow_rays": indirect_shadows,
            "total_rays": total,
        }
    return radiance, reservoir


def render_frame_restir(scene, camera_ubo, accum, prev_reservoir,
                        frame_number, cfg: RenderConfig, pixel_start=0,
                        num_pixels=None, num_tiles: int = 1, axis_name=None):
    """Progressive accumulation step with ReSTIR DI. Returns
    (accum', reservoir)."""
    radiance, reservoir = render_wavefront_restir(
        scene, camera_ubo, prev_reservoir, frame_number, cfg,
        pixel_start=pixel_start, num_pixels=num_pixels,
        num_tiles=num_tiles, axis_name=axis_name,
    )
    from raytracer_tpu.integrator.wavefront import accumulate

    return accumulate(accum, radiance, frame_number), reservoir
