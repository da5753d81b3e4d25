"""The wavefront path-tracing integrator — rgen/rchit/rmiss as one jitted fn.

Wavefront restructuring of the reference's RT pipeline:

  simple.rgen (per-pixel recursion driver)  ->  SoA wavefront [N = W*H] with
                                                an alive mask, bounce loop as
                                                a fori_loop under one jit
  traceRayEXT hardware traversal            ->  ops/traverse.intersect_bvh
  simple.rchit (surface shading + NEE/MIS)  ->  _shade(): masked lockstep
                                                port of every branch
  rayQueryEXT shadow rays                   ->  ops/traverse.occlusion_bvh
  simple.rmiss                              ->  miss-mask branch
  rgba32f accumulation image                ->  accum f32[N,3] carried state

Faithfulness notes (constants all from shaders/simple.rgen + simple.rchit):
  - Two RNG streams per pixel, as in the reference: the rgen-local seed
    (jitter + russian roulette) and payload.seed (all shading draws) split
    after the jitter draws (simple.rgen:71-79). Masked draws keep each
    lane's stream identical to the reference's serial consumption order.
  - Russian roulette only from depth >= 3, luminance-driven p in [.05,.95]
    (simple.rgen:55-68) — dead code at MAX_DEPTH=3, live at depth 8+.
  - The reference's quirk of adding the background when a *hit* surface
    fails to produce a BSDF sample (rchit sets payload.hit=false at
    simple.rchit:701-703, and rgen then runs its miss branch at
    simple.rgen:106-109) is reproduced bit-for-bit.
  - Emissive-hit MIS uses the *previous* bounce's p_sample_light /
    didDirectIllumination / brdf pdf (payload fields are only overwritten
    after the emissive block — simple.rchit:641-691).
  - Radiance clamp 5.0 + NaN scrub, then running-mean accumulation
    (simple.rgen:121-136).

Extension beyond the reference (BASELINE config 3): dielectric transmission/
refraction driven by Material.transmission/ior, fields the reference declares
but never reads (ray_common.glsl:9-10). Scenes with transmission == 0
everywhere take the exact reference path (no extra RNG draws: the dielectric
branch replaces, not precedes, the standard lottery draw for such lanes).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer_tpu.ops import brdf, rng
from raytracer_tpu.ops.intersect import intersect_brute, occlusion_brute
from raytracer_tpu.ops.math3d import (
    cos_theta,
    cross,
    dot,
    dot_k,
    length,
    local_to_world,
    luminance_rec709,
    make_basis,
    mis_weight_power,
    normalize,
    world_to_local,
)
from raytracer_tpu.ops.traverse import intersect_bvh, occlusion_bvh
from raytracer_tpu.utils.config import RenderConfig


class WavefrontState(NamedTuple):
    """The RayPayload SoA (ray_common.glsl:13-26) + the rgen-local loop
    state, one lane per pixel."""

    origin: jnp.ndarray  # f32[N,3]
    direction: jnp.ndarray  # f32[N,3]
    color: jnp.ndarray  # f32[N,3]
    throughput: jnp.ndarray  # f32[N,3]
    seed_rgen: jnp.ndarray  # u32[N] rgen-local stream (jitter/RR)
    seed: jnp.ndarray  # u32[N] payload.seed stream (shading)
    alive: jnp.ndarray  # bool[N]
    first_bounce: jnp.ndarray  # bool[N]
    is_specular: jnp.ndarray  # bool[N]
    prev_brdf_pdf: jnp.ndarray  # f32[N]
    prev_hit_pos: jnp.ndarray  # f32[N,3]
    p_sample_light: jnp.ndarray  # f32[N]
    did_direct: jnp.ndarray  # bool[N]
    # Spectral channel lock for dispersion (-1 = broadband): after the first
    # dispersive refraction a path follows one RGB channel's IOR.
    channel: jnp.ndarray  # i32[N]


def _camera_rays(inverse_view, inverse_proj, width, height, jitter,
                 pixel_idx):
    """calculateCameraRay (simple.rgen:41-53) for the given pixels.

    jitter: f32[N,2] subpixel offset (already includes the 0.5 center);
    pixel_idx: u32[N] global raster-order pixel indices."""
    idx = pixel_idx.astype(jnp.int32)
    px = (idx % width).astype(jnp.float32)
    py = (idx // width).astype(jnp.float32)
    n = idx.shape[0]
    pixel_center = jnp.stack([px, py], axis=-1) + jitter
    in_uv = pixel_center / jnp.asarray([width, height], jnp.float32)
    d = in_uv * 2.0 - 1.0

    origin = jnp.broadcast_to(inverse_view[:3, 3], (n, 3))
    target_h = (
        inverse_proj[:3, 0] * d[:, 0:1]
        + inverse_proj[:3, 1] * d[:, 1:2]
        + inverse_proj[:3, 2]
        + inverse_proj[:3, 3]
    )
    t = normalize(target_h)
    # HIGHEST keeps the product in true f32 on backends whose default
    # matmul precision is lower (TF32 on tensor cores).
    direction = jnp.matmul(t, inverse_view[:3, :3].T,
                           precision=jax.lax.Precision.HIGHEST)
    return origin, normalize(direction)


def _trace(scene, origin, direction, cfg: RenderConfig, active):
    if cfg.accel == "brute":
        rec = intersect_brute(
            origin, direction, scene.tri_v0, scene.tri_e1, scene.tri_e2,
            cfg.t_min, cfg.t_max,
        )
        return rec._replace(
            hit=rec.hit & active, tri=jnp.where(active, rec.tri, -1)
        )
    return intersect_bvh(
        origin, direction, scene, cfg.t_min, cfg.t_max,
        leaf_size=cfg.bvh_leaf_size, active_mask=active,
    )


def _occluded(scene, origin, direction, t_max, skip_object, cfg, active):
    if cfg.accel == "brute":
        occ = occlusion_brute(
            origin, direction, cfg.t_min, t_max,
            scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_object,
            skip_object,
        )
        return occ & active
    return occlusion_bvh(
        origin, direction, cfg.t_min, t_max, scene, skip_object,
        leaf_size=cfg.bvh_leaf_size, active_mask=active,
    )


def _light_weights(scene, hit_pos, skip_object, cfg: RenderConfig,
                   w_all=None):
    """Power/distance² light weights over the first min(L, MAXLIGHTS) lights
    (computeLightWeight/computeTotalLightWeight, simple.rchit:507-534).
    Returns ([N,Lc] weights with `skip_object` zeroed, [N] total).

    `w_all` (the un-skipped [N,Lc] weights from a previous call at the SAME
    hit positions) skips the [N,L,3] distance pass: the skip-zeroing is the
    last op, so deriving from w_all is bit-identical — the NEE and
    emissive-MIS blocks share one distance pass per bounce."""
    l_used = min(scene.num_lights, cfg.max_lights)
    light_objs = scene.light_object[:l_used]
    if w_all is None:
        w_all = _light_weights_base(scene, hit_pos, cfg)
    w = jnp.where(light_objs[None, :] == skip_object[:, None], 0.0, w_all)
    return w, jnp.sum(w, axis=-1)


def _light_weights_base(scene, hit_pos, cfg: RenderConfig):
    """Un-skipped power/dist² weights [N,Lc], in COLUMN form: the obvious
    `sum((pos[:,None,:]-centers)**2, -1)` materializes an [N,L,3] block and
    reduces over the minor size-3 axis, which XLA lowers ~7x slower than
    three [N,L] column FMAs (measured 72 -> ~11 ms/bounce at 1080p). The
    adds keep the reduce's left-to-right order, so values are bit-identical."""
    l_used = min(scene.num_lights, cfg.max_lights)
    centers = scene.light_center[:l_used]
    powers = scene.light_power[:l_used]
    dx = hit_pos[:, 0:1] - centers[None, :, 0]
    dy = hit_pos[:, 1:2] - centers[None, :, 1]
    dz = hit_pos[:, 2:3] - centers[None, :, 2]
    dist_sq = dx * dx + dy * dy + dz * dz
    return powers[None, :] / jnp.maximum(dist_sq, 0.001)


def _sample_light(scene, sel, hit_pos, seed, active, cfg: RenderConfig):
    """sampleLight (simple.rchit:239-322): pick a uniform triangle of light
    `sel` (i32[N]), area-sample it with sqrt-barycentrics, return the sample
    and the solid-angle pdf. Consumes 3 masked draws.

    TWO gathers total (meta row + light-tri row): XLA gathers are
    row-throughput-bound (~25 ns/row at 2M lanes), so the 6 narrow gathers
    this used to issue cost ~300 ms/bounce at 1080p — the packed tables are
    the NEE analog of tri_shade/mat_packed."""
    l_used = min(scene.num_lights, cfg.max_lights)
    sel_c = jnp.clip(sel, 0, l_used - 1)
    meta = scene.light_meta_packed[sel_c]  # [N,8] — gather 1
    first = meta[:, 0].astype(jnp.int32)
    num_tris = meta[:, 1].astype(jnp.int32)

    r_tri, seed = rng.rnd_masked(seed, active)
    tri_local = jnp.minimum(
        (r_tri * num_tris.astype(jnp.float32)).astype(jnp.int32),
        num_tris - 1,
    )
    ti = jnp.clip(first + tri_local, 0, scene.light_tri_packed.shape[0] - 1)
    trow = scene.light_tri_packed[ti]  # [N,16] — gather 2
    v0 = trow[:, 0:3]
    e1 = trow[:, 3:6]
    e2 = trow[:, 6:9]

    r1, seed = rng.rnd_masked(seed, active)
    r2, seed = rng.rnd_masked(seed, active)
    sqrt_r1 = jnp.sqrt(r1)
    bu = 1.0 - sqrt_r1
    bv = sqrt_r1 * (1.0 - r2)
    bw = sqrt_r1 * r2
    pos = bu[:, None] * v0 + bv[:, None] * (v0 + e1) + bw[:, None] * (v0 + e2)

    face_n = cross(e1, e2)
    normal = normalize(face_n)
    to_surface = normalize(hit_pos - pos)
    cos_l = dot(normal, to_surface)
    normal = jnp.where((cos_l < 0.0)[:, None], -normal, normal)
    cos_l = jnp.abs(cos_l)

    to_light = pos - hit_pos
    dist = jnp.maximum(length(to_light), 0.01)
    direction = to_light / dist[:, None]
    area = 0.5 * length(face_n)
    cos_theta_l = jnp.maximum(0.0, dot(-direction, normal))

    valid = (cos_l > 0.0) & (cos_theta_l > 1e-6) & (num_tris > 0)
    pdf = (
        (1.0 / jnp.maximum(num_tris.astype(jnp.float32), 1.0))
        * (1.0 / jnp.maximum(area, 1e-20))
        * dist * dist / jnp.maximum(cos_theta_l, 1e-20)
    )
    emission = meta[:, 2:5]
    light_obj = meta[:, 5].astype(jnp.int32)
    return pos, normal, direction, dist, pdf, emission, light_obj, valid, seed


class SurfaceHit(NamedTuple):
    """Interpolated hit surface + material fetch (simple.rchit:590-614) —
    shared by the standard shader and the ReSTIR G-buffer pass."""

    world_pos: jnp.ndarray  # f32[N,3]
    world_nrm: jnp.ndarray  # f32[N,3] face-forward flipped
    front_facing: jnp.ndarray  # bool[N]
    tri: jnp.ndarray  # i32[N] clipped triangle index
    e1: jnp.ndarray  # f32[N,3] (for emissive-hit area pdf)
    e2: jnp.ndarray  # f32[N,3]
    obj: jnp.ndarray  # i32[N]
    mat: jnp.ndarray  # i32[N]
    albedo: jnp.ndarray  # f32[N,3]
    roughness: jnp.ndarray  # f32[N]
    metallic: jnp.ndarray  # f32[N]
    emission_color: jnp.ndarray  # f32[N,3]
    emission_power: jnp.ndarray  # f32[N]
    transmission: jnp.ndarray  # f32[N]
    ior: jnp.ndarray  # f32[N]
    dispersion: jnp.ndarray  # f32[N]
    light_index: jnp.ndarray  # i32[N] owning object's light (-1 if none)
    light_num_tris: jnp.ndarray  # f32[N] that light's triangle count


def fetch_surface(scene, hit, ray_dir, lane) -> SurfaceHit:
    """Barycentric interpolation of the hit triangle + material lookup.

    TWO gathers total: XLA gathers are row-throughput-bound, so triangle
    shading data and materials are packed into single rows at bake
    (tri_shade f32[T,24], mat_packed f32[M,16])."""
    t_count = scene.tri_shade.shape[0]
    ti = jnp.clip(hit.tri, 0, t_count - 1)
    row = scene.tri_shade[ti]  # [N,24] — gather 1
    v0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    bary_u = hit.u[:, None]
    bary_v = hit.v[:, None]
    world_pos = v0 + bary_u * e1 + bary_v * e2
    bw = 1.0 - bary_u - bary_v
    n_interp = (
        bw * row[:, 9:12] + bary_u * row[:, 12:15] + bary_v * row[:, 15:18]
    )
    world_nrm = normalize(n_interp)
    front_facing = dot(world_nrm, -ray_dir) > 0.0
    world_nrm = jnp.where(front_facing[:, None], world_nrm, -world_nrm)
    obj = jnp.where(lane, row[:, 18].astype(jnp.int32), 0)
    mat = jnp.where(lane, row[:, 19].astype(jnp.int32), 0)
    mrow = scene.mat_packed[mat]  # [N,16] — gather 2
    return SurfaceHit(
        world_pos=world_pos,
        world_nrm=world_nrm,
        front_facing=front_facing,
        tri=ti,
        e1=e1,
        e2=e2,
        obj=obj,
        mat=mat,
        albedo=mrow[:, 0:3],
        roughness=mrow[:, 7],
        metallic=mrow[:, 8],
        emission_color=mrow[:, 3:6],
        emission_power=mrow[:, 6],
        transmission=mrow[:, 9],
        ior=mrow[:, 10],
        dispersion=mrow[:, 11],
        light_index=row[:, 20].astype(jnp.int32),
        light_num_tris=row[:, 21],
    )


def _shade(scene, state: WavefrontState, hit, cfg: RenderConfig,
           suppress_nee: bool = False):
    """The simple.rchit port. `hit` is the traversal HitRecord; lanes where
    `state.alive & hit.hit` run shading, everything else is masked out.

    `suppress_nee=True` (static) skips the NEE lottery + draws entirely and
    marks shaded lanes did_direct so the next bounce's emissive-hit MIS stays
    off — used when ReSTIR supplies the direct lighting at this vertex.

    Returns (new_state, payload_hit bool[N], shadow_ray_count)."""
    lane = state.alive & hit.hit
    n = state.origin.shape[0]

    surf = fetch_surface(scene, hit, state.direction, lane)
    world_pos = surf.world_pos
    world_nrm = surf.world_nrm
    ray_dir = state.direction
    e1 = surf.e1
    e2 = surf.e2
    obj = surf.obj
    albedo = surf.albedo
    roughness = surf.roughness
    metallic = surf.metallic
    emission_color = surf.emission_color
    emission_power = surf.emission_power
    transmission = surf.transmission
    ior = surf.ior
    is_emissive = emission_power > 0.0

    color = state.color
    throughput = state.throughput
    seed = state.seed

    basis = make_basis(world_nrm)
    wo_local = world_to_local(-ray_dir, basis)

    # --- dielectric lanes (extension; see module docstring) ---
    if cfg.enable_transmission:
        dielectric = lane & (transmission > 0.0)
    else:
        dielectric = jnp.zeros(n, bool)
    surface_lane = lane & ~dielectric

    # --- NEE with MIS (simple.rchit:618-632) ---
    did_direct = jnp.zeros(n, bool)
    p_sample_light = jnp.clip(roughness, 0.1, 0.9)
    # One power/dist² distance pass per bounce, shared bit-identically by
    # the NEE selection (skip-zeroed view) and the emissive-MIS selection
    # pdf (un-skipped view) — the zeroing is _light_weights' last op.
    if cfg.use_direct_lighting and scene.num_lights > 0:
        w_base = _light_weights_base(scene, world_pos, cfg)
    else:
        w_base = None
    if suppress_nee:
        # ReSTIR owns direct lighting at this vertex; flag lanes did_direct
        # so the next bounce's emissive-hit MIS path stays suppressed.
        did_direct = surface_lane
        shadow_rays = jnp.int32(0)
    elif cfg.use_direct_lighting and scene.num_lights > 0:
        # Light-only mode (USE_LIGHT_SAMPLING_ONLY semantics) behaves like
        # the USE_MIS=0 estimator for direct light: deterministic NEE,
        # weight 1, no lottery draw.
        mis_nee = cfg.use_mis and not cfg.use_light_sampling_only
        if mis_nee:
            # Stochastic NEE lottery (simple.rchit:621-623).
            p_draw, seed = rng.rnd_masked(seed, surface_lane)
            do_nee = surface_lane & (p_draw < p_sample_light)
        else:
            # USE_MIS=0 (simple.rchit:628-631): NEE every bounce, weight 1.
            do_nee = surface_lane

        weights, total_w = _light_weights(scene, world_pos, obj, cfg,
                                          w_all=w_base)
        has_weight = total_w > 0.0
        m_sel = do_nee & has_weight
        r_sel, seed = rng.rnd_masked(seed, m_sel)
        r1 = r_sel * total_w
        cs = jnp.cumsum(weights, axis=1)
        found = jnp.any(cs >= r1[:, None], axis=1)
        selected = jnp.argmax(cs >= r1[:, None], axis=1).astype(jnp.int32)
        m_samp = m_sel & found

        l_used = min(scene.num_lights, cfg.max_lights)
        sel_c = jnp.clip(selected, 0, l_used - 1)
        sel_w = jnp.take_along_axis(weights, sel_c[:, None], axis=1)[:, 0]
        light_sel_pdf = sel_w / jnp.maximum(total_w, 1e-20)

        (l_pos, _l_nrm, l_dir, _l_dist, l_pdf, l_emission, light_obj,
         l_valid, seed
         ) = _sample_light(scene, selected, world_pos, seed, m_samp, cfg)

        wi_local = world_to_local(l_dir, basis)
        consider = m_samp & l_valid & (cos_theta(wi_local) > 1e-4)

        # Shadow ray (isVisibleRQ, simple.rchit:350-385).
        eps = 0.001
        to_light_n = normalize(l_pos - world_pos)
        offset_from = world_pos + world_nrm * (
            eps * jnp.sign(dot_k(world_nrm, to_light_n))
        )
        sr = l_pos - offset_from
        sr_dist = length(sr)
        sr_dir = sr / jnp.maximum(sr_dist, 1e-20)[:, None]
        occ = _occluded(
            scene, offset_from, sr_dir, sr_dist * 0.999, light_obj, cfg,
            consider & (sr_dist > 0.0),
        )
        visible = consider & (sr_dist > 0.0) & ~occ

        brdf_val = brdf.evaluate_full(wo_local, wi_local, albedo, roughness,
                                      metallic)
        light_pdf = l_pdf * light_sel_pdf
        p_spec = brdf.specular_probability(albedo, roughness, metallic)
        h_local = normalize(wo_local + wi_local)
        spec_pdf = brdf.microfacet_pdf(wo_local, h_local, roughness)
        diff_pdf = cos_theta(wi_local) / brdf.M_PI
        brdf_pdf = p_spec * spec_pdf + (1.0 - p_spec) * diff_pdf
        if mis_nee:
            weight = mis_weight_power(light_pdf, brdf_pdf)
        else:
            weight = jnp.ones_like(light_pdf)  # evaluateLightMIS else-branch

        radiance = (
            brdf_val * l_emission
            * (cos_theta(wi_local) * weight
               / jnp.maximum(light_pdf, 1e-6))[:, None]
        )
        if mis_nee:
            # Stochastic-NEE unbiasing divide (simple.rchit:625).
            contrib = throughput * radiance / p_sample_light[:, None]
        else:
            contrib = throughput * radiance
        color = jnp.where(visible[:, None], color + contrib, color)
        did_direct = do_nee
        shadow_rays = jnp.sum((consider & (sr_dist > 0.0)).astype(jnp.int32))
    elif (cfg.use_direct_lighting and cfg.use_mis
          and not cfg.use_light_sampling_only):
        # No lights: the NEE lottery draw still happens (simple.rchit:622).
        _, seed = rng.rnd_masked(seed, surface_lane)
        shadow_rays = jnp.int32(0)
    else:
        shadow_rays = jnp.int32(0)

    # --- BSDF sampling (simple.rchit:634-639 -> sampleBRDF) ---
    sample, seed_after_brdf = brdf.sample_brdf(
        wo_local, albedo, roughness, metallic, seed
    )
    # Only surface lanes consume the 3 draws; dielectric lanes consume their
    # own draws below.
    seed_surface = jnp.where(surface_lane, seed_after_brdf, seed)

    # --- emissive-hit handling (simple.rchit:641-686) ---
    if (cfg.use_direct_lighting and cfg.use_mis
            and not cfg.use_light_sampling_only):
        add_full = surface_lane & is_emissive & (
            state.first_bounce | state.is_specular
        )
        color = jnp.where(
            add_full[:, None],
            color + throughput * emission_color * emission_power[:, None],
            color,
        )
        if scene.num_lights > 0:
            # Owning-light index + triangle count ride in the tri_shade row
            # (no extra gathers).
            light_idx = surf.light_index
            add_mis = (
                surface_lane & is_emissive
                & ~(state.first_bounce | state.is_specular)
                & ~state.did_direct & (light_idx >= 0)
            )
            d = length(world_pos - state.prev_hit_pos)
            cos_light = jnp.maximum(0.0, dot(world_nrm, -ray_dir))
            tri_area = 0.5 * length(cross(e1, e2))
            num_tris_l = surf.light_num_tris
            pdf_geo = (
                (1.0 / jnp.maximum(num_tris_l, 1.0))
                * (1.0 / jnp.maximum(tri_area, 1e-20))
                * d * d / jnp.maximum(cos_light, 1e-20)
            )
            # computeLightSelectionPdf uses the un-skipped total
            # (simple.rchit:536-541); reuses the bounce's one distance pass.
            w_all, _ = _light_weights(
                scene, world_pos, jnp.full((n,), -1, jnp.int32), cfg,
                w_all=w_base,
            )
            total_all = jnp.sum(w_all, axis=-1)
            l_used = min(scene.num_lights, cfg.max_lights)
            li_cap = jnp.clip(light_idx, 0, l_used - 1)
            w_this = jnp.take_along_axis(w_all, li_cap[:, None], axis=1)[:, 0]
            light_sel = jnp.where(
                total_all > 0.0, w_this / jnp.maximum(total_all, 1e-20), 0.0
            )
            light_pdf_hit = light_sel * pdf_geo
            mis_w = mis_weight_power(state.prev_brdf_pdf, light_pdf_hit)
            contrib = (
                throughput * emission_color
                * (emission_power * mis_w
                   / jnp.maximum(1.0 - state.p_sample_light, 1e-20))[:, None]
            )
            color = jnp.where(add_mis[:, None], color + contrib, color)
    else:
        add_full = surface_lane & is_emissive
        if cfg.use_direct_lighting:  # USE_MIS=0 branch (simple.rchit:679-681)
            add_full = add_full & (state.first_bounce | state.is_specular)
        color = jnp.where(
            add_full[:, None],
            color + throughput * emission_color * emission_power[:, None],
            color,
        )

    # --- bounce update (simple.rchit:693-703) ---
    sample_ok = (sample.pdf > 0.0) & (cos_theta(sample.direction) > 0.0)
    new_dir_surface = local_to_world(sample.direction, basis)
    tp_scale = (cos_theta(sample.direction) / sample.pdf)[:, None] * sample.value

    # --- dielectric transmission lanes (extension) ---
    if cfg.enable_transmission:
        dispersion = surf.dispersion
        (diel_dir, diel_tp, diel_ok, new_channel, seed_diel) = (
            _sample_dielectric(
                ray_dir, world_nrm, surf.front_facing, albedo, ior,
                transmission, dispersion, state.channel, seed, dielectric,
            )
        )
        seed = jnp.where(dielectric, seed_diel, seed_surface)
        new_dir = jnp.where(dielectric[:, None], diel_dir, new_dir_surface)
        tp_mult = jnp.where(dielectric[:, None], diel_tp, tp_scale)
        sample_ok = jnp.where(dielectric, diel_ok, sample_ok)
        new_specular = jnp.where(dielectric, True, sample.is_specular)
        new_pdf = jnp.where(dielectric, 1.0, sample.pdf)
        channel = jnp.where(dielectric, new_channel, state.channel)
    else:
        seed = seed_surface
        new_dir = new_dir_surface
        tp_mult = tp_scale
        new_specular = sample.is_specular
        new_pdf = sample.pdf
        channel = state.channel

    upd = lane & sample_ok
    throughput = jnp.where(upd[:, None], throughput * tp_mult, throughput)

    new_state = WavefrontState(
        origin=jnp.where(upd[:, None], world_pos, state.origin),
        direction=jnp.where(upd[:, None], new_dir, state.direction),
        color=jnp.where(lane[:, None], color, state.color),
        throughput=throughput,
        seed_rgen=state.seed_rgen,
        seed=jnp.where(lane, seed, state.seed),
        alive=state.alive,
        first_bounce=jnp.where(lane, False, state.first_bounce),
        is_specular=jnp.where(upd, new_specular, state.is_specular),
        prev_brdf_pdf=jnp.where(upd, new_pdf, state.prev_brdf_pdf),
        prev_hit_pos=jnp.where(upd[:, None], world_pos, state.prev_hit_pos),
        p_sample_light=jnp.where(lane, p_sample_light, state.p_sample_light),
        did_direct=jnp.where(lane, did_direct, state.did_direct),
        channel=channel,
    )
    payload_hit = lane & sample_ok
    return new_state, payload_hit, shadow_rays


def _sample_dielectric(ray_dir, normal, front_facing, albedo, ior,
                       transmission, dispersion, channel, seed, active):
    """Smooth dielectric BSDF (reflection/refraction), extension lanes only.

    Consumes 2 masked draws (transmit lottery + Fresnel lottery) plus one
    masked draw on the first dispersive event (spectral channel pick).
    Delta lobes: throughput multiplier already includes value*cos/pdf.

    Dispersion (KHR_materials_dispersion semantics: D = 20/Abbe):
    nF - nC = (ior - 1) * D / 20; channels use ior + {-1/2, 0, +1/2} of that
    spread for R/G/B. The first dispersive refraction locks the path to one
    channel (prob 1/3 each, throughput x3 in that channel) — the standard
    spectral-RGB estimator."""
    is_dispersive = dispersion > 0.0
    need_channel = active & is_dispersive & (channel < 0)
    r_chan, seed = rng.rnd_masked(seed, need_channel)
    picked = jnp.minimum((r_chan * 3.0).astype(jnp.int32), 2)
    channel = jnp.where(need_channel, picked, channel)

    spread = (ior - 1.0) * dispersion / 20.0
    # R (nC, long wavelength) < G (nd) < B (nF, short wavelength).
    chan_offset = (
        jnp.where(channel == 0, -0.5, jnp.where(channel == 2, 0.5, 0.0))
    )
    ior_eff = jnp.where(
        is_dispersive & (channel >= 0), ior + chan_offset * spread, ior
    )

    r_lottery, seed = rng.rnd_masked(seed, active)
    r_fresnel, seed = rng.rnd_masked(seed, active)

    ior = ior_eff
    eta = jnp.where(front_facing, 1.0 / ior, ior)
    cos_i = jnp.clip(dot(-ray_dir, normal), 0.0, 1.0)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))

    f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    fresnel = f0 + (1.0 - f0) * jnp.power(1.0 - cos_i, 5.0)
    fresnel = jnp.where(tir, 1.0, fresnel)

    refl_dir = normalize(ray_dir + 2.0 * cos_i[:, None] * normal)
    refr_dir = normalize(
        eta[:, None] * ray_dir + (eta * cos_i - cos_t)[:, None] * normal
    )

    take_transmit = r_lottery < transmission
    reflect_lobe = ~take_transmit | (r_fresnel < fresnel)
    new_dir = jnp.where(reflect_lobe[:, None], refl_dir, refr_dir)
    # Reflection off the dielectric is untinted; transmission is tinted by
    # albedo (absorption proxy). Delta lobes with lottery-matched pdfs cancel.
    tp = jnp.where(
        reflect_lobe[:, None],
        jnp.ones_like(albedo),
        albedo,
    )
    # Spectral channel lock: on the first dispersive refraction the path
    # keeps one channel's energy (x3 unbiased weight).
    chan_onehot = (
        jnp.arange(3)[None, :] == channel[:, None]
    ).astype(jnp.float32) * 3.0
    tp = jnp.where(need_channel[:, None], tp * chan_onehot, tp)
    ok = jnp.ones_like(take_transmit)
    return new_dir, tp, ok, channel, seed


def primary_state(camera_ubo, frame_number, cfg: RenderConfig, pixel_idx,
                  active=None) -> WavefrontState:
    """Camera rays and fresh per-lane path state for the global pixel ids
    `pixel_idx` (u32[N]) — the rgen prologue (simple.rgen:70-86).
    `frame_number` is a scalar or a per-lane u32[N] vector."""
    n = pixel_idx.shape[0]
    frame_u32 = jnp.asarray(frame_number, jnp.uint32)
    seed0 = rng.seed_pixels(pixel_idx, frame_u32)

    # Jitter (getSampleOffset, simple.rgen:25-38): center on frame 0, else
    # 0.4-amplitude. Two masked draws keep stream alignment. The per-lane
    # mask form is bit-identical to the scalar-predicate original for
    # scalar frames (all-true / all-false mask).
    jitter_mask = jnp.broadcast_to(frame_u32 > 0, (n,))
    r1, seed_rgen = rng.rnd_masked(seed0, jitter_mask)
    r2, seed_rgen = rng.rnd_masked(seed_rgen, jitter_mask)
    jitter = jnp.where(
        jitter_mask[:, None],
        0.5 + (jnp.stack([r1, r2], axis=-1) - 0.5) * 0.4,
        jnp.full((n, 2), 0.5, jnp.float32),
    )

    origin, direction = _camera_rays(
        camera_ubo["inverse_view"], camera_ubo["inverse_proj"],
        cfg.width, cfg.height, jitter, pixel_idx,
    )
    return WavefrontState(
        origin=origin,
        direction=direction,
        color=jnp.zeros((n, 3), jnp.float32),
        throughput=jnp.ones((n, 3), jnp.float32),
        seed_rgen=seed_rgen,
        seed=seed_rgen,
        alive=(jnp.ones((n,), bool) if active is None
               else jnp.asarray(active, bool)),
        first_bounce=jnp.ones((n,), bool),
        is_specular=jnp.zeros((n,), bool),
        prev_brdf_pdf=jnp.ones((n,), jnp.float32),
        prev_hit_pos=jnp.zeros((n, 3), jnp.float32),
        p_sample_light=jnp.zeros((n,), jnp.float32),
        did_direct=jnp.zeros((n,), bool),
        channel=jnp.full((n,), -1, jnp.int32),
    )


def end_of_bounce(state: WavefrontState, payload_hit, cfg: RenderConfig):
    """After shading: the miss branch (simple.rgen:106-109, including the
    failed-BSDF-sample quirk — payload.hit=false from rchit) and the
    throughput validity kill (simple.rgen:115-118)."""
    clear_color = jnp.asarray(cfg.background, jnp.float32)
    missed = state.alive & ~payload_hit
    state = state._replace(
        color=jnp.where(
            missed[:, None],
            state.color + state.throughput * clear_color,
            state.color,
        ),
        alive=state.alive & payload_hit,
    )
    tp = state.throughput
    bad = (
        jnp.any(jnp.isnan(tp) | jnp.isinf(tp), axis=-1)
        | jnp.all(tp < 0.001, axis=-1)
    )
    return state._replace(alive=state.alive & ~bad)


def trace_bounce(scene, state: WavefrontState, depth, cfg: RenderConfig):
    """One full bounce of the wavefront: russian roulette, closest-hit
    trace, shading with NEE, then end_of_bounce. Returns
    (state, rays_traced, shadow_rays)."""
    # Russian roulette (simple.rgen:55-68,88-90).
    rr_lane = state.alive & (depth >= cfg.rr_start_depth)
    lum = luminance_rec709(state.throughput)
    p = jnp.minimum(jnp.maximum(lum, 0.05), 0.95)
    r, seed_rgen = rng.rnd_masked(state.seed_rgen, rr_lane)
    rr_kill = rr_lane & (r > p)
    throughput = jnp.where(
        (rr_lane & ~rr_kill)[:, None], state.throughput / p[:, None],
        state.throughput,
    )
    state = state._replace(
        seed_rgen=seed_rgen,
        throughput=throughput,
        alive=state.alive & ~rr_kill,
    )

    rays_traced = jnp.sum(state.alive.astype(jnp.int32))
    hit = _trace(scene, state.origin, state.direction, cfg, state.alive)
    state, payload_hit, shadow_rays = _shade(scene, state, hit, cfg)
    return end_of_bounce(state, payload_hit, cfg), rays_traced, shadow_rays


def finish_radiance(state: WavefrontState, cfg: RenderConfig):
    """Clamp + NaN scrub (simple.rgen:121-125)."""
    final = jnp.minimum(state.color, cfg.radiance_clamp)
    invalid = jnp.any(jnp.isnan(final) | jnp.isinf(final), axis=-1)
    return jnp.where(invalid[:, None], 0.0, final)


def render_wavefront(scene, camera_ubo, frame_number, cfg: RenderConfig,
                     pixel_start=0, num_pixels=None, with_stats: bool = False,
                     active=None, pixel_indices=None):
    """One progressive sample for a contiguous pixel range: returns radiance
    f32[N,3] (and a stats dict when with_stats=True).

    This is the body of simple.rgen:70-125 (everything but accumulation).
    `pixel_start`/`num_pixels` carve out a tile for multi-chip sharding
    (parallel/sharding.py): seeds and camera rays use GLOBAL pixel indices so
    a sharded render is bit-identical to a single-chip one.

    `pixel_indices` (u32[N], overrides pixel_start/num_pixels) renders an
    arbitrary — strided, repeated — set of global pixel ids: strided tiles
    for width-vs-rate measurement, and repeated
    ids with a per-lane `frame_number` vector batch S progressive samples
    of one tile into a single launch (spp batching restores wavefront
    width on small per-chip tiles). Lanes are per-pixel independent, so
    each lane's radiance is bit-identical to the same (pixel, frame) lane
    of any other launch shape.

    `frame_number` may be a PER-PIXEL u32[N] vector (adaptive sampling:
    each pixel's sample count is its own frame index, so seeds and the
    frame-0 centered jitter stay per-pixel-correct). `active` (bool[N])
    masks lanes out of the whole sample — their radiance is garbage and
    the caller must not accumulate it (integrator/adaptive.py); lanes are
    per-pixel independent, so active lanes are bit-identical to a run
    without the mask."""
    cfg = cfg.resolve_accel()
    if pixel_indices is not None:
        pixel_idx = jnp.asarray(pixel_indices, jnp.uint32)
    else:
        n = cfg.num_pixels if num_pixels is None else num_pixels
        pixel_idx = (
            jnp.asarray(pixel_start, jnp.uint32)
            + jnp.arange(n, dtype=jnp.uint32)
        )
    state = primary_state(camera_ubo, frame_number, cfg, pixel_idx, active)

    def bounce(depth, carry):
        state, rays_traced, shadow_total = carry
        state, rays, shadows = trace_bounce(scene, state, depth, cfg)
        return state, rays_traced + rays, shadow_total + shadows

    state, rays_traced, shadow_total = jax.lax.fori_loop(
        0, cfg.max_depth, bounce, (state, jnp.int32(0), jnp.int32(0))
    )
    radiance = finish_radiance(state, cfg)
    if with_stats:
        return radiance, {
            "rays_traced": rays_traced,
            "shadow_rays": shadow_total,
            "total_rays": rays_traced + shadow_total,
        }
    return radiance


def accumulate(accum, radiance, frame_number):
    """The progressive running mean (simple.rgen:127-136): frame 0 stores,
    later frames blend with weight 1/(frame+1). The ONE accumulation formula
    — wavefront, ReSTIR, sharded and adaptive paths all share it.

    `frame_number` may be a per-pixel u32[N] vector (adaptive sampling:
    each pixel blends at its own count) — the scalar form broadcasts to
    exactly the same per-element arithmetic."""
    frame_f = jnp.asarray(frame_number, jnp.float32)
    a = 1.0 / (frame_f + 1.0)
    first = jnp.asarray(frame_number, jnp.uint32) == 0
    if frame_f.ndim == 1:
        a = a[:, None]
        first = first[:, None]
    return jnp.where(first, radiance, accum + (radiance - accum) * a)


def render_tile_spp_batched(scene, camera_ubo, accum_tile, frame_number,
                            cfg: RenderConfig, pixel_start=0, n_local=None):
    """cfg.spp_batch progressive samples of one contiguous pixel tile in a
    SINGLE wavefront launch: pixel ids repeated S times with a per-lane
    frame vector frame_number + [0..S), folded into the accumulation by S
    applications of the one sequential formula (`accumulate`) — so the
    result matches S sequential `render_frame` steps up to XLA fusion
    reassociation (the suite's sharded-vs-single 1e-6 standard).

    Batching S samples restores the wavefront width a small per-device
    tile loses on a mesh. Lanes are per-pixel independent, so
    each lane's radiance is the same as the same (pixel, frame) lane of a
    1-spp launch."""
    S = cfg.spp_batch
    n = cfg.num_pixels if n_local is None else n_local
    pix = (jnp.asarray(pixel_start, jnp.uint32)
           + jnp.arange(n, dtype=jnp.uint32))
    frame_u32 = jnp.asarray(frame_number, jnp.uint32)
    frames = frame_u32 + jnp.repeat(
        jnp.arange(S, dtype=jnp.uint32), n, total_repeat_length=S * n
    )
    radiance = render_wavefront(
        scene, camera_ubo, frames, cfg, pixel_indices=jnp.tile(pix, S)
    )
    radiance = radiance.reshape(S, n, 3)
    for s in range(S):
        accum_tile = accumulate(
            accum_tile, radiance[s], frame_u32 + jnp.uint32(s)
        )
    return accum_tile


def render_frame(scene, camera_ubo, accum, frame_number, cfg: RenderConfig):
    """Progressive accumulation step (simple.rgen:127-136): returns the new
    accumulation buffer f32[N,3]. jit this (scene/cfg static via closure or
    static_argnums). With cfg.spp_batch = S > 1 the step renders S samples
    in one launch and advances the accumulation by S counts."""
    if cfg.spp_batch > 1:
        return render_tile_spp_batched(
            scene, camera_ubo, accum, frame_number, cfg
        )
    radiance = render_wavefront(scene, camera_ubo, frame_number, cfg)
    return accumulate(accum, radiance, frame_number)
