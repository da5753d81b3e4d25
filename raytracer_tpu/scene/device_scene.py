"""SceneOnDevice: the baked, device-resident scene pytree.

Device-resident equivalent of the reference's GPU-scene compiler
(`src/raytracer/gpu_scene.odin:45-428`): instead of per-mesh device buffers
addressed via buffer_device_address + a TLAS of instances, the whole scene is
flattened into padded SoA arrays at bake time:

  - all triangles pre-transformed to WORLD space (model matrix applied to
    positions, inverse-transpose to normals — scene.odin:213-224 semantics).
    Vertex normals are stored *unnormalized* (normal_matrix @ n): since
    normalize(M·Σb·n_i) == normalize(Σb·(M·n_i)), interpolating these and
    normalizing once reproduces simple.rchit:607-608 exactly.
  - triangles stored as (v0, e1, e2) for Möller–Trumbore, in BVH leaf order,
    padded to a lane-friendly multiple with degenerate (zero-area) triangles.
  - per-triangle object id; per-object material id (Object_GPU_Data,
    gpu_scene.odin:23-29, minus the device addresses which become indices).
  - material SoA (Material_Data SSBO, gpu_scene.odin:17-21,399-428).
  - light table built from emissive objects: object index, triangle range,
    world transform translation (= light center for the power/distance²
    selection weight, simple.rchit:507-520), emission — the analog of
    Light_GPU_Data/get_lights (gpu_scene.odin:31-36,603-623).
  - the flattened BVH (accel/bvh.py), replacing BLAS/TLAS.

The pytree is replicated on every chip (scenes are ≤ a few hundred MB);
pixel tiles are what gets sharded (parallel/sharding.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np

from raytracer_tpu.accel.bvh import BVH, build_bvh
from raytracer_tpu.scene.model import Scene

_PAD = 128  # pad triangle count to a lane multiple


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneOnDevice:
    # --- triangle geometry, world space, BVH leaf order, padded ---
    tri_v0: jax.Array  # f32[T,3]
    tri_e1: jax.Array  # f32[T,3]
    tri_e2: jax.Array  # f32[T,3]
    tri_n0: jax.Array  # f32[T,3] unnormalized world vertex normals
    tri_n1: jax.Array  # f32[T,3]
    tri_n2: jax.Array  # f32[T,3]
    tri_object: jax.Array  # i32[T] (-1 for padding)
    tri_material: jax.Array  # i32[T]

    # --- BVH (flattened skip-link layout) ---
    nodes_min: jax.Array  # f32[NN,3]
    nodes_max: jax.Array  # f32[NN,3]
    nodes_skip: jax.Array  # i32[NN]
    nodes_first: jax.Array  # i32[NN]
    nodes_count: jax.Array  # i32[NN]

    # --- packed single-gather layouts for the hot traversal loop ---
    # nodes_packed f32[NN,8]: min.xyz, max.xyz, bitcast(skip),
    #   bitcast(meta) with meta = ~leaf_block_id (< 0) for leaves and
    #   meta = right-child index (>= 0) for internal nodes.
    nodes_packed: jax.Array
    # tris_packed f32[NB, LEAF, 12]: leaf-blocked v0.xyz, e1.xyz, e2.xyz,
    #   bitcast(global tri index), bitcast(object), pad — ONE gather with [N]
    #   block ids fetches whole leaves; padding rows are degenerate (never
    #   intersect), so no count masking is needed in the hot loop.
    tris_packed: jax.Array
    # Shading fast path: ONE gather per hit instead of ~16 (XLA gathers are
    # row-throughput-bound, ~40-80M rows/s, so packing dominates shade cost).
    # tri_shade f32[T,24]: v0(3) e1(3) e2(3) n0(3) n1(3) n2(3) obj_f mat_f
    #   (ints as exact f32) + pad.
    # mat_packed f32[M,16]: albedo(3) emission_color(3) emission_power
    #   roughness metallic transmission ior dispersion + pad.
    tri_shade: jax.Array
    mat_packed: jax.Array

    # --- materials SoA ---
    mat_albedo: jax.Array  # f32[M,3]
    mat_emission_color: jax.Array  # f32[M,3]
    mat_emission_power: jax.Array  # f32[M]
    mat_roughness: jax.Array  # f32[M]
    mat_metallic: jax.Array  # f32[M]
    mat_transmission: jax.Array  # f32[M]
    mat_ior: jax.Array  # f32[M]
    mat_dispersion: jax.Array  # f32[M] (KHR_materials_dispersion)

    # --- lights (emissive objects) ---
    light_object: jax.Array  # i32[L]
    light_first_tri: jax.Array  # i32[L] into the *unsorted* light tri arrays
    light_num_tris: jax.Array  # i32[L]
    light_center: jax.Array  # f32[L,3] model-matrix translation column
    light_emission: jax.Array  # f32[L,3] emission_color * emission_power
    light_power: jax.Array  # f32[L] material emission_power (selection weight)
    # Light triangles in original (pre-BVH) order so [first, first+count)
    # ranges stay contiguous per light:
    light_tri_v0: jax.Array  # f32[LT,3]
    light_tri_e1: jax.Array  # f32[LT,3]
    light_tri_e2: jax.Array  # f32[LT,3]
    # Owning object per light-tri row (original pre-BVH triangle order), so
    # a ReSTIR reservoir can identify its sample by GLOBAL light-triangle id
    # (light = obj_light_index[light_tri_object[tri]]).
    light_tri_object: jax.Array  # i32[LT]

    # --- per-object light index (-1 if not a light), for emissive-hit MIS ---
    obj_light_index: jax.Array  # i32[O]

    # Single-row packed light tables: the NEE and ReSTIR samplers gather
    # per-lane light data, and XLA gathers are ROW-throughput-bound
    # (~40-80M rows/s — width is free), so 3-6 narrow gathers collapse into
    # one wide one (same trick as tri_shade/mat_packed).
    # light_meta_packed f32[L,8]: first_tri_f, num_tris_f, emission rgb,
    #   object_f, power, pad (ints exact as f32, < 2^24).
    # light_tri_packed f32[LT,16]: v0(3) e1(3) e2(3) object_f light_index_f
    #   light_num_tris_f, owning light's emission rgb (cols 12:15, kept
    #   fresh by update_materials), pad — original pre-BVH triangle order
    #   like light_tri_*.
    light_meta_packed: jax.Array
    light_tri_packed: jax.Array

    # --- static metadata ---
    num_triangles: int = dataclasses.field(metadata=dict(static=True))
    num_lights: int = dataclasses.field(metadata=dict(static=True))
    num_objects: int = dataclasses.field(metadata=dict(static=True))
    # Stable-shape (capacity-padded) bakes only: i32[4] device scalar array
    # [true_tris, true_lights, true_objects, true_refs]. Under
    # `bake_scene(stable_shapes=True)` every table is padded to a geometric
    # capacity bucket and the static counts above hold TABLE sizes, so small
    # topology edits (the reference's add/remove-object editor path,
    # ui.odin:350-484) re-bake into the SAME jit signature — no re-trace,
    # no re-compile. Host code needing exact counts reads this leaf.
    true_counts: jax.Array = None

    @property
    def num_nodes(self) -> int:
        return self.nodes_skip.shape[0]

def _pad_rows(a: np.ndarray, total: int, fill=0.0) -> np.ndarray:
    if len(a) == total:
        return a
    pad_shape = (total - len(a),) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])


def _bucket(n: int, align: int) -> int:
    """Geometric capacity bucket: round `n` up to a multiple of
    max(align, floor_pow2(n)/8). The FLOOR power of two bounds the slack
    at +12.5% (a ceil pow2 step would allow +25% just above a power of
    two); capacities are then stable under small growth, so repeated
    re-bakes of an edited scene keep identical array shapes — the point
    of stable_shapes bakes."""
    n = max(int(n), align)
    step = max(align, (1 << (n.bit_length() - 1)) // 8)
    return -(-n // step) * step


def _pack_traversal_arrays(bvh, v0, e1, e2, tri_object, leaf_size):
    """Build the single-gather traversal layouts.

    nodes_packed f32[NN,8] = min3, max3, bitcast(skip), bitcast(meta);
    tris_packed  f32[NB,LEAF,12] = leaf-blocked triangles with the global
    triangle index and object id bitcast into slots 9/10; padding rows are
    degenerate (v0=e1=e2=0 -> det=0, never hit) with object id -1.
    """
    nn = bvh.num_nodes
    is_leaf = bvh.nodes_count > 0
    leaf_ids = np.cumsum(is_leaf) - 1  # block id per node (valid at leaves)
    nb = max(1, int(is_leaf.sum()))

    # Internal node i's children in preorder: left = i+1, right = the end of
    # the left subtree = skip[i+1].
    right_child = np.zeros(nn, np.int32)
    if nn > 1:
        right_child[:-1] = bvh.nodes_skip[1:]
    meta = np.where(is_leaf, ~leaf_ids, right_child).astype(np.int32)
    nodes_packed = np.zeros((nn, 8), np.float32)
    nodes_packed[:, 0:3] = bvh.nodes_min
    nodes_packed[:, 3:6] = bvh.nodes_max
    nodes_packed[:, 6] = bvh.nodes_skip.view(np.float32)
    nodes_packed[:, 7] = meta.view(np.float32)

    tris_packed = np.zeros((nb, leaf_size, 12), np.float32)
    if is_leaf.any():
        lf = bvh.nodes_first[is_leaf].astype(np.int64)
        lc = np.minimum(bvh.nodes_count[is_leaf], leaf_size).astype(np.int64)
        idx = lf[:, None] + np.arange(leaf_size)
        valid = np.arange(leaf_size)[None, :] < lc[:, None]
        idxc = np.clip(idx, 0, len(v0) - 1)
        vm = valid[..., None]
        tris_packed[:, :, 0:3] = np.where(vm, v0[idxc], 0.0)
        tris_packed[:, :, 3:6] = np.where(vm, e1[idxc], 0.0)
        tris_packed[:, :, 6:9] = np.where(vm, e2[idxc], 0.0)
        tri_idx = np.where(valid, idxc, 0).astype(np.int32)
        obj_pad = np.where(valid, tri_object[idxc], -1).astype(np.int32)
        tris_packed[:, :, 9] = tri_idx.view(np.float32)
        tris_packed[:, :, 10] = obj_pad.view(np.float32)
    return nodes_packed, tris_packed


def _pack_tri_shade(v0, e1, e2, n0, n1, n2, obj, mat,
                    obj_light_index=None, obj_light_num=None):
    t = len(v0)
    out = np.zeros((t, 24), np.float32)
    out[:, 0:3] = v0
    out[:, 3:6] = e1
    out[:, 6:9] = e2
    out[:, 9:12] = n0
    out[:, 12:15] = n1
    out[:, 15:18] = n2
    out[:, 18] = obj.astype(np.float32)
    out[:, 19] = mat.astype(np.float32)
    # Owning object's light index (-1 if not a light) and that light's
    # triangle count ride along in the already-gathered row, so the
    # emissive-hit MIS path (simple.rchit:654-676) needs NO extra gathers.
    if obj_light_index is not None:
        oc = np.clip(obj, 0, len(obj_light_index) - 1)
        out[:, 20] = np.where(obj >= 0, obj_light_index[oc], -1).astype(
            np.float32)
        out[:, 21] = np.where(obj >= 0, obj_light_num[oc], 0).astype(
            np.float32)
    else:
        out[:, 20] = -1.0
    return out


def _pack_materials(materials):
    m = len(materials)
    out = np.zeros((m, 16), np.float32)
    for i, mt in enumerate(materials):
        out[i, 0:3] = mt.albedo
        out[i, 3:6] = mt.emission_color
        out[i, 6] = mt.emission_power
        out[i, 7] = mt.roughness
        out[i, 8] = mt.metallic
        out[i, 9] = mt.transmission
        out[i, 10] = mt.ior
        out[i, 11] = mt.dispersion
    return out


def bake_scene(scene: Scene, leaf_size: int = 8,
               device_put: bool = True,
               reuse_bvh: BVH = None,
               stable_shapes: bool = False) -> Tuple[SceneOnDevice, BVH]:
    """Flatten + world-transform + BVH-build a CPU Scene.

    The analog of gpu_scene_init/bake (gpu_scene.odin:45,77-118). Returns
    (device_scene, host_bvh).

    `reuse_bvh`: the TLAS UPDATE-mode path (gpu_scene.odin:457-482 /
    cmd_create_tlas refit) — keep the previous bake's tree TOPOLOGY
    (tri_order, links) and only recompute node AABBs bottom-up for the
    re-transformed triangles. Valid when the triangle COUNT and ordering
    basis are unchanged (transform edits); quality degrades under large
    motion exactly like a driver refit.

    `stable_shapes=True` pads every table to a geometric capacity bucket
    (≤ +12.5% rows) and sets the static counts to TABLE sizes, so small
    topology edits re-bake into the SAME jit signature: object add/remove
    becomes bake+upload instead of an XLA re-compile (the reference's
    editor adds objects instantly through driver AS rebuilds,
    gpu_scene.odin:430-455). Image-neutral by construction: padded lights
    carry zero selection weight and zero emission, padded triangles are
    degenerate, padded tree rows are unreachable (done-skips are rewritten
    past the padding). Exact counts ride in the `true_counts` device leaf.
    """
    if not scene.objects:
        raise ValueError("cannot bake an empty scene")

    v0s, e1s, e2s, n0s, n1s, n2s, tri_obj = [], [], [], [], [], [], []
    obj_first_tri = []
    tri_cursor = 0
    for oi, obj in enumerate(scene.objects):
        mesh = scene.meshes[obj.mesh_index]
        m = obj.transform.model_matrix
        nmat = obj.transform.normal_matrix
        wpos = mesh.positions @ m[:3, :3].T + m[:3, 3]
        wnrm = mesh.normals @ nmat[:3, :3].T  # unnormalized, see module doc
        tris = mesh.indices.reshape(-1, 3).astype(np.int64)
        a, b, c = wpos[tris[:, 0]], wpos[tris[:, 1]], wpos[tris[:, 2]]
        v0s.append(a)
        e1s.append(b - a)
        e2s.append(c - a)
        n0s.append(wnrm[tris[:, 0]])
        n1s.append(wnrm[tris[:, 1]])
        n2s.append(wnrm[tris[:, 2]])
        tri_obj.append(np.full(len(tris), oi, np.int32))
        obj_first_tri.append(tri_cursor)
        tri_cursor += len(tris)

    v0 = np.concatenate(v0s).astype(np.float32)
    e1 = np.concatenate(e1s).astype(np.float32)
    e2 = np.concatenate(e2s).astype(np.float32)
    n0 = np.concatenate(n0s).astype(np.float32)
    n1 = np.concatenate(n1s).astype(np.float32)
    n2 = np.concatenate(n2s).astype(np.float32)
    tri_object = np.concatenate(tri_obj)
    num_tris = len(v0)

    obj_material = np.asarray(
        [o.material_index for o in scene.objects], np.int32
    )

    # --- lights from emissive objects (gpu_scene.odin:603-623) ---
    light_object, light_first, light_count = [], [], []
    light_center, light_emission, light_power = [], [], []
    obj_light_index = np.full(len(scene.objects), -1, np.int32)
    for oi, obj in enumerate(scene.objects):
        mat = scene.materials[obj.material_index]
        if mat.emission_power > 0:
            obj_light_index[oi] = len(light_object)
            light_object.append(oi)
            light_first.append(obj_first_tri[oi])
            light_count.append(scene.meshes[obj.mesh_index].num_triangles)
            light_center.append(obj.transform.model_matrix[:3, 3])
            light_emission.append(
                np.asarray(mat.emission_color, np.float32) * mat.emission_power
            )
            light_power.append(mat.emission_power)
    num_lights = len(light_object)

    # --- BVH over world triangles, then permute triangle arrays ---
    # tri_order may contain REPEATED ids (spatial reference splitting,
    # accel/bvh.py:build_bvh_split): the permuted per-triangle arrays then
    # carry duplicate rows, which is transparent to traversal and shading.
    if reuse_bvh is not None:
        ref_basis = reuse_bvh.input_tris if reuse_bvh.input_tris >= 0 \
            else len(reuse_bvh.tri_order)
        assert ref_basis == num_tris, (
            "refit requires an unchanged triangle count"
        )
        bvh = reuse_bvh
        perm = bvh.tri_order
        bvh.refit(v0[perm], e1[perm], e2[perm])
    else:
        # Spatial reference splitting (accel/bvh.py:build_bvh_split) is
        # kept available for scenes with mixed triangle scales; off here.
        bvh = build_bvh(v0, e1, e2, leaf_size=leaf_size)
        bvh.input_tris = num_tris
        perm = bvh.tri_order
    num_refs = len(perm)
    v0p, e1p, e2p = v0[perm], e1[perm], e2[perm]
    n0p, n1p, n2p = n0[perm], n1[perm], n2[perm]
    tri_object_p = tri_object[perm]
    tri_material_p = obj_material[tri_object_p]

    # --- packed traversal layouts (see SceneOnDevice field docs) ---
    nodes_packed, tris_packed = _pack_traversal_arrays(
        bvh, v0p, e1p, e2p, tri_object_p, leaf_size
    )
    # --- pad triangle tables to lane multiple with degenerate triangles ---
    t_pad = (_bucket(num_refs, _PAD) if stable_shapes
             else max(_PAD, ((num_refs + _PAD - 1) // _PAD) * _PAD))

    # Node tables: exact by default; capacity-padded under stable shapes.
    # Padded node rows are UNREACHABLE — traversal enters nodes only via
    # descend (cur+1 within the real preorder) or skip links, and every
    # "done" skip (== real node count) is rewritten to point past the
    # padding — so fills are defensive (empty/NaN boxes that cannot hit).
    nodes_min_a, nodes_max_a = bvh.nodes_min, bvh.nodes_max
    nodes_skip_a = bvh.nodes_skip
    nodes_first_a, nodes_count_a = bvh.nodes_first, bvh.nodes_count
    if stable_shapes:
        nn_real = bvh.num_nodes
        nn_cap = _bucket(nn_real, 64)
        skip_rw = np.where(bvh.nodes_skip >= nn_real, nn_cap,
                           bvh.nodes_skip).astype(np.int32)
        nodes_min_a = _pad_rows(bvh.nodes_min, nn_cap, fill=np.inf)
        nodes_max_a = _pad_rows(bvh.nodes_max, nn_cap, fill=-np.inf)
        nodes_skip_a = _pad_rows(skip_rw, nn_cap, fill=nn_cap)
        nodes_first_a = _pad_rows(bvh.nodes_first, nn_cap, fill=0)
        nodes_count_a = _pad_rows(bvh.nodes_count, nn_cap, fill=0)
        nodes_packed = nodes_packed.copy()
        nodes_packed[:, 6] = skip_rw.view(np.float32)
        np_pad = np.zeros((nn_cap - nn_real, 8), np.float32)
        np_pad[:, 0:3] = np.inf
        np_pad[:, 3:6] = -np.inf
        np_pad[:, 6] = np.asarray([nn_cap], np.int32).view(np.float32)[0]
        nodes_packed = np.concatenate([nodes_packed, np_pad])
        tris_packed = _pad_rows(tris_packed,
                                _bucket(tris_packed.shape[0], 64))
    materials = scene.materials

    # --- packed light tables (see SceneOnDevice field docs) ---
    light_emission_arr = np.asarray(light_emission, np.float32).reshape(
        num_lights, 3)
    light_meta = np.zeros((num_lights, 8), np.float32)
    if num_lights:
        assert max(light_first) < (1 << 24) and max(light_count) < (1 << 24)
        light_meta[:, 0] = np.asarray(light_first, np.float32)
        light_meta[:, 1] = np.asarray(light_count, np.float32)
        light_meta[:, 2:5] = light_emission_arr
        light_meta[:, 5] = np.asarray(light_object, np.float32)
        light_meta[:, 6] = np.asarray(light_power, np.float32)
    obj_light_num = np.zeros(len(scene.objects), np.int32)
    if num_lights:
        obj_light_num[np.asarray(light_object, np.int64)] = np.asarray(
            light_count, np.int32)
    light_tri_packed = np.zeros((num_tris, 16), np.float32)
    light_tri_packed[:, 0:3] = v0
    light_tri_packed[:, 3:6] = e1
    light_tri_packed[:, 6:9] = e2
    light_tri_packed[:, 9] = tri_object.astype(np.float32)
    light_tri_packed[:, 10] = obj_light_index[tri_object].astype(np.float32)
    light_tri_packed[:, 11] = obj_light_num[tri_object].astype(np.float32)
    # Owning light's emission rides in the SAME row (cols 12:15) so ReSTIR's
    # _sample_light_point needs no second gather; material edits refresh
    # these columns on-device (update_materials).
    if num_lights:
        own = obj_light_index[tri_object]
        light_tri_packed[:, 12:15] = np.where(
            (own >= 0)[:, None],
            light_emission_arr[np.clip(own, 0, num_lights - 1)], 0.0
        )

    # Light / material / object / light-tri tables as locals (padded to
    # capacity buckets under stable shapes; exact otherwise). Padded lights
    # have zero power (never selected: zero CDF mass; zero contribution at
    # the r==0 tie) and num_tris 0 (sample marked invalid); padded mats are
    # only reachable through padded (degenerate) triangles.
    light_object_arr = np.asarray(light_object, np.int32).reshape(num_lights)
    light_first_arr = np.asarray(light_first, np.int32).reshape(num_lights)
    light_count_arr = np.asarray(light_count, np.int32).reshape(num_lights)
    light_center_arr = np.asarray(light_center, np.float32).reshape(
        num_lights, 3)
    light_power_arr = np.asarray(light_power, np.float32).reshape(num_lights)
    light_tri_v0_arr = np.ascontiguousarray(v0)
    light_tri_e1_arr = np.ascontiguousarray(e1)
    light_tri_e2_arr = np.ascontiguousarray(e2)
    light_tri_object_arr = np.ascontiguousarray(tri_object)
    obj_light_index_arr = obj_light_index
    mat_packed_arr = _pack_materials(materials)
    mat_cols = {
        "mat_albedo": np.asarray([m.albedo for m in materials], np.float32),
        "mat_emission_color": np.asarray(
            [m.emission_color for m in materials], np.float32),
        "mat_emission_power": np.asarray(
            [m.emission_power for m in materials], np.float32),
        "mat_roughness": np.asarray(
            [m.roughness for m in materials], np.float32),
        "mat_metallic": np.asarray(
            [m.metallic for m in materials], np.float32),
        "mat_transmission": np.asarray(
            [m.transmission for m in materials], np.float32),
        "mat_ior": np.asarray([m.ior for m in materials], np.float32),
        "mat_dispersion": np.asarray(
            [m.dispersion for m in materials], np.float32),
    }
    l_tab, o_tab, m_tab, t_tab = (num_lights, len(scene.objects),
                                  len(materials), num_tris)
    true_counts = None
    if stable_shapes:
        l_tab = _bucket(num_lights, 4) if num_lights else 0
        o_tab = _bucket(len(scene.objects), 16)
        m_tab = _bucket(len(materials), 8)
        t_tab = _bucket(num_tris, _PAD)
        light_object_arr = _pad_rows(light_object_arr, l_tab, fill=-1)
        light_first_arr = _pad_rows(light_first_arr, l_tab)
        light_count_arr = _pad_rows(light_count_arr, l_tab)
        light_center_arr = _pad_rows(light_center_arr, l_tab)
        light_emission_arr = _pad_rows(light_emission_arr, l_tab)
        light_power_arr = _pad_rows(light_power_arr, l_tab)
        light_meta = _pad_rows(light_meta, l_tab)
        light_tri_v0_arr = _pad_rows(light_tri_v0_arr, t_tab)
        light_tri_e1_arr = _pad_rows(light_tri_e1_arr, t_tab)
        light_tri_e2_arr = _pad_rows(light_tri_e2_arr, t_tab)
        light_tri_object_arr = _pad_rows(light_tri_object_arr, t_tab,
                                         fill=-1)
        ltp_pad = np.zeros((t_tab - len(light_tri_packed), 16), np.float32)
        ltp_pad[:, 10] = -1.0  # no owning light
        light_tri_packed = np.concatenate([light_tri_packed, ltp_pad])
        obj_light_index_arr = _pad_rows(obj_light_index_arr, o_tab, fill=-1)
        mat_packed_arr = _pad_rows(mat_packed_arr, m_tab)
        mat_packed_arr[len(materials):, 10] = 1.0  # padded ior = vacuum
        for k in mat_cols:
            mat_cols[k] = _pad_rows(
                mat_cols[k], m_tab, fill=1.0 if k == "mat_ior" else 0.0)
        # Statics hold TABLE sizes under stable shapes.
        true_counts = np.asarray(
            [num_tris, num_lights, len(scene.objects), num_refs], np.int32)

    def as_device(x):
        return jax.device_put(x) if device_put else x

    ds = SceneOnDevice(
        tri_v0=as_device(_pad_rows(v0p, t_pad)),
        tri_e1=as_device(_pad_rows(e1p, t_pad)),
        tri_e2=as_device(_pad_rows(e2p, t_pad)),
        tri_n0=as_device(_pad_rows(n0p, t_pad)),
        tri_n1=as_device(_pad_rows(n1p, t_pad)),
        tri_n2=as_device(_pad_rows(n2p, t_pad)),
        tri_object=as_device(_pad_rows(tri_object_p, t_pad, fill=-1)),
        tri_material=as_device(_pad_rows(tri_material_p, t_pad, fill=0)),
        nodes_min=as_device(nodes_min_a),
        nodes_max=as_device(nodes_max_a),
        nodes_skip=as_device(nodes_skip_a),
        nodes_first=as_device(nodes_first_a),
        nodes_count=as_device(nodes_count_a),
        nodes_packed=as_device(nodes_packed),
        tris_packed=as_device(tris_packed),
        tri_shade=as_device(
            _pack_tri_shade(
                _pad_rows(v0p, t_pad), _pad_rows(e1p, t_pad),
                _pad_rows(e2p, t_pad), _pad_rows(n0p, t_pad),
                _pad_rows(n1p, t_pad), _pad_rows(n2p, t_pad),
                _pad_rows(tri_object_p, t_pad, fill=-1),
                _pad_rows(tri_material_p, t_pad, fill=0),
                obj_light_index, obj_light_num,
            )
        ),
        mat_packed=as_device(mat_packed_arr),
        mat_albedo=as_device(mat_cols["mat_albedo"]),
        mat_emission_color=as_device(mat_cols["mat_emission_color"]),
        mat_emission_power=as_device(mat_cols["mat_emission_power"]),
        mat_roughness=as_device(mat_cols["mat_roughness"]),
        mat_metallic=as_device(mat_cols["mat_metallic"]),
        mat_transmission=as_device(mat_cols["mat_transmission"]),
        mat_ior=as_device(mat_cols["mat_ior"]),
        mat_dispersion=as_device(mat_cols["mat_dispersion"]),
        light_object=as_device(light_object_arr),
        light_first_tri=as_device(light_first_arr),
        light_num_tris=as_device(light_count_arr),
        light_center=as_device(light_center_arr),
        light_emission=as_device(light_emission_arr),
        light_power=as_device(light_power_arr),
        light_tri_v0=as_device(light_tri_v0_arr),
        light_tri_e1=as_device(light_tri_e1_arr),
        light_tri_e2=as_device(light_tri_e2_arr),
        light_tri_object=as_device(light_tri_object_arr),
        obj_light_index=as_device(obj_light_index_arr),
        light_meta_packed=as_device(light_meta),
        light_tri_packed=as_device(light_tri_packed),
        num_triangles=t_tab,
        num_lights=l_tab,
        num_objects=o_tab,
        true_counts=(as_device(true_counts) if true_counts is not None
                     else None),
    )
    return ds, bvh


def update_materials(ds: SceneOnDevice, scene: Scene,
                     **bake_kwargs) -> SceneOnDevice:
    """Cheap incremental material update (gpu_scene_update_material,
    gpu_scene.odin:560-601): rewrite the material SoA and light emissions
    without touching geometry or the BVH. Falls back to a full bake when the
    set of emissive objects changed (the reference also rebuilds lights +
    TLAS masks in that case); `bake_kwargs` (leaf_size, stable_shapes)
    parameterize that fallback bake."""
    mats = scene.materials
    emissive_now = [
        oi for oi, o in enumerate(scene.objects)
        if mats[o.material_index].emission_power > 0
    ]
    # Capacity-padded bakes carry -1 padding in light_object; compare
    # against the real entries only. New materials beyond the baked table
    # also force the full bake (their rows don't exist yet).
    lo = np.asarray(ds.light_object)
    if (emissive_now != lo[lo >= 0].tolist()
            or len(mats) > ds.mat_albedo.shape[0]):
        new_ds, _ = bake_scene(scene, **bake_kwargs)
        return new_ds
    light_emission = np.asarray(
        [
            np.asarray(mats[scene.objects[oi].material_index].emission_color,
                       np.float32)
            * mats[scene.objects[oi].material_index].emission_power
            for oi in emissive_now
        ],
        np.float32,
    ).reshape(len(emissive_now), 3)
    light_power = np.asarray(
        [mats[scene.objects[oi].material_index].emission_power
         for oi in emissive_now],
        np.float32,
    ).reshape(len(emissive_now))
    # Preserve the baked table shapes (capacity-padded bakes are larger
    # than the true counts; exact bakes are equal — padding is a no-op).
    m_tab = ds.mat_albedo.shape[0]
    l_tab = ds.light_power.shape[0]
    mat_packed_arr = _pad_rows(_pack_materials(mats), m_tab)
    mat_packed_arr[len(mats):, 10] = 1.0  # padded ior = vacuum

    def mat_col(vals, fill=0.0):
        return jax.device_put(
            _pad_rows(np.asarray(vals, np.float32), m_tab, fill=fill))

    return dataclasses.replace(
        ds,
        mat_albedo=mat_col([m.albedo for m in mats]),
        mat_emission_color=mat_col([m.emission_color for m in mats]),
        mat_emission_power=mat_col([m.emission_power for m in mats]),
        mat_roughness=mat_col([m.roughness for m in mats]),
        mat_metallic=mat_col([m.metallic for m in mats]),
        mat_transmission=mat_col([m.transmission for m in mats]),
        mat_ior=mat_col([m.ior for m in mats], fill=1.0),
        mat_dispersion=mat_col([m.dispersion for m in mats]),
        mat_packed=jax.device_put(mat_packed_arr),
        light_emission=jax.device_put(_pad_rows(light_emission, l_tab)),
        light_power=jax.device_put(_pad_rows(light_power, l_tab)),
        light_meta_packed=jax.device_put(_refresh_light_meta(
            np.asarray(ds.light_meta_packed), light_emission, light_power
        )),
        light_tri_packed=_refresh_light_tri_emission(
            ds.light_tri_packed, light_emission
        ),
    )


def _refresh_light_tri_emission(light_tri_packed, light_emission: np.ndarray):
    """Rewrite the per-row emission columns (12:15) of light_tri_packed
    on-device after a material edit (the rows' owning-light index is
    col 10)."""
    import jax.numpy as jnp

    li = light_tri_packed[:, 10].astype(jnp.int32)
    em = jnp.asarray(light_emission, jnp.float32)
    if em.shape[0] == 0:
        return light_tri_packed
    new_em = jnp.where(
        (li >= 0)[:, None], em[jnp.clip(li, 0, em.shape[0] - 1)], 0.0
    )
    return light_tri_packed.at[:, 12:15].set(new_em)


def _refresh_light_meta(meta: np.ndarray, light_emission: np.ndarray,
                        light_power: np.ndarray) -> np.ndarray:
    """Material edits change only the emission/power slots of the packed
    light meta rows (the in-place material-SSBO-write analog). `meta` may
    be capacity-padded beyond the true light count — only real rows are
    rewritten."""
    meta = meta.copy()
    k = len(light_emission)
    meta[:k, 2:5] = light_emission
    meta[:k, 6] = light_power
    return meta
