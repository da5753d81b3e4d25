"""Host-built BVH over world-space triangles, flattened for stackless
lockstep traversal on the device.

This plays the role of the reference's VK_KHR_acceleration_structure
BLAS/TLAS (`src/raytracer/acceleration_structure.odin`,
`gpu_scene.odin:209-315`), redesigned for a wavefront walk:

  - Instead of per-mesh BLAS + instance TLAS, all triangles are
    pre-transformed to world space at bake time and ONE BVH is built over
    them (scene sizes here — up to ~300k tris — easily fit; this removes a
    level of indirection from the per-ray inner loop, which is pure
    gather cost).
  - The driver's fixed-function BVH build is replaced by a host binned-SAH
    builder (native C++, native/bvh_builder.cpp, built at first use;
    numpy reference builder alongside); "UPDATE mode" refit
    (acceleration_structure.odin:125-131) becomes `refit()`, which recomputes
    node AABBs bottom-up without changing topology.
  - Hardware traversal is replaced by a vectorized stackless skip-link walk
    (ops/traverse.py): depth-first node order, hit -> node+1,
    miss/leaf-done -> skip[node]. Per-ray state is just one node index, so a
    whole wavefront advances in lockstep with two gathers per step.

Flattened layout (SoA, static shapes):
  nodes_min/max f32[NN,3]  AABBs
  nodes_skip    i32[NN]    next node on miss / after leaf (NN = "done")
  nodes_first   i32[NN]    first triangle (leaves; 0 for internal)
  nodes_count   i32[NN]    triangle count (0 = internal node)
  tri_order     i32[T]     permutation: BVH leaf order -> input order
  parent        i32[NN]    for bottom-up refit
"""

from __future__ import annotations

import dataclasses

import numpy as np

_SAH_BINS = 32
_TRAVERSAL_COST = 1.0
_INTERSECT_COST = 1.5


@dataclasses.dataclass
class BVH:
    nodes_min: np.ndarray  # f32[NN,3]
    nodes_max: np.ndarray  # f32[NN,3]
    nodes_skip: np.ndarray  # i32[NN]
    nodes_first: np.ndarray  # i32[NN]
    nodes_count: np.ndarray  # i32[NN]
    tri_order: np.ndarray  # i32[R] (triangle ids in leaf order; with spatial
    # reference splitting R >= T and ids may REPEAT — see build_bvh_split)
    parent: np.ndarray  # i32[NN]
    # Number of distinct input triangles the build saw (refit validity
    # check; tri_order may be longer under reference splitting).
    input_tris: int = -1

    @property
    def num_nodes(self) -> int:
        return len(self.nodes_skip)

    def max_depth(self) -> int:
        """Deepest node's depth (root = 0). Binned SAH can emit highly skewed
        trees on adversarial (clustered / exponentially spaced) input; a
        fixed-size traversal stack must be checked against this."""
        p = self.parent.astype(np.int64)
        depth = np.zeros(len(p), np.int64)
        anc = p.copy()
        while (anc >= 0).any():
            live = anc >= 0
            depth += live
            anc = np.where(live, p[np.maximum(anc, 0)], -1)
        return int(depth.max(initial=0))

    def refit(self, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
        """Recompute AABBs bottom-up for updated (already reordered) triangle
        world positions — the analog of TLAS UPDATE-mode rebuild
        (gpu_scene.odin:457-482). Topology is unchanged, so quality degrades
        under large motion exactly like a driver refit would."""
        lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
        hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
        nn = self.num_nodes
        new_min = np.full((nn, 3), np.inf, np.float32)
        new_max = np.full((nn, 3), -np.inf, np.float32)
        # Leaves first.
        for i in np.nonzero(self.nodes_count > 0)[0]:
            f, c = self.nodes_first[i], self.nodes_count[i]
            new_min[i] = lo[f : f + c].min(axis=0)
            new_max[i] = hi[f : f + c].max(axis=0)
        # Internal nodes in reverse depth-first order (children have larger
        # indices than parents in preorder layout).
        for i in range(nn - 1, -1, -1):
            p = self.parent[i]
            if p >= 0:
                new_min[p] = np.minimum(new_min[p], new_min[i])
                new_max[p] = np.maximum(new_max[p], new_max[i])
        self.nodes_min = new_min.astype(np.float32)
        self.nodes_max = new_max.astype(np.float32)
        return self


def _sah_split(lo, hi, centroids, idx):
    """3-axis binned SAH split of the triangle subset `idx`: all three
    centroid axes are binned and swept, and the global min-cost (axis, k)
    wins. Measured on the 300k bench scene (tools/r3_sah_cpu_proxy.py):
    vs the widest-axis-only split this cuts per-ray quad-tree visits ~24%
    (primary 19.4 -> 14.8, bounce 15.0 -> 11.3) — and per-visit serial
    latency is the traversal cost model, so tree quality pays 1:1.

    ALWAYS returns (left_idx, right_idx): the traversal's leaf loop is a
    static `range(leaf_size)`, so leaves may never exceed leaf_size — when
    no SAH split is usable we median-split instead of keeping a fat leaf.
    """
    c = centroids[idx]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    extent = cmax - cmin
    widest = int(np.argmax(extent))
    if extent[widest] <= 1e-12:
        # All centroids coincide: arbitrary halves.
        half = len(idx) // 2
        return idx[:half], idx[half:]

    def area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    tlo = lo[idx]
    thi = hi[idx]
    # Bin all three axes in ONE scatter pass: flat index = axis*BINS + bin.
    # (Three separate np.minimum.at passes dominated build time; the
    # combined pass is ~2x faster and bit-identical — same bins, same
    # sweeps, same tie-breaking by axis order through argmin below.)
    live = extent > 1e-12
    scale = np.where(live, _SAH_BINS * (1.0 - 1e-6) / np.maximum(extent, 1e-30),
                     0.0)
    bins3 = ((c - cmin) * scale).astype(np.int32)  # [n,3]
    np.clip(bins3, 0, _SAH_BINS - 1, out=bins3)
    flat = bins3 + (np.arange(3, dtype=np.int32) * _SAH_BINS)  # [n,3]

    counts = np.bincount(flat.ravel(), minlength=3 * _SAH_BINS)
    bin_min = np.full((3 * _SAH_BINS, 3), np.inf, np.float32)
    bin_max = np.full((3 * _SAH_BINS, 3), -np.inf, np.float32)
    rep_lo = np.repeat(tlo, 3, axis=0)
    np.minimum.at(bin_min, flat.ravel(), rep_lo)
    np.maximum.at(bin_max, flat.ravel(), np.repeat(thi, 3, axis=0))

    counts = counts.reshape(3, _SAH_BINS)
    bin_min = bin_min.reshape(3, _SAH_BINS, 3)
    bin_max = bin_max.reshape(3, _SAH_BINS, 3)

    # Prefix/suffix sweeps, vectorized across the 3 axes.
    lmin = np.minimum.accumulate(bin_min, axis=1)
    lmax = np.maximum.accumulate(bin_max, axis=1)
    rmin = np.minimum.accumulate(bin_min[:, ::-1], axis=1)[:, ::-1]
    rmax = np.maximum.accumulate(bin_max[:, ::-1], axis=1)[:, ::-1]
    lcount = np.cumsum(counts, axis=1)
    rcount = np.cumsum(counts[:, ::-1], axis=1)[:, ::-1]

    # Split after bin k: left = bins[0..k], right = bins[k+1..].
    nl = lcount[:, :-1]
    nr = rcount[:, 1:]
    costs = np.where(
        (nl > 0) & (nr > 0) & live[:, None],
        area(lmin[:, :-1], lmax[:, :-1]) * nl
        + area(rmin[:, 1:], rmax[:, 1:]) * nr,
        np.inf,
    )
    flat_best = int(np.argmin(costs))
    best_axis, best_k = divmod(flat_best, _SAH_BINS - 1)
    if not np.isfinite(costs[best_axis, best_k]):
        best_axis = -1

    if best_axis < 0:
        # Fall back to a median split on the widest axis.
        order = np.argsort(c[:, widest], kind="stable")
        half = len(idx) // 2
        return idx[order[:half]], idx[order[half:]]

    left_sel = bins3[:, best_axis] <= best_k
    return idx[left_sel], idx[~left_sel]


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = 8) -> BVH:
    """Binned-SAH BVH over triangles given as (v0, edge1, edge2).

    Uses the native C++ builder (native/bvh_builder.cpp), compiled on
    first use (accel/native_builder.py); `build_bvh_numpy` is the reference
    implementation the tests compare it with.
    Triangles are reordered so each leaf owns a contiguous [first, count)
    range; apply `tri_order` to all per-triangle arrays after building.
    """
    from raytracer_tpu.accel import native_builder

    return native_builder.build_bvh_native(v0, e1, e2, leaf_size)


_SPLIT_REL_AREA = 64.0   # split refs whose AABB area > this x median
_SPLIT_MAX_FACTOR = 2.0  # total references capped at factor x triangles


def _clip_poly_axis(poly: np.ndarray, axis: int, pos: float,
                    keep_low: bool) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex polygon ([k,3] vertices) against
    the axis-aligned half-space x[axis] <= pos (or >= pos)."""
    out = []
    k = len(poly)
    for i in range(k):
        a = poly[i]
        b = poly[(i + 1) % k]
        a_in = a[axis] <= pos if keep_low else a[axis] >= pos
        b_in = b[axis] <= pos if keep_low else b[axis] >= pos
        if a_in:
            out.append(a)
        if a_in != b_in:
            denom = b[axis] - a[axis]
            t = (pos - a[axis]) / denom if denom != 0.0 else 0.0
            out.append(a + t * (b - a))
    return np.asarray(out, np.float64) if out else np.zeros((0, 3))


def make_split_refs(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    rel_area: float = _SPLIT_REL_AREA,
                    max_factor: float = _SPLIT_MAX_FACTOR):
    """Spatial reference splitting (SBVH-lite, Ernst/Greiner early-split
    style): triangles whose AABB surface area is an outlier are split into
    multiple REFERENCES with tight clipped AABBs, so one room-sized wall
    quad no longer smears a scene-wide box across the tree. The triangle
    GEOMETRY is untouched — a ref only contributes its AABB to the build;
    leaves then hold (possibly duplicated) full triangles, which cannot
    change hit results (any true hit lies in some ref's box, and extra
    ref visits only re-test the same triangle).

    Returns (ref_tri i32[R], ref_lo f32[R,3], ref_hi f32[R,3]); R == T and
    ref boxes == tri boxes when nothing qualifies.

    Reference analog: the driver BVH build quality knob PREFER_FAST_TRACE
    (acceleration_structure.odin:65-143) — split quality is the host
    builder's responsibility here.
    """
    import heapq

    v1 = v0 + e1
    v2 = v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)

    def area(alo, ahi):
        d = np.maximum(ahi - alo, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    areas = area(lo, hi)
    pos_areas = areas[areas > 0]
    if len(pos_areas) == 0:
        return (np.arange(len(v0), dtype=np.int32), lo.astype(np.float32),
                hi.astype(np.float32))
    thresh = rel_area * float(np.median(pos_areas))
    budget = int(max_factor * len(v0)) - len(v0)

    ref_tri = list(range(len(v0)))
    ref_lo = [lo[i] for i in range(len(v0))]
    ref_hi = [hi[i] for i in range(len(v0))]
    polys = {}

    heap = [(-areas[i], i) for i in np.nonzero(areas > thresh)[0]]
    heapq.heapify(heap)
    while heap and budget > 0:
        neg_a, ri = heapq.heappop(heap)
        if -neg_a <= thresh:
            break
        poly = polys.get(ri)
        if poly is None:
            t = ref_tri[ri]
            poly = np.stack([v0[t], v1[t], v2[t]]).astype(np.float64)
        box_lo, box_hi = ref_lo[ri], ref_hi[ri]
        axis = int(np.argmax(box_hi - box_lo))
        pos = 0.5 * (box_lo[axis] + box_hi[axis])
        pieces = []
        for keep_low in (True, False):
            p = _clip_poly_axis(poly, axis, pos, keep_low)
            if len(p) >= 3:
                plo = np.maximum(p.min(axis=0), box_lo)
                phi = np.minimum(p.max(axis=0), box_hi)
                pieces.append((p, plo, phi))
        if len(pieces) < 2:
            continue  # numerically degenerate split: leave the ref as-is
        # First piece replaces the ref in place; the second is appended.
        (p0, lo0, hi0), (p1, lo1, hi1) = pieces
        polys[ri] = p0
        ref_lo[ri], ref_hi[ri] = lo0, hi0
        new_ri = len(ref_tri)
        ref_tri.append(ref_tri[ri])
        ref_lo.append(lo1)
        ref_hi.append(hi1)
        polys[new_ri] = p1
        budget -= 1
        for r, alo, ahi in ((ri, lo0, hi0), (new_ri, lo1, hi1)):
            a = float(area(alo, ahi))
            if a > thresh:
                heapq.heappush(heap, (-a, r))

    return (
        np.asarray(ref_tri, np.int32),
        np.stack(ref_lo).astype(np.float32),
        np.stack(ref_hi).astype(np.float32),
    )


def build_bvh_split(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    leaf_size: int = 8) -> BVH:
    """build_bvh with spatial reference splitting: large triangles become
    several leaf references with tight clipped AABBs. `tri_order` may repeat
    triangle ids; downstream packing duplicates those rows (hit records are
    unaffected — same triangle, same t/u/v). Proxy 'triangles' spanning each
    ref box feed the unmodified (numpy or native) SAH builder, so both build
    paths benefit."""
    ref_tri, ref_lo, ref_hi = make_split_refs(v0, e1, e2)
    if len(ref_tri) == len(v0):
        bvh = build_bvh(v0, e1, e2, leaf_size=leaf_size)
        bvh.input_tris = len(v0)
        return bvh
    # Proxy with the ref box's exact AABB/centroid: v0=lo, v1=hi, v2=lo.
    bvh = build_bvh(ref_lo, ref_hi - ref_lo, np.zeros_like(ref_lo),
                    leaf_size=leaf_size)
    bvh.tri_order = ref_tri[bvh.tri_order]
    bvh.input_tris = len(v0)
    return bvh


def build_bvh_numpy(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    leaf_size: int = 8) -> BVH:
    t = len(v0)
    assert t > 0, "cannot build a BVH over zero triangles"
    v1 = v0 + e1
    v2 = v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroids = ((lo + hi) * 0.5).astype(np.float32)

    # Recursive top-down build using an explicit stack; children are emitted
    # in preorder so hit-links are implicit (node+1).
    nodes = []  # [min, max, first, count, parent] with count<0 marking internal
    order = []

    stack = [(np.arange(t, dtype=np.int64), -1)]
    while stack:
        idx, parent_slot = stack.pop()
        node_id = len(nodes)
        nmin = lo[idx].min(axis=0)
        nmax = hi[idx].max(axis=0)

        if len(idx) <= leaf_size:
            first = len(order)
            order.extend(idx.tolist())
            nodes.append([nmin, nmax, first, len(idx), parent_slot])
        else:
            left, right = _sah_split(lo, hi, centroids, idx)
            nodes.append([nmin, nmax, 0, -1, parent_slot])
            # Preorder: left child next -> push right first.
            stack.append((right, node_id))
            stack.append((left, node_id))

    nn = len(nodes)
    nodes_min = np.stack([n[0] for n in nodes]).astype(np.float32)
    nodes_max = np.stack([n[1] for n in nodes]).astype(np.float32)
    nodes_first = np.asarray([n[2] for n in nodes], np.int32)
    counts = np.asarray([n[3] for n in nodes], np.int32)
    parent = np.asarray([n[4] for n in nodes], np.int32)
    nodes_count = np.where(counts < 0, 0, counts).astype(np.int32)

    nodes_skip = _compute_skip_links(parent, counts, nn)

    return BVH(
        nodes_min=nodes_min,
        nodes_max=nodes_max,
        nodes_skip=nodes_skip,
        nodes_first=nodes_first,
        nodes_count=nodes_count,
        tri_order=np.asarray(order, np.int32),
        parent=parent,
    )


def _compute_skip_links(parent: np.ndarray, counts: np.ndarray, nn: int) -> np.ndarray:
    """skip[i] = next node in preorder after i's subtree (nn = done).

    In preorder layout a node's subtree is the contiguous index range
    [i, end_i), so the skip target is simply end_i.
    """
    del counts
    # In preorder layout a node's subtree occupies the contiguous index range
    # [i, end_i), so the skip target is simply end_i (== nn means done).
    # Subtree ends come from a reverse scan propagating child ends up to
    # parents (parents always precede children in preorder).
    end = np.arange(1, nn + 1, dtype=np.int32)  # a leaf's subtree ends at i+1
    for i in range(nn - 1, 0, -1):
        p = parent[i]
        if p >= 0 and end[i] > end[p]:
            end[p] = end[i]
    return end
