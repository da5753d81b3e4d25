"""BVH structural invariants + native builder parity + refit."""

import numpy as np
import pytest

from raytracer_tpu.accel.bvh import build_bvh_numpy
from raytracer_tpu.accel import native_builder


def _random_tris(rng_np, t):
    v0 = rng_np.uniform(-5, 5, size=(t, 3)).astype(np.float32)
    e1 = rng_np.uniform(-1, 1, size=(t, 3)).astype(np.float32)
    e2 = rng_np.uniform(-1, 1, size=(t, 3)).astype(np.float32)
    return v0, e1, e2


def _check_invariants(bvh, v0, e1, e2, leaf_size):
    t = len(v0)
    nn = bvh.num_nodes
    # Permutation covers all triangles once.
    assert sorted(bvh.tri_order.tolist()) == list(range(t))
    # Leaves are small enough for the static traversal loop.
    leaves = bvh.nodes_count > 0
    assert bvh.nodes_count[leaves].max() <= leaf_size
    # Leaf ranges are disjoint and cover [0, T).
    firsts = bvh.nodes_first[leaves]
    counts = bvh.nodes_count[leaves]
    seen = np.zeros(t, bool)
    for f, c in zip(firsts, counts):
        assert not seen[f : f + c].any()
        seen[f : f + c] = True
    assert seen.all()
    # Skip links are strictly forward and land in (i, nn].
    skips = bvh.nodes_skip
    idx = np.arange(nn)
    assert (skips > idx).all() and (skips <= nn).all()
    # AABBs contain their triangles (reordered).
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)[bvh.tri_order]
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)[bvh.tri_order]
    for i in np.nonzero(leaves)[0]:
        f, c = bvh.nodes_first[i], bvh.nodes_count[i]
        assert (lo[f : f + c] >= bvh.nodes_min[i] - 1e-4).all()
        assert (hi[f : f + c] <= bvh.nodes_max[i] + 1e-4).all()
    # Children are inside parents.
    for i in range(1, nn):
        p = bvh.parent[i]
        assert (bvh.nodes_min[i] >= bvh.nodes_min[p] - 1e-4).all()
        assert (bvh.nodes_max[i] <= bvh.nodes_max[p] + 1e-4).all()


@pytest.mark.parametrize("t", [1, 2, 7, 64, 513])
def test_numpy_builder_invariants(rng_np, t):
    v0, e1, e2 = _random_tris(rng_np, t)
    bvh = build_bvh_numpy(v0, e1, e2, leaf_size=8)
    _check_invariants(bvh, v0, e1, e2, 8)


def test_degenerate_coincident_centroids():
    t = 40
    v0 = np.zeros((t, 3), np.float32)
    e1 = np.tile([[1, 0, 0]], (t, 1)).astype(np.float32)
    e2 = np.tile([[0, 1, 0]], (t, 1)).astype(np.float32)
    bvh = build_bvh_numpy(v0, e1, e2, leaf_size=8)
    _check_invariants(bvh, v0, e1, e2, 8)


def test_native_builder_invariants(rng_np):
    v0, e1, e2 = _random_tris(rng_np, 1000)
    bvh = native_builder.build_bvh_native(v0, e1, e2, leaf_size=8)
    _check_invariants(bvh, v0, e1, e2, 8)


def test_native_matches_numpy_hit_results(rng_np):
    """Different trees are fine; identical closest hits are required."""
    import jax.numpy as jnp

    from raytracer_tpu.ops.traverse import intersect_bvh

    t, r = 600, 128
    v0, e1, e2 = _random_tris(rng_np, t)
    o = rng_np.uniform(-6, 6, size=(r, 3)).astype(np.float32)
    d = rng_np.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    from tests.conftest import make_traversal_scene

    results = []
    for builder in (build_bvh_numpy, native_builder.build_bvh_native):
        scene = make_traversal_scene(v0, e1, e2, leaf_size=8, builder=builder)
        rec = intersect_bvh(jnp.asarray(o), jnp.asarray(d), scene, 1e-3, 1e4)
        # Map hit tri back to input order for comparison.
        tri_global = np.where(
            np.asarray(rec.hit),
            scene.perm[np.clip(np.asarray(rec.tri), 0, t - 1)],
            -1,
        )
        results.append((np.asarray(rec.hit), np.asarray(rec.t), tri_global))

    np.testing.assert_array_equal(results[0][0], results[1][0])
    hits = results[0][0]
    np.testing.assert_allclose(
        results[0][1][hits], results[1][1][hits], rtol=1e-5, atol=1e-5
    )


def test_refit_tracks_moved_triangles(rng_np):
    v0, e1, e2 = _random_tris(rng_np, 200)
    bvh = build_bvh_numpy(v0, e1, e2, leaf_size=8)
    perm = bvh.tri_order
    v0s, e1s, e2s = v0[perm], e1[perm], e2[perm]
    offset = np.asarray([3.0, -1.0, 2.0], np.float32)
    bvh.refit(v0s + offset, e1s, e2s)
    _check_invariants_after_refit(bvh, v0s + offset, e1s, e2s)


def _check_invariants_after_refit(bvh, v0s, e1s, e2s):
    lo = np.minimum(np.minimum(v0s, v0s + e1s), v0s + e2s)
    hi = np.maximum(np.maximum(v0s, v0s + e1s), v0s + e2s)
    leaves = bvh.nodes_count > 0
    for i in np.nonzero(leaves)[0]:
        f, c = bvh.nodes_first[i], bvh.nodes_count[i]
        assert (lo[f : f + c] >= bvh.nodes_min[i] - 1e-4).all()
        assert (hi[f : f + c] <= bvh.nodes_max[i] + 1e-4).all()
    for i in range(1, bvh.num_nodes):
        p = bvh.parent[i]
        assert (bvh.nodes_min[i] >= bvh.nodes_min[p] - 1e-4).all()
        assert (bvh.nodes_max[i] <= bvh.nodes_max[p] + 1e-4).all()


def test_split_refs_cover_and_clip(rng_np):
    """make_split_refs: every input triangle keeps >=1 reference, ref boxes
    stay inside the original tri AABB, and outlier-area tris actually split."""
    from raytracer_tpu.accel.bvh import make_split_refs

    t = 300
    v0, e1, e2 = _random_tris(rng_np, t)
    # Four scene-spanning "wall" triangles: area outliers that must split.
    big = np.asarray(
        [
            [[-50, -50, 0], [100, 0, 0], [0, 100, 0]],
            [[-50, -50, 0], [0, 100, 0], [100, 0, 0]],
            [[-50, 0, -50], [100, 0, 0], [0, 0, 100]],
            [[0, -50, -50], [0, 100, 0], [0, 0, 100]],
        ],
        np.float32,
    )
    v0 = np.concatenate([v0, big[:, 0]])
    e1 = np.concatenate([e1, big[:, 1]])
    e2 = np.concatenate([e2, big[:, 2]])

    ref_tri, ref_lo, ref_hi = make_split_refs(v0, e1, e2)
    assert len(ref_tri) > t + 4, "outlier tris did not split"
    assert set(ref_tri.tolist()) == set(range(t + 4))
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    assert (ref_lo >= lo[ref_tri] - 1e-3).all()
    assert (ref_hi <= hi[ref_tri] + 1e-3).all()
    assert (ref_lo <= ref_hi).all()


def test_split_build_matches_unsplit_hits(rng_np):
    """build_bvh_split trees (duplicated leaf refs) must return bit-identical
    closest hits to the plain SAH tree."""
    import jax.numpy as jnp

    from raytracer_tpu.accel.bvh import build_bvh_split
    from raytracer_tpu.ops.traverse import intersect_bvh
    from tests.conftest import make_traversal_scene

    t, r = 300, 256
    v0, e1, e2 = _random_tris(rng_np, t)
    # One scene-spanning floor pair guarantees splitting kicks in.
    v0 = np.concatenate([v0, [[-40, -6, -40], [40, -6, 40]]]).astype(
        np.float32)
    e1 = np.concatenate([e1, [[80, 0, 0], [-80, 0, 0]]]).astype(np.float32)
    e2 = np.concatenate([e2, [[0, 0, 80], [0, 0, -80]]]).astype(np.float32)
    t += 2

    o = rng_np.uniform(-8, 8, size=(r, 3)).astype(np.float32)
    d = rng_np.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    results = []
    for builder in (build_bvh_numpy, build_bvh_split):
        scene = make_traversal_scene(v0, e1, e2, leaf_size=8, builder=builder)
        rec = intersect_bvh(jnp.asarray(o), jnp.asarray(d), scene, 1e-3, 1e4)
        nrefs = len(scene.perm)
        tri_global = np.where(
            np.asarray(rec.hit),
            scene.perm[np.clip(np.asarray(rec.tri), 0, nrefs - 1)],
            -1,
        )
        results.append((np.asarray(rec.hit), np.asarray(rec.t), tri_global))

    assert len(results[1][0]) == len(results[0][0])
    np.testing.assert_array_equal(results[0][0], results[1][0])
    hits = results[0][0]
    np.testing.assert_array_equal(results[0][2], results[1][2])
    np.testing.assert_allclose(
        results[0][1][hits], results[1][1][hits], rtol=1e-6, atol=1e-6
    )


def test_max_depth_matches_recursive_reference(rng_np):
    """max_depth (vectorized ancestor walk) vs a direct per-node parent chase."""
    v0, e1, e2 = _random_tris(rng_np, 300)
    bvh = build_bvh_numpy(v0, e1, e2, leaf_size=4)

    def depth_of(i):
        d = 0
        while bvh.parent[i] >= 0:
            i = bvh.parent[i]
            d += 1
        return d

    ref = max(depth_of(i) for i in range(bvh.num_nodes))
    assert bvh.max_depth() == ref
    assert ref >= 1


def test_max_depth_single_leaf():
    v0 = np.zeros((1, 3), np.float32)
    e1 = np.asarray([[1, 0, 0]], np.float32)
    e2 = np.asarray([[0, 1, 0]], np.float32)
    assert build_bvh_numpy(v0, e1, e2, leaf_size=8).max_depth() == 0


def test_native_library_is_built_on_first_use(tmp_path, monkeypatch):
    """With no libbvh.so (a fresh checkout), the first build compiles it
    from native/bvh_builder.cpp with native/build.sh, then loads it; a
    library older than its source is rebuilt."""
    import os
    import shutil

    src_dir = os.path.dirname(native_builder.SOURCE_PATH)
    for name in ("bvh_builder.cpp", "build.sh"):
        shutil.copy(os.path.join(src_dir, name), tmp_path)
    lib = tmp_path / "libbvh.so"
    monkeypatch.setattr(native_builder, "SOURCE_PATH",
                        str(tmp_path / "bvh_builder.cpp"))
    monkeypatch.setattr(native_builder, "LIBRARY_PATH", str(lib))
    monkeypatch.setattr(native_builder, "_BUILD_SCRIPT",
                        str(tmp_path / "build.sh"))
    monkeypatch.setattr(native_builder, "_lib", None)
    assert native_builder._needs_build()
    v0, e1, e2 = _random_tris(np.random.default_rng(3), 50)
    bvh = native_builder.build_bvh_native(v0, e1, e2, leaf_size=4)
    _check_invariants(bvh, v0, e1, e2, 4)
    assert lib.exists() and not native_builder._needs_build()
    os.utime(lib, (1, 1))  # older than the source
    assert native_builder._needs_build()
