"""ops/traverse.py (the BVH walk, the only compiled traversal path) against
ops/intersect.py (brute force, its oracle): closest hits and occlusion over
seeded scenes that cover the tree's edge cases, at leaf sizes 4 and 16."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.ops.intersect import intersect_brute, occlusion_brute
from raytracer_tpu.ops.traverse import intersect_bvh, occlusion_bvh

T_MIN, T_MAX = 1e-3, 1e4
N_RAYS = 256


def _tri(points):
    p = np.asarray(points, np.float32)
    return p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]


def _raw(v0, e1, e2, leaf):
    """Traversal arrays for raw triangles through the production builder;
    object ids group triangles in threes so skip_object masks several."""
    from raytracer_tpu.accel.bvh import build_bvh
    from tests.conftest import make_traversal_scene

    obj = (np.arange(len(v0)) // 3).astype(np.int32)
    return make_traversal_scene(v0, e1, e2, tri_object=obj, leaf_size=leaf,
                                builder=build_bvh)


def _baked(scene, leaf, stable=False):
    from raytracer_tpu.scene.device_scene import bake_scene

    ds, _ = bake_scene(scene, leaf_size=leaf, stable_shapes=stable)
    return ds


def _scene(name, leaf):
    rng = np.random.default_rng(7)
    if name == "cornell":
        from raytracer_tpu.scene.model import create_cornell_box

        return _baked(create_cornell_box(), leaf)
    if name == "stable_padded":
        from raytracer_tpu.scene.model import create_cornell_box

        return _baked(create_cornell_box(), leaf, stable=True)
    if name == "atrium_2k":
        from raytracer_tpu.scene.benchmark import create_benchmark_atrium

        return _baked(create_benchmark_atrium(2000), leaf)
    if name == "random_soup":
        v0 = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
        e1 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        e2 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        return _raw(v0, e1, e2, leaf)
    if name == "one_triangle":
        return _raw(*_tri([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]]), leaf)
    if name == "single_leaf_root":
        # Fewer triangles than the smallest leaf: the root is the leaf.
        return _raw(*_tri([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                           [[-1, -1, 1], [1, -1, 1], [0, 1, 1]],
                           [[-2, 0, -1], [2, 0, -1], [0, 0, 2]]]), leaf)
    if name == "coincident_centroids":
        # Same centroid for every triangle: SAH binning cannot split.
        ang = rng.uniform(0, 2 * np.pi, 40)
        pts = []
        for a in ang:
            d = np.asarray([np.cos(a), np.sin(a), 0.3 * np.sin(3 * a)])
            pts.append([d, -0.5 * d + [0, 0, 1], -0.5 * d - [0, 0, 1]])
        return _raw(*_tri(pts), leaf)
    raise KeyError(name)


SCENES = ["cornell", "random_soup", "one_triangle", "single_leaf_root",
          "coincident_centroids", "stable_padded", "atrium_2k"]


def _rays(scene, rng):
    """Half the rays aim at points on random triangles (hits), half go in
    random directions; origins scatter around the scene's bounds."""
    v0 = np.asarray(scene.tri_v0)
    e1 = np.asarray(scene.tri_e1)
    e2 = np.asarray(scene.tri_e2)
    real = np.abs(np.cross(e1, e2)).sum(-1) > 0  # skip degenerate padding
    v0, e1, e2 = v0[real], e1[real], e2[real]
    pts = np.concatenate([v0, v0 + e1, v0 + e2])
    lo, hi = pts.min(0), pts.max(0)
    ext = np.maximum(hi - lo, 1e-3)
    origin = rng.uniform(lo - 0.5 * ext, hi + 0.5 * ext, (N_RAYS, 3))
    k = rng.integers(0, len(v0), N_RAYS)
    a, b = rng.uniform(0, 1, (2, N_RAYS))
    flip = a + b > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    target = v0[k] + a[:, None] * e1[k] + b[:, None] * e2[k]
    d = target - origin
    rand = rng.normal(size=(N_RAYS, 3))
    d[N_RAYS // 2:] = rand[N_RAYS // 2:]
    dist = np.linalg.norm(d, axis=1)
    d /= dist[:, None]
    return (origin.astype(np.float32), d.astype(np.float32),
            dist.astype(np.float32))


def _assert_same_closest(bvh, brute):
    hit_b, hit_r = np.asarray(bvh.hit), np.asarray(brute.hit)
    np.testing.assert_array_equal(hit_b, hit_r)
    t_b, t_r = np.asarray(bvh.t), np.asarray(brute.t)
    np.testing.assert_allclose(t_b[hit_r], t_r[hit_r], rtol=1e-6)
    # The triangle may differ only where two triangles tie on t.
    tri_b, tri_r = np.asarray(bvh.tri), np.asarray(brute.tri)
    differs = hit_r & (tri_b != tri_r)
    assert np.all(t_b[differs] == t_r[differs])
    assert hit_r.any(), "no ray hit anything: the case tests nothing"


@pytest.mark.parametrize("leaf", [4, 16])
@pytest.mark.parametrize("name", SCENES)
def test_closest_hit_matches_brute(name, leaf):
    scene = _scene(name, leaf)
    o, d, _ = _rays(scene, np.random.default_rng(11))
    o, d = jnp.asarray(o), jnp.asarray(d)
    bvh = intersect_bvh(o, d, scene, T_MIN, T_MAX)
    brute = intersect_brute(o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2,
                            T_MIN, T_MAX)
    _assert_same_closest(bvh, brute)


@pytest.mark.parametrize("leaf", [4, 16])
@pytest.mark.parametrize("name", SCENES)
def test_occlusion_matches_brute(name, leaf):
    """Any-hit with per-ray t_max (some segments end before their target,
    some after) and skip_object (hits on the skipped object are ignored)."""
    scene = _scene(name, leaf)
    rng = np.random.default_rng(13)
    o, d, dist = _rays(scene, rng)
    t_max = jnp.asarray(dist * rng.uniform(0.5, 1.2, N_RAYS), jnp.float32)
    objs = np.asarray(scene.tri_object)
    skip = np.where(rng.uniform(size=N_RAYS) < 0.5,
                    rng.choice(objs[objs >= 0], N_RAYS), -1).astype(np.int32)
    o, d, skip = jnp.asarray(o), jnp.asarray(d), jnp.asarray(skip)
    got = occlusion_bvh(o, d, T_MIN, t_max, scene, skip)
    want = occlusion_brute(o, d, T_MIN, t_max, scene.tri_v0, scene.tri_e1,
                           scene.tri_e2, scene.tri_object, skip)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(want).any() and not np.asarray(want).all()


def test_active_mask_closest_hit():
    """Inactive lanes start finished: a miss with t = t_max and tri = -1;
    active lanes are unaffected."""
    scene = _scene("cornell", 16)
    rng = np.random.default_rng(17)
    o, d, _ = _rays(scene, rng)
    active = rng.uniform(size=N_RAYS) < 0.6
    o, d = jnp.asarray(o), jnp.asarray(d)
    got = intersect_bvh(o, d, scene, T_MIN, T_MAX,
                        active_mask=jnp.asarray(active))
    full = intersect_bvh(o, d, scene, T_MIN, T_MAX)
    assert not np.asarray(got.hit)[~active].any()
    assert (np.asarray(got.tri)[~active] == -1).all()
    np.testing.assert_array_equal(np.asarray(got.t)[~active], T_MAX)
    for f in ("t", "tri", "u", "v", "hit"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[active],
                                      np.asarray(getattr(full, f))[active])


def test_active_mask_occlusion():
    scene = _scene("atrium_2k", 16)
    rng = np.random.default_rng(19)
    o, d, dist = _rays(scene, rng)
    active = rng.uniform(size=N_RAYS) < 0.6
    skip = jnp.full((N_RAYS,), -1, jnp.int32)
    args = (jnp.asarray(o), jnp.asarray(d), T_MIN,
            jnp.asarray(dist * 0.999, jnp.float32), scene, skip)
    got = np.asarray(occlusion_bvh(*args, active_mask=jnp.asarray(active)))
    full = np.asarray(occlusion_bvh(*args))
    assert not got[~active].any()
    np.testing.assert_array_equal(got[active], full[active])
