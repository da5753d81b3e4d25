"""Capacity-padded (stable-shape) bakes: image-neutral, and topology edits
re-bake into the SAME jit signature (no re-trace / re-compile).

The reference's editor adds/removes objects instantly through driver AS
rebuilds (gpu_scene.odin:430-455); here the analog is keeping every scene
table at a capacity bucket so the step() jit cache-hits across edits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.api import ProgressiveRenderer, _render_frame_jit
from raytracer_tpu.integrator.wavefront import render_frame
from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.scene.device_scene import bake_scene, update_materials
from raytracer_tpu.scene.model import (
    Material,
    create_cornell_box,
    create_sphere,
)
from raytracer_tpu.utils.config import RenderConfig


def _ubo(aspect=1.0):
    cam = Camera.create(position=(0.0, 0.0, -3.0), aspect=aspect)
    mats = cam.matrices()
    return {
        "inverse_view": jnp.asarray(mats["inverse_view"]),
        "inverse_proj": jnp.asarray(mats["inverse_proj"]),
    }


def _render(ds, cfg, frames=2):
    ubo = _ubo(cfg.width / cfg.height)
    accum = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    step = jax.jit(functools.partial(render_frame, cfg=cfg))
    for f in range(frames):
        accum = step(ds, ubo, accum, jnp.uint32(f))
    return np.asarray(accum)


def _sig(ds):
    """The ds-dependent part of a jit cache key: treedef (includes the
    static fields) + every leaf's shape/dtype."""
    leaves, treedef = jax.tree_util.tree_flatten(ds)
    return (str(treedef),
            tuple((tuple(x.shape), str(x.dtype)) for x in leaves))


def test_stable_bake_images_bit_identical():
    scene = create_cornell_box()
    cfg = RenderConfig(width=24, height=24, accel="bvh")
    ds_exact, _ = bake_scene(scene, stable_shapes=False)
    ds_pad, _ = bake_scene(scene, stable_shapes=True)
    a = _render(ds_exact, cfg)
    b = _render(ds_pad, cfg)
    assert np.array_equal(a, b)
    # Padding really happened (otherwise this test is vacuous).
    assert ds_pad.nodes_skip.shape[0] > ds_exact.nodes_skip.shape[0]
    assert ds_pad.num_lights > ds_exact.num_lights
    tc = np.asarray(ds_pad.true_counts)
    assert tc[0] == ds_exact.light_tri_v0.shape[0]
    assert tc[1] == ds_exact.light_power.shape[0]


def test_stable_bake_restir_bit_identical():
    from raytracer_tpu.integrator.restir import Reservoir, render_frame_restir

    scene = create_cornell_box()
    cfg = RenderConfig(width=16, height=16, accel="bvh", use_restir=True,
                       restir_initial_candidates=2,
                       restir_spatial_neighbors=1)
    ubo = _ubo()
    outs = {}
    for stable in (False, True):
        ds, _ = bake_scene(scene, stable_shapes=stable)
        accum = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
        res = Reservoir.empty(cfg.num_pixels)
        step = jax.jit(functools.partial(render_frame_restir, cfg=cfg))
        for f in range(2):
            accum, res = step(ds, ubo, accum, res, jnp.uint32(f))
        outs[stable] = np.asarray(accum)
    assert np.array_equal(outs[False], outs[True])


def test_object_add_keeps_jit_signature():
    """An object add inside the capacity bucket re-bakes into identical
    shapes/statics AND the render jit cache-hits (no recompile)."""
    scene = create_cornell_box()
    # Leaf 16 pins the tree size: at leaf 8 this particular edit moves the
    # Cornell tree's node count across a capacity bucket boundary.
    cfg = RenderConfig(width=16, height=16, accel="bvh", stable_bake=True,
                       bvh_leaf_size=16)
    r = ProgressiveRenderer(scene, config=cfg)
    assert r.step()
    sig0 = _sig(r.device_scene)
    n_compiles = _render_frame_jit._cache_size()

    mesh_idx = scene.add_mesh(create_sphere(stacks=4, slices=4))
    scene.add_object("extra", mesh_idx, material_index=0,
                     position=(0.2, 0.1, 0.0), scale=(0.1, 0.1, 0.1))
    assert r.step()
    assert _sig(r.device_scene) == sig0
    assert _render_frame_jit._cache_size() == n_compiles
    # The new geometry is really in the baked tables.
    assert int(np.asarray(r.device_scene.true_counts)[0]) > 3980


def test_object_delete_keeps_jit_signature():
    """Object removal (swap-remove, journaled as OBJECT_REMOVED) also
    re-bakes inside the capacity bucket: shapes/statics unchanged, the
    render jit cache-hits, and the geometry is really gone."""
    scene = create_cornell_box()
    mesh_idx = scene.add_mesh(create_sphere(4, 4))
    extra = scene.add_object("doomed", mesh_idx, 0, position=(0.2, 0, 0),
                             scale=(0.1, 0.1, 0.1))
    # Leaf 16 pins the tree size (see test_object_add_keeps_jit_signature).
    cfg = RenderConfig(width=16, height=16, accel="bvh", stable_bake=True,
                       bvh_leaf_size=16)
    r = ProgressiveRenderer(scene, config=cfg)
    assert r.step()
    sig0 = _sig(r.device_scene)
    tris0 = int(np.asarray(r.device_scene.true_counts)[0])
    n_compiles = _render_frame_jit._cache_size()

    scene.delete_object(extra)
    assert r.step()
    assert _sig(r.device_scene) == sig0
    assert _render_frame_jit._cache_size() == n_compiles
    assert int(np.asarray(r.device_scene.true_counts)[0]) < tris0


def test_bucket_slack_bound():
    """The documented capacity guarantee: ≤ +12.5% slack (plus the align
    floor for tiny tables), idempotent (a bucket is its own bucket — the
    stability property that keeps re-bake shapes identical)."""
    from raytracer_tpu.scene.device_scene import _bucket

    ns = list(range(1, 3000, 7)) + [
        (1 << k) + d for k in range(8, 22) for d in (-1, 0, 1, 5)
    ]
    for align in (4, 8, 16, 64, 128):
        for n in ns:
            b = _bucket(n, align)
            assert b >= max(n, align)
            assert b % align == 0
            assert b <= max(n * 9 // 8 + 1, n + align), (n, align, b)
            assert _bucket(b, align) == b


def test_object_delete_guards():
    import pytest

    from raytracer_tpu.scene.model import Scene, create_plane

    s = Scene()
    s.add_material(Material(name="m"))
    mesh = s.add_mesh(create_plane())
    s.add_object("only", mesh, 0)
    with pytest.raises(IndexError):
        s.delete_object(5)
    with pytest.raises(ValueError):
        s.delete_object(0)  # deleting the last object strands the renderer


def test_material_update_keeps_shapes_under_padding():
    scene = create_cornell_box()
    ds, _ = bake_scene(scene, stable_shapes=True)
    sig0 = _sig(ds)
    # Edit a non-emissive material in place (same emissive set).
    m0 = scene.materials[0]
    scene.update_material(0, Material(
        name=m0.name, albedo=(0.9, 0.1, 0.1), roughness=0.3,
        metallic=m0.metallic, emission_color=m0.emission_color,
        emission_power=m0.emission_power))
    ds2 = update_materials(ds, scene, stable_shapes=True)
    assert _sig(ds2) == sig0
    np.testing.assert_allclose(np.asarray(ds2.mat_albedo)[0],
                               [0.9, 0.1, 0.1], rtol=1e-6)
    # Padded material rows keep vacuum ior.
    assert float(np.asarray(ds2.mat_ior)[-1]) == 1.0


def test_padded_walk_terminates_everywhere():
    """Rays fired outward (guaranteed miss) and inward both terminate on
    the padded skip-link layout — the rewritten done-links never land in
    the padding."""
    from raytracer_tpu.ops.traverse import intersect_bvh

    scene = create_cornell_box()
    ds, _ = bake_scene(scene, stable_shapes=True)
    n = 64
    rng = np.random.default_rng(3)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.full((n, 3), 50.0, np.float32)  # outside the box, mostly misses
    hit_out = intersect_bvh(jnp.asarray(o), jnp.asarray(d), ds, 1e-3, 1e4)
    o2 = np.zeros((n, 3), np.float32)  # inside: everything hits
    hit_in = intersect_bvh(jnp.asarray(o2), jnp.asarray(d), ds, 1e-3, 1e4)
    ds_exact, _ = bake_scene(scene, stable_shapes=False)
    ref_out = intersect_bvh(jnp.asarray(o), jnp.asarray(d), ds_exact,
                            1e-3, 1e4)
    ref_in = intersect_bvh(jnp.asarray(o2), jnp.asarray(d), ds_exact,
                           1e-3, 1e4)
    for a, b in ((hit_out, ref_out), (hit_in, ref_in)):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))
