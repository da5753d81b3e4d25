"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set XLA flags before jax initializes (SURVEY.md §4: multi-device tests
use the CPU fake backend; the card itself is exercised by chip_smoke.py)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cornell_scene():
    from raytracer_tpu.scene.model import create_cornell_box

    return create_cornell_box()


@pytest.fixture(scope="session")
def cornell_device_scene(cornell_scene):
    from raytracer_tpu.scene.device_scene import bake_scene

    ds, _bvh = bake_scene(cornell_scene)
    return ds


@pytest.fixture()
def rng_np():
    return np.random.default_rng(seed=1234)


def make_traversal_scene(v0, e1, e2, tri_object=None, leaf_size=8,
                         builder=None):
    """Build a minimal traversal-ready scene (BVH + packed layouts) from raw
    triangles, for unit tests that bypass the full bake."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from raytracer_tpu.accel.bvh import build_bvh_numpy
    from raytracer_tpu.scene.device_scene import _pack_traversal_arrays

    if tri_object is None:
        tri_object = np.arange(len(v0), dtype=np.int32)
    bvh = (builder or build_bvh_numpy)(v0, e1, e2, leaf_size=leaf_size)
    perm = bvh.tri_order
    nodes_packed, tris_packed = _pack_traversal_arrays(
        bvh, v0[perm], e1[perm], e2[perm], tri_object[perm], leaf_size
    )
    return SimpleNamespace(
        bvh=bvh,
        perm=perm,
        tri_v0=jnp.asarray(v0[perm]),
        tri_e1=jnp.asarray(e1[perm]),
        tri_e2=jnp.asarray(e2[perm]),
        tri_object=jnp.asarray(tri_object[perm]),
        nodes_packed=jnp.asarray(nodes_packed),
        tris_packed=jnp.asarray(tris_packed),
    )
