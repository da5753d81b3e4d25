"""Scene model, loaders, camera, device bake."""

import os

import numpy as np
import pytest

from raytracer_tpu.ops.camera import Camera
from raytracer_tpu.scene.model import (
    Material,
    Scene,
    SceneChangeType,
    Transform,
    create_cornell_box,
    create_plane,
    create_sphere,
)

REF = "/root/reference"


def test_plane_mesh():
    m = create_plane()
    assert m.positions.shape == (4, 3)
    assert m.indices.tolist() == [0, 1, 2, 0, 2, 3]
    assert (m.normals == [0, 0, 1]).all()


def test_sphere_mesh():
    m = create_sphere(32, 32)
    # 1 + 31*32 + 1 vertices; 32*2 cap tris + 30*32*2 quad tris
    assert len(m.positions) == 2 + 31 * 32
    assert m.num_triangles == 32 * 2 + 30 * 32 * 2
    r = np.linalg.norm(m.positions, axis=1)
    np.testing.assert_allclose(r, 1.0, atol=1e-5)


def test_transform_matrix_trs_order():
    tr = Transform(position=(1, 2, 3), rotation=(0, 90, 0), scale=(2, 2, 2))
    tr.update_matrices()
    # M = T*Ry(90)*S: x axis maps to -z scaled by 2 plus translation.
    p = tr.model_matrix @ np.asarray([1, 0, 0, 1], np.float32)
    np.testing.assert_allclose(p[:3], [1, 2, 3 - 2], atol=1e-5)
    # normal matrix = inv transpose
    want = np.linalg.inv(tr.model_matrix).T
    np.testing.assert_allclose(tr.normal_matrix, want, atol=1e-6)


def test_change_journal():
    scene = create_cornell_box()
    scene.drain_changes()
    scene.update_material(0, Material(name="white", albedo=(1, 0, 0)))
    scene.update_object_position(0, (1, 1, 1))
    changes = scene.drain_changes()
    assert [c.type for c in changes] == [
        SceneChangeType.MATERIAL_CHANGED,
        SceneChangeType.OBJECT_TRANSFORM_CHANGED,
    ]
    assert scene.drain_changes() == []


def test_cornell_box_structure():
    scene = create_cornell_box()
    assert len(scene.objects) == 8
    assert len(scene.materials) == 6
    assert scene.num_triangles == 6 * 2 + 2 * (32 * 2 + 30 * 32 * 2)
    light_mats = [
        scene.materials[o.material_index]
        for o in scene.objects
        if scene.materials[o.material_index].emission_power > 0
    ]
    assert len(light_mats) == 1 and light_mats[0].emission_power == 10.0


def test_json_loader_matches_builtin_cornell():
    from raytracer_tpu.scene.loaders import load_scene

    path = os.path.join(REF, "scenes/cornell_box.json")
    if not os.path.exists(path):
        pytest.skip("reference scenes not mounted")
    scene = load_scene(path)
    # The shipped JSON has one extra sphere vs the built-in constructor.
    assert len(scene.objects) == 9
    assert len(scene.materials) == 6
    names = {m.name for m in scene.materials}
    assert names == {"white", "red", "green", "light", "metallic", "glossy"}


def test_in_repo_cornell_json_matches_builtin_cornell():
    """examples/scenes/cornell_box.json is create_cornell_box() in the
    reference's JSON format: same materials, objects, meshes, transforms."""
    from raytracer_tpu.scene.loaders import load_scene
    from raytracer_tpu.scene.model import create_cornell_box

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "scenes", "cornell_box.json")
    got, want = load_scene(path), create_cornell_box()
    assert got.materials == want.materials
    assert len(got.objects) == len(want.objects) == 8
    for a, b in zip(got.objects, want.objects):
        assert (a.name, a.mesh_index, a.material_index) == (
            b.name, b.mesh_index, b.material_index)
        np.testing.assert_array_equal(a.transform.model_matrix,
                                      b.transform.model_matrix)
    for a, b in zip(got.meshes, want.meshes):
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize(
    "rel",
    [
        "scenes/cornell_pbr.glb",
        "scenes/multi-dispersion.gltf",
        "models/conference.glb",
        "models/conference_mirror_chairs.glb",
        "models/conference_room_large_pbr.glb",
        "models/cornell_box/scene.gltf",
        "models/cornell_box/scene_with_light.glb",
    ],
)
def test_gltf_loader(rel):
    from raytracer_tpu.scene.loaders import load_scene

    path = os.path.join(REF, rel)
    if not os.path.exists(path):
        pytest.skip("reference scenes not mounted")
    scene = load_scene(path)
    assert len(scene.objects) > 0
    assert scene.num_triangles > 0
    for m in scene.meshes:
        assert np.isfinite(m.positions).all()
        assert int(m.indices.max()) < len(m.positions)


def test_gltf_transmission_extension():
    from raytracer_tpu.scene.loaders import load_scene

    path = os.path.join(REF, "scenes/multi-dispersion.gltf")
    if not os.path.exists(path):
        pytest.skip("reference scenes not mounted")
    scene = load_scene(path)
    assert any(m.transmission > 0 for m in scene.materials)


def test_camera_matrices():
    cam = Camera.create(position=(0, 0, -3), aspect=1.0)
    mats = cam.matrices()
    # inverse_view translation column = camera position
    np.testing.assert_allclose(
        mats["inverse_view"][:3, 3], [0, 0, -3], atol=1e-6
    )
    # view * inverse_view = I
    np.testing.assert_allclose(
        mats["view"] @ mats["inverse_view"], np.eye(4), atol=1e-5
    )
    # Vulkan Y flip: proj[1][1] negative of GL convention
    assert mats["proj"][1, 1] < 0
    # Forward: camera at -z looking at origin -> center ray points +z.
    d = np.asarray([0.0, 0.0])  # NDC center
    t = mats["inverse_proj"][:3, :] @ np.asarray([d[0], d[1], 1, 1], np.float32)
    t = t / np.linalg.norm(t)
    direction = mats["inverse_view"][:3, :3] @ t
    direction /= np.linalg.norm(direction)
    np.testing.assert_allclose(direction, [0, 0, 1], atol=1e-5)


def test_bake_scene(cornell_scene, cornell_device_scene):
    ds = cornell_device_scene
    assert ds.num_lights == 1
    assert ds.num_triangles == cornell_scene.num_triangles
    assert ds.tri_v0.shape[0] % 128 == 0
    assert int(ds.light_num_tris[0]) == 2
    # Light center: the reference light sits near the floor at y=-2.4.
    np.testing.assert_allclose(
        np.asarray(ds.light_center[0]), [0, -2.4, 0], atol=1e-5
    )
    # Padding triangles are degenerate and flagged object -1.
    pad = np.asarray(ds.tri_object[ds.num_triangles:])
    assert (pad == -1).all()


def test_material_update_path(cornell_scene):
    from raytracer_tpu.scene.device_scene import bake_scene, update_materials

    ds, _ = bake_scene(cornell_scene)
    cornell_scene.update_material(
        0, Material(name="white", albedo=(0.9, 0.1, 0.1), roughness=0.5)
    )
    ds2 = update_materials(ds, cornell_scene)
    np.testing.assert_allclose(
        np.asarray(ds2.mat_albedo[0]), [0.9, 0.1, 0.1], atol=1e-6
    )
    # Geometry untouched (same arrays).
    assert ds2.tri_v0 is ds.tri_v0
    cornell_scene.drain_changes()


def test_gltf_trs_decompose_roundtrip():
    """Loader TRS fields must regenerate the node matrix under the Transform
    contract (T*Rx*Ry*Rz*S), so a later transform edit doesn't mangle
    quaternion-rotated objects (previously quat x,y,z were stored verbatim
    as Euler degrees)."""
    import math

    from raytracer_tpu.scene.gltf import _decompose_trs
    from raytracer_tpu.scene.model import Transform

    rng = np.random.default_rng(7)
    for trial in range(50):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        x, y, z, w = q
        r = np.asarray(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        world = np.eye(4, dtype=np.float32)
        world[:3, :3] = r @ np.diag(rng.uniform(0.2, 3.0, size=3))
        world[:3, 3] = rng.uniform(-5, 5, size=3)

        pos, rot, scale = _decompose_trs(world)
        t = Transform(position=pos, rotation=rot, scale=scale).update_matrices()
        assert np.allclose(t.model_matrix, world, atol=1e-4), (
            trial, t.model_matrix, world
        )

    # Gimbal-lock case: pure +90deg pitch (R[0,2] = 1).
    world = np.eye(4, dtype=np.float32)
    world[:3, :3] = np.asarray(
        [[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32
    )
    pos, rot, scale = _decompose_trs(world)
    t = Transform(position=pos, rotation=rot, scale=scale).update_matrices()
    assert np.allclose(t.model_matrix, world, atol=1e-5)
