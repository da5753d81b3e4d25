"""Procedural benchmark scenes at Sponza scale.

The reference's large scenes are unusable in this checkout: Sponza,
white-room and bed_room ship without their .bin geometry blobs
(.MISSING_LARGE_BLOBS), and conference.glb is a 468-triangle low-poly decimat
— so the ~300k-triangle BVH-stress workload BASELINE config 4 calls for has
to be generated. Two deterministic scenes:

- `create_benchmark_atrium`: a colonnade of high-res spheres inside a walled
  room with an emissive ceiling panel — architectural occlusion (columns
  shadowing each other), mixed materials, triangle count tunable to Sponza
  scale. Uniform-density sphere lattice: the SAH happy path.
- `create_benchmark_hall`: a Sponza-geometry-class stress scene. Sponza's
  distinguishing properties (the reference's sponza.gltf node/mesh
  structure: curtain and drape meshes alongside full-hall floor/wall
  slabs) are long thin quads (drapes, ceiling beams), a >100:1
  triangle-scale mix (60-unit wall triangles vs ~0.1-unit drape cells), and
  occlusion corridors (two colonnade rows down a long hall, lit from one
  end) — all of which stress SAH split quality off the atrium's happy path.
"""

from __future__ import annotations

import math

import numpy as np

from raytracer_tpu.scene.model import (
    Material,
    Mesh,
    Scene,
    create_plane,
    create_sphere,
)


def create_benchmark_atrium(target_triangles: int = 300_000) -> Scene:
    scene = Scene()
    floor_mat = scene.add_material(
        Material(name="floor", albedo=(0.7, 0.68, 0.65), roughness=0.9)
    )
    wall_mat = scene.add_material(
        Material(name="wall", albedo=(0.75, 0.72, 0.6), roughness=1.0)
    )
    col_mats = [
        scene.add_material(
            Material(name="column_diffuse", albedo=(0.8, 0.78, 0.7),
                     roughness=0.8)
        ),
        scene.add_material(
            Material(name="column_metal", albedo=(0.85, 0.83, 0.8),
                     metallic=1.0, roughness=0.15)
        ),
        scene.add_material(
            Material(name="column_glossy", albedo=(0.4, 0.5, 0.7),
                     roughness=0.3)
        ),
    ]
    light_mat = scene.add_material(
        Material(name="skylight", albedo=(1.0, 1.0, 1.0),
                 emission_color=(1.0, 0.95, 0.9), emission_power=20.0)
    )

    plane = scene.add_mesh(create_plane())
    sphere = scene.add_mesh(create_sphere(32, 32))  # 1984 tris
    sphere_tris = scene.meshes[sphere].num_triangles

    # Room shell: 40 x 12 x 20 units.
    w, h, d = 40.0, 12.0, 20.0
    scene.add_object("Floor", plane, floor_mat, position=(0, 0, 0),
                     scale=(w, d, 1), rotation=(-90, 0, 0))
    scene.add_object("Ceiling", plane, wall_mat, position=(0, h, 0),
                     scale=(w, d, 1), rotation=(90, 0, 0))
    scene.add_object("Back", plane, wall_mat, position=(0, h / 2, d / 2),
                     scale=(w, h, 1), rotation=(0, 180, 0))
    scene.add_object("Front", plane, wall_mat, position=(0, h / 2, -d / 2),
                     scale=(w, h, 1))
    scene.add_object("Left", plane, wall_mat, position=(-w / 2, h / 2, 0),
                     scale=(d, h, 1), rotation=(0, 90, 0))
    scene.add_object("Right", plane, wall_mat, position=(w / 2, h / 2, 0),
                     scale=(d, h, 1), rotation=(0, -90, 0))
    scene.add_object("Skylight", plane, light_mat,
                     position=(0, h - 0.05, 0), scale=(w * 0.4, d * 0.4, 1),
                     rotation=(90, 0, 0))

    # Colonnade: stacked spheres as "columns" on a grid filling the
    # triangle budget.
    n_spheres = max(1, (target_triangles - 14) // sphere_tris)
    per_column = 4
    n_columns = max(1, n_spheres // per_column)
    cols_x = max(1, int(math.sqrt(n_columns * w / d)))
    cols_z = max(1, (n_columns + cols_x - 1) // cols_x)
    placed = 0
    for ix in range(cols_x):
        for iz in range(cols_z):
            if placed >= n_spheres:
                break
            x = -w / 2 + (ix + 0.5) * w / cols_x
            z = -d / 2 + (iz + 0.5) * d / cols_z
            for k in range(per_column):
                if placed >= n_spheres:
                    break
                y = 1.0 + k * 2.2
                r = 1.0 - 0.12 * k
                scene.add_object(
                    f"col_{ix}_{iz}_{k}", sphere,
                    col_mats[(ix + iz + k) % len(col_mats)],
                    position=(x, y, z), scale=(r, r, r),
                )
                placed += 1
    return scene


def _create_box() -> Mesh:
    """Unit cube centered at the origin with per-face normals (24 verts,
    12 tris). Scaled long and thin it makes Sponza-style pillars/beams."""
    pos, nrm, idx = [], [], []
    # (axis, sign): face normal along +-axis; the face is a quad in the
    # other two axes.
    for axis in range(3):
        for sign in (1.0, -1.0):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            base = len(pos)
            for du, dv in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5),
                           (-0.5, 0.5)):
                p = [0.0, 0.0, 0.0]
                p[axis] = 0.5 * sign
                p[u] = du
                p[v] = dv
                pos.append(p)
                n = [0.0, 0.0, 0.0]
                n[axis] = sign
                nrm.append(n)
            if sign > 0:
                idx += [base, base + 1, base + 2, base, base + 2, base + 3]
            else:
                idx += [base, base + 2, base + 1, base, base + 3, base + 2]
    return Mesh(name="Box", positions=np.asarray(pos, np.float32),
                normals=np.asarray(nrm, np.float32),
                indices=np.asarray(idx, np.uint32))


def _create_drape(nx: int, ny: int, waves: float = 3.0,
                  amp: float = 0.12) -> Mesh:
    """A hanging curtain: an (nx x ny)-cell sheet in the XY plane (unit
    square, centered), displaced in Z by a sine along X whose amplitude
    grows toward the bottom (pinned at the rail, free at the hem — the
    shape of Sponza's curtain meshes). Cells are tall and thin: with
    nx >> ny per unit aspect the triangles are long slivers, the case that
    degrades axis-aligned SAH splits. Analytic normals from the surface
    derivative."""
    xs = np.linspace(-0.5, 0.5, nx + 1, dtype=np.float32)
    ys = np.linspace(-0.5, 0.5, ny + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")  # [nx+1, ny+1]
    phase = 2.0 * np.pi * waves * (gx + 0.5)
    droop = (0.5 - gy)  # 0 at the rail (top), 1 at the hem
    gz = amp * np.sin(phase) * droop
    pos = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    # z = amp*sin(phase(x))*droop(y):  dz/dx, dz/dy -> n = (-dz/dx, -dz/dy, 1)
    dzdx = amp * 2.0 * np.pi * waves * np.cos(phase) * droop
    dzdy = -amp * np.sin(phase)
    n = np.stack([-dzdx, -dzdy, np.ones_like(gz)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nrm = n.reshape(-1, 3).astype(np.float32)

    idx = []
    stride = ny + 1
    for i in range(nx):
        for j in range(ny):
            v00 = i * stride + j
            v01 = v00 + 1
            v10 = v00 + stride
            v11 = v10 + 1
            idx += [v00, v10, v11, v00, v11, v01]
    return Mesh(name="Drape", positions=pos.astype(np.float32), normals=nrm,
                indices=np.asarray(idx, np.uint32))


def create_benchmark_hall(target_triangles: int = 300_000) -> Scene:
    """Sponza-class stress hall: a 60x12x15 corridor,
    two colonnade rows of square pillars, long thin ceiling beams, and
    tessellated drapes hanging between the pillars, lit by one emissive
    panel at the far end plus a narrow skylight strip. Geometry
    distribution modeled on the reference's models/sponza/sponza.gltf
    (curtain/drape meshes alongside full-hall slabs; loader semantics
    src/raytracer/scene_loader.odin:102-187):

    - long thin quads: beams are 15-unit-long x 0.25-unit boxes (60:1),
      pillar faces are 9x0.9 (10:1)
    - >100:1 triangle-scale mix: wall triangles span 60 units, drape cells
      ~0.1 units
    - occlusion corridors: the far-end panel lights the hall down its
      length through two pillar rows and the drapes

    Triangle budget is filled by drape tessellation; everything is
    deterministic (pure analytic geometry, no RNG)."""
    scene = Scene()
    stone = scene.add_material(
        Material(name="stone", albedo=(0.62, 0.58, 0.52), roughness=0.95)
    )
    pillar_mat = scene.add_material(
        Material(name="pillar", albedo=(0.70, 0.66, 0.58), roughness=0.85)
    )
    beam_mat = scene.add_material(
        Material(name="beam_bronze", albedo=(0.55, 0.38, 0.22),
                 metallic=1.0, roughness=0.35)
    )
    drape_mats = [
        scene.add_material(
            Material(name="drape_red", albedo=(0.55, 0.08, 0.08),
                     roughness=1.0)
        ),
        scene.add_material(
            Material(name="drape_green", albedo=(0.10, 0.35, 0.12),
                     roughness=1.0)
        ),
        scene.add_material(
            Material(name="drape_blue", albedo=(0.10, 0.15, 0.45),
                     roughness=1.0)
        ),
    ]
    end_light = scene.add_material(
        Material(name="end_light", albedo=(1.0, 1.0, 1.0),
                 emission_color=(1.0, 0.93, 0.85), emission_power=30.0)
    )
    sky_light = scene.add_material(
        Material(name="sky_strip", albedo=(1.0, 1.0, 1.0),
                 emission_color=(0.8, 0.9, 1.0), emission_power=12.0)
    )

    plane = scene.add_mesh(create_plane())
    box = scene.add_mesh(_create_box())

    # Hall shell: 60 long (x), 12 high (y), 15 deep (z). Wall triangles
    # span the full 60 units — the huge end of the scale mix.
    L, H, D = 60.0, 12.0, 15.0
    scene.add_object("Floor", plane, stone, position=(0, 0, 0),
                     scale=(L, D, 1), rotation=(-90, 0, 0))
    scene.add_object("Ceiling", plane, stone, position=(0, H, 0),
                     scale=(L, D, 1), rotation=(90, 0, 0))
    scene.add_object("WallBack", plane, stone, position=(0, H / 2, D / 2),
                     scale=(L, H, 1), rotation=(0, 180, 0))
    scene.add_object("WallFront", plane, stone, position=(0, H / 2, -D / 2),
                     scale=(L, H, 1))
    scene.add_object("WallLeft", plane, stone, position=(-L / 2, H / 2, 0),
                     scale=(D, H, 1), rotation=(0, 90, 0))
    # Far end (+x): the emissive panel that lights the corridor lengthwise.
    scene.add_object("WallRight", plane, stone, position=(L / 2, H / 2, 0),
                     scale=(D, H, 1), rotation=(0, -90, 0))
    scene.add_object("EndLight", plane, end_light,
                     position=(L / 2 - 0.05, H * 0.45, 0),
                     scale=(D * 0.6, H * 0.55, 1), rotation=(0, -90, 0))
    scene.add_object("SkyStrip", plane, sky_light,
                     position=(-L * 0.3, H - 0.05, 0),
                     scale=(L * 0.25, 1.2, 1), rotation=(90, 0, 0))

    # Two colonnade rows of square pillars (10:1 faces) + ceiling beams
    # (60:1 slivers) spanning the hall's depth.
    n_pillars = 9
    for row, z in ((0, -D * 0.28), (1, D * 0.28)):
        for i in range(n_pillars):
            x = -L / 2 + (i + 0.5) * L / n_pillars
            scene.add_object(f"pillar_{row}_{i}", box, pillar_mat,
                             position=(x, (H - 2.0) / 2, z),
                             scale=(0.9, H - 2.0, 0.9))
    for i in range(n_pillars - 1):
        x = -L / 2 + (i + 1.0) * L / n_pillars
        scene.add_object(f"beam_{i}", box, beam_mat,
                         position=(x, H - 0.6, 0),
                         scale=(0.25, 0.25, D))

    # Drapes between consecutive pillars of each row: the tessellation
    # budget. Cells are ~4x taller than wide (long slivers).
    fixed_tris = scene.num_triangles
    n_drapes = 2 * (n_pillars - 1)
    per_drape = max((target_triangles - fixed_tris) // n_drapes, 2)
    cells = max(per_drape // 2, 1)
    nx = max(int(math.sqrt(cells * 4.0)), 1)  # 4:1 tall cells
    ny = max(cells // nx, 1)
    drape = scene.add_mesh(_create_drape(nx, ny))
    dw = L / n_pillars - 1.2  # span between pillar faces
    dh = H - 3.4
    for row, z in ((0, -D * 0.28), (1, D * 0.28)):
        for i in range(n_pillars - 1):
            x = -L / 2 + (i + 1.0) * L / n_pillars
            scene.add_object(
                f"drape_{row}_{i}", drape,
                drape_mats[(row + i) % len(drape_mats)],
                position=(x, 2.2 + dh / 2, z),
                scale=(dw, dh, 1.0),
            )
    return scene


def create_benchmark_lightgrid(n_lights: int = 64,
                               target_triangles: int = 20_000) -> Scene:
    """Many-light stress room: an 8x8 (default) grid of colored emissive
    ceiling panels over a field of occluder boxes and spheres.

    ReSTIR DI's value is proportional to the number of lights competing per
    pixel (RIS over M candidates + temporal M growth — Bitterli et al.
    2020); the atrium/hall scenes have 1-2 lights, where plain NEE's
    power/distance^2 CDF pick (simple.rchit:543-583) is already near-optimal.
    This scene is the regime the reference's restir scaffolding
    (shaders/restir/restir_structs.glsl) targets: every surface point sees
    dozens of panels of mixed power and color, most shadowed by the box
    field, so the one-light-per-bounce NEE estimator is noisy while
    reservoir reuse converges. Deterministic (index-hashed panel colors,
    analytic layout); n_lights is capped at MAXLIGHTS=256
    (simple.rchit:13)."""
    n_lights = min(n_lights, 256)
    scene = Scene()
    wall = scene.add_material(
        Material(name="wall", albedo=(0.62, 0.60, 0.58), roughness=0.9)
    )
    floor_mat = scene.add_material(
        Material(name="floor", albedo=(0.45, 0.45, 0.48), roughness=0.6)
    )
    box_mats = [
        scene.add_material(
            Material(name="crate_warm", albedo=(0.55, 0.35, 0.18),
                     roughness=0.8)
        ),
        scene.add_material(
            Material(name="crate_cool", albedo=(0.20, 0.30, 0.45),
                     roughness=0.7)
        ),
        scene.add_material(
            Material(name="crate_metal", albedo=(0.85, 0.85, 0.88),
                     metallic=1.0, roughness=0.25)
        ),
    ]

    plane = scene.add_mesh(create_plane())
    box = scene.add_mesh(_create_box())

    # Room shell: 24 x 6 x 24.
    W, H, D = 24.0, 6.0, 24.0
    scene.add_object("Floor", plane, floor_mat, position=(0, 0, 0),
                     scale=(W, D, 1), rotation=(-90, 0, 0))
    scene.add_object("Ceiling", plane, wall, position=(0, H, 0),
                     scale=(W, D, 1), rotation=(90, 0, 0))
    scene.add_object("WallBack", plane, wall, position=(0, H / 2, D / 2),
                     scale=(W, H, 1), rotation=(0, 180, 0))
    scene.add_object("WallFront", plane, wall, position=(0, H / 2, -D / 2),
                     scale=(W, H, 1))
    scene.add_object("WallLeft", plane, wall, position=(-W / 2, H / 2, 0),
                     scale=(D, H, 1), rotation=(0, 90, 0))
    scene.add_object("WallRight", plane, wall, position=(W / 2, H / 2, 0),
                     scale=(D, H, 1), rotation=(0, -90, 0))

    # Light grid: ng x ng downward panels, colors/powers index-hashed so
    # neighbors differ (power spans 16:1 — selection matters).
    ng = max(int(math.sqrt(n_lights)), 1)
    palette = [
        (1.0, 0.85, 0.6), (0.6, 0.8, 1.0), (1.0, 0.5, 0.5),
        (0.6, 1.0, 0.6), (1.0, 1.0, 0.9), (0.9, 0.6, 1.0),
    ]
    placed = 0
    for i in range(ng):
        for j in range(ng):
            if placed >= n_lights:
                break
            color = palette[(i * 7 + j * 3) % len(palette)]
            power = 2.0 * (1 + ((i * 5 + j) % 4)) * (
                8.0 if (i * ng + j) % 9 == 0 else 1.0
            )
            m = scene.add_material(
                Material(name=f"panel_{i}_{j}", albedo=(1, 1, 1),
                         emission_color=color, emission_power=power)
            )
            x = -W / 2 + (i + 0.5) * W / ng
            z = -D / 2 + (j + 0.5) * D / ng
            scene.add_object(f"Panel_{i}_{j}", plane, m,
                             position=(x, H - 0.02, z),
                             scale=(0.45 * W / ng, 0.45 * D / ng, 1),
                             rotation=(90, 0, 0))
            placed += 1

    # Occluder field: a 6x6 grid of boxes of varied heights (deterministic
    # pseudo-random from the index) so most panels are shadowed from most
    # floor points, plus a few high-res spheres to fill the triangle
    # budget and add specular pickup of the colored panels.
    nb = 6
    for i in range(nb):
        for j in range(nb):
            h = 0.6 + 2.2 * (((i * 13 + j * 7) % 8) / 7.0)
            s = 0.8 + 0.9 * (((i * 3 + j * 11) % 5) / 4.0)
            x = -W / 2 + (i + 0.75) * W / (nb + 0.5)
            z = -D / 2 + (j + 0.75) * D / (nb + 0.5)
            scene.add_object(f"crate_{i}_{j}", box,
                             box_mats[(i + 2 * j) % len(box_mats)],
                             position=(x, h / 2, z), scale=(s, h, s))
    fixed = scene.num_triangles
    n_spheres = 4
    per = max((target_triangles - fixed) // n_spheres, 8)
    stacks = max(int(math.sqrt(per / 2.0)), 4)
    sphere = scene.add_mesh(create_sphere(stacks, stacks))
    for k in range(n_spheres):
        x = -6.0 + 4.0 * k
        scene.add_object(f"orb_{k}", sphere, box_mats[2 - (k % 3) % 3],
                         position=(x, 1.4, -8.5 + 1.5 * (k % 2)),
                         scale=(1.4, 1.4, 1.4))
    return scene
