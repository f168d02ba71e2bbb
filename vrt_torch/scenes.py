"""Scenes the port renders: the flagship frame of ``bench.py``, as a device
scene built directly (``flagship_scene``) and as a host scene graph
(``flagship_graph``)."""

from __future__ import annotations

import numpy as np
import torch

# where ``__graft_entry__._flagship_scene`` places things
SPHERE_POSITION = (0.0, -70.0, 0.0)
BOX_POSITION = (0.0, 90.0, 10.0)
BOX_EULER = (0.0, 30.0, 0.0)
CAMERA_POSITION = (320.0, 0.0, 40.0)
CAMERA_EULER = (0.0, 180.0, 0.0)
LIGHT_EULER = (0.0, 45.0, -30.0)
LIGHT_STRENGTH = 6.0
SKY = (0.25, 0.45, 0.85)


def flagship_volumes(resolution: int = 5):
    """The flagship's two host volumes: a roughness-0.1 reflective sphere
    and a CSG box minus a sphere."""
    from vrt_torch.core.material import Material
    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    sphere = VoxelVolume.from_generator(
        S.Sphere(radius=50.0), resolution, 100.0,
        material=Material(albedo=(0.9, 0.2, 0.2, 1.0), roughness=0.1,
                          metallic=0.6))
    csg = S.CSG(shape=S.Box(extends=(40.0, 40.0, 40.0)))
    csg.add_child(S.Sphere(radius=50.0), S.SUBTRACT)
    box = VoxelVolume.from_generator(
        csg, resolution, 100.0,
        material=Material(albedo=(0.2, 0.4, 0.9, 1.0), roughness=0.8))
    return sphere, box


def _sky():
    env = np.zeros((6, 8, 8, 3), np.float32)
    env[:] = SKY
    return env


def flagship_scene(resolution: int = 5, accel_mode: str = "octree",
                   march_dtype: torch.dtype | None = None,
                   device: torch.device | str = "cuda",
                   use_colors: bool = False):
    """Two instances — a roughness-0.1 reflective sphere and a CSG box
    minus a sphere — an 8x8 sky cube, and a directional light with shadows
    (the parameters of ``__graft_entry__._flagship_scene``).  With
    ``use_colors`` both volumes carry per-voxel colours of 0.5, the fit's
    albedo field (``vrt/apps/bench.py``'s config6 and config4 scenes)."""
    from vrt_torch.core import quat as vq
    from vrt_torch.render.gpuscene import build_scene

    sphere, box = flagship_volumes(resolution)
    colors = None
    if use_colors:
        n = sphere.n_voxels
        colors = np.full((2, n, n, n, 3), 0.5, np.float32)
    return build_scene(
        [sphere, box],
        [{"volume": 0, "position": SPHERE_POSITION},
         {"volume": 1, "position": BOX_POSITION,
          "rotation": np.asarray(vq.from_euler_degrees(*BOX_EULER))}],
        accel_mode=accel_mode, march_dtype=march_dtype,
        camera={"position": CAMERA_POSITION,
                "rotation": vq.from_euler_degrees(*CAMERA_EULER),
                "fov": 60.0},
        dir_light={"direction": np.asarray(vq.forward_vector(
            vq.from_euler_degrees(*LIGHT_EULER))),
            "strength": LIGHT_STRENGTH},
        env=_sky(), voxel_colors=colors, device=device)


def flagship_graph(resolution: int = 5):
    """The flagship as a host ``Scene``: the same two volumes, camera, light
    and sky, placed as ``flagship_scene`` places them, so that
    ``flagship_graph(r).to_gpu(accel_mode=m, device=d)`` holds the tensors of
    ``flagship_scene(r, m, device=d)``.  Returns (scene, sphere object, box
    object)."""
    from vrt_torch.core import quat as vq
    from vrt_torch.scene.scene import (Camera, DirectionalLight, Scene,
                                       VoxelObject)

    sphere, box = flagship_volumes(resolution)
    scene = Scene()
    a = scene.spawn(VoxelObject(
        volume=sphere, position=np.asarray(SPHERE_POSITION, np.float32)))
    b = scene.spawn(VoxelObject(
        volume=box, position=np.asarray(BOX_POSITION, np.float32),
        rotation=np.asarray(vq.from_euler_degrees(*BOX_EULER))))
    scene.spawn(Camera(
        position=np.asarray(CAMERA_POSITION, np.float32),
        rotation=np.asarray(vq.from_euler_degrees(*CAMERA_EULER)), fov=60.0))
    scene.spawn(DirectionalLight(
        rotation=np.asarray(vq.from_euler_degrees(*LIGHT_EULER)),
        strength=LIGHT_STRENGTH))
    scene.environment = _sky()
    return scene, a, b


def shading_scene(resolution: int = 4, points: int = 2, spots: int = 1,
                  colors: bool = False, reflective: bool = True,
                  accel_mode: str = "octree",
                  march_dtype: torch.dtype | None = None,
                  device: torch.device | str = "cuda", seed: int = 0):
    """The flagship's two volumes with everything shading can read switched
    on: three seeded 16x8, 8x8 and 4x16 textures (albedo, tangent normal,
    roughness / metallic) tiled every 37 x 23 units, a scaled and rotated
    box, ``points`` point and ``spots`` spot lights around the objects, a
    seeded 8x8 env cube and, with ``colors``, seeded per-voxel colours.
    Without ``reflective`` no material is smooth enough to bounce."""
    from vrt_torch.core import quat as vq
    from vrt_torch.render.gpuscene import build_scene

    rng = np.random.default_rng(seed)
    sphere, box = flagship_volumes(resolution)
    sphere.material.texture_scale = box.material.texture_scale = (37.0, 23.0)
    if not reflective:
        sphere.material.roughness = 0.5
    textures = np.zeros((3, 16, 16, 3), np.float32)
    sizes = np.asarray([[16, 8], [8, 8], [4, 16]], np.int32)
    for i, (h, w) in enumerate(sizes):
        textures[i, :h, :w] = rng.uniform(0.2, 1.0, size=(h, w, 3))
    # tangent normals near +z
    textures[1, :8, :8] = (0.5, 0.5, 1.0) + rng.uniform(
        -0.1, 0.1, size=(8, 8, 3))
    n = sphere.n_voxels
    point_lights = [
        dict(position=(150.0, -40.0 + 120.0 * i, 120.0 - 60.0 * i),
             color=(1.0, 0.8 - 0.3 * i, 0.6, 1.0), intensity=60.0 + 30.0 * i,
             att_linear=0.05, att_exp=0.0005) for i in range(points)]
    spot_lights = [
        dict(position=(200.0, 30.0 - 90.0 * i, 160.0),
             forward=(-0.7, -0.1 + 0.3 * i, -0.7), color=(0.5, 0.9, 1.0, 1.0),
             intensity=120.0, att_linear=0.02, att_exp=0.0002, angle=50.0,
             falloff=25.0) for i in range(spots)]
    for s in spot_lights:
        s["forward"] = tuple(np.asarray(s["forward"])
                             / np.linalg.norm(s["forward"]))
    return build_scene(
        [sphere, box],
        [{"volume": 0, "position": SPHERE_POSITION},
         {"volume": 1, "position": BOX_POSITION, "scale": (1.0, 1.25, 0.8),
          "rotation": np.asarray(vq.from_euler_degrees(*BOX_EULER))}],
        accel_mode=accel_mode, march_dtype=march_dtype,
        camera={"position": CAMERA_POSITION,
                "rotation": vq.from_euler_degrees(*CAMERA_EULER),
                "fov": 60.0},
        dir_light={"direction": np.asarray(vq.forward_vector(
            vq.from_euler_degrees(*LIGHT_EULER))),
            "strength": LIGHT_STRENGTH},
        point_lights=point_lights, spot_lights=spot_lights,
        env=rng.uniform(0.1, 1.0, size=(6, 8, 8, 3)).astype(np.float32),
        textures=textures, tex_sizes=sizes,
        texture_ids=[(0, 1, 2), (0, 1, 2)],
        voxel_colors=(rng.uniform(size=(2, n, n, n, 3)).astype(np.float32)
                      if colors else None),
        device=device)
