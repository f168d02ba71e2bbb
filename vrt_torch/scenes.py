"""Scenes the port renders: the flagship frame of ``bench.py``, as a device
scene built directly (``flagship_scene``) and as a host scene graph
(``flagship_graph``); config3's voxelized glTF torus
(``voxelized_torus_scene``); config5's CSG volume for the slab-sharded
frame (``config5_slab_volume``, ``config5_scene``)."""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
# config3 (``vrt/apps/bench.py``'s ``bench_voxelized_mesh``)
TORUS_MESH = dict(major=60.0, minor=25.0, nu=96, nv=48)
TORUS_CAMERA_POSITION = (250.0, 0.0, 120.0)
TORUS_CAMERA_EULER = (0.0, 180.0, -25.0)
TORUS_SKY = (0.25, 0.35, 0.55)
# config5 (``vrt/apps/scaling.py``): the light of its ``run``
CONFIG5_EXTENDS = 100.0
CONFIG5_LIGHT_EULER = (0.0, 45.0, -30.0)


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


def posed_instances(scene):
    """``scene`` with its first instance posed as a pose fit moves it: its
    rotation composed with Euler (15, 25, -10) and scaled to a quaternion of
    norm 1.05 (``core/quat.py::rotate``'s formula then also scales by
    1.05^2, as ``vrt``'s does), its scale made uneven (1.1, 0.85, 1.2 times
    its own).  The checks of the backward kernels' instance variants run on
    it."""
    from vrt_torch.core import quat as vq

    dev = scene.inst_rot.device
    turn = torch.as_tensor(vq.from_euler_degrees(15.0, 25.0, -10.0),
                           dtype=torch.float32, device=dev)
    rot = scene.inst_rot.clone()
    q = vq.multiply(rot[0], turn)
    rot[0] = q * (1.05 / torch.linalg.vector_norm(q))
    scale = scene.inst_scale.clone()
    scale[0] = scale[0] * torch.tensor([1.1, 0.85, 1.2], device=dev)
    return dataclasses.replace(scene, inst_rot=rot, inst_scale=scale)


def padded_sampled_tables(scene, side: int = 256):
    """``scene`` with the same texels stacked into a [T, side, side, 3]
    table (each texture keeps its size; the rest is padding) and its env
    cube at twice its side (each texel repeated 2 x 2): tables past the
    shared-memory budgets of the shade backward's texture and env variants
    (``kernels.shade.table_path``), whose cotangents then take f32 atomics
    into the table."""
    tex = scene.textures
    padded = torch.zeros((tex.shape[0], side, side, 3), dtype=tex.dtype,
                         device=tex.device)
    padded[:, :tex.shape[1], :tex.shape[2]] = tex
    env = scene.env.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return dataclasses.replace(scene, textures=padded,
                               env=env.contiguous())


def voxelized_torus_scene(resolution: int = 8,
                          device: torch.device | str = "cuda"):
    """config3 of ``vrt/apps/bench.py``: a 9,216-triangle torus written as
    a glTF mesh named ``torus_<resolution>``, voxelized through
    ``vrt_torch.apps.voxelize.convert`` (257^3 at resolution 8, the
    reference voxelizer's cap), read back from its ``.vox`` file and built
    with the chebyshev accel and a bf16 corner table, lit by a directional
    light at Euler (0, 45, -30), strength 6, under a flat 6x2x2 sky.
    Returns (scene, seconds): the host seconds of each step, ``mesh``
    (triangulate and write the glTF), ``convert`` (import, voxelize, write
    the ``.vox``), ``load`` (read it) and ``build`` (``build_scene``: the
    accel, the corner table and the upload)."""
    from vrt_torch.apps.make_assets import torus_mesh, write_gltf_mesh
    from vrt_torch.apps.voxelize import convert
    from vrt_torch.core import quat as vq
    from vrt_torch.io.voxfile import load_scene
    from vrt_torch.render.gpuscene import build_scene
    from vrt_torch.scene.scene import Camera, DirectionalLight

    seconds = {}
    t0 = time.perf_counter()
    verts, faces = torus_mesh(**TORUS_MESH)
    with tempfile.TemporaryDirectory() as td:
        gltf = os.path.join(td, "scene.gltf")
        write_gltf_mesh(gltf, verts, faces, name=f"torus_{resolution}")
        t1 = time.perf_counter()
        vox = convert(gltf, verbose=False)
        t2 = time.perf_counter()
        host = load_scene(vox)
        t3 = time.perf_counter()
    seconds.update(mesh=t1 - t0, convert=t2 - t1, load=t3 - t2)
    host.spawn(DirectionalLight(
        rotation=np.asarray(vq.from_euler_degrees(*LIGHT_EULER)),
        strength=LIGHT_STRENGTH))
    host.active_camera = Camera(
        position=np.asarray(TORUS_CAMERA_POSITION, np.float32),
        rotation=np.asarray(vq.from_euler_degrees(*TORUS_CAMERA_EULER)))
    vol = host.volumes[0]
    cam = host.active_camera
    light = host.active_directional_light
    t0 = time.perf_counter()
    scene = build_scene(
        [vol], [dict(volume=0, position=o.position, rotation=o.rotation,
                     scale=o.scale) for o in host.voxel_objects],
        camera=dict(position=cam.position, rotation=cam.rotation,
                    fov=cam.fov),
        dir_light=dict(direction=light.direction, strength=light.strength),
        env=np.full((6, 2, 2, 3), TORUS_SKY, np.float32),
        accel_mode="chebyshev", march_dtype=torch.bfloat16, device=device)
    seconds["build"] = time.perf_counter() - t0
    return scene, seconds


def config5_slab_volume(resolution: int = 9):
    """config5's volume (``vrt/apps/scaling.py::build_volume``, "a
    512^3-class brick-sharded SDF"): a sphere of radius 62 plus a
    150x60x60 box at z = 45 minus a sphere of radius 35 at x = 30, baked at
    n = 2^resolution + 1 over [-100, 100]^3 (513^3 at 9, 0.54 GB f32).  The
    bake runs a slab of x-planes at a time (each voxel's value depends on
    its position alone, so the grid is ``from_generator``'s bit for bit)
    to bound the host memory of the 513^3 grid, in threads."""
    from vrt_torch.core.grid import GridLaw
    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    ext = CONFIG5_EXTENDS
    csg = S.CSG(shape=S.Sphere(radius=0.62 * ext))
    csg.add_child(S.Box(extends=(0.75 * ext, 0.3 * ext, 0.3 * ext),
                        position=np.array([0.0, 0.0, 0.45 * ext],
                                          np.float32)), S.ADD)
    csg.add_child(S.Sphere(radius=0.35 * ext,
                           position=np.array([0.3 * ext, 0.0, 0.0],
                                             np.float32)), S.SUBTRACT)
    law = GridLaw(resolution, ext)
    n = law.n_voxels
    sdf = np.empty((n, n, n), np.float32)
    yz = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  axis=-1)
    step = max(1, (1 << 22) // (n * n))

    def bake(x0):
        xs = np.arange(x0, min(n, x0 + step))
        idx = np.concatenate(
            [np.broadcast_to(xs[:, None, None, None], (len(xs), n, n, 1)),
             np.broadcast_to(yz[None], (len(xs), n, n, 2))], axis=-1)
        pos = np.asarray(idx, np.float32) * law.cell_size + law.origin
        sdf[x0:x0 + len(xs)] = csg.evaluate(pos)

    # numpy's loops release the interpreter lock: the slabs bake in threads
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(bake, range(0, n, step)))
    return VoxelVolume(resolution, ext, sdf=sdf,
                       voxel_materials=(sdf <= 0.0).astype(np.uint8))


def config5_scene(vol, device: torch.device | str = "cuda",
                  stub: bool = True):
    """config5's scene around ``vol``: ``vrt``'s ``default_fit_scene``
    (camera at (300, 0, 0) looking down -x, a roughness-0.8 material, a flat
    sky) lit along Euler (0, 45, -30), as ``scaling.run`` sets it.  With
    ``stub`` the scene of the slab-sharded frame (a 2^3 stub SDF with the
    volume's geometry); without, the same scene over the whole volume (the
    octree accel, an f32 corner table), the replicated frame's."""
    from vrt_torch.core import quat as vq
    from vrt_torch.dist.slab_render import default_fit_scene

    light = np.asarray(vq.forward_vector(
        vq.from_euler_degrees(*CONFIG5_LIGHT_EULER)), np.float32)
    scene = default_fit_scene(vol.n_voxels, vol.cell_size, vol.extends,
                              light, device=device)
    if stub:
        return scene
    from vrt_torch.render.gpuscene import build_scene

    return dataclasses.replace(scene, volumes=build_scene(
        [vol], [{"volume": 0}], camera={"position": (0.0, 0.0, 0.0)},
        device=device).volumes)
