"""Scenes the port renders: the flagship frame of ``bench.py``."""

from __future__ import annotations

import numpy as np
import torch


def flagship_scene(resolution: int = 5, accel_mode: str = "octree",
                   march_dtype: torch.dtype | None = None,
                   device: torch.device | str = "cpu",
                   use_colors: bool = False):
    """Two instances — a roughness-0.1 reflective sphere and a CSG box
    minus a sphere — an 8x8 sky cube, and a directional light with shadows
    (the parameters of ``__graft_entry__._flagship_scene``).  With
    ``use_colors`` both volumes carry per-voxel colours of 0.5, the fit's
    albedo field (``vrt/apps/bench.py``'s config6 and config4 scenes)."""
    from vrt_torch.core import quat as vq
    from vrt_torch.core.material import Material
    from vrt_torch.render.gpuscene import build_scene
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

    env = np.zeros((6, 8, 8, 3), np.float32)
    env[:] = (0.25, 0.45, 0.85)

    cam_rot = vq.from_euler_degrees(0.0, 180.0, 0.0)
    colors = None
    if use_colors:
        n = sphere.n_voxels
        colors = np.full((2, n, n, n, 3), 0.5, np.float32)
    return build_scene(
        [sphere, box],
        [{"volume": 0, "position": (0.0, -70.0, 0.0)},
         {"volume": 1, "position": (0.0, 90.0, 10.0),
          "rotation": np.asarray(vq.from_euler_degrees(0.0, 30.0, 0.0))}],
        accel_mode=accel_mode, march_dtype=march_dtype,
        camera={"position": (320.0, 0.0, 40.0), "rotation": cam_rot,
                "fov": 60.0},
        dir_light={"direction": np.asarray(vq.forward_vector(
            vq.from_euler_degrees(0.0, 45.0, -30.0))), "strength": 6.0},
        env=env, voxel_colors=colors, device=device)
