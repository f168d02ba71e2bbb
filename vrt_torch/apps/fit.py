"""Differentiable-fit CLI: optimize per-voxel colours (and, with
``--fit-sdf``, the SDF) of a sphere volume until its renders match
multi-view images of a box-with-hole target (port of ``vrt.apps.fit``).

    python -m vrt_torch.apps.fit [--device cuda] [--resolution 4]
        [--views 4] [--size 48] [--steps 100] [--lr 2e-2] [--fit-sdf]

The device is explicit (default ``cuda``); the CLI never moves to the CPU
on its own.  It prints the loss every tenth of the run and the final loss
as a share of the first.  ``--out`` (PNG renders of the fitted views) waits
for the port of ``vrt.io.image``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vrt_torch.core import quat as vq
from vrt_torch.core.material import Material
from vrt_torch.diff.fit import fit, render_views
from vrt_torch.render.gpuscene import RenderMode, build_scene
from vrt_torch.volume import sdf as S
from vrt_torch.volume.volume import VoxelVolume


def orbit_cameras(count: int, distance: float = 300.0, height: float = 50.0):
    cams = []
    for i in range(count):
        yaw = 360.0 * i / count
        a = np.deg2rad(yaw)
        pos = np.asarray([distance * np.cos(a), distance * np.sin(a), height],
                         np.float32)
        rot = vq.from_euler_degrees(0.0, 180.0 + yaw, -10.0)
        cams.append(dict(position=pos, rotation=np.asarray(rot), fov=60.0))
    return cams


def main(argv=None):
    """Run the fit; returns the loss of every step."""
    ap = argparse.ArgumentParser(description="vrt_torch differentiable fit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resolution", type=int, default=4)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--fit-sdf", action="store_true",
                    help="optimize the SDF too (default: colours only)")
    ap.add_argument("--out", default=None,
                    help="save fitted renders as PNG (not ported yet)")
    args = ap.parse_args(argv)
    if args.out:
        raise NotImplementedError("--out needs vrt.io.image, which the port "
                                  "does not have yet (ROADMAP M11)")
    device = torch.device(args.device)

    # target: box-with-hole CSG, coloured
    csg = S.CSG(shape=S.Box(extends=(45.0, 45.0, 45.0)))
    csg.add_child(S.Sphere(radius=55.0), S.SUBTRACT)
    target_vol = VoxelVolume.from_generator(
        csg, args.resolution, 100.0,
        material=Material(albedo=(0.9, 0.5, 0.2, 1.0)))
    n = target_vol.n_voxels
    rng = np.random.default_rng(0)
    target_colors = rng.uniform(0.2, 0.9, (1, n, n, n, 3)).astype(np.float32)

    def make_scene(vol, colors):
        return build_scene(
            [vol], [{"volume": 0}],
            camera=dict(position=(300.0, 0.0, 0.0),
                        rotation=np.asarray(
                            vq.from_euler_degrees(0.0, 180.0, 0.0))),
            dir_light={"direction": np.asarray(vq.forward_vector(
                vq.from_euler_degrees(0.0, 45.0, -30.0))), "strength": 4.0},
            voxel_colors=colors, device=device)

    cams = orbit_cameras(args.views)
    mode = RenderMode()
    with torch.no_grad():
        targets = render_views(make_scene(target_vol, target_colors), cams,
                               args.size, args.size, mode)
    print("rendered targets", tuple(targets.shape), file=sys.stderr)

    start_vol = VoxelVolume.from_generator(
        S.Sphere(radius=60.0), args.resolution, 100.0,
        material=target_vol.material)
    scene = make_scene(start_vol, np.full_like(target_colors, 0.5))
    params = {"voxel_colors": scene.voxel_colors}
    if args.fit_sdf:
        params["sdf"] = scene.volumes.sdf

    params, losses = fit(scene, params, cams, targets, args.size, args.size,
                         mode, steps=args.steps, learning_rate=args.lr,
                         log_every=max(1, args.steps // 10))
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"({losses[-1] / losses[0]:.3%} of start)", file=sys.stderr)
    return losses


if __name__ == "__main__":
    main()
