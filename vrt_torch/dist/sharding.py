"""Ray data parallelism over the mesh (port of ``vrt.dist.sharding``, its
serving half).

Pixels are one flat batch of rays, split over every rank of the mesh; the
scene is replicated (the <= 20-instance scene is small next to the rays).
Each rank builds the full camera rays, takes its slice, renders it through
the default tracer (the scene march, the fused resolve and the shade
kernels on the card), and the ranks all-gather the rows: a frame equal to
``render_image`` bit for bit, since each ray's row depends on that ray
alone.  The data-parallel fit step (``make_loss_and_grad_dp``,
``make_fit_step_dp``) is not ported yet.
"""

from __future__ import annotations

import torch

from vrt_torch.dist import mesh as _mesh
from vrt_torch.render.gpuscene import GPUScene, RenderMode
from vrt_torch.render.renderer import render_rays


def _pad_rays(total: int, n_shards: int, *arrays):
    """Pad the leading axis to a multiple of ``n_shards``: origins with
    zeros, directions (the second array) with ones (any valid ray: its
    result is dropped), the rest with zeros.  Returns (padded..., pad)."""
    pad = (-total) % n_shards
    if pad == 0:
        return (*arrays, 0)
    out = []
    for i, a in enumerate(arrays):
        fill = torch.ones if i == 1 else torch.zeros
        out.append(torch.cat([a, fill((pad,) + tuple(a.shape[1:]),
                                      dtype=a.dtype, device=a.device)]))
    return (*out, pad)


def _interleave_perm(padded: int, n_shards: int, device=None):
    """Round-robin ray -> shard assignment: lane i goes to shard
    i % n_shards, so every shard samples the whole image (a blocked split
    gives some shards the sky and others the surfaces).  Returns (perm,
    inv_perm), int64 on ``device``."""
    ar = torch.arange(padded, device=device)
    perm = ar.reshape(-1, n_shards).T.reshape(-1)
    inv = ar.reshape(n_shards, -1).T.reshape(-1)
    return perm, inv


def render_image_sharded(scene: GPUScene, width: int, height: int,
                         mode: RenderMode, mesh,
                         interleave: bool = True) -> torch.Tensor:
    """``render_image`` with the rays split over every rank of ``mesh``
    (round-robin by default, see ``_interleave_perm``): [H,W,4] f32 on
    every rank, equal to ``render_image`` of the same scene."""
    from vrt_torch.render.camera import camera_rays

    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov,
                       width, height)
    total = width * height
    group, index, n_shards = _mesh.axis_group(
        mesh, tuple(mesh.mesh_dim_names))
    o, d, _ = _pad_rays(total, n_shards, o, d)
    if interleave:
        perm, inv = _interleave_perm(o.shape[0], n_shards, o.device)
        o, d = o[perm], d[perm]
    local = o.shape[0] // n_shards
    mine = slice(index * local, (index + 1) * local)
    rgba = render_rays(scene, o[mine].clone(), d[mine].clone(), mode)
    rgba = _mesh.all_gather(rgba, group)
    if interleave:
        rgba = rgba[inv]
    return rgba[:total].reshape(height, width, 4)
