"""Differentiable fitting: optimize the SDF, per-voxel colours, material
constants or the camera from pixel losses (port of ``vrt.diff.fit``).

Pixel losses reach the SDF through resolve's IFT-at-the-root term and the
central-difference normal, both read from the corner table, which is
repacked from the SDF inside the step with the accel
(``kernels.accel.RebuildAccel``: on CUDA tensors the accel kernels and the
pack's backward kernel); colours reach the colour grid through its corner-packed view,
repacked in the step too, or, where the scene has none (above
``gpuscene.COLOR_CORNER_BUDGET_BYTES``, as config4's 257^3 grid), directly:
the shading samples the f32 grid.  On CUDA tensors the corner table is read
by the fused resolve, whose backward kernel adds the corner cotangents
(``vrt_torch.kernels.resolve.ResolveScene``), and every radiance level
shades through ``vrt_torch.kernels.shade.ShadeSurface`` and
``ShadeCombine``: the two shade kernels forward, and two backward kernels
that recompute the stage and return the cotangents of the rays, ``t``,
``n_obj`` and the record, the surface backward adding the colour rows'
cotangents into the colour table (16-byte atomics into a packed view, one
f32 atomic a component into the grid).  Only the tonemap
and the loss stay eager.  A fit that also optimizes a material constant,
a light, the texture scale, a texture, the env or an instance transform
(``inst_pos``, ``inst_rot``, ``inst_scale``: a pose fit) shades and
resolves through the same Functions (their backward kernels' variants
return those gradients; ``renderer.shade_stages``).  The march runs
under ``torch.no_grad()`` and is never re-run by the backward.  The octree
accel is rebuilt from the current SDF on the device every step
(``rebuild_accel``), so the fitted geometry is always marched
consistently.

Parameters are dicts of tensors; a step is a plain function
``step(params, opt_state, ...) -> (params, opt_state, loss)`` with the
optimizer of ``vrt_torch.diff.optim``, whose ``apply`` takes the gradients
(on CUDA tensors Adam's is one kernel over every leaf); a view step that
smooths the SDF update takes ``update``, ``smooth3`` and
``apply_updates``.  There is no chunked frame: the
whole view is one batch of rays (``vrt``'s chunked, deferred, remat'd fit
frame computes the same loss and gradients, tests/test_grad.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from vrt_torch.core import quat as vq
from vrt_torch.diff.optim import adam, apply_updates
from vrt_torch.march.types import pack_cell_corners
from vrt_torch.render.camera import camera_rays
from vrt_torch.render.gpuscene import (GPUScene, RenderMode,
                                       pack_voxel_color_corners)
from vrt_torch.render.renderer import tonemap, trace_radiance


def graft_params(scene: GPUScene, params: Dict,
                 repack: bool = True) -> GPUScene:
    """The scene with ``params`` grafted in.

    Keys: 'sdf' [V,N,N,N] (the corner table is repacked from it,
    differentiably, keeping the folded accel channel; ``rebuild_accel``
    rebuilds the accel itself), 'voxel_colors' [V,N,N,N,3] (its packed view
    is repacked where the scene has one; above
    ``COLOR_CORNER_BUDGET_BYTES`` it has none and the grid is grafted
    as it is), and any other field of the scene by name ('tint',
    'roughness', 'metallic', 'cam_pos', 'cam_rot', light fields).
    ``repack=False`` leaves the corner table stale, for a caller that
    calls ``rebuild_accel`` next (``graft_and_rebuild``)."""
    vols = scene.volumes
    if "sdf" in params:
        corners = vols.corners
        if repack:
            accel_ch = (corners[..., 8].to(torch.int32)
                        if corners.shape[-1] > 8 else None)
            corners = pack_cell_corners(params["sdf"], accel_ch,
                                        corners.dtype)
        vols = dataclasses.replace(vols, sdf=params["sdf"], corners=corners,
                                   u8_view=vols.accel_u8)
    scene = dataclasses.replace(scene, volumes=vols)
    direct = {k: v for k, v in params.items()
              if k != "sdf" and hasattr(scene, k)}
    if direct:
        scene = dataclasses.replace(scene, **direct)
    if "voxel_colors" in params and scene.voxel_color_corners is not None:
        scene = dataclasses.replace(
            scene, voxel_color_corners=pack_voxel_color_corners(
                params["voxel_colors"], scene.voxel_color_corners.dtype))
    return scene


def rebuild_accel(scene: GPUScene) -> GPUScene:
    """Rebuild what the march derives from the (possibly updated) SDF, on
    its device: the octree accel (``accel_mode`` becomes 'octree') with its
    u8 view and the corner table, repacked differentiably with the new accel
    folded in where the table has a 9th channel.  All volumes share the
    padded resolution.  That is one ``RebuildAccel``: on CUDA tensors the
    accel kernels (the pyramid and the rebuild, which writes the three) and
    the pack's backward kernel, on CPU tensors their plain versions."""
    from vrt_torch.kernels.accel import RebuildAccel

    vols = scene.volumes
    sdf = vols.sdf
    resolution = (sdf.shape[-1] - 1).bit_length() - 1
    corners, accel, accel_u8 = RebuildAccel.apply(
        sdf.contiguous(), resolution, vols.corners.dtype,
        vols.corners.shape[-1])
    return dataclasses.replace(
        scene, volumes=dataclasses.replace(
            vols, accel=accel, corners=corners, accel_mode="octree",
            u8_view=accel_u8))


def graft_and_rebuild(scene: GPUScene, params: Dict) -> GPUScene:
    """``rebuild_accel(graft_params(scene, params))`` with the corner table
    packed once, by ``rebuild_accel``: the scene a fit step renders."""
    return rebuild_accel(graft_params(scene, params, repack=False))


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def render_views(scene: GPUScene, cams: Sequence[Dict], width: int,
                 height: int, mode: RenderMode):
    """One tonemapped image per camera dict {position, rotation, fov}:
    [C, H*W, 3].  Camera values may be tensors that require grad."""
    dev = scene.cam_pos.device
    imgs = []
    for cam in cams:
        o, d = camera_rays(_f32(cam["position"], dev),
                           _f32(cam["rotation"], dev),
                           _f32(cam.get("fov", 60.0), dev), width, height)
        imgs.append(tonemap(trace_radiance(scene, o, d, 0, mode)))
    return torch.stack(imgs)


def _value_and_grad(loss_fn, params: Dict):
    """(loss, grads) of ``loss_fn(leaves)`` at ``params``; a parameter the
    loss does not reach gets a zero gradient."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), grads


def make_fit_step(scene: GPUScene, cams: Sequence[Dict], width: int,
                  height: int, mode: RenderMode, optimizer):
    """Single-device fit step factory.

    step(params, opt_state, targets [C,H*W,3]) -> (params, opt_state, loss)
    """

    def step(params, opt_state, targets):
        def loss_fn(p):
            s = graft_and_rebuild(scene, p)
            imgs = render_views(s, cams, width, height, mode)
            return torch.mean((imgs - targets) ** 2)

        loss, grads = _value_and_grad(loss_fn, params)
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return params, opt_state, loss

    return step


def make_fit_step_view(scene: GPUScene, width: int, height: int,
                       mode: RenderMode, optimizer,
                       light_follows_camera: bool = False,
                       sdf_smooth: float = 0.0):
    """Single-view fit step factory with the camera as a step argument.

    step(params, opt_state, cam_pos [3], cam_rot [4], cam_fov [], target
    [H*W,3]) -> (params, opt_state, loss)

    ``light_follows_camera`` points the directional light along the
    camera's forward vector (a headlamp: the light sits at the camera,
    ``dir_light_dir`` = -forward); targets must be rendered with the same
    per-view light.  ``sdf_smooth`` blends ``smooth3`` into the SDF
    *update* (not the field) at that strength."""

    def step(params, opt_state, cam_pos, cam_rot, cam_fov, target):
        dev = scene.cam_pos.device
        cam_rot = _f32(cam_rot, dev)

        def loss_fn(p):
            s = graft_and_rebuild(scene, p)
            if light_follows_camera:
                s = dataclasses.replace(
                    s, dir_light_dir=-vq.forward_vector(cam_rot))
            cam = [dict(position=cam_pos, rotation=cam_rot, fov=cam_fov)]
            imgs = render_views(s, cam, width, height, mode)
            return torch.mean((imgs[0] - target) ** 2)

        loss, grads = _value_and_grad(loss_fn, params)
        if not (sdf_smooth and "sdf" in params):
            params, opt_state = optimizer.apply(params, grads, opt_state)
            return params, opt_state, loss
        updates, opt_state = optimizer.update(grads, opt_state, params)
        updates = dict(updates, sdf=smooth3(updates["sdf"], sdf_smooth))
        return apply_updates(params, updates), opt_state, loss

    return step


def smooth3(x, alpha: float):
    """``(1-alpha)*x + alpha*blur(x)`` for a separable 3-tap [1/4, 1/2,
    1/4] blur over the grid axes 1-3 of [V,N,N,N(,C)], edges replicated."""
    y = x
    for ax in (1, 2, 3):
        n = y.shape[ax]
        lo = torch.index_select(
            y, ax, torch.tensor([0] + list(range(n - 1)), device=y.device))
        hi = torch.index_select(
            y, ax, torch.tensor(list(range(1, n)) + [n - 1], device=y.device))
        y = 0.25 * lo + 0.5 * y + 0.25 * hi
    return (1.0 - alpha) * x + alpha * y


def upsample_params(params: Dict) -> Dict:
    """Coarse-to-fine transfer: 'sdf' and 'voxel_colors' grids go from
    n = 2^r + 1 to 2^(r+1) + 1 per axis by exact trilinear refinement (even
    planes copy, odd planes average their neighbours); values transfer
    unscaled.  Other parameters pass through."""

    def up_axis(x, ax):
        n = x.shape[ax]
        mid = 0.5 * (x.narrow(ax, 0, n - 1) + x.narrow(ax, 1, n - 1))
        shape = list(x.shape)
        shape[ax] = 2 * n - 1
        out = x.new_zeros(shape)
        even = [slice(None)] * x.ndim
        odd = [slice(None)] * x.ndim
        even[ax] = slice(0, 2 * n - 1, 2)
        odd[ax] = slice(1, 2 * n - 1, 2)
        out[tuple(even)] = x
        out[tuple(odd)] = mid
        return out

    out = {}
    for k, v in params.items():
        if k in ("sdf", "voxel_colors"):
            with torch.no_grad():
                for ax in (1, 2, 3):
                    v = up_axis(v, ax)
        out[k] = v
    return out


def psnr(img, ref):
    """Peak signal-to-noise ratio of tonemapped [..., 3] images in [0, 1]
    (mse clamped at 1e-12)."""
    mse = torch.mean((img - ref) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


def fit(scene: GPUScene, params: Dict, cams: Sequence[Dict], targets,
        width: int, height: int, mode: RenderMode = RenderMode(),
        steps: int = 100, learning_rate: float = 1e-2, log_every: int = 0):
    """Adam-fit ``params`` to multi-view ``targets``; returns the fitted
    params and the loss of every step."""
    optimizer = adam(learning_rate)
    opt_state = optimizer.init(params)
    step = make_fit_step(scene, cams, width, height, mode, optimizer)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, targets)
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {float(loss):.6f}", flush=True)
        losses.append(loss)
    return params, [float(v) for v in losses]
