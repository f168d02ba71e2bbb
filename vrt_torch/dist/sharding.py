"""Ray data parallelism over the mesh, and the data-parallel fit (port of
``vrt.dist.sharding``).

Pixels are one flat batch of rays, split over every rank of the mesh; the
scene is replicated (the <= 20-instance scene is small next to the rays).
Each rank builds the full camera rays, takes its slice, renders it through
the default tracer (the scene march, the fused resolve and the shade
kernels on the card), and the ranks all-gather the rows: a frame equal to
``render_image`` bit for bit, since each ray's row depends on that ray
alone.

The data-parallel fit (``make_loss_and_grad_dp``, ``make_fit_step_dp``):
each rank renders its slice of the rays through the default path (the
scene march, the fused resolve and the shade kernels, forward and backward,
on the card), takes the backward of its share of the loss locally, and one
all-reduce over the whole mesh sums the parameter gradients, flattened into
one buffer a dtype (gloo makes one call, not one a tensor).  The loss's sum
over the ranks passes its cotangent through, so the gradient equals the
single-process gradient of the same summed loss, as ``vrt``'s psum inside
the differentiated function gives it.
"""

from __future__ import annotations

import torch

from vrt_torch.diff.fit import _value_and_grad, graft_and_rebuild
from vrt_torch.dist import mesh as _mesh
from vrt_torch.render.gpuscene import GPUScene, RenderMode
from vrt_torch.render.renderer import render_rays, tonemap, trace_radiance


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


def _all_reduce_grads(grads: dict, group) -> dict:
    """The sum over ``group`` of every rank's gradients (a dict of tensors):
    one all-reduce a dtype, over the tensors flattened into one buffer."""
    out = {}
    for dtype in dict.fromkeys(g.dtype for g in grads.values()):
        keys = [k for k, g in grads.items() if g.dtype == dtype]
        flat = _mesh.all_reduce_sum(
            torch.cat([grads[k].detach().reshape(-1) for k in keys]), group)
        for k, part in zip(keys, flat.split([grads[k].numel()
                                             for k in keys])):
            out[k] = part.view(grads[k].shape)
    return {k: out[k] for k in grads}


def make_loss_and_grad_dp(mode: RenderMode, mesh, reduce: str = "sum",
                          interleave: bool = True):
    """Data-parallel pixel loss and gradient (``vrt``'s
    ``make_loss_and_grad_dp``), run by every rank of ``mesh``.

    Returns ``loss_and_grad(params, scene, o, d, targets) -> (loss,
    grads)``: ``params`` (a dict, as ``graft_params`` takes it) and
    ``scene`` are replicated, ``o``, ``d`` [R,3] and ``targets`` [R,3] are
    every ray, as on every rank.  Each rank pads them to a multiple of the
    ranks with a weight column ``w`` (1 on real rays, 0 on padding), applies
    the round-robin permutation (``interleave``), takes its slice, renders
    it on ``graft_and_rebuild(scene, params)`` and takes
    ``sum(err * w) / denom`` (``denom`` 1 for "sum", R*3 for "mean"); the
    loss is that summed over the ranks, the gradients the all-reduce of each
    rank's local backward: on every rank the single-process value and
    gradient of the summed loss."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce is 'sum' or 'mean', got {reduce!r}")
    group, index, n_shards = _mesh.axis_group(
        mesh, tuple(mesh.mesh_dim_names))

    def loss_and_grad(params, scene, o, d, targets):
        total = o.shape[0]
        w = torch.ones(total, dtype=torch.float32, device=o.device)
        o, d, targets, w, _ = _pad_rays(total, n_shards, o, d, targets, w)
        if interleave:
            perm, _ = _interleave_perm(o.shape[0], n_shards, o.device)
            o, d, targets, w = o[perm], d[perm], targets[perm], w[perm]
        local = o.shape[0] // n_shards
        mine = slice(index * local, (index + 1) * local)
        o, d, targets, w = (x[mine].contiguous() for x in (o, d, targets, w))
        denom = 1.0 if reduce == "sum" else float(total * targets.shape[-1])

        def loss_fn(p):
            s = graft_and_rebuild(scene, p)
            err = (tonemap(trace_radiance(s, o, d, 0, mode)) - targets) ** 2
            return _mesh.loss_sum(torch.sum(err * w[:, None]) / denom, group)

        loss, grads = _value_and_grad(loss_fn, params)
        return loss, _all_reduce_grads(grads, group)

    return loss_and_grad


def make_fit_step_dp(mode: RenderMode, mesh, optimizer):
    """Data-parallel fit step (``vrt``'s ``make_fit_step_dp``): step(params,
    opt_state, scene, o, d, targets) -> (params, opt_state, loss), the mean
    squared error of ``make_loss_and_grad_dp(reduce="mean")``, its
    gradients all-reduced before the optimizer's update, which every rank
    applies to its replica."""
    loss_and_grad = make_loss_and_grad_dp(mode, mesh, reduce="mean")

    def step(params, opt_state, scene, o, d, targets):
        loss, grads = loss_and_grad(params, scene, o, d, targets)
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return params, opt_state, loss

    return step
