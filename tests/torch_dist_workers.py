"""Rank functions of the distributed port's CPU tests
(tests/test_torch_{dist,brick,slab_render}.py), run by
``vrt_torch.dist.mesh.spawn_world`` in fresh processes over gloo.  This
module imports torch and the port only, so that a rank starts without JAX;
every function takes and returns numpy arrays and Python values."""

import numpy as np
import torch

from vrt_torch.dist import brick, mesh
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy

HIT_FIELDS = ("hit", "t", "kind", "cell", "t_in", "t_out", "face_normal",
              "steps")


def _setup():
    torch.set_num_threads(2)


def _hit_np(h):
    return {f: getattr(h, f).numpy() for f in HIT_FIELDS
            if getattr(h, f) is not None}


def mesh_world(rank, world):
    """The mesh helpers and the three collectives on a (1, world) mesh."""
    _setup()
    m = mesh.make_render_mesh(1, world, "cpu")
    group, index, size = mesh.axis_group(m, mesh.MODEL_AXIS)
    _, flat, total = mesh.axis_group(m, (mesh.DATA_AXIS, mesh.MODEL_AXIS))
    mesh.reset_stats()
    x = torch.arange(3, dtype=torch.float32) + 10 * rank
    gathered = mesh.all_gather(x[None], group)
    summed = mesh.all_reduce_sum(x, group)
    left, right = mesh.neighbour_exchange(x + 100, x - 100, group)
    return dict(
        backend=mesh.init_distributed("gloo"), coord=tuple(m.get_coordinate()),
        index=index, size=size, flat=flat, total=total,
        shape=mesh.local_mesh_shape(world), gathered=gathered.numpy(),
        summed=summed.numpy(), x=x.numpy(),
        left=None if left is None else left.numpy(),
        right=None if right is None else right.numpy(),
        stats=dict(mesh.STATS))


def sharded_world(rank, world, fields, width, height, mode, interleave):
    """``render_image_sharded`` of the scene ``fields`` over a (world, 1)
    mesh, on the CPU."""
    from vrt_torch.dist.sharding import render_image_sharded

    _setup()
    scene = scene_from_numpy(fields, device="cpu")
    m = mesh.make_render_mesh(world, 1, "cpu")
    img = render_image_sharded(scene, width, height, RenderMode(**mode), m,
                               interleave=interleave)
    return img.numpy()


def combine_world(rank, world, slab_fields, accel_mode, o, d, t_max, cases):
    """Every rank marches its slab with the twin, then ``combine_hits``:
    the combined hits of each (interp, debug_overlay) case."""
    _setup()
    slabs = brick.slab_from_numpy(slab_fields, accel_mode)
    slab = slabs.local(rank, "cpu")
    m = mesh.make_render_mesh(1, world, "cpu")
    group = mesh.axis_group(m, mesh.MODEL_AXIS)[0]
    o, d, t_max = (torch.from_numpy(x) for x in (o, d, t_max))
    out = []
    for interp, debug in cases:
        h = brick.march_volume_slab(slab, o, d, t_max, interp, debug)
        out.append(_hit_np(brick.combine_hits(h, group)))
    return out


def halo_world(rank, world, slab_fields, accel_mode, delta):
    """Add ``delta`` [S, span, N, N] to every rank's slab, then
    ``exchange_halos``: this rank's refreshed planes, and whether a slab
    that requires a gradient gives the same planes with a graph."""
    _setup()
    slabs = brick.slab_from_numpy(slab_fields, accel_mode)
    slab = slabs.local(rank, "cpu")
    slab = brick.SlabVolume(**{**{f: getattr(slab, f)
                                  for f in brick._FIELDS},
                               "sdf": slab.sdf + torch.from_numpy(
                                   delta[rank])},
                            accel_mode=accel_mode)
    group = mesh.axis_group(mesh.make_render_mesh(1, world, "cpu"),
                            mesh.MODEL_AXIS)[0]
    out = brick.exchange_halos(slab, group).sdf.numpy()
    slab.sdf.requires_grad_(True)
    graph = brick.exchange_halos(slab, group).sdf
    return dict(sdf=out, graph=graph.requires_grad,
                same=bool(np.array_equal(graph.detach().numpy(), out)))


def slab_render_world(rank, world, fields, slab_fields, accel_mode, width,
                      height, mode):
    """``render_slab_image`` of the scene ``fields`` through the stacked
    slabs ``slab_fields`` over a (1, world) mesh, on the CPU; with the
    slab march and resolve calls this rank made."""
    from vrt_torch.dist.slab_render import render_slab_image

    _setup()
    scene = scene_from_numpy(fields, device="cpu")
    slabs = brick.slab_from_numpy(slab_fields, accel_mode)
    m = mesh.make_render_mesh(1, world, "cpu")
    calls = {"march": 0, "resolve": 0}
    march, resolve = brick.march_volume_slab, brick.resolve_slab_hits

    def counted_march(*a, **k):
        calls["march"] += 1
        return march(*a, **k)

    def counted_resolve(*a, **k):
        calls["resolve"] += 1
        return resolve(*a, **k)

    from vrt_torch.dist import slab_render

    slab_render.march_volume_slab = counted_march
    slab_render.resolve_slab_hits = counted_resolve
    try:
        img = render_slab_image(scene, slabs, m, width, height,
                                RenderMode(**mode))
    finally:
        slab_render.march_volume_slab = march
        slab_render.resolve_slab_hits = resolve
    return dict(img=img.numpy(), calls=calls)


def resync_world(rank, world, slab_fields, resolution):
    """``assemble_full_sdf`` and ``resync_slabs`` of the local slabs over
    a (1, world) mesh."""
    _setup()
    slab = brick.slab_from_numpy(slab_fields).local(rank, "cpu")
    group = mesh.axis_group(mesh.make_render_mesh(1, world, "cpu"),
                            mesh.MODEL_AXIS)[0]
    full = brick.assemble_full_sdf(slab, group)
    again = brick.resync_slabs(slab, resolution, group)
    return dict(full=full.numpy(), sdf=again.sdf.numpy(),
                accel=again.accel.numpy())


# ---- the fit steps (tests/test_torch_dist_fit.py) ----------------------------

def collective_grad_world(rank, world, xs, cots):
    """The gradients of ``all_gather``, ``all_reduce_sum`` and ``loss_sum``
    of this rank's ``xs[rank]`` under this rank's cotangents ``cots[k][rank]``
    on a (1, world) mesh, the loss's value, and the collectives' counts."""
    _setup()
    group = mesh.axis_group(mesh.make_render_mesh(1, world, "cpu"),
                            mesh.MODEL_AXIS)[0]
    mesh.reset_stats()
    out = {}
    for name, fn in (("gather", mesh.all_gather), ("sum", mesh.all_reduce_sum)):
        x = torch.from_numpy(xs[rank]).requires_grad_(True)
        (fn(x, group) * torch.from_numpy(cots[name][rank])).sum().backward()
        out[name] = x.grad.numpy()
    x = torch.from_numpy(xs[rank]).requires_grad_(True)
    loss = mesh.loss_sum((x * x).sum(), group)
    (loss * float(cots["loss"][rank])).backward()
    out.update(loss=loss.item(), loss_grad=x.grad.numpy())
    with torch.no_grad():
        plain = mesh.all_gather(torch.from_numpy(xs[rank]), group)
    out.update(plain_graph=plain.requires_grad, stats=dict(mesh.STATS))
    return out


def halo_grad_world(rank, world, slab_fields, accel_mode, cots):
    """The gradient of sum(exchange_halos(planes) * cots[rank]) in this
    rank's planes."""
    _setup()
    slab = brick.slab_from_numpy(slab_fields, accel_mode).local(rank, "cpu")
    slab.sdf.requires_grad_(True)
    group = mesh.axis_group(mesh.make_render_mesh(1, world, "cpu"),
                            mesh.MODEL_AXIS)[0]
    new = brick.exchange_halos(slab, group).sdf
    (new * torch.from_numpy(cots[rank])).sum().backward()
    return slab.sdf.grad.numpy()


def dp_world(rank, world, fields, params, o, d, targets, mode, cases):
    """``make_loss_and_grad_dp`` over a (world, 1) mesh for each
    (reduce, interleave) of ``cases``: [(loss, grads)]."""
    from vrt_torch.dist.sharding import make_loss_and_grad_dp

    _setup()
    scene = scene_from_numpy(fields, device="cpu")
    m = mesh.make_render_mesh(world, 1, "cpu")
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    o, d, targets = (torch.from_numpy(x) for x in (o, d, targets))
    out = []
    for reduce, interleave in cases:
        fn = make_loss_and_grad_dp(RenderMode(**mode), m, reduce, interleave)
        loss, grads = fn(p, scene, o, d, targets)
        out.append((loss.item(), {k: g.numpy() for k, g in grads.items()}))
    return out


def dp_step_world(rank, world, shape, fields, params, o, d, targets, lr,
                  steps):
    """``steps`` of ``make_fit_step_dp`` with SGD at ``lr`` over a mesh of
    ``shape``: the losses and the last params."""
    from vrt_torch.diff.optim import sgd
    from vrt_torch.dist.sharding import make_fit_step_dp

    _setup()
    scene = scene_from_numpy(fields, device="cpu")
    m = mesh.make_render_mesh(*shape, "cpu")
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    o, d, targets = (torch.from_numpy(x) for x in (o, d, targets))
    optimizer = sgd(lr)
    state = optimizer.init(p)
    step = make_fit_step_dp(RenderMode(), m, optimizer)
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, scene, o, d, targets)
        losses.append(loss.item())
    return dict(losses=losses, params={k: v.numpy() for k, v in p.items()})


def slab_fit_world(rank, world, shape, fields, slab_fields, o, d, targets,
                   optimizer, opt_args, crossed=False, table="planes"):
    """One slab fit step over a mesh of ``shape`` (data, model):
    ``make_slab_fit_step`` over the model axis, or with ``crossed``
    ``make_slab_fit_step_crossed``, with the optimizer ``optimizer`` of
    ``vrt_torch.diff.optim`` (its arguments ``opt_args``), the kernels on
    the slab's ``table``; rays and targets are split as ``vrt``'s in-specs
    split them.  This rank's updated planes, the loss, and the gradient the
    step handed the optimizer."""
    from vrt_torch.diff import optim
    from vrt_torch.dist.slab_render import (make_slab_fit_step,
                                            make_slab_fit_step_crossed)

    _setup()
    scene = scene_from_numpy(fields, device="cpu")
    m = mesh.make_render_mesh(*shape, "cpu")
    _, model, s_count = mesh.axis_group(m, mesh.MODEL_AXIS)
    _, flat, total = mesh.axis_group(m, (mesh.DATA_AXIS, mesh.MODEL_AXIS))
    slab = brick.slab_from_numpy(slab_fields, table=table).local(model,
                                                                  "cpu")
    opt = _Recording(getattr(optim, optimizer)(**opt_args))
    if crossed:
        step = make_slab_fit_step_crossed(m, opt, scene)
        part = flat
    else:
        step = make_slab_fit_step(m, opt, scene)
        part, total = model, s_count
    rows = o.shape[0] // total
    mine = slice(part * rows, (part + 1) * rows)
    params = slab.sdf.clone()
    params1, _, loss = step(params, opt.init(params), slab,
                            *(torch.from_numpy(x[mine])
                              for x in (o, d, targets)))
    return dict(params=params1.numpy(), loss=loss.item(), model=model,
                grad=opt.grads.numpy())


class _Recording:
    """An optimizer of ``vrt_torch.diff.optim`` that keeps the gradient a
    step hands it (after the step's own all-reduce)."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params=None):
        self.grads = grads
        return self.inner.update(grads, state, params)

    def apply(self, params, grads, state):
        self.grads = grads
        return self.inner.apply(params, grads, state)
