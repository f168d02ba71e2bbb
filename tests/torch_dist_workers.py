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
    m = mesh.make_render_mesh(1, world)
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
    m = mesh.make_render_mesh(world, 1)
    img = render_image_sharded(scene, width, height, RenderMode(**mode), m,
                               interleave=interleave)
    return img.numpy()


def combine_world(rank, world, slab_fields, accel_mode, o, d, t_max, cases):
    """Every rank marches its slab with the twin, then ``combine_hits``:
    the combined hits of each (interp, debug_overlay) case."""
    _setup()
    slabs = brick.slab_from_numpy(slab_fields, accel_mode)
    slab = slabs.local(rank, "cpu")
    m = mesh.make_render_mesh(1, world)
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
    that requires a gradient is refused."""
    _setup()
    slabs = brick.slab_from_numpy(slab_fields, accel_mode)
    slab = slabs.local(rank, "cpu")
    slab = brick.SlabVolume(**{**{f: getattr(slab, f)
                                  for f in brick._FIELDS},
                               "sdf": slab.sdf + torch.from_numpy(
                                   delta[rank])},
                            accel_mode=accel_mode)
    group = mesh.axis_group(mesh.make_render_mesh(1, world),
                            mesh.MODEL_AXIS)[0]
    out = brick.exchange_halos(slab, group).sdf.numpy()
    slab.sdf.requires_grad_(True)
    try:
        brick.exchange_halos(slab, group)
        refused = False
    except NotImplementedError:
        refused = True
    return dict(sdf=out, refused=refused)


def slab_render_world(rank, world, fields, slab_fields, accel_mode, width,
                      height, mode):
    """``render_slab_image`` of the scene ``fields`` through the stacked
    slabs ``slab_fields`` over a (1, world) mesh, on the CPU; with the
    slab march and resolve calls this rank made."""
    from vrt_torch.dist.slab_render import render_slab_image

    _setup()
    scene = scene_from_numpy(fields, device="cpu")
    slabs = brick.slab_from_numpy(slab_fields, accel_mode)
    m = mesh.make_render_mesh(1, world)
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
    group = mesh.axis_group(mesh.make_render_mesh(1, world),
                            mesh.MODEL_AXIS)[0]
    full = brick.assemble_full_sdf(slab, group)
    again = brick.resync_slabs(slab, resolution, group)
    return dict(full=full.numpy(), sdf=again.sdf.numpy(),
                accel=again.accel.numpy())
