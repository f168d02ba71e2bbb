"""The render pipeline over a slab-sharded volume, and its fit steps (port
of ``vrt.dist.slab_render``).

``SlabTracer`` plugs the slab march into the renderer's tracer seam
(``vrt_torch.render.renderer.SceneTracer``): primary, shadow and bounce
rays all march this rank's slab (``vrt_torch.dist.brick.march_volume_slab``:
K7 on the card) and combine their closest hits across the model axis;
resolve runs on every rank against its own slab, and the sum over ranks of
the hit owner's value (the others contribute zeros) gives every rank the
owner's.  Shadow rays take ``SceneTracer.march_any_hit``'s default, which
reads ``march``'s hits, as in ``vrt``.  Everything above the seam (the
shade kernels, lights, shadows, mirror bounce, env, tonemap) is the same
code as for the replicated frame.

A scene for a big volume is built with ``build_slab_scene_stub``: it
carries the instance, material, light, camera and env with a 2^3 stub SDF,
while the voxels live only in the ranks' slabs.

The fit steps (``make_slab_fit_step``, ``make_slab_fit_step_crossed``)
differentiate the same frame in the rank's planes.  The march reads the
planes without a graph; resolve goes through ``ResolveSlab`` (the fused
resolve's forward and backward kernels over the slab's planes on the
card), whose backward returns the planes' gradient, which reaches the
owners of the halo planes through ``exchange_halos``' backward (with
``SlabVolume.table == "packed"``, the first design, a table gradient that
reaches the planes through the table's pack first).  The collectives
carry the gradient as ``vrt``'s transposes do (``vrt_torch.dist.mesh``):
the owner sum's backward all-reduces the cotangent, the ray all-gather's
is the reduce-scatter, and the loss's sum over the ranks passes its
cotangent through.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vrt_torch.diff.fit import _value_and_grad
from vrt_torch.dist import mesh as _mesh
from vrt_torch.dist.brick import (SlabVolume, combine_hits, exchange_halos,
                                  march_volume_slab, resolve_slab_hits)
from vrt_torch.dist.mesh import DATA_AXIS, MODEL_AXIS
from vrt_torch.march.types import MarchHit
from vrt_torch.render.gpuscene import GPUScene, RenderMode
from vrt_torch.render.renderer import (SceneTracer, _needs_autograd,
                                       _world_to_object, render_rays,
                                       tonemap, trace_radiance)

_RESOLVE_FIELDS = ("hit", "t", "kind", "cell", "face_normal")


class SlabTracer(SceneTracer):
    """March and resolve against ONE slab-sharded volume (instance 0 of
    the scene, its only instance) on this rank's slab, the ranks of
    ``group`` (the model axis) holding the others.  The scene's own voxel
    tables are never read, so a stub scene works."""

    def __init__(self, slab: SlabVolume, group):
        self.slab = slab
        self.group = group

    def _object_rays(self, scene: GPUScene, o_w, d_w):
        return _world_to_object(scene.inst_pos[0], scene.inst_rot[0],
                                scene.inst_scale[0], o_w, d_w)

    def march(self, scene: GPUScene, o_w, d_w, t_max, interp: bool,
              debug_overlay: bool = False):
        with torch.no_grad():
            o, d = self._object_rays(scene, o_w, d_w)
            hit = march_volume_slab(self.slab, o, d, t_max, interp,
                                    debug_overlay)
            hit_c = combine_hits(hit, self.group)
        inst = torch.where(hit_c.hit, 0, -1).to(torch.int32)
        return hit_c, inst

    def resolve(self, scene: GPUScene, o_w, d_w, hit: MarchHit, inst):
        """The hit owner's (t, object-space normal, unlit) on every rank:
        each rank resolves against its own slab (the 2-voxel halo covers a
        boundary cell's stencil); the sum over the ranks of the owner's
        value and zeros elsewhere replicates it.  On the card, and on the
        CPU where a graph is recorded through the rays or the slab's planes,
        ``ResolveSlab`` (the fused resolve over the slab's planes, or its
        packed table, forward and backward); else ``resolve_slab_hits``.
        The sum over the ranks is differentiable: its backward all-reduces
        the cotangent."""
        if (o_w.device.type == "cuda"
                or _needs_autograd(o_w, d_w, self.slab.sdf)):
            from vrt_torch.kernels.resolve import ResolveSlab

            t, n_obj, unlit = ResolveSlab.apply(
                o_w.contiguous(), d_w.contiguous(),
                self.slab.resolve_table, scene, self.slab,
                dataclasses.replace(hit, cell=hit.cell.contiguous(),
                                    face_normal=hit.face_normal.contiguous()),
                inst.contiguous())
        else:
            o, d = self._object_rays(scene, o_w, d_w)
            t, n_obj, unlit = resolve_slab_hits(self.slab, o, d, hit)
        owned = (hit.hit & (hit.cell[:, 0] >= self.slab.cell_lo)
                 & (hit.cell[:, 0] < self.slab.cell_hi))
        t = _mesh.all_reduce_sum(torch.where(owned, t, 0.0), self.group)
        n_obj = _mesh.all_reduce_sum(
            torch.where(owned[:, None], n_obj, 0.0), self.group)
        unlit = _mesh.all_reduce_sum(
            torch.where(owned, unlit, False).to(torch.int32), self.group) > 0
        return t, n_obj, unlit


class GatherSlabTracer(SceneTracer):
    """``SlabTracer`` for ray-sharded callers: the lanes entering march and
    resolve are this rank's slice of the rays; the tracer all-gathers the
    slices (every ray must test every slab), runs the full-width slab march
    or resolve, and hands back this rank's rows.  So the shading above the
    seam runs on R/S rays a rank.  Resolve's gathers of the rays are
    differentiable (their backward the reduce-scatter); the march records
    no graph."""

    def __init__(self, slab: SlabVolume, group):
        self.inner = SlabTracer(slab, group)
        self.group = group

    def _slice(self, x, local_n):
        i = torch.distributed.get_rank(self.group)
        return x[i * local_n:(i + 1) * local_n]

    def _gather(self, x):
        return _mesh.all_gather(x, self.group)

    @torch.no_grad()
    def march(self, scene: GPUScene, o_w, d_w, t_max, interp: bool,
              debug_overlay: bool = False):
        n = o_w.shape[0]
        hit, inst = self.inner.march(scene, self._gather(o_w),
                                     self._gather(d_w), self._gather(t_max),
                                     interp, debug_overlay)
        return (MarchHit(**{f.name: self._slice(getattr(hit, f.name), n)
                            for f in dataclasses.fields(MarchHit)}),
                self._slice(inst, n))

    def resolve(self, scene: GPUScene, o_w, d_w, hit: MarchHit, inst):
        # resolve reads the hit's flag, t, kind, cell and face normal
        n = o_w.shape[0]
        full = MarchHit(t_in=None, t_out=None,
                        **{f: self._gather(getattr(hit, f))
                           for f in _RESOLVE_FIELDS})
        out = self.inner.resolve(scene, self._gather(o_w), self._gather(d_w),
                                 full, self._gather(inst))
        return tuple(self._slice(x, n) for x in out)


def build_slab_scene_stub(vol_n: int, cell_size: float, extends: float,
                          material=None, device="cuda",
                          **scene_kwargs) -> GPUScene:
    """A GPUScene whose one instance has the volume's GEOMETRY (voxels per
    axis, cell size, extent) but a 2^3 stub SDF, with materials, lights,
    camera and env as ``build_scene`` takes them.  Pair it with a
    ``SlabVolume`` of the same geometry: the slab tracers never read the
    scene's voxel tables, so the full grid need not exist on any rank."""
    from vrt_torch.core.material import Material
    from vrt_torch.render.gpuscene import build_scene
    from vrt_torch.volume.volume import VoxelVolume

    stub = VoxelVolume(resolution=0, extends=extends,
                       material=material or Material())
    scene = build_scene([stub], [{"volume": 0}], device=device,
                        **scene_kwargs)
    vols = dataclasses.replace(
        scene.volumes,
        n=torch.full_like(scene.volumes.n, vol_n),
        cell_size=torch.full_like(scene.volumes.cell_size, cell_size),
        extends=torch.full_like(scene.volumes.extends, extends))
    return dataclasses.replace(scene, volumes=vols)


def default_fit_scene(vol_n: int, cell_size: float, extends: float,
                      light_dir, strength: float = 4.0,
                      albedo=(0.8, 0.5, 0.3), background=(0.2, 0.3, 0.5),
                      device="cuda") -> GPUScene:
    """The stub-volume scene of ``vrt``'s slab fit and config5: a
    directional light, a flat-colour env, a rough (roughness 0.8, so
    non-reflective) material, the camera at (300, 0, 0) looking down -x."""
    from vrt_torch.core import quat as vq
    from vrt_torch.core.material import Material

    env = np.zeros((6, 2, 2, 3), np.float32)
    env[:] = background
    mat = Material(albedo=tuple(albedo) + (1.0,), roughness=0.8)
    return build_slab_scene_stub(
        vol_n, cell_size, extends, material=mat, device=device,
        camera={"position": (300.0, 0.0, 0.0),
                "rotation": np.asarray(vq.from_euler_degrees(0.0, 180.0,
                                                             0.0))},
        dir_light={"direction": np.asarray(light_dir, np.float32),
                   "strength": strength},
        env=env)


def render_slab_image(scene: GPUScene, slab: SlabVolume, mesh, width: int,
                      height: int, mode: RenderMode = RenderMode(),
                      axis: str = MODEL_AXIS) -> torch.Tensor:
    """The full frame through a slab-sharded volume, on every rank of the
    ``axis`` of ``mesh``: [H,W,4] f32.  ``slab`` is this rank's slab (a
    local ``SlabVolume``; stacked slabs are cut to it).  The rays are split
    over the axis in contiguous slices; the ``GatherSlabTracer`` gathers
    them for every march, so the shading runs on each rank's slice.  Equal
    to the replicated ``render_image`` of the same volume but on hits in a
    slab's boundary cells, whose bracket starts may differ within the cell
    (see ``brick.march_volume_slab_reference``)."""
    from vrt_torch.render.camera import camera_rays

    group, index, s_count = _mesh.axis_group(mesh, axis)
    if slab.sdf.dim() == 4:
        slab = slab.local(index, scene.cam_pos.device)
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov,
                       width, height)
    total = width * height
    pad = (-total) % s_count
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype,
                                      device=o.device)])
        d = torch.cat([d, torch.ones((pad, 3), dtype=d.dtype,
                                     device=d.device)])
    local = o.shape[0] // s_count
    mine = slice(index * local, (index + 1) * local)
    rgba = render_rays(scene, o[mine].clone(), d[mine].clone(), mode,
                       GatherSlabTracer(slab, group))
    return _mesh.all_gather(rgba, group)[:total].reshape(height, width, 4)


def _slab_loss_fn(scene, mode, slab, o, d, targets, halo_group, tracer_group,
                  loss_group, pixels):
    """The fit loss of one rank's planes: a fresh local slab from them, its
    halos refreshed over ``halo_group``, the frame of this rank's rays
    through the ``GatherSlabTracer`` over ``tracer_group``, and the summed
    squared error over ``loss_group`` divided by the ``pixels`` values of
    the whole batch."""

    def loss_fn(p):
        s = exchange_halos(dataclasses.replace(slab, sdf=p), halo_group)
        rgb = trace_radiance(scene, o, d, 0, mode,
                             tracer=GatherSlabTracer(s, tracer_group))
        se = torch.sum((tonemap(rgb) - targets) ** 2)
        return _mesh.loss_sum(se, loss_group) / pixels

    return loss_fn


def make_slab_fit_step(mesh, optimizer, scene: GPUScene,
                       mode: RenderMode = RenderMode(),
                       axis: str = MODEL_AXIS):
    """Model-parallel fit step through the production shade (``vrt``'s
    ``make_slab_fit_step``), run by every rank of ``axis``.

    step(params f32 [span,N,N], opt_state, slab, o, d, targets) -> (params,
    opt_state, loss): ``params`` this rank's planes (halos included),
    ``slab`` its local ``SlabVolume`` (geometry, accel and ``table``, the
    design the kernels read; its planes are not read), ``o``, ``d``
    [R/S,3] and ``targets`` [R/S,3] this rank's rows of the rays
    (``vrt``'s ``P(axis)``), ``opt_state`` the
    ``vrt_torch.diff.optim`` optimizer's state of ``params``.  Per step: a
    fresh slab from ``params``, the differentiable halo exchange, the slab
    march (no graph) and closest-hit combine for the primary rays and every
    shadow ray the shading spawns, the owner-summed differentiable resolve,
    the shade kernels and the tonemap at R/S rays a rank, and the mean
    squared error over every rank's pixels; then the backward and the
    optimizer's update of this rank's planes.  ``loss`` is the global loss,
    on every rank.  The accel stays as ``slab`` holds it (``vrt``'s
    traversal is frozen between ``resync_slabs`` calls too)."""
    group, _, s_count = _mesh.axis_group(mesh, axis)

    def step(params, opt_state, slab: SlabVolume, o, d, targets):
        pixels = float(targets.numel() * s_count)
        loss_fn = _slab_loss_fn(scene, mode, slab, o, d, targets, group,
                                group, group, pixels)
        loss, g = _value_and_grad(lambda p: loss_fn(p["sdf"]),
                                  {"sdf": params})
        params, opt_state = optimizer.apply(params, g["sdf"], opt_state)
        return params, opt_state, loss

    return step


def make_slab_fit_step_crossed(mesh, optimizer, scene: GPUScene,
                               mode: RenderMode = RenderMode(),
                               data_axis: str = DATA_AXIS,
                               model_axis: str = MODEL_AXIS):
    """The crossed data x model fit step (``vrt``'s
    ``make_slab_fit_step_crossed``): the halo exchange, the ray gathers and
    the owner sums ride ``model_axis``; the loss is summed over both axes;
    the planes' gradient is all-reduced over ``data_axis`` (each data row saw
    other rays) before the update.

    step(params [span,N,N], opt_state, slab, o, d, targets) -> (params,
    opt_state, loss), as ``make_slab_fit_step``'s, with ``o``, ``d`` and
    ``targets`` this rank's R/(D*S) rows (``vrt``'s ``P((data, model))``:
    the rows of flat index ``data * S + model``).  The planes are the model
    rank's, the same on every data rank."""
    model, _, s_count = _mesh.axis_group(mesh, model_axis)
    data, _, d_count = _mesh.axis_group(mesh, data_axis)
    both, _, _ = _mesh.axis_group(mesh, tuple(mesh.mesh_dim_names))

    def step(params, opt_state, slab: SlabVolume, o, d, targets):
        pixels = float(targets.numel() * s_count * d_count)
        loss_fn = _slab_loss_fn(scene, mode, slab, o, d, targets, model,
                                model, both, pixels)
        loss, g = _value_and_grad(lambda p: loss_fn(p["sdf"]),
                                  {"sdf": params})
        grad = _mesh.all_reduce_sum(g["sdf"], data)
        params, opt_state = optimizer.apply(params, grad, opt_state)
        return params, opt_state, loss

    return step
