"""The render pipeline — raygen, scene traversal, shading, tonemap (port of
``vrt.render.renderer``, the unchunked inline path).

- the TLAS over per-instance AABBs is a loop over the (<= 20) instances in
  entry-t order: each candidate is marched in its object space with its own
  255-step budget, clamped to the closest hit so far.  On CUDA tensors that
  loop runs inside one kernel launch per trace (K1's scene march); its plain
  version ``march_scene_reference`` runs one pass over all rays per
  candidate,
- hit resolve (t, normal, unlit) is one fused kernel on CUDA tensors, with a
  backward kernel of its own where a graph is recorded (``resolve_scene``),
- the recursive ``TraceRay`` tree (recursion cap 3) recurses inline:
  depth-0/1/2 radiance traces with masked reflection lanes and boolean
  shadow traces,
- shading is the reference's closest-hit Cook-Torrance with point and spot
  lights, the env miss lookup, and Reinhard + gamma tonemapping; with
  per-voxel colours the albedo is their trilinear sample at the hit.  A
  level shades in two stages, one on each side of the traces it spawns
  (``shade_stages``): on CUDA tensors the two kernels of ``shade.cu`` (with
  a graph, through the ``autograd.Function`` pair whose backward is their
  backward kernels), on CPU tensors their plain versions
  ``shade_surface_reference`` and ``shade_combine_reference`` (which the
  tests also differentiate under autograd).

The frame is differentiable in the scene's tensors: the march runs under
``torch.no_grad()`` (its hits are piecewise constant in the SDF, as under
``vrt``'s ``stop_gradient``), and autograd records resolve and the shading
stages.

Like ``vrt`` it uses the spot light's own colour (the reference's
``g_spotLightsCB[pi]`` indexing bug is not reproduced).
"""

from __future__ import annotations

import dataclasses

import torch

from vrt_torch.core import kinks
from vrt_torch.core import quat as vq
from vrt_torch.kernels.rows import (gather_rows, gather_rows_reference,
                                    scatter_rows_reference)
from vrt_torch.march import isosurface as iso
from vrt_torch.march.march import march_lanes, ray_aabb
from vrt_torch.march.resolve import (_OFFS7, resolve_hits,
                                      resolve_hits_backward)
from vrt_torch.march.types import (RECORD_GRAD_FIELDS, MarchHit,
                                    SurfaceRecord)
from vrt_torch.render.gpuscene import (INSTANCE_FIELDS, LIGHT_FIELDS,
                                       MATERIAL_FIELDS, TEXTURE_FIELDS,
                                       GPUScene, RenderMode, color_table)
from vrt_torch.shade import brdf as _brdf
from vrt_torch.shade import lights as _lights
from vrt_torch.shade import texture as _tex

MAX_RAY_RECURSION_DEPTH = 3
RADIANCE_TMAX = 10000.0
DIR_SHADOW_TMAX = 5000.0

_INF = float("inf")


def _safe_unit(v):
    """Normalize; zero vectors map to zero (not NaN)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    n = torch.sqrt(torch.where(n2 > 0, n2, 1.0))
    return torch.where(n2 > 0, v / n, 0.0)


def _safe_div(num, den):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _world_to_object(pos, rot, scale, o_w, d_w):
    """Rays into an instance's object space: the instance transform is
    world = diag(s)*R(v) + p, so rays take its inverse; t is preserved."""
    qi = vq.conjugate(rot)
    o = vq.rotate(qi, (o_w - pos) / scale)
    d = vq.rotate(qi, d_w / scale)
    return o, d


def _object_normal_to_world(rot, scale, n_obj):
    """Normals go through ObjectToWorld with w=0, *not* renormalized."""
    return vq.rotate(rot, n_obj) * scale


def _no_instances(o_w):
    """The all-miss result of a scene without instances."""
    r = o_w.shape[0]
    hit = MarchHit.none_like(o_w)
    hit.steps = torch.zeros(r, dtype=torch.int32, device=o_w.device)
    return hit, torch.full((r,), -1, dtype=torch.int32, device=o_w.device)


def march_scene(scene: GPUScene, o_w, d_w, t_max, interp: bool = True,
                debug_overlay: bool = False, lane_marcher=None):
    """Closest hit across all active instances — the TLAS equivalent.

    Per ray, candidate instances are ordered by AABB entry t and marched
    one at a time; candidate j's t_max is clamped to the best hit so far,
    and each candidate gets its own 255-step budget.  Ties in entry t keep
    the lower instance index (stable sort).

    Returns (hit: MarchHit with object-space brackets of the winning
    instance and ``steps`` summed over candidates, inst: i32 [R] winning
    instance id, -1 when none).  CUDA tensors go to K1's scene march, one
    launch for the whole trace (``kernels.march.march_scene_cuda``); CPU
    tensors go to its plain version ``march_scene_reference``.
    ``lane_marcher`` (signature of ``march_lanes``) selects the plain
    version's candidate loop on any device, with that per-candidate march.
    Runs under ``torch.no_grad()``: nothing it returns carries a
    gradient."""
    if lane_marcher is not None or o_w.device.type == "cpu":
        return march_scene_reference(scene, o_w, d_w, t_max, interp,
                                     debug_overlay,
                                     lane_marcher or march_lanes)
    if scene.num_instances == 0:
        return _no_instances(o_w)
    return _scene_march_kernel(scene, o_w, d_w, t_max, interp, debug_overlay)


def march_scene_any_hit(scene: GPUScene, o_w, d_w, t_max,
                        interp: bool = True):
    """Whether each ray hits anything within [0, t_max]: bool [R], the
    ``hit`` of ``march_scene``'s result without the debug overlay.  On CUDA
    tensors K1's scene march writes only this and stops at the first
    candidate that hits; on CPU tensors it is read off the plain version."""
    if o_w.device.type == "cpu":
        return march_scene_reference(scene, o_w, d_w, t_max, interp)[0].hit
    if scene.num_instances == 0:
        return _no_instances(o_w)[0].hit
    return _scene_march_kernel(scene, o_w, d_w, t_max, interp, any_hit=True)


def _scene_march_kernel(scene, o_w, d_w, t_max, interp, debug_overlay=False,
                        any_hit=False):
    if o_w.device.type != "cuda":
        raise ValueError(f"no scene march for device {o_w.device}")
    from vrt_torch.kernels import march as k1

    return k1.march_scene_cuda(scene, o_w.contiguous(), d_w.contiguous(),
                               t_max.contiguous(), interp, debug_overlay,
                               any_hit=any_hit)


@torch.no_grad()
def march_scene_reference(scene: GPUScene, o_w, d_w, t_max,
                          interp: bool = True, debug_overlay: bool = False,
                          lane_marcher=march_lanes):
    """The plain version of the scene march (port of
    ``vrt.render.renderer.march_scene``): per-instance transforms and slab
    tests, a stable ``argsort`` of the entry t, and one ``lane_marcher``
    pass over all rays per candidate.  A candidate that is not live (its
    box is missed, its instance inactive, or its entry t not below the best
    hit so far) is marched with t_max = -inf and retires at the slab
    test."""
    r = o_w.shape[0]
    dev = o_w.device
    n_inst = scene.num_instances
    if n_inst == 0:
        return _no_instances(o_w)

    o_objs, d_objs, oks, keys = [], [], [], []
    ext_i = scene.volumes.extends[scene.inst_volume.long()]      # [I]
    for i in range(n_inst):
        o_i, d_i = _world_to_object(scene.inst_pos[i], scene.inst_rot[i],
                                    scene.inst_scale[i], o_w, d_w)
        ok_i, te_i, _ = ray_aabb(o_i, d_i, -ext_i[i], ext_i[i], t_max)
        ok_i = ok_i & scene.inst_active[i]
        o_objs.append(o_i)
        d_objs.append(d_i)
        oks.append(ok_i)
        keys.append(torch.where(ok_i, te_i, _INF))
    o_objs = torch.stack(o_objs)                                 # [I,R,3]
    d_objs = torch.stack(d_objs)
    oks = torch.stack(oks)                                       # [I,R]
    key = torch.stack(keys)
    order = torch.argsort(key, dim=0, stable=True)               # [I,R]
    lane = torch.arange(r, device=dev)

    best = MarchHit.none_like(o_w)
    best_inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_t = torch.full((r,), _INF, device=dev)
    total_steps = torch.zeros(r, dtype=torch.int32, device=dev)
    for j in range(n_inst):
        inst_j = order[j]                                        # [R]
        live = oks[inst_j, lane] & (key[inst_j, lane] < best_t)
        t_max_j = torch.where(live, torch.minimum(t_max, best_t), -_INF)
        h = lane_marcher(scene.volumes, scene.inst_volume[inst_j],
                         o_objs[inst_j, lane], d_objs[inst_j, lane],
                         t_max_j, interp=interp,
                         debug_overlay=debug_overlay)
        total_steps = total_steps + h.steps
        closer = h.hit & (h.t < best_t)
        best = h.select(closer, best)
        best_inst = torch.where(closer, inst_j.to(torch.int32), best_inst)
        best_t = torch.where(closer, h.t, best_t)
    best.steps = total_steps
    return best, best_inst


def _per_ray_instance(scene: GPUScene, inst, take=None):
    """Per-ray instance transform + volume data (inst i32 [R]); ``take``
    reads a transform's rows by instance (``table[idx]`` by default)."""
    vols = scene.volumes
    if scene.num_instances == 0:
        # every lane is a miss: identity transform, volume 0
        vol_id = torch.zeros_like(inst).long()
        zf3 = torch.zeros(inst.shape + (3,), device=inst.device)
        rot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=inst.device)
        return dict(vol=vol_id, pos=zf3, rot=rot.expand(inst.shape + (4,)),
                    scale=zf3 + 1.0, n=vols.n[vol_id],
                    cell_size=vols.cell_size[vol_id],
                    extends=vols.extends[vol_id])
    ic = torch.clamp_min(inst, 0).long()
    vol_id = scene.inst_volume[ic].long()
    take = take or _take
    return dict(vol=vol_id, pos=take(scene.inst_pos, ic),
                rot=take(scene.inst_rot, ic),
                scale=take(scene.inst_scale, ic), n=vols.n[vol_id],
                cell_size=vols.cell_size[vol_id],
                extends=vols.extends[vol_id])


def resolve_scene(scene: GPUScene, o_w, d_w, hit: MarchHit, inst):
    """(t, object-space normal, unlit) for scene hits, read from the
    packed corner table (f32 or bf16), differentiable in the table, the
    rays and the instance transforms (``INSTANCE_FIELDS``).

    Everything goes to ``kernels.resolve.ResolveScene``: on CUDA tensors
    the fused resolve kernel and, where a graph is recorded, its backward
    kernel (its instance variant where a transform needs a gradient); on
    CPU tensors their plain versions (``resolve_scene_reference`` without a
    graph and the closed form ``resolve_scene_backward_reference``).  A
    build or launch that fails raises; nothing falls back."""
    if o_w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no resolve for device {o_w.device}")
    from vrt_torch.kernels.resolve import ResolveScene

    return ResolveScene.apply(o_w.contiguous(), d_w.contiguous(),
                              scene.volumes.corners,
                              *(getattr(scene, f) for f in INSTANCE_FIELDS),
                              scene, hit, inst)


def resolve_scene_reference(scene: GPUScene, o_w, d_w, hit: MarchHit, inst,
                            take=None):
    """``resolve_scene`` in plain PyTorch, differentiable by autograd in
    the corner table, the rays and the instance transforms (port of
    ``vrt.render.renderer.resolve_scene``): the plain version of the fused
    resolve kernel.  ``take`` reads a transform's rows by instance
    (``table[idx]`` by default)."""
    pr = _per_ray_instance(scene, inst, take)
    o, d = _world_to_object(pr["pos"], pr["rot"], pr["scale"], o_w, d_w)
    cfetch = iso.make_stacked_corner_fetch(scene.volumes.corners, pr["n"],
                                           pr["vol"])
    return resolve_hits(cfetch, pr["cell_size"], pr["extends"], o, d, hit)


def _rotate_backward(q, v, g):
    """The cotangent of the quaternion q [..., 4] of ``vq.rotate(q, v)`` for
    the output's cotangent g, by ``vq.rotate``'s formula (t = 2 qv x v; v +
    qw t + qv x t) for any q, in the operation order of ``shade.cu``'s
    ``rotate_bwd``."""
    qv, qw = q[..., :3], q[..., 3:4]
    tt = 2.0 * vq.cross(qv, v)
    g_qw = ((g[..., 0] * tt[..., 0] + g[..., 1] * tt[..., 1])
            + g[..., 2] * tt[..., 2])[..., None]
    gt = 2.0 * (qw * g + vq.cross(g, qv))
    return torch.cat([vq.cross(tt, g) + vq.cross(v, gt), g_qw], dim=-1)


def _object_backward(pos, rot, scale, x_w, g, point: bool):
    """The per-lane cotangents (pos [R,3], rot [R,4], scale [R,3]) of an
    instance transform for the cotangent g of an object-space vector x =
    rotate(conj(rot), a), a = (x_w - pos) / scale for a ``point``, x_w /
    scale for a direction (``_world_to_object``).  Under ``vq.rotate``'s
    formula M(q)^T = M(conj q) exactly, so the transpose of the rotation is
    rotate(rot, .): a's cotangent g_a = rotate(rot, g), x_w's g_a / scale,
    -g_a / scale into pos (a point's), -(g_a / scale) a into scale; the
    quaternion's is ``_rotate_backward`` on the conjugate with the sign of
    its vector part flipped."""
    a = (x_w - pos) / scale if point else x_w / scale
    g_x = vq.rotate(rot, g) / scale
    g_q = _rotate_backward(vq.conjugate(rot), a, g)
    g_pos = -g_x if point else torch.zeros_like(g_x)
    return g_pos, vq.conjugate(g_q), -(g_x * a)


@torch.no_grad()
def resolve_scene_backward_reference(scene: GPUScene, o_w, d_w,
                                     hit: MarchHit, inst, g_t, g_normal,
                                     acc_dtype=torch.float32,
                                     instances: bool = False):
    """The vector-Jacobian product of ``resolve_scene_reference`` in the
    rays and the corner table, in closed form: -> (g_o_w f32 [R,3], g_d_w
    f32 [R,3], g_corners [V*C^3, ch]) for the cotangents ``g_t`` [R] and
    ``g_normal`` [R,3].  The plain version of the fused resolve's backward
    kernel: ``resolve_hits_backward`` per ray in object space, the
    transpose of ``_world_to_object`` for the rays, and
    ``scatter_rows_reference`` for the table (summed in ``acc_dtype``; the
    caller casts once to the table's dtype).  Only ``hit.kind``, ``hit.t``
    and ``hit.cell`` are read.  With ``instances`` (the plain version of
    the kernel's instance variant) four more follow: the cotangents of the
    instance transforms (``INSTANCE_FIELDS``: pos [I,3], rot [I,4], scale
    [I,3], f32), each lane's (``_object_backward`` of its ray's origin and
    direction) summed over the lanes in float64, then a tuple of the three
    tables' sums of their lanes' |terms| (float64)."""
    pr = _per_ray_instance(scene, inst)
    o, d = _world_to_object(pr["pos"], pr["rot"], pr["scale"], o_w, d_w)
    corners = scene.volumes.corners
    cc, ch = corners.shape[1], corners.shape[-1]
    flat = corners.reshape(-1, ch)
    offs = torch.as_tensor(_OFFS7, device=o_w.device)
    idx = iso.stacked_corner_index(hit.cell[:, None, :] + offs, pr["n"],
                                   pr["vol"], cc).reshape(-1)
    rows7 = gather_rows_reference(flat, idx, 8).reshape(-1, 7, 8)
    g_o, g_d, g_rows7 = resolve_hits_backward(
        rows7, pr["cell_size"], pr["extends"], o, d, hit, g_t, g_normal)
    g_o_w = vq.rotate(pr["rot"], g_o) / pr["scale"]
    g_d_w = vq.rotate(pr["rot"], g_d) / pr["scale"]
    g_corners = scatter_rows_reference(g_rows7.reshape(-1, 8), idx,
                                       flat.shape[0], ch, acc_dtype)
    out = (g_o_w, g_d_w, g_corners)
    if not instances:
        return out
    # the lanes whose kind carries a gradient (surface, solid entry)
    carries = ((hit.kind == 1) | (hit.kind == 2))[:, None]
    lanes = [torch.zeros(0, 3, device=o_w.device)] * 3
    if scene.num_instances:
        terms = [_object_backward(pr["pos"], pr["rot"], pr["scale"], x, g,
                                  point)
                 for x, g, point in ((o_w, g_o, True), (d_w, g_d, False))]
        lanes = [torch.where(carries, a + b, 0.0)
                 for a, b in zip(*terms)]
    ic = torch.clamp_min(inst, 0).long()
    summed = [_summed(getattr(scene, f), [(g, ic)] if scene.num_instances
                      else [])
              for f, g in zip(INSTANCE_FIELDS, lanes)]
    return out + tuple(s for s, _ in summed) + (tuple(t for _, t in summed),)


def _voxel_color_sample(scene: GPUScene, pr, hit: MarchHit, o_w, d_w, t,
                        gather=None):
    """Trilinear sample of the per-voxel colour field at the hit point, with
    the per-corner valid mask after the gather: from one 24-channel row of
    the corner-packed colours per hit cell (``gather``, default
    ``gather_rows``: K3 on CUDA tensors) or, where the scene has no packed
    view (above ``COLOR_CORNER_BUDGET_BYTES``), from 8 voxel rows of 3
    channels of the f32 grid, each corner's index clipped to the grid
    (``gather``, default plain indexing: K3 takes rows of 4k channels)."""
    o, d = _world_to_object(pr["pos"], pr["rot"], pr["scale"], o_w, d_w)
    h = pr["cell_size"]
    cell = hit.cell
    cell_base = cell.to(torch.float32) * h[..., None] \
        - pr["extends"][..., None]
    p = (o + d * t[..., None] - cell_base) / h[..., None]
    corners = torch.as_tensor(iso.CORNERS, device=cell.device)
    idx = cell[:, None, :] + corners[None]                     # [R,8,3]
    valid = torch.all((idx >= 0) & (idx < pr["n"][:, None, None]), dim=-1)
    pcc = scene.voxel_color_corners
    if pcc is not None:
        cn = pcc.shape[1]
        ic = torch.clamp(cell, 0, cn - 1)
        lin = iso._flat_index(pr["vol"], ic, cn).to(torch.int32)
        rows = (gather or gather_rows)(pcc.reshape(-1, 24), lin,
                                       24).reshape(-1, 8, 3)
    else:
        colors = scene.voxel_colors
        nn = colors.shape[1]
        ic = torch.clamp(idx, 0, nn - 1)
        lin = iso._flat_index(pr["vol"][:, None], ic, nn).to(torch.int32)
        rows = (gather or gather_rows_reference)(
            colors.reshape(-1, 3), lin.reshape(-1), 3).reshape(-1, 8, 3)
    cvals = torch.where(valid[..., None], rows, 0.0)
    w = kinks.abs_((1.0 - corners.to(torch.float32))[None] - p[:, None, :])
    w = (w[..., 0] * w[..., 1]) * w[..., 2]                    # [R,8]
    return torch.sum(w[..., None] * cvals, dim=1)


class SceneTracer:
    """The march/resolve seam of the render pipeline (port of
    ``vrt.render.renderer.SceneTracer``).

    The default tracer is the replicated TLAS-equivalent: ``march_scene``,
    ``march_scene_any_hit`` and ``resolve_scene``, which pick the kernels on
    CUDA tensors and their plain versions on CPU tensors.  A tracer that
    marches something else (a slab-sharded volume whose hits are combined
    across devices, as ``vrt.dist.slab_render`` does) overrides these
    methods; everything above the seam — shading, lights, bounce, tonemap —
    is the same code for every tracer, passed down as ``tracer=``.

    ``march_any_hit`` has no twin in ``vrt``, whose shadow rays go through
    ``march`` and keep ``hit.hit``: the port's shadow rays take the any-hit
    variant of the scene march.  Its default reads ``march``'s result, so a
    tracer that overrides only ``march`` and ``resolve`` is complete; the
    default tracer overrides it with the any-hit kernel's dispatcher.
    """

    def march(self, scene: GPUScene, o_w, d_w, t_max, interp: bool,
              debug_overlay: bool = False):
        return march_scene(scene, o_w, d_w, t_max, interp,
                           debug_overlay=debug_overlay)

    def march_any_hit(self, scene: GPUScene, o_w, d_w, t_max, interp: bool):
        """bool [R]: whether each ray hits anything within [0, t_max]."""
        return self.march(scene, o_w, d_w, t_max, interp)[0].hit

    def resolve(self, scene: GPUScene, o_w, d_w, hit: MarchHit, inst):
        return resolve_scene(scene, o_w, d_w, hit, inst)


class _DefaultTracer(SceneTracer):
    def march_any_hit(self, scene: GPUScene, o_w, d_w, t_max, interp: bool):
        return march_scene_any_hit(scene, o_w, d_w, t_max, interp)


_DEFAULT_TRACER = _DefaultTracer()


def trace_shadow(scene: GPUScene, o_w, d_w, max_dist, depth: int,
                 interp: bool, relevant=None, tracer: SceneTracer = None):
    """Boolean occlusion trace in the frame's march mode, without the
    debug overlay: any accepted hit within [0, max_dist] blocks;
    recursion-capped rays return un-blocked.  ``relevant`` masks lanes
    whose result the caller discards (their t_max becomes -inf, so they
    retire at the slab test)."""
    if depth >= MAX_RAY_RECURSION_DEPTH:
        return torch.zeros(o_w.shape[0], dtype=torch.bool, device=o_w.device)
    if relevant is not None:
        max_dist = torch.where(relevant, max_dist, -_INF)
    return (tracer or _DEFAULT_TRACER).march_any_hit(scene, o_w, d_w,
                                                     max_dist, interp)


def _shadow_rays(scene: GPUScene, shadow_origin, hit_mask):
    """The shadow rays of a level, for the march alone (no graph): (t_max
    per light, each f32 [R]: the directional light's, then the point and the
    spot lights'; direction per point and spot light, each f32 [R,3]).  A
    lane whose shadow nobody reads (a miss, or a light too dim there) gets
    t_max = -inf and retires at the slab test.  Third, per point and spot
    light its (direction, distance, intensity) at the shadow origin, with
    their graph, for the combine stage to shade with."""
    dev = shadow_origin.device
    lights = tuple(
        [_point_light(scene, pi, shadow_origin)
         for pi in range(scene.num_point)]
        + [_spot_light(scene, si, shadow_origin)
           for si in range(scene.num_spot)])
    floors = [0.005] * scene.num_point + [0.01] * scene.num_spot
    with torch.no_grad():
        t_max = [torch.where(
            hit_mask, torch.full(hit_mask.shape, DIR_SHADOW_TMAX, device=dev),
            -_INF)]
        for (_, dist, inten), floor in zip(lights, floors):
            t_max.append(torch.where(hit_mask & (inten > floor),
                                     dist.detach(), -_INF))
    return (tuple(t_max), tuple(sdir.detach() for sdir, _, _ in lights),
            lights)


def _point_light(scene: GPUScene, pi: int, shadow_origin):
    """(direction to point light ``pi`` [R,3], its distance [R], its
    intensity there [R])."""
    delta = scene.point_pos[pi] - shadow_origin
    dist = torch.linalg.vector_norm(delta, dim=-1)
    inten = _lights.point_light_intensity(
        scene.point_intensity[pi], dist,
        scene.point_att_l[pi], scene.point_att_e[pi])
    return _safe_div(delta, dist[..., None]), dist, inten


def _spot_light(scene: GPUScene, si: int, shadow_origin):
    """``_point_light`` for spot light ``si``."""
    delta = scene.spot_pos[si] - shadow_origin
    dist = torch.linalg.vector_norm(delta, dim=-1)
    inten = _lights.spot_light_intensity(
        shadow_origin, dist, scene.spot_pos[si], scene.spot_fwd[si],
        scene.spot_intensity[si], scene.spot_att_l[si],
        scene.spot_att_e[si], scene.spot_cos_angle[si],
        scene.spot_cos_falloff[si])
    return _safe_div(delta, dist[..., None]), dist, inten


def _take(table, idx):
    return table[idx]


def shade_surface_reference(scene: GPUScene, o_w, d_w, t, n_obj,
                            hit: MarchHit, inst, mode: RenderMode,
                            bounce: bool, shadows: bool,
                            gather=None, take=None,
                            fetch=None) -> SurfaceRecord:
    """The first stage of a level's shading, before the traces the level
    spawns, in plain PyTorch (the plain version of ``shade.cu``'s surface
    kernel; port of the head of ``vrt.render.renderer._shade_lit`` and of
    ``_shade_unlit_mode``).  From the march's ``hit`` / ``inst`` and the
    resolve's ``t`` / ``n_obj``: miss lanes sanitised (their values are
    discarded by the last select), the hit point, the material at it —
    triplanar albedo, roughness / metallic and tangent normal, or the
    per-voxel colour sample — and the world normal; with ``bounce`` the
    mirror direction and its gate (roughness < 0.3); with ``shadows`` the
    level's shadow rays.  In unlit mode only the albedo.  ``gather`` reads
    the colour rows (``kernels.rows.gather_rows`` by default), ``take`` a
    material constant's or the texture scale's row by volume and an
    instance transform's by instance (``table[idx]`` by default), ``fetch``
    a texture tap (``shade.texture``'s seam)."""
    dev = o_w.device
    t = torch.where(hit.hit, t, 0.0)
    n_obj = torch.where(hit.hit[..., None], n_obj,
                        torch.tensor([0.0, 0.0, 1.0], device=dev))
    take = take or _take
    pr = _per_ray_instance(scene, inst, take)
    vol_id = pr["vol"]
    if not mode.lit:
        return SurfaceRecord(albedo=_unlit_albedo(scene, pr, o_w, d_w, t,
                                                  n_obj, hit, mode, gather,
                                                  take, fetch))

    hit_pos = o_w + t[..., None] * d_w
    shadow_origin = hit_pos - d_w * 0.1

    tint = take(scene.tint, vol_id)[..., :3]
    k = take(scene.k, vol_id)

    if mode.textured:
        obj_pos = vq.rotate(vq.conjugate(pr["rot"]),
                            (hit_pos - pr["pos"]) / pr["scale"])
        tscale = take(scene.tex_scale, vol_id)
        albedo = tint * _tex.tri_sample(scene.textures, scene.tex_sizes,
                                        scene.albedo_tex[vol_id], tscale,
                                        obj_pos, n_obj, fetch)
        rm = _tex.tri_sample(scene.textures, scene.tex_sizes,
                             scene.rm_tex[vol_id], tscale, obj_pos, n_obj,
                             fetch)
        roughness = kinks.clip(take(scene.roughness, vol_id) * rm[..., 0],
                               0.0, 1.0)
        metallic = kinks.clip(take(scene.metallic, vol_id) * rm[..., 1],
                              0.0, 1.0)
        n_shade = _tex.tri_sample_normal(scene.textures, scene.tex_sizes,
                                         scene.normal_tex[vol_id], tscale,
                                         obj_pos, n_obj, fetch)
    else:
        albedo = tint
        roughness = kinks.clip(take(scene.roughness, vol_id), 0.0, 1.0)
        metallic = kinks.clip(take(scene.metallic, vol_id), 0.0, 1.0)
        n_shade = n_obj

    if scene.use_voxel_colors:
        albedo = _voxel_color_sample(scene, pr, hit, o_w, d_w, t, gather)

    rec = SurfaceRecord(
        albedo=albedo, shadow_origin=shadow_origin,
        n_w=_object_normal_to_world(pr["rot"], pr["scale"], n_shade),
        roughness=roughness, metallic=metallic, k=k)

    # mirror reflection for roughness < 0.3
    if bounce:
        refl_dir = d_w - 2.0 * torch.sum(d_w * rec.n_w, -1, keepdim=True) \
            * rec.n_w
        rec.refl_dir = _safe_unit(refl_dir)
        rec.gate = hit.hit & (roughness < 0.3)
    if shadows:
        rec.shadow_tmax, rec.shadow_dir, rec.lights = _shadow_rays(
            scene, shadow_origin, hit.hit)
    return rec


def _unlit_albedo(scene: GPUScene, pr, o_w, d_w, t, n_obj, hit: MarchHit,
                  mode: RenderMode, gather, take, fetch):
    """Unlit closest hit: tinted albedo only (the per-voxel colour
    sample where the scene has one)."""
    if scene.use_voxel_colors:
        return _voxel_color_sample(scene, pr, hit, o_w, d_w, t, gather)
    vol_id = pr["vol"]
    tint = take(scene.tint, vol_id)[..., :3]
    if mode.textured:
        hit_pos = o_w + t[..., None] * d_w
        obj_pos = vq.rotate(vq.conjugate(pr["rot"]),
                            (hit_pos - pr["pos"]) / pr["scale"])
        return tint * _tex.tri_sample(scene.textures, scene.tex_sizes,
                                      scene.albedo_tex[vol_id],
                                      take(scene.tex_scale, vol_id), obj_pos,
                                      n_obj, fetch)
    return tint.expand(d_w.shape)


def shade_combine_reference(scene: GPUScene, rec: SurfaceRecord, d_w, n_obj,
                            hit_mask, unlit_attr, refl_rgb, blocked,
                            mode: RenderMode, final: bool = False,
                            fetch=None):
    """The second stage of a level's shading, after its traces, in plain
    PyTorch (the plain version of ``shade.cu``'s combine kernel; port of the
    tail of ``vrt.render.renderer._shade_lit``, of the selects of
    ``trace_radiance`` and, with ``final``, of ``tonemap``).  From the
    surface record, the bounce's radiance ``refl_rgb`` [R,3] (None without a
    bounce) and ``blocked``, the level's shadow traces (bool [R] per light,
    the directional one first; None where no shadow is traced): the mirror
    term, the directional, point and spot lights with their shadows, the
    unlit-attribute select and the miss select with the env lookup.
    Returns linear rgb [R,3], or with ``final`` the tonemapped frame
    [R,4] with alpha 1.  ``fetch`` reads the env's taps (``shade.texture``'s
    seam)."""
    miss_rgb = _tex.sample_env(scene.env, d_w, fetch)
    if mode.lit:
        shaded = _lit_radiance(scene, rec, d_w, refl_rgb, blocked)
    else:
        shaded = rec.albedo
    # unlit-attribute lanes show the raw (object-space) attribute normal
    shaded = torch.where(unlit_attr[..., None], n_obj, shaded)
    rgb = torch.where(hit_mask[..., None], shaded, miss_rgb)
    return _tonemapped(rgb) if final else rgb


def _tonemapped(rgb):
    """The frame of the primary rays' radiance: tonemapped [R,4], alpha 1."""
    return torch.cat([tonemap(rgb), torch.ones((rgb.shape[0], 1),
                                               device=rgb.device)], dim=-1)


def _lit_radiance(scene: GPUScene, rec: SurfaceRecord, d_w, refl_rgb,
                  blocked):
    """Closest-hit lit shading from the surface record: mirror term for
    roughness < 0.3, shadowed directional light, point and spot lights."""
    albedo, n_w, k = rec.albedo, rec.n_w, rec.k
    roughness, metallic = rec.roughness, rec.metallic
    shadow_origin = rec.shadow_origin
    diffuse = torch.full(d_w.shape, _brdf.SHADOW_BRIGHTNESS,
                         device=d_w.device)
    wo = -d_w

    if refl_rgb is not None:
        refl_rgb = kinks.maximum(
            refl_rgb * (1.0 - (roughness * 2.2)[..., None]), 0.0)
        add = _brdf.radiance(refl_rgb, rec.refl_dir, wo, n_w, albedo,
                             roughness, metallic, k)
        diffuse = diffuse + torch.where((roughness < 0.3)[..., None], add,
                                        0.0)

    # directional light
    li = scene.dir_light_strength
    dir_add = _brdf.radiance(li.expand(d_w.shape),
                             scene.dir_light_dir.expand(d_w.shape),
                             wo, n_w, albedo, roughness, metallic, k)
    if blocked is not None:
        dir_add = torch.where(blocked[0][..., None], 0.0, dir_add)
    diffuse = diffuse + dir_add

    # point lights, then spot lights — a spot's colour is its own
    lights = [(_point_light, pi, scene.point_color, 0.005)
              for pi in range(scene.num_point)]
    lights += [(_spot_light, si, scene.spot_color, 0.01)
               for si in range(scene.num_spot)]
    for j, (light, i, colors, floor) in enumerate(lights):
        # the surface stage's own, where it made the level's shadow rays
        sdir, _, inten = rec.lights[j] if rec.lights is not None \
            else light(scene, i, shadow_origin)
        li = colors[i][..., :3] * inten[..., None]
        add = _brdf.radiance(li, sdir, wo, n_w, albedo, roughness, metallic,
                             k)
        lit = inten > floor
        if blocked is not None:
            lit = lit & ~blocked[1 + j]
        diffuse = diffuse + torch.where(lit[..., None], add, 0.0)
    return diffuse


def _lane_lights(scene: GPUScene, lanes: int, leaves: bool = False):
    """``scene`` with each light table read as one row a lane: the sun's
    [lanes, 3] and [lanes, 1], a point or spot light's table [n, lanes,
    ...], each an expanded view that the plain stages read as they read the
    table (with ``leaves``, of the table detached, a leaf that requires a
    gradient).  Returns (that scene, {field: (view, its lane axis)})."""
    views = {}
    for f in LIGHT_FIELDS:
        x = getattr(scene, f)
        x = x.detach() if leaves else x
        if f.startswith("dir_"):
            x, axis = x.reshape(1, -1), 0
        else:
            x, axis = x.unsqueeze(1), 1
        shape = list(x.shape)
        shape[axis] = lanes
        v = x.expand(shape)
        views[f] = (v.requires_grad_(True) if leaves else v, axis)
    return dataclasses.replace(
        scene, **{f: v for f, (v, _) in views.items()}), views


def _summed(table, reads):
    """A scene table's gradient from its rows' (``reads``: (the gradient of
    the rows, their rows in the table viewed as [rows, ...]) each), summed
    over the lanes in float64: (the f32 sum, the float64 sum of the lanes'
    |terms|), each of the table's shape."""
    acc = None
    for g, idx in reads:
        g = g.double()
        if acc is None:
            row = max(torch.Size(g.shape[1:]).numel(), 1)
            acc = torch.zeros((table.numel() // row,) + g.shape[1:],
                              dtype=torch.float64, device=table.device)
            acc_abs = acc.clone()
        acc.index_add_(0, idx, g)
        acc_abs.index_add_(0, idx, g.abs())
    if acc is None:
        acc = acc_abs = torch.zeros(table.shape, dtype=torch.float64,
                                    device=table.device)
    return (acc.reshape(table.shape).float(),
            acc_abs.reshape(table.shape))


def shade_surface_backward_reference(scene: GPUScene, o_w, d_w, t, n_obj,
                                     hit: MarchHit, inst, mode: RenderMode,
                                     bounce: bool, cotangents,
                                     acc_dtype=torch.float32, g_k=None,
                                     material: bool = False,
                                     textures: bool = False,
                                     instances: bool = False):
    """The vector-Jacobian product of ``shade_surface_reference`` in the
    rays, ``t``, ``n_obj`` and the colour table: the plain version of the
    surface backward kernel.  ``cotangents`` are those of the record's
    ``RECORD_GRAD_FIELDS`` (albedo, shadow origin, world normal, roughness,
    metallic, mirror direction), each None for zero.  Returns (g_o_w, g_d_w
    f32 [R,3], g_t f32 [R], g_n_obj f32 [R,3], g_colors in ``acc_dtype``:
    [V*C^3, 24] of the packed view or [V*N^3, 3] of the voxel grid, the
    table ``gpuscene.color_table`` names, or None without per-voxel
    colours; the caller casts it once to the table's dtype).  With
    ``material`` (the plain version of the kernel's material variant),
    ``g_k`` [R] (None for zero) being the cotangent of the record's ``k``,
    five more follow: the cotangents of the material constants
    (``MATERIAL_FIELDS``: tint [V,4], roughness, metallic, k [V], f32, each
    summed over the lanes in float64), then a tuple of the four tables'
    sums of their lanes' |terms| (float64: the scale that rounding moves an
    entry's sum by, where its terms may cancel).  With ``textures`` (the
    plain version of the kernel's texture variant) three more follow: the
    cotangents of ``tex_scale`` [V,2] and of the stacked ``textures``
    [T,TH,TW,3] (f32, summed in float64; the padding of the stack exactly
    zero), then a tuple of the two tables' sums of |terms|.  With
    ``instances`` (the plain version of the kernel's instance variant)
    four more follow: the cotangents of the instance transforms
    (``INSTANCE_FIELDS``: pos [I,3], rot [I,4], scale [I,3], f32, summed in
    float64), then a tuple of the three tables' sums of |terms|.

    The stage is computed again under ``torch.enable_grad()`` on leaves of
    the inputs and differentiated by ``torch.autograd.grad``; the colour
    rows are gathered by plain indexing as leaves of their own, and their
    gradient is added into the table by ``scatter_rows_reference``; with
    ``material`` each material read (``take``) is a leaf of the lanes' rows
    too, with ``textures`` each read of the texture scale and each texture
    tap (``fetch``: 12 a triplanar sample), with ``instances`` each read of
    an instance transform (``take``: one row a lane of each).  A miss lane's record is read
    by no one (the combine stage selects the env there, the traces the
    level spawns march it with t_max = -inf), so its cotangents are taken
    as zero, as the kernel takes them."""
    hit_mask = hit.hit
    leaves = [x.detach().requires_grad_(True) for x in (o_w, d_w, t, n_obj)]
    tables = (MATERIAL_FIELDS if material else ()) \
        + (("tex_scale",) if textures else ()) \
        + (INSTANCE_FIELDS if instances else ())
    taken, reads, taps = [], {f: [] for f in tables}, []
    names = {id(getattr(scene, f)): f
             for f in MATERIAL_FIELDS + ("tex_scale",) + INSTANCE_FIELDS}

    def gather(table, idx, ch):
        rows = gather_rows_reference(table.detach(), idx, ch)
        taken.append((rows.requires_grad_(True), idx, table.shape))
        return rows

    def take(table, idx):
        rows = table.detach()[idx]
        if names[id(table)] in reads:
            reads[names[id(table)]].append((rows.requires_grad_(True), idx))
        return rows

    def fetch(table, *index):
        rows = table.detach()[index]
        if textures:
            taps.append((rows.requires_grad_(True),
                         _tex.flat_index(index, table.shape)))
        return rows

    with torch.enable_grad():
        rec = shade_surface_reference(scene, *leaves, hit, inst, mode, bounce,
                                      False, gather=gather, take=take,
                                      fetch=fetch)
    outs, cots = [], []
    for name, g in zip(RECORD_GRAD_FIELDS + ("k",), (*cotangents, g_k)):
        x = getattr(rec, name)
        if g is not None and x is not None and x.requires_grad:
            keep = hit_mask.reshape(hit_mask.shape + (1,) * (g.ndim - 1))
            outs.append(x)
            cots.append(torch.where(keep, g, 0.0))
    rows = [r for r, _, _ in taken]
    lanes = [r for f in tables for r, _ in reads[f]] + [r for r, _ in taps]
    inputs = leaves + rows + lanes
    grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True) \
        if outs else [None] * len(inputs)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    g_colors = None
    if taken:
        _, idx, (n_rows, ch) = taken[0]
        g_colors = scatter_rows_reference(grads[4], idx, n_rows, ch,
                                          acc_dtype)
    out = (*grads[:4], g_colors)
    g_lanes = iter(grads[4 + len(rows):])
    summed = {f: _summed(getattr(scene, f),
                         [(next(g_lanes), idx) for _, idx in reads[f]])
              for f in tables}
    if material:
        out += tuple(summed[f][0] for f in MATERIAL_FIELDS) \
            + (tuple(summed[f][1] for f in MATERIAL_FIELDS),)
    if textures:
        tex = _summed(scene.textures, [(next(g_lanes), idx)
                                       for _, idx in taps])
        out += (summed["tex_scale"][0], tex[0],
                (summed["tex_scale"][1], tex[1]))
    if instances:
        out += tuple(summed[f][0] for f in INSTANCE_FIELDS) \
            + (tuple(summed[f][1] for f in INSTANCE_FIELDS),)
    return out


def shade_combine_backward_reference(scene: GPUScene, rec: SurfaceRecord,
                                     d_w, n_obj, hit_mask, unlit_attr,
                                     refl_rgb, blocked, mode: RenderMode,
                                     g_rgb, lights: bool = False,
                                     env: bool = False):
    """The vector-Jacobian product of ``shade_combine_reference`` (linear
    rgb, without ``final``) for the cotangent ``g_rgb`` [R,3]: the plain
    version of the combine backward kernel.  Returns the cotangents of the
    record's ``RECORD_GRAD_FIELDS``, then of ``d_w``, ``n_obj`` and
    ``refl_rgb``, f32, each None where that input is None.  With ``lights``
    (the plain version of the kernel's light variant) three more follow: the
    cotangent of the record's ``k`` (f32 [R], None where the record has
    none), a tuple of the cotangents of the light tables (``LIGHT_FIELDS``,
    each of its table's shape, f32, summed over the lanes in float64) and a
    tuple of the light tables' sums of their lanes' |terms| (float64: the
    scale that rounding moves an entry's sum by).  With ``env`` (the plain
    version of the kernel's env variant) two more follow: the cotangent of
    the env cube [6,E,E,3] (f32, summed in float64) and its sum of |terms|.

    The stage is computed again under ``torch.enable_grad()`` and
    differentiated by ``torch.autograd.grad``: on the hit lanes, where it
    reads the record (and, with ``lights``, every light table as one leaf
    row a lane: ``_lane_lights``), and on the miss lanes, where it reads the
    direction alone (the env lookup; with ``env`` each of its four taps a
    leaf of the lanes' rows).  A miss lane's record is read by no one and
    may hold anything (the kernel leaves it unwritten): it gets an exact
    zero and never enters the arithmetic, where a zero cotangent times a
    NaN would give NaN.  Each lane is shaded on its own, so the two parts
    are the stage."""
    fields = [getattr(rec, f) for f in RECORD_GRAD_FIELDS]
    inputs = fields + [d_w, n_obj, refl_rgb] + ([rec.k] if lights else [])
    hits = hit_mask.nonzero().squeeze(-1)
    misses = (~hit_mask).nonzero().squeeze(-1)
    lit_scene, views = _lane_lights(scene, hits.shape[0], True) if lights \
        else (scene, {})
    taps = []

    def leaf(x, lanes):
        return None if x is None else \
            x.detach()[lanes].requires_grad_(True)

    def fetch(table, *index):
        rows = table.detach()[index].requires_grad_(True)
        taps.append((rows, _tex.flat_index(index, table.shape)))
        return rows

    sub = [leaf(x, hits) for x in inputs]
    sub_rec = SurfaceRecord(
        **dict(zip(RECORD_GRAD_FIELDS, sub[:len(fields)])),
        k=sub[-1] if lights else None if rec.k is None else rec.k[hits])
    d_miss = leaf(d_w, misses)
    with torch.enable_grad():
        shaded = shade_combine_reference(
            lit_scene, sub_rec, sub[len(fields)], sub[len(fields) + 1],
            torch.ones_like(hits, dtype=torch.bool), unlit_attr[hits],
            sub[len(fields) + 2],
            None if blocked is None else [b[hits] for b in blocked], mode)
        miss_rgb = _tex.sample_env(scene.env, d_miss,
                                   fetch if env else None)
    want = [x for x in sub if x is not None and x.requires_grad]
    lanes = [v for v, _ in views.values()]
    got = iter(torch.autograd.grad(shaded, want + lanes, g_rgb[hits],
                                   allow_unused=True))
    g_miss, *g_taps = torch.autograd.grad(
        miss_rgb, [d_miss] + [r for r, _ in taps], g_rgb[misses],
        allow_unused=True)
    out = []
    for x in inputs:
        if x is None:
            out.append(None)
            continue
        g = torch.zeros_like(x)
        sub_g = next(got)
        if sub_g is not None:
            g[hits] = sub_g
        out.append(g)
    if g_miss is not None:
        out[len(fields)][misses] = g_miss
    out = tuple(out)
    if lights:
        sums, terms = [], []
        for f, (v, axis) in views.items():
            g = next(got)
            g = torch.zeros(v.shape, dtype=torch.float64, device=v.device) \
                if g is None else g.double()
            shape = getattr(scene, f).shape
            sums.append(g.sum(dim=axis).reshape(shape).float())
            terms.append(g.abs().sum(dim=axis).reshape(shape))
        out += (tuple(sums), tuple(terms))
    if env:
        out += _summed(scene.env, [
            (torch.zeros_like(r) if g is None else g, idx)
            for (r, idx), g in zip(taps, g_taps)])
    return out


def _needs_autograd(*tensors) -> bool:
    """Whether a graph is being recorded through any of ``tensors``."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


# the scene's tensors that a level's shading reads and a fit may optimize,
# whose gradient the shade Functions' backward kernels return, as they
# return that of the rays, t and n_obj (and so of the corner table behind t
# and n_obj): the colour tables (the packed view where the scene has one,
# else the voxel grid: ``gpuscene.color_table``), the material constants,
# the lights, the texture scale, the textures, the env and the instance
# transforms (the kernels' material, light, texture, env and instance
# variants).
_KERNEL_GRAD_FIELDS = ("voxel_colors", "voxel_color_corners") \
    + MATERIAL_FIELDS + LIGHT_FIELDS + TEXTURE_FIELDS + INSTANCE_FIELDS


def shade_stages(scene: GPUScene, o_w, d_w, t, n_obj):
    """The two stages of a level's shading, (surface, combine), picked on
    the inputs alone, between two pairs:

    - a graph through the rays, ``t``, ``n_obj``, the corner table, a
      colour table, a material constant, a light table, the texture scale,
      the textures, the env or an instance transform (every fit step of the
      SDF and the colours, of the materials and the lights, of the textures
      and the env, and of the objects' poses): the ``autograd.Function``
      pair of ``kernels.shade`` (``ShadeSurface``, ``ShadeCombine``), whose
      forward and backward are the kernels on CUDA tensors and the plain
      versions on CPU tensors;
    - no graph: the plain versions on CPU tensors, the two kernels of
      ``shade.cu`` on CUDA tensors.

    A build or launch that fails raises; nothing falls back."""
    kind = o_w.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no shading for device {o_w.device}")
    if _needs_autograd(o_w, d_w, t, n_obj, scene.volumes.corners,
                       *(getattr(scene, f) for f in _KERNEL_GRAD_FIELDS)):
        return _shade_surface_function, _shade_combine_function
    if kind == "cpu":
        return shade_surface_reference, shade_combine_reference
    return _shade_surface_kernel, _shade_combine_kernel


def _contiguous_hit(hit: MarchHit) -> MarchHit:
    return dataclasses.replace(hit, hit=hit.hit.contiguous(),
                               cell=hit.cell.contiguous())


def _contiguous_combine_args(refl_rgb, blocked):
    if refl_rgb is not None:
        refl_rgb = refl_rgb.contiguous()
    if blocked is not None:
        blocked = [b.contiguous() for b in blocked]
    return refl_rgb, blocked


def _shade_surface_kernel(scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce,
                          shadows):
    from vrt_torch.kernels import shade as k4

    return k4.shade_surface_cuda(scene, o_w.contiguous(), d_w.contiguous(),
                                 t.contiguous(), n_obj.contiguous(),
                                 _contiguous_hit(hit), inst.contiguous(),
                                 mode, bounce, shadows)


def _shade_combine_kernel(scene, rec, d_w, n_obj, hit_mask, unlit_attr,
                          refl_rgb, blocked, mode, final=False):
    from vrt_torch.kernels import shade as k4

    refl_rgb, blocked = _contiguous_combine_args(refl_rgb, blocked)
    return k4.shade_combine_cuda(scene, rec, d_w.contiguous(),
                                 n_obj.contiguous(), hit_mask.contiguous(),
                                 unlit_attr.contiguous(), refl_rgb, blocked,
                                 mode, final)


def _shade_surface_function(scene, o_w, d_w, t, n_obj, hit, inst, mode,
                            bounce, shadows):
    """The surface stage through ``ShadeSurface``, differentiable in the
    rays, ``t``, ``n_obj``, the colour table, the material constants, the
    texture scale, the textures and the instance transforms."""
    from vrt_torch.kernels import shade as k4

    return SurfaceRecord.unpack(k4.ShadeSurface.apply(
        o_w.contiguous(), d_w.contiguous(), t.contiguous(),
        n_obj.contiguous(), color_table(scene),
        *(getattr(scene, f) for f in MATERIAL_FIELDS), scene.tex_scale,
        scene.textures, *(getattr(scene, f) for f in INSTANCE_FIELDS), scene,
        _contiguous_hit(hit), inst.contiguous(), mode, bounce, shadows))


def _shade_combine_function(scene, rec, d_w, n_obj, hit_mask, unlit_attr,
                            refl_rgb, blocked, mode, final=False):
    """The combine stage through ``ShadeCombine``, differentiable in the
    record's floats (``k`` among them), ``d_w``, ``n_obj``, ``refl_rgb``,
    the light tables and the env; with ``final`` the tonemap follows in
    eager PyTorch."""
    from vrt_torch.kernels import shade as k4

    refl_rgb, blocked = _contiguous_combine_args(refl_rgb, blocked)
    rgb = k4.ShadeCombine.apply(
        *(getattr(rec, f) for f in RECORD_GRAD_FIELDS), d_w.contiguous(),
        n_obj.contiguous(), refl_rgb, rec.k,
        *(getattr(scene, f) for f in LIGHT_FIELDS), scene.env, scene,
        hit_mask.contiguous(), unlit_attr.contiguous(), blocked, mode)
    return _tonemapped(rgb) if final else rgb


def _trace_level(scene: GPUScene, o_w, d_w, depth: int, mode: RenderMode,
                 active, tracer: SceneTracer, final: bool):
    """One radiance level: march, resolve, the surface stage, the traces it
    spawns (the level's shadow rays and, inline, the mirror bounce's level),
    the combine stage.  ``final`` asks the combine stage for the tonemapped
    [R,4] frame instead of linear rgb [R,3]."""
    r = o_w.shape[0]
    dev = o_w.device
    if depth >= MAX_RAY_RECURSION_DEPTH:
        return torch.zeros((r, 3), device=dev)

    t_max = torch.full((r,), RADIANCE_TMAX, device=dev)
    if active is not None:
        t_max = torch.where(active, t_max, -_INF)
    hit, inst = tracer.march(scene, o_w, d_w, t_max, mode.interp,
                             debug_overlay=mode.debug_overlay)
    t, n_obj, unlit_attr = tracer.resolve(scene, o_w, d_w, hit, inst)

    surface, combine = shade_stages(scene, o_w, d_w, t, n_obj)
    deeper = depth + 1 < MAX_RAY_RECURSION_DEPTH
    # the bounce is skipped when no material can reflect (the traced
    # contribution would be identically zero)
    bounce = mode.lit and scene.any_reflective and deeper
    rec = surface(scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce,
                  mode.lit and deeper)

    blocked = refl_rgb = None
    if rec.shadow_tmax is not None:
        dirs = (scene.dir_light_dir.expand(d_w.shape),) + rec.shadow_dir
        blocked = [trace_shadow(scene, rec.shadow_origin, sdir, dist,
                                depth + 1, mode.interp, tracer=tracer)
                   for sdir, dist in zip(dirs, rec.shadow_tmax)]
    if bounce:
        refl_rgb = _trace_level(scene, rec.shadow_origin, rec.refl_dir,
                                depth + 1, mode, rec.gate, tracer, False)
    return combine(scene, rec, d_w, n_obj, hit.hit, unlit_attr, refl_rgb,
                   blocked, mode, final)


def trace_radiance(scene: GPUScene, o_w, d_w, depth: int, mode: RenderMode,
                   active=None, tracer: SceneTracer = None):
    """One radiance level; returns linear rgb [R,3].  Recursion is inline
    (cap 3).  ``active`` masks lanes whose result the caller discards:
    their t_max is -inf, so they retire at the slab test.  ``tracer``
    (default: the scene march and the fused resolve) does every march and
    resolve of this level and the levels below; the shading between them is
    the stage pair ``shade_stages`` picks."""
    return _trace_level(scene, o_w, d_w, depth, mode, active,
                        tracer or _DEFAULT_TRACER, False)


def tonemap(rgb):
    """Reinhard c/(c+1), gamma 1/2.2, then the UNORM render-target
    conversion (NaN -> 0, clamp to [0,1]); negative radiance gives NaN
    through pow and is flushed to black, as on the reference's target."""
    c = rgb / (rgb + 1.0)
    pos = c > 0
    out = torch.where(pos, torch.pow(torch.where(pos, c, 1.0), 1.0 / 2.2),
                      torch.where(c < 0, float("nan"), 0.0))
    return torch.clamp(torch.nan_to_num(out, nan=0.0, posinf=1.0,
                                        neginf=0.0), 0.0, 1.0)


def render_image(scene: GPUScene, width: int, height: int,
                 mode: RenderMode = RenderMode(),
                 tracer: SceneTracer = None):
    """Full frame: camera rays -> radiance -> tonemap.  [H,W,4] float32,
    the whole frame as one batch of rays, marched and resolved by
    ``tracer`` (default: the scene's own kernels or plain versions); the
    last combine stage tonemaps and writes the alpha channel."""
    from vrt_torch.render.camera import camera_rays

    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov,
                       width, height)
    return render_rays(scene, o, d, mode, tracer).reshape(height, width, 4)


def render_rays(scene: GPUScene, o_w, d_w, mode: RenderMode = RenderMode(),
                tracer: SceneTracer = None):
    """``render_image``'s frame for any batch of world rays: the tonemapped
    [R,4] rows (a sharded frame renders its slice of the camera rays through
    this; each ray's row depends on that ray alone)."""
    return _trace_level(scene, o_w, d_w, 0, mode, None,
                        tracer or _DEFAULT_TRACER, True)
