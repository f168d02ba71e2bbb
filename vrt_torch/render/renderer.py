"""The render pipeline — raygen, scene traversal, shading, tonemap (port of
``vrt.render.renderer``, the unchunked inline path).

- the TLAS over per-instance AABBs is a loop over the (<= 20) instances in
  entry-t order: each candidate is marched in its object space with its own
  255-step budget, clamped to the closest hit so far.  On CUDA tensors that
  loop runs inside one kernel launch per trace (K1's scene march); its plain
  version ``march_scene_reference`` runs one pass over all rays per
  candidate,
- hit resolve (t, normal, unlit) is one fused kernel on CUDA tensors when no
  autograd graph is recorded, and plain PyTorch over K3's row gather
  otherwise (``resolve_scene``),
- the recursive ``TraceRay`` tree (recursion cap 3) recurses inline:
  depth-0/1/2 radiance traces with masked reflection lanes and boolean
  shadow traces,
- shading is the reference's closest-hit Cook-Torrance with point and spot
  lights, the env miss lookup, and Reinhard + gamma tonemapping; with
  per-voxel colours the albedo is their trilinear sample at the hit.

The frame is differentiable in the scene's tensors: the march runs under
``torch.no_grad()`` (its hits are piecewise constant in the SDF, as under
``vrt``'s ``stop_gradient``), and autograd records resolve and shading.

Like ``vrt`` it uses the spot light's own colour (the reference's
``g_spotLightsCB[pi]`` indexing bug is not reproduced).
"""

from __future__ import annotations

import torch

from vrt_torch.core import quat as vq
from vrt_torch.kernels.rows import gather_rows
from vrt_torch.march import isosurface as iso
from vrt_torch.march.march import march_lanes, ray_aabb
from vrt_torch.march.resolve import resolve_hits
from vrt_torch.march.types import MarchHit
from vrt_torch.render.gpuscene import GPUScene, RenderMode
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


def _per_ray_instance(scene: GPUScene, inst):
    """Per-ray instance transform + volume data (inst i32 [R])."""
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
    return dict(vol=vol_id, pos=scene.inst_pos[ic], rot=scene.inst_rot[ic],
                scale=scene.inst_scale[ic], n=vols.n[vol_id],
                cell_size=vols.cell_size[vol_id],
                extends=vols.extends[vol_id])


def resolve_scene(scene: GPUScene, o_w, d_w, hit: MarchHit, inst):
    """(t, object-space normal, unlit) for scene hits, read from the
    packed corner table (f32 or bf16).

    Dispatches on the device and on autograd's state.  CUDA tensors with
    no graph to record (grad mode is off, or neither the corner table, nor
    the rays, nor the instance transforms require a gradient) go to the
    fused resolve kernel (``kernels.resolve.resolve_scene_cuda``).  CUDA
    tensors with a graph to record (a fit step) go through
    ``resolve_scene_reference``, whose row gather is K3 with its
    scatter-add backward: the fused kernel has no backward yet.  CPU
    tensors go to ``resolve_scene_reference``, the kernel's plain version.
    A launch that fails raises; nothing falls back."""
    if o_w.device.type == "cuda" and not _records_graph(scene, o_w, d_w):
        from vrt_torch.kernels import resolve as kr

        return kr.resolve_scene_cuda(scene, o_w.contiguous(),
                                     d_w.contiguous(), hit, inst)
    if o_w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no resolve for device {o_w.device}")
    return resolve_scene_reference(scene, o_w, d_w, hit, inst)


def _records_graph(scene: GPUScene, o_w, d_w) -> bool:
    """Whether resolve's result would carry a gradient."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (scene.volumes.corners, o_w, d_w,
                                  scene.inst_pos, scene.inst_rot,
                                  scene.inst_scale))


def resolve_scene_reference(scene: GPUScene, o_w, d_w, hit: MarchHit, inst):
    """``resolve_scene`` in plain PyTorch, differentiable in the corner
    table, the rays and the instance transforms (port of
    ``vrt.render.renderer.resolve_scene``)."""
    pr = _per_ray_instance(scene, inst)
    o, d = _world_to_object(pr["pos"], pr["rot"], pr["scale"], o_w, d_w)
    cfetch = iso.make_stacked_corner_fetch(scene.volumes.corners, pr["n"],
                                           pr["vol"])
    return resolve_hits(cfetch, pr["cell_size"], pr["extends"], o, d, hit)


def _voxel_color_sample(scene: GPUScene, pr, hit: MarchHit, o_w, d_w, t):
    """Trilinear sample of the per-voxel colour field at the hit point,
    from one 24-channel row of the corner-packed colours per hit cell (K3
    on CUDA tensors), with the per-corner valid mask after the gather."""
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
    cn = pcc.shape[1]
    ic = torch.clamp(cell, 0, cn - 1)
    lin = iso._flat_index(pr["vol"], ic, cn).to(torch.int32)
    rows = gather_rows(pcc.reshape(-1, 24), lin, 24).reshape(-1, 8, 3)
    cvals = torch.where(valid[..., None], rows, 0.0)
    w = torch.abs((1.0 - corners.to(torch.float32))[None] - p[:, None, :])
    w = (w[..., 0] * w[..., 1]) * w[..., 2]                    # [R,8]
    return torch.sum(w[..., None] * cvals, dim=1)


def trace_shadow(scene: GPUScene, o_w, d_w, max_dist, depth: int,
                 interp: bool, relevant=None):
    """Boolean occlusion trace in the frame's march mode, without the
    debug overlay: any accepted hit within [0, max_dist] blocks;
    recursion-capped rays return un-blocked.  ``relevant`` masks lanes
    whose result the caller discards (their t_max becomes -inf, so they
    retire at the slab test)."""
    if depth >= MAX_RAY_RECURSION_DEPTH:
        return torch.zeros(o_w.shape[0], dtype=torch.bool, device=o_w.device)
    if relevant is not None:
        max_dist = torch.where(relevant, max_dist, -_INF)
    return march_scene_any_hit(scene, o_w, d_w, max_dist, interp)


def _shade_lit(scene: GPUScene, o_w, d_w, t, n_obj, inst, hit: MarchHit,
               depth: int, mode: RenderMode):
    """Closest-hit lit shading: shadowed directional light, mirror bounce
    for roughness < 0.3 (traced inline), point and spot lights."""
    pr = _per_ray_instance(scene, inst)
    vol_id = pr["vol"]
    dev = o_w.device

    hit_pos = o_w + t[..., None] * d_w
    shadow_origin = hit_pos - d_w * 0.1

    shadow_dir_hit = trace_shadow(
        scene, shadow_origin, scene.dir_light_dir.expand(d_w.shape),
        torch.full(t.shape, DIR_SHADOW_TMAX, device=dev), depth + 1,
        mode.interp, relevant=hit.hit)

    diffuse = torch.full(d_w.shape, _brdf.SHADOW_BRIGHTNESS, device=dev)

    tint = scene.tint[vol_id][..., :3]
    k = scene.k[vol_id]

    if mode.textured:
        obj_pos = vq.rotate(vq.conjugate(pr["rot"]),
                            (hit_pos - pr["pos"]) / pr["scale"])
        tscale = scene.tex_scale[vol_id]
        albedo = tint * _tex.tri_sample(scene.textures, scene.tex_sizes,
                                        scene.albedo_tex[vol_id], tscale,
                                        obj_pos, n_obj)
        rm = _tex.tri_sample(scene.textures, scene.tex_sizes,
                             scene.rm_tex[vol_id], tscale, obj_pos, n_obj)
        roughness = torch.clamp(scene.roughness[vol_id] * rm[..., 0],
                                0.0, 1.0)
        metallic = torch.clamp(scene.metallic[vol_id] * rm[..., 1], 0.0, 1.0)
        n_shade = _tex.tri_sample_normal(scene.textures, scene.tex_sizes,
                                         scene.normal_tex[vol_id], tscale,
                                         obj_pos, n_obj)
    else:
        albedo = tint
        roughness = torch.clamp(scene.roughness[vol_id], 0.0, 1.0)
        metallic = torch.clamp(scene.metallic[vol_id], 0.0, 1.0)
        n_shade = n_obj

    if scene.use_voxel_colors:
        albedo = _voxel_color_sample(scene, pr, hit, o_w, d_w, t)

    n_w = _object_normal_to_world(pr["rot"], pr["scale"], n_shade)
    wo = -d_w

    # mirror reflection for roughness < 0.3; skipped when no material can
    # reflect (the traced contribution would be identically zero)
    if scene.any_reflective and depth + 1 < MAX_RAY_RECURSION_DEPTH:
        refl_dir = d_w - 2.0 * torch.sum(d_w * n_w, -1, keepdim=True) * n_w
        refl_dir = _safe_unit(refl_dir)
        gate = hit.hit & (roughness < 0.3)
        refl_rgb = trace_radiance(scene, shadow_origin, refl_dir, depth + 1,
                                  mode, active=gate)
        refl_rgb = torch.clamp_min(
            refl_rgb * (1.0 - (roughness * 2.2)[..., None]), 0.0)
        add = _brdf.radiance(refl_rgb, refl_dir, wo, n_w, albedo,
                             roughness, metallic, k)
        diffuse = diffuse + torch.where((roughness < 0.3)[..., None], add,
                                        0.0)

    # directional light
    li = scene.dir_light_strength
    dir_add = _brdf.radiance(li.expand(d_w.shape),
                             scene.dir_light_dir.expand(d_w.shape),
                             wo, n_w, albedo, roughness, metallic, k)
    diffuse = diffuse + torch.where(shadow_dir_hit[..., None], 0.0, dir_add)

    # point lights
    for pi in range(scene.num_point):
        delta = scene.point_pos[pi] - shadow_origin
        dist = torch.linalg.vector_norm(delta, dim=-1)
        inten = _lights.point_light_intensity(
            scene.point_intensity[pi], dist,
            scene.point_att_l[pi], scene.point_att_e[pi])
        li = scene.point_color[pi][:3] * inten[..., None]
        sdir = _safe_div(delta, dist[..., None])
        sh = trace_shadow(scene, shadow_origin, sdir, dist, depth + 1,
                          mode.interp, relevant=hit.hit & (inten > 0.005))
        add = _brdf.radiance(li, sdir, wo, n_w, albedo, roughness,
                             metallic, k)
        lit = (inten > 0.005) & ~sh
        diffuse = diffuse + torch.where(lit[..., None], add, 0.0)

    # spot lights — colour indexed by the spot light itself
    for si in range(scene.num_spot):
        delta = scene.spot_pos[si] - shadow_origin
        dist = torch.linalg.vector_norm(delta, dim=-1)
        inten = _lights.spot_light_intensity(
            shadow_origin, dist, scene.spot_pos[si], scene.spot_fwd[si],
            scene.spot_intensity[si], scene.spot_att_l[si],
            scene.spot_att_e[si], scene.spot_cos_angle[si],
            scene.spot_cos_falloff[si])
        li = scene.spot_color[si][:3] * inten[..., None]
        sdir = _safe_div(delta, dist[..., None])
        sh = trace_shadow(scene, shadow_origin, sdir, dist, depth + 1,
                          mode.interp, relevant=hit.hit & (inten > 0.01))
        add = _brdf.radiance(li, sdir, wo, n_w, albedo, roughness,
                             metallic, k)
        lit = (inten > 0.01) & ~sh
        diffuse = diffuse + torch.where(lit[..., None], add, 0.0)

    return diffuse


def _shade_unlit_mode(scene: GPUScene, o_w, d_w, t, n_obj, inst,
                      hit: MarchHit, mode: RenderMode):
    """Unlit closest hit: tinted albedo only (the per-voxel colour
    sample where the scene has one)."""
    pr = _per_ray_instance(scene, inst)
    if scene.use_voxel_colors:
        return _voxel_color_sample(scene, pr, hit, o_w, d_w, t)
    vol_id = pr["vol"]
    tint = scene.tint[vol_id][..., :3]
    if mode.textured:
        hit_pos = o_w + t[..., None] * d_w
        obj_pos = vq.rotate(vq.conjugate(pr["rot"]),
                            (hit_pos - pr["pos"]) / pr["scale"])
        return tint * _tex.tri_sample(scene.textures, scene.tex_sizes,
                                      scene.albedo_tex[vol_id],
                                      scene.tex_scale[vol_id], obj_pos, n_obj)
    return tint.expand(d_w.shape)


def trace_radiance(scene: GPUScene, o_w, d_w, depth: int, mode: RenderMode,
                   active=None):
    """One radiance level; returns linear rgb [R,3].  Recursion is inline
    (cap 3).  ``active`` masks lanes whose result the caller discards:
    their t_max is -inf, so they retire at the slab test."""
    r = o_w.shape[0]
    dev = o_w.device
    if depth >= MAX_RAY_RECURSION_DEPTH:
        return torch.zeros((r, 3), device=dev)

    t_max = torch.full((r,), RADIANCE_TMAX, device=dev)
    if active is not None:
        t_max = torch.where(active, t_max, -_INF)
    hit, inst = march_scene(scene, o_w, d_w, t_max, mode.interp,
                            debug_overlay=mode.debug_overlay)
    t, n_obj, unlit_attr = resolve_scene(scene, o_w, d_w, hit, inst)

    # sanitize miss lanes before shading: their values are discarded by the
    # final select
    t = torch.where(hit.hit, t, 0.0)
    n_obj = torch.where(hit.hit[..., None], n_obj,
                        torch.tensor([0.0, 0.0, 1.0], device=dev))

    miss_rgb = _tex.sample_env(scene.env, d_w)

    if mode.lit:
        shaded = _shade_lit(scene, o_w, d_w, t, n_obj, inst, hit, depth,
                            mode)
    else:
        shaded = _shade_unlit_mode(scene, o_w, d_w, t, n_obj, inst, hit,
                                   mode)

    # unlit-attribute lanes show the raw (object-space) attribute normal
    shaded = torch.where(unlit_attr[..., None], n_obj, shaded)
    return torch.where(hit.hit[..., None], shaded, miss_rgb)


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
                 mode: RenderMode = RenderMode()):
    """Full frame: camera rays -> radiance -> tonemap.  [H,W,4] float32,
    the whole frame as one batch of rays."""
    from vrt_torch.render.camera import camera_rays

    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov,
                       width, height)
    rgb = trace_radiance(scene, o, d, 0, mode)
    img = tonemap(rgb).reshape(height, width, 3)
    return torch.cat([img, torch.ones((height, width, 1), device=img.device)],
                     dim=-1)
