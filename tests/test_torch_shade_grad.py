"""The gradient of a level's shading: the ``autograd.Function`` pair
(``kernels.shade.ShadeSurface`` / ``ShadeCombine``) that a fit step shades
through, on the CPU, where its forward is the plain stages and its backward
their plain versions ``shade_surface_backward_reference`` /
``shade_combine_backward_reference``.

- the Function pair against the plain pair under autograd on one level, per
  case (lit and unlit, textured and untextured, with and without per-voxel
  colours, with and without the bounce, one point and one spot light of
  ``scenes.shading_scene``'s seeded textures, the debug overlay's
  unlit-attribute lanes): the outputs equal, the gradients in the rays,
  ``t``, ``n_obj``, the colour table and the bounce's radiance within
  1e-6 * max|g| and a cosine of 1 - 1e-10 (the same operations, summed in
  another grouping);
- a record whose miss lanes hold NaN gives the same, finite gradients;
- a whole level, and the level with its shadow traces and its bounce,
  against ``jax.grad`` of vrt's ``trace_radiance`` on the same scene (JAX on
  the CPU): the gradients in the rays and the colour table within a cosine
  of 1 - 1e-9 and 1e-4 * max|g| (XLA's CPU backend contracts multiply-adds
  into FMAs, ROADMAP Queue 3);
- the record's packing for the Functions, and the wrappers' refusals.

On the card the backward kernels are held against the same plain versions
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_host import scene_fields
from tests.test_torch_shade import _level_inputs, _vrt_scene
from vrt.render import renderer as vren
from vrt.render.gpuscene import RenderMode as VMode
from vrt_torch.kernels import shade as k4
from vrt_torch.march.types import (RECORD_FIELDS, RECORD_GRAD_FIELDS,
                                   SurfaceRecord)
from vrt_torch.render import renderer as tren
from vrt_torch.render.camera import camera_rays
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
from vrt_torch.scenes import shading_scene

torch.set_num_threads(2)

GRAD_RTOL, COS_TOL = 1e-6, 1e-10
VRT_GRAD_RTOL, VRT_COS_TOL = 1e-4, 1e-9

CASES = {
    "lit-textured-lights": dict(),
    "lit-colours": dict(colors=True),
    "lit-untextured": dict(mode=RenderMode(textured=False)),
    "lit-no-bounce": dict(bounce=False),
    "unlit-textured": dict(mode=RenderMode(lit=False)),
    "unlit-untextured": dict(mode=RenderMode(lit=False, textured=False)),
    "unlit-colours": dict(colors=True, mode=RenderMode(lit=False)),
    "overlay": dict(mode=RenderMode(debug_overlay=True)),
}


def _seeded(rng, shape, on=None):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if on is not None:
        x = torch.where(on.reshape(on.shape + (1,) * (x.ndim - 1)), x, 0.0)
    return x


def _level(case):
    """One level of ``shading_scene`` (one point and one spot light, its
    seeded textures) at 48x32: the scene, mode, bounce flag and inputs,
    seeded weights for the loss, and seeded shadow booleans."""
    spec = dict(CASES[case])
    mode = spec.pop("mode", RenderMode())
    bounce = spec.pop("bounce", True) and mode.lit
    scene = shading_scene(4, 1, 1, device="cpu", **spec)
    o, d, hit, inst, t, n_obj, unlit = _level_inputs(scene, mode)
    rng = np.random.default_rng(7)
    rays = o.shape[0]
    weights = {f: _seeded(rng, (rays,) if f in ("roughness", "metallic")
                          else (rays, 3), on=hit.hit)
               for f in RECORD_GRAD_FIELDS}
    weights["rgb"] = _seeded(rng, (rays, 3))
    blocked = [torch.from_numpy(rng.uniform(size=rays) < 0.3)
               for _ in range(1 + scene.num_point + scene.num_spot)]
    refl = torch.from_numpy(rng.uniform(size=(rays, 3)).astype(np.float32))
    return scene, mode, bounce, (o, d, t, n_obj), hit, inst, unlit, \
        weights, blocked, refl


def _shade(pair, scene, mode, bounce, inputs, hit, inst, unlit, weights,
           blocked, refl, spoil=False):
    """The level through ``pair`` on leaves of its inputs: (rgb, record,
    the loss's gradients in o_w, d_w, t, n_obj, the colour table and the
    bounce's radiance).  The loss weighs the radiance and, on hit lanes, the
    record's floats (what the traces the level spawns hand back).  With
    ``spoil`` the record's miss lanes are set to NaN before the combine
    stage reads it."""
    surface, combine = pair
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    colors = None
    if scene.use_voxel_colors:
        colors = scene.voxel_color_corners.detach().clone().requires_grad_()
        scene = dataclasses.replace(scene, voxel_color_corners=colors)
    refl_leaf = refl.clone().requires_grad_(True) if bounce else None
    rec = surface(scene, *leaves, hit, inst, mode, bounce, mode.lit)
    if spoil:
        with torch.no_grad():
            for f in RECORD_FIELDS[:-1]:
                x = getattr(rec, f)
                if x is not None:
                    x[~hit.hit] = float("nan")
    rgb = combine(scene, rec, leaves[1], leaves[3], hit.hit, unlit,
                  refl_leaf, blocked if mode.lit else None, mode)
    loss = (rgb * weights["rgb"]).sum()
    for f in RECORD_GRAD_FIELDS:
        x = getattr(rec, f)
        if x is not None and x.requires_grad:
            loss = loss + (torch.where(
                hit.hit.reshape(hit.hit.shape + (1,) * (x.ndim - 1)), x, 0.0)
                * weights[f]).sum()
    wrt = leaves + [x for x in (colors, refl_leaf) if x is not None]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(wrt, grads)]
    return rgb.detach(), rec, grads


def _assert_grads_close(got, want, rtol, cos_tol, names):
    for name, a, b in zip(names, got, want):
        a, b = a.double().ravel(), b.double().ravel()
        assert bool(torch.isfinite(a).all()), name
        scale = b.abs().max().item()
        if scale == 0.0:
            assert not bool(a.any()), name
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert 1.0 - cos <= cos_tol, (name, 1.0 - cos)
        assert (a - b).abs().max().item() <= rtol * scale, name


PLAIN = (tren.shade_surface_reference, tren.shade_combine_reference)
FUNCTIONS = (tren._shade_surface_function, tren._shade_combine_function)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_pair_matches_plain_autograd(case):
    level = _level(case)
    scene, mode, bounce, _, hit = level[:5]
    unlit = level[6]
    assert 100 < int(hit.hit.sum()) < hit.hit.numel()
    if mode.debug_overlay:
        assert int((unlit & hit.hit).sum()) > 10
    if mode.textured:
        assert tuple(scene.tex_sizes[1].tolist()) == (8, 8)
    rgb_p, rec_p, g_p = _shade(PLAIN, *level)
    rgb_f, rec_f, g_f = _shade(FUNCTIONS, *level)
    assert torch.equal(rgb_f, rgb_p)
    on = hit.hit
    for f in RECORD_GRAD_FIELDS:
        a, b = getattr(rec_f, f), getattr(rec_p, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a[on], b[on].detach()), f
    names = ["o_w", "d_w", "t", "n_obj"] \
        + (["colors"] if scene.use_voxel_colors else []) \
        + (["refl_rgb"] if bounce else [])
    assert len(g_f) == len(names)
    _assert_grads_close(g_f, g_p, GRAD_RTOL, COS_TOL, names)
    # lit, every input carries a gradient; unlit, at least the direction
    # (the env lookup on miss lanes)
    assert all(bool(g.any()) for g in g_f) if mode.lit else bool(g_f[1].any())


@pytest.mark.parametrize("case", ["lit-colours", "unlit-textured"])
def test_miss_lanes_of_the_record_are_never_read(case):
    """The record's miss lanes set to NaN before the combine stage reads
    them: the Function pair's gradients are finite and the same."""
    level = _level(case)
    _, _, clean = _shade(FUNCTIONS, *level)
    _, _, spoilt = _shade(FUNCTIONS, *level, spoil=True)
    for a, b in zip(spoilt, clean):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth", [2, 0], ids=["one-level", "with-traces"])
def test_level_gradient_matches_vrt(depth):
    """``trace_radiance`` at ``depth`` 2 (one level, no trace of its own)
    and 0 (the level with its shadow traces and the bounce's two levels)
    through the Function pair, against ``jax.grad`` of vrt's on the same
    scene: the gradients of a seeded weighting of the radiance in the ray
    origins and directions and in the colour table."""
    vs = _vrt_scene(colors=True)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    assert vs.voxel_color_corners is not None
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, 32, 24)
    weights = np.random.default_rng(0).normal(
        size=(o.shape[0], 3)).astype(np.float32)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (o, d, ts.voxel_color_corners)]
    seen = []
    plain = tren.shade_stages

    def spy(*args):
        seen.append(plain(*args))
        return seen[-1]

    tren.shade_stages = spy
    try:
        scene = dataclasses.replace(ts, voxel_color_corners=leaves[2])
        rgb = tren.trace_radiance(scene, leaves[0], leaves[1], depth,
                                  RenderMode())
        got = torch.autograd.grad((rgb * torch.from_numpy(weights)).sum(),
                                  leaves)
    finally:
        tren.shade_stages = plain
    assert seen == [FUNCTIONS] * (3 - depth)

    def loss(o_, d_, pcc):
        v2 = dataclasses.replace(vs, voxel_color_corners=pcc)
        return jnp.sum(vren.trace_radiance(v2, o_, d_, depth, VMode())
                       * weights)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        vs.voxel_color_corners)
    _assert_grads_close(got, [torch.from_numpy(np.array(w)) for w in want],
                        VRT_GRAD_RTOL, VRT_COS_TOL, ("o_w", "d_w", "colors"))


def test_contention_colour_gradient_matches_vrt():
    """The surface backward's contention case (``CONTENTION_CAMERA``: every
    ray of the frame hits one cell, so every colour-row cotangent falls on
    one row): the 32x32 frame through the Function pair, against
    ``jax.grad`` of vrt's ``trace_radiance`` on the same scene: the
    gradients in the rays and the colour table."""
    import __graft_entry__ as ge
    from tests.test_torch_kernels import contention_scene

    vs = contention_scene(ge._flagship_scene(resolution=4, use_colors=True))
    vs = dataclasses.replace(vs, cam_pos=jnp.asarray(vs.cam_pos),
                             cam_fov=jnp.asarray(vs.cam_fov))
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, 32, 32)
    o = o.contiguous()
    hit, inst = tren.march_scene(ts, o, d, torch.full((o.shape[0],),
                                                      tren.RADIANCE_TMAX))
    assert bool(hit.hit.all())
    assert torch.unique(hit.cell, dim=0).shape[0] == 1
    weights = np.random.default_rng(1).normal(
        size=(o.shape[0], 3)).astype(np.float32)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (o, d, ts.voxel_color_corners)]
    scene = dataclasses.replace(ts, voxel_color_corners=leaves[2])
    rgb = tren.trace_radiance(scene, leaves[0], leaves[1], 0, RenderMode())
    got = torch.autograd.grad((rgb * torch.from_numpy(weights)).sum(), leaves)
    assert int((got[2] != 0).any(-1).any(-1).sum()) <= 2

    def loss(o_, d_, pcc):
        v2 = dataclasses.replace(vs, voxel_color_corners=pcc)
        return jnp.sum(vren.trace_radiance(v2, o_, d_, 0, VMode()) * weights)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        vs.voxel_color_corners)
    _assert_grads_close(got, [torch.from_numpy(np.array(w)) for w in want],
                        VRT_GRAD_RTOL, VRT_COS_TOL, ("o_w", "d_w", "colors"))


def test_record_packs_for_the_functions():
    """``pack`` / ``unpack``: the record's tensors in ``RECORD_FIELDS``
    order, the shadow tuples stacked (rows of one tensor are taken as they
    are), ``lights`` dropped."""
    scene = shading_scene(3, 2, 1, device="cpu")
    mode = RenderMode()
    o, d, hit, inst, t, n_obj, _ = _level_inputs(scene, mode, 12, 8)
    rec = tren.shade_surface_reference(scene, o, d, t, n_obj, hit, inst,
                                       mode, True, True)
    packed = rec.pack()
    assert len(packed) == len(RECORD_FIELDS) + 2
    back = SurfaceRecord.unpack(packed)
    assert back.lights is None and rec.lights is not None
    for f in RECORD_FIELDS:
        assert getattr(back, f) is getattr(rec, f), f
    for f in ("shadow_tmax", "shadow_dir"):
        assert len(getattr(back, f)) == len(getattr(rec, f))
        for a, b in zip(getattr(back, f), getattr(rec, f)):
            assert torch.equal(a, b), f
    again = back.pack()
    assert again[-2] is packed[-2] and again[-1] is packed[-1]
    unlit = SurfaceRecord(albedo=rec.albedo)
    packed = unlit.pack()
    assert packed[0] is rec.albedo and all(x is None for x in packed[1:])
    assert SurfaceRecord.unpack(packed).shadow_tmax is None


def test_functions_and_backward_wrappers_refuse():
    """``ShadeSurface`` takes the scene's own colour table, material
    constants, texture scale, textures and instance transforms and no
    others, ``ShadeCombine``
    the scene's own light tables and env; the backward wrappers refuse CPU
    tensors without launching."""
    scene = shading_scene(3, 1, 1, colors=True, device="cpu")
    mode = RenderMode()
    o, d, hit, inst, t, n_obj, unlit = _level_inputs(scene, mode, 8, 6)
    materials = [scene.tint, scene.roughness, scene.metallic, scene.k,
                 scene.tex_scale, scene.textures, scene.inst_pos,
                 scene.inst_rot, scene.inst_scale]
    with pytest.raises(ValueError, match="colour table"):
        k4.ShadeSurface.apply(o, d, t, n_obj,
                              scene.voxel_color_corners.clone(), *materials,
                              scene, hit, inst, mode, True, True)
    for i, name in ((1, "roughness"), (5, "textures"), (8, "inst_scale")):
        tables = list(materials)
        tables[i] = tables[i].clone()
        with pytest.raises(ValueError, match=name):
            k4.ShadeSurface.apply(o, d, t, n_obj, scene.voxel_color_corners,
                                  *tables, scene, hit, inst, mode, True,
                                  True)
    rec = tren.shade_surface_reference(scene, o, d, t, n_obj, hit, inst,
                                       mode, False, False)
    lights = [getattr(scene, f) for f in k4.LIGHT_FIELDS]
    lights[4] = lights[4].clone()
    with pytest.raises(ValueError, match="point_att_l"):
        k4.ShadeCombine.apply(
            *(getattr(rec, f) for f in RECORD_GRAD_FIELDS), d, n_obj, None,
            rec.k, *lights, scene.env, scene, hit.hit, unlit, None, mode)
    lights[4] = scene.point_att_l
    with pytest.raises(ValueError, match="env"):
        k4.ShadeCombine.apply(
            *(getattr(rec, f) for f in RECORD_GRAD_FIELDS), d, n_obj, None,
            rec.k, *lights, scene.env.clone(), scene, hit.hit, unlit, None,
            mode)
    before = dict(k4.LAUNCHES)
    cots = [None] * len(RECORD_GRAD_FIELDS)
    with pytest.raises(ValueError, match="CUDA"):
        k4.shade_surface_backward_cuda(scene, o, d, t, n_obj, hit, inst, mode,
                                       True, cots)
    rec = tren.shade_surface_reference(scene, o, d, t, n_obj, hit, inst,
                                       mode, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        k4.shade_combine_backward_cuda(scene, rec, d, n_obj, hit.hit, unlit,
                                       None, None, mode, torch.zeros_like(d))
    assert k4.LAUNCHES == before


@pytest.mark.parametrize("flags", [dict(instances=True),
                                   dict(instances=True, material=True)])
def test_instance_variant_refuses_the_first_design(flags):
    """The surface backward's first design has no instance variant: asking
    for one raises before anything is checked, built or launched, whatever
    else is asked (the dispatch never asks: ``ShadeSurface`` launches the
    merged kernel)."""
    scene = shading_scene(3, 1, 1, colors=True, device="cpu")
    mode = RenderMode()
    o, d, hit, inst, t, n_obj, _ = _level_inputs(scene, mode, 8, 6)
    before = (dict(k4.LAUNCHES), dict(k4.VARIANT_LAUNCHES))
    with pytest.raises(ValueError, match="first design has no instance"):
        k4.shade_surface_backward_cuda(
            scene, o, d, t, n_obj, hit, inst, mode, True,
            [None] * len(RECORD_GRAD_FIELDS), _old_design=True, **flags)
    assert (k4.LAUNCHES, k4.VARIANT_LAUNCHES) == before


# The combine backward's redesign moves a warp's [32,3] spans in 16-byte
# words where every one that the launch touches starts on a 16-byte
# boundary (``combine_bwd_vectors``, judged by ``shade_path``), else every
# lane its own words; its first design stays behind ``_old_design``.

COMBINE_SPANS = ("none", "d_w", "g_rgb", "hit", "unlit", "albedo",
                 "shadow_origin", "n_w", "refl_dir", "refl_rgb", "g_albedo",
                 "g_d_w", "g_roughness")


@pytest.mark.parametrize("which", COMBINE_SPANS)
def test_combine_backward_path_follows_alignment(which):
    """``shade_path`` over ``combine_bwd_vectors``: "v4" where the
    direction, the radiance's cotangent, both flags, the record's [R,3]
    floats, the mirror ray and its radiance and every [R,3] cotangent all
    start on a 16-byte boundary; "scalar" where any one does not.  An [R]
    cotangent (roughness) is written lane by lane on either path and does
    not count; the design int follows the path, the first design takes
    neither."""
    from tests.test_torch_kernels import _off_boundary

    rays = 64
    rng = np.random.default_rng(3)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    x = dict(d_w=f32(rays, 3), g_rgb=f32(rays, 3),
             hit=torch.ones(rays, dtype=torch.bool),
             unlit=torch.zeros(rays, dtype=torch.bool), albedo=f32(rays, 3),
             shadow_origin=f32(rays, 3), n_w=f32(rays, 3),
             refl_dir=f32(rays, 3), refl_rgb=f32(rays, 3),
             g_albedo=f32(rays, 3), g_d_w=f32(rays, 3),
             g_roughness=f32(rays))
    if which != "none":
        x[which] = _off_boundary(x[which])
    rec = SurfaceRecord(albedo=x["albedo"], shadow_origin=x["shadow_origin"],
                        n_w=x["n_w"], refl_dir=x["refl_dir"])
    outs = [x["g_albedo"], None, None, x["g_roughness"], None, None,
            x["g_d_w"], None, None]
    got = k4.shade_path(k4.combine_bwd_vectors(
        x["d_w"], x["g_rgb"], x["hit"], x["unlit"], rec, x["refl_rgb"],
        outs))
    want = "v4" if which in ("none", "g_roughness") else "scalar"
    assert got == want
    # without a bounce the mirror ray is not read
    no_bounce = k4.shade_path(k4.combine_bwd_vectors(
        x["d_w"], x["g_rgb"], x["hit"], x["unlit"], rec, None, outs))
    assert no_bounce == ("v4" if which in ("none", "g_roughness", "refl_dir",
                                           "refl_rgb") else "scalar")
    assert k4._design(False, got) == (2 if want == "v4" else 1)
    assert k4._design(True, got) == 0


# (layout, the first tensor off a 16-byte boundary, the path)
SURFACE_PATHS = {
    "voxels": ("voxels f32", False, "voxels"),
    "voxels-off-16": ("voxels f32", True, "voxels"),
    "packed-f32": ("packed f32", False, "v4"),
    "packed-f32-off-16": ("packed f32", True, "scalar"),
    "packed-bf16": ("packed bf16", False, "v4"),
    "packed-bf16-off-16": ("packed bf16", True, "scalar"),
    "no-colours": (None, False, "v4"),
    "no-colours-off-16": (None, True, "scalar")}


@pytest.mark.parametrize("case", sorted(SURFACE_PATHS))
def test_surface_path_follows_the_colour_layout(case):
    """``surface_path``: "voxels" (``surface_voxels_kernel``) on the
    unpacked colour grid, whatever the tensors' alignment; on a packed view
    or without colours the resident kernel's path by ``shade_path``; the
    design int follows the path, and ``_old_design`` takes the first design
    on any path."""
    from tests.test_torch_kernels import _off_boundary

    layout, off16, want = SURFACE_PATHS[case]
    vectors = [torch.zeros(8, 3), None]
    if off16:
        vectors[0] = _off_boundary(vectors[0])
    got = k4.surface_path(layout, vectors)
    assert got == want
    assert k4._design(False, got) == dict(v4=2, scalar=1, voxels=3)[want]
    assert k4._design(True, got) == 0


@pytest.mark.parametrize("old_design", [False, True], ids=["new", "old"])
def test_combine_backward_refuses_cpu_tensors(old_design):
    """Either design of the combine backward takes CUDA tensors only: on
    CPU tensors the wrapper raises and launches nothing."""
    scene = shading_scene(3, 1, 1, device="cpu")
    mode = RenderMode()
    o, d, hit, inst, t, n_obj, unlit = _level_inputs(scene, mode, 8, 6)
    rec = tren.shade_surface_reference(scene, o, d, t, n_obj, hit, inst,
                                       mode, False, False)
    before = (dict(k4.LAUNCHES), dict(k4.PATH_LAUNCHES))
    with pytest.raises(ValueError, match="CUDA"):
        k4.shade_combine_backward_cuda(scene, rec, d, n_obj, hit.hit, unlit,
                                       None, None, mode, torch.zeros_like(d),
                                       _old_design=old_design)
    assert (k4.LAUNCHES, k4.PATH_LAUNCHES) == before


# The combine stage's branches, each the one a lane takes in the kernels
# (combine_bwd_branch in csrc/shade.cu): the plain backward
# ``shade_combine_backward_reference`` against ``jax.vjp`` of the same
# stage written with vrt's own functions (the tail of
# ``vrt.render.renderer._shade_lit`` and the selects of ``trace_radiance``:
# ``vrt.shade.brdf.radiance``, ``vrt.shade.lights``,
# ``vrt.shade.texture.sample_env``), on 64 seeded lanes a case.

COMBINE_BRANCHES = ("miss", "unlit-lanes", "unlit-mode", "mirror-under-0.3",
                    "mirror-at-0.3", "light-at-threshold")


def _vrt_combine(scene, mode, hit, unlit, blocked, k, bounce):
    """vrt's combine stage as a function of the record's floats, the
    direction, the attribute normal and the bounce's radiance."""
    from vrt.render.renderer import _safe_div
    from vrt.shade import brdf as vbrdf
    from vrt.shade import lights as vlights
    from vrt.shade import texture as vtex

    def j(x):
        return jnp.asarray(x.numpy())

    env = j(scene.env)
    hit, unlit, k = j(hit), j(unlit), j(k)
    blocked = [j(b) for b in blocked] if blocked is not None else None

    def stage(albedo, so, n_w, rough, metal, refl_dir, d_w, n_obj, refl_rgb):
        miss_rgb = vtex.sample_env(env, d_w)
        if not mode.lit:
            shaded = albedo
        else:
            diffuse = jnp.full(d_w.shape, vbrdf.SHADOW_BRIGHTNESS)
            wo = -d_w
            if bounce:
                r = jnp.maximum(0.0, refl_rgb
                                * (1.0 - (rough * 2.2)[..., None]))
                add = vbrdf.radiance(r, refl_dir, wo, n_w, albedo, rough,
                                     metal, k)
                diffuse = diffuse + jnp.where((rough < 0.3)[..., None], add,
                                              0.0)
            dir_add = vbrdf.radiance(
                jnp.broadcast_to(j(scene.dir_light_strength), d_w.shape),
                jnp.broadcast_to(j(scene.dir_light_dir), d_w.shape), wo, n_w,
                albedo, rough, metal, k)
            diffuse = diffuse + jnp.where(blocked[0][..., None], 0.0,
                                          dir_add)
            for pi in range(scene.num_point):
                delta = j(scene.point_pos)[pi] - so
                dist = jnp.linalg.norm(delta, axis=-1)
                inten = vlights.point_light_intensity(
                    j(scene.point_intensity)[pi], dist,
                    j(scene.point_att_l)[pi], j(scene.point_att_e)[pi])
                li = j(scene.point_color)[pi][:3] * inten[..., None]
                sdir = _safe_div(delta, dist[..., None])
                add = vbrdf.radiance(li, sdir, wo, n_w, albedo, rough, metal,
                                     k)
                lit = (inten > 0.005) & ~blocked[1 + pi]
                diffuse = diffuse + jnp.where(lit[..., None], add, 0.0)
            for si in range(scene.num_spot):
                delta = j(scene.spot_pos)[si] - so
                dist = jnp.linalg.norm(delta, axis=-1)
                inten = vlights.spot_light_intensity(
                    so, dist, j(scene.spot_pos)[si], j(scene.spot_fwd)[si],
                    j(scene.spot_intensity)[si], j(scene.spot_att_l)[si],
                    j(scene.spot_att_e)[si], j(scene.spot_cos_angle)[si],
                    j(scene.spot_cos_falloff)[si])
                li = j(scene.spot_color)[si][:3] * inten[..., None]
                sdir = _safe_div(delta, dist[..., None])
                add = vbrdf.radiance(li, sdir, wo, n_w, albedo, rough, metal,
                                     k)
                lit = (inten > 0.01) & ~blocked[1 + scene.num_point + si]
                diffuse = diffuse + jnp.where(lit[..., None], add, 0.0)
            shaded = diffuse
        shaded = jnp.where(unlit[..., None], n_obj, shaded)
        return jnp.where(hit[..., None], shaded, miss_rgb)

    return stage


@pytest.mark.parametrize("branch", COMBINE_BRANCHES)
def test_combine_backward_matches_vrt_vjp_on_branches(branch):
    """Each branch a lane of the combine backward takes: miss lanes (the
    env lookup's backward alone), unlit-attribute lanes among lit ones,
    unlit mode, the mirror term at a roughness just under 0.3 (taken) and
    at 0.3 (not taken), and two point lights of intensity exactly at their
    0.005 floor (not lit) and one float step above it (lit): all nine
    cotangents within ``VRT_GRAD_RTOL`` * max|g| and ``VRT_COS_TOL`` of
    ``jax.vjp``."""
    rays = 64
    rng = np.random.default_rng(11)
    points = 2 if branch == "light-at-threshold" else 1
    scene = shading_scene(3, points, 1, device="cpu")
    mode = RenderMode(lit=branch != "unlit-mode")

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    d_w = f32(unit(rays))
    n_w = unit(rays)
    n_w = f32(n_w * -np.sign((n_w * d_w.numpy()).sum(1, keepdims=True)))
    so = f32(scene.point_pos[0].numpy() + rng.uniform(-60, 60, (rays, 3)))
    rough = rng.uniform(0.05, 0.9, rays)
    if branch == "mirror-under-0.3":
        rough[:] = np.nextafter(np.float32(0.3), np.float32(0.0))
    elif branch == "mirror-at-0.3":
        rough[:] = np.float32(0.3)
    if branch == "light-at-threshold":
        floor = np.float32(0.005)
        scene = dataclasses.replace(
            scene, point_att_l=torch.zeros_like(scene.point_att_l),
            point_att_e=torch.zeros_like(scene.point_att_e),
            point_intensity=scene.point_intensity.clone())
        scene.point_intensity[0] = float(floor)
        scene.point_intensity[1] = float(np.nextafter(floor, np.float32(1)))
    hit = torch.from_numpy(rng.uniform(size=rays) < 0.8)
    hit[:4] = True
    if branch == "miss":
        hit[:] = False
    unlit = torch.zeros(rays, dtype=torch.bool)
    if branch == "unlit-lanes":
        unlit = torch.from_numpy(rng.uniform(size=rays) < 0.5) & hit
    bounce = mode.lit and branch != "light-at-threshold"
    blocked = None
    if mode.lit:
        blocked = [torch.from_numpy(rng.uniform(size=rays) < 0.2)
                   for _ in range(1 + scene.num_point + scene.num_spot)]
        if branch == "light-at-threshold":
            for b in blocked[1:1 + points]:
                b[:] = False
    floats = dict(albedo=f32(rng.uniform(0.1, 0.9, (rays, 3))),
                  shadow_origin=so, n_w=n_w, roughness=f32(rough),
                  metallic=f32(rng.uniform(0.0, 1.0, rays)),
                  refl_dir=f32(unit(rays)))
    k = f32(rng.uniform(0.05, 0.5, rays))
    n_obj = f32(unit(rays))
    refl_rgb = f32(rng.uniform(0.0, 1.0, (rays, 3))) if bounce else None
    g_rgb = f32(rng.normal(size=(rays, 3)))
    if mode.lit:
        rec = SurfaceRecord(**floats, k=k)
        if not bounce:
            rec.refl_dir = None
    else:
        rec = SurfaceRecord(albedo=floats["albedo"])
    got = tren.shade_combine_backward_reference(
        scene, rec, d_w, n_obj, hit, unlit, refl_rgb, blocked, mode, g_rgb)

    stage = _vrt_combine(scene, mode, hit, unlit, blocked, k, bounce)
    primals = [jnp.asarray(floats[f].numpy()) for f in RECORD_GRAD_FIELDS] \
        + [jnp.asarray(d_w.numpy()), jnp.asarray(n_obj.numpy()),
           jnp.asarray((refl_rgb if bounce else torch.zeros(rays, 3))
                       .numpy())]
    _, vjp = jax.vjp(stage, *primals)
    want = [torch.from_numpy(np.array(w)) for w in
            vjp(jnp.asarray(g_rgb.numpy()))]
    names = list(RECORD_GRAD_FIELDS) + ["d_w", "n_obj", "refl_rgb"]
    for name, a, b in zip(names, got, want):
        if a is None:
            # an input the stage does not read in this mode
            assert not bool(b.any()), name
            continue
        _assert_grads_close([a], [b], VRT_GRAD_RTOL, VRT_COS_TOL, [name])
    taken = {"miss": "d_w", "unlit-lanes": "n_obj", "unlit-mode": "albedo",
             "mirror-under-0.3": "refl_rgb", "mirror-at-0.3": "n_w",
             "light-at-threshold": "shadow_origin"}[branch]
    assert bool(got[names.index(taken)].any()), taken
    if branch == "mirror-at-0.3":
        assert not bool(got[names.index("refl_rgb")].any())
    if branch == "miss":
        assert all(g is None or not bool(g.any())
                   for n, g in zip(names, got) if n != "d_w")
