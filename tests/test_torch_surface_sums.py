"""The algebra of the surface backward's sums epilogue, on the CPU.

The material and instance variants' redesign (``csrc/shade.cu``'s
``surface_bwd_sums_kernel``) stages, for each hit lane, the few values its
table cotangents follow from (``SumWords``): for the instance transform,
the object-space cotangents and the points they were read at where the
stage reads the transform (the world normal: ``n_shade`` and ``n_w``'s
cotangent; the textures' hit point: the object position's cotangent at
``o_w + t d_w``; the colour sample's ray: the object-space origin's and
direction's cotangents at ``o_w`` and ``d_w``); for the material
constants, the albedo's triplanar sample and the rm sample's x and y.  An
epilogue (``sums_epilogue``) forms the material cotangents from them after
the lane's code, and the transform's statistics: over the object-space
places M = sum of a g^T (a = (x_w - pos) / scale at a point, x_w / scale
for the direction) and G = the points' sum of g, at the normal N =
n_shade g_nw^T; the transform's cotangents are bilinear in these, and
``inst_from_stats`` forms them once a block an instance from the block's
sums.  Here the same values are taken from the plain stage
(``shade_surface_reference`` with its triplanar samples, its normal's
``_object_normal_to_world`` and its colour sample's ``_world_to_object``
recorded, differentiated by autograd at those points), the epilogue's
algebra is transcribed in float64 torch, and the results are held

- summed over the lanes by instance and volume, against the plain
  backward ``shade_surface_backward_reference(instances=True,
  material=True)``: each entry within 1e-5 of the sum of its lanes'
  |terms| + 1e-12 (the gate the card holds the kernel to);
- lane by lane (each lane's statistics through ``inst_from_stats``'s
  algebra alone), the transform's cotangents against ``jax.vjp`` of
  ``vrt``'s ``_object_normal_to_world`` and ``_world_to_object`` at the
  same points with the same cotangents, at ``tests/test_torch_grad.py``'s
  f32 gates (a cosine of at least 1 - 1e-6, a largest difference of at most
  1e-4 * max|g|).

On the card ``tests/test_torch_kernels.py`` (``-k sums_designs``) and
``chip_smoke.py`` hold the kernel's epilogue against its first design and
these plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_grad import COS_F32, DIFF_F32
from tests.test_torch_instance_grads import (CASES, TERMS_ATOL, TERMS_RTOL,
                                             _case, _level)
from vrt.render import renderer as vren
from vrt_torch.core import quat as vq
from vrt_torch.march.types import RECORD_GRAD_FIELDS
from vrt_torch.render import renderer as tren
from vrt_torch.render.gpuscene import INSTANCE_FIELDS, MATERIAL_FIELDS

torch.set_num_threads(2)


def _inputs(case, lit):
    """The case's scene and its primary level (rays, hits, resolve), seeded
    cotangents of every record field and of ``k``."""
    vs, ts, mode, *_ = _case(case)
    mode = dataclasses.replace(mode, lit=lit)
    o, d, hit, inst, _, _ = _level(ts, mode)
    t, n_obj, _ = tren.resolve_scene(ts, o, d, hit, inst)
    rng = np.random.default_rng(37)
    r = o.shape[0]

    def cot(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    cots = [cot(r) if f in ("roughness", "metallic") else cot(r, 3)
            for f in RECORD_GRAD_FIELDS] if lit else \
        [cot(r, 3)] + [None] * (len(RECORD_GRAD_FIELDS) - 1)
    g_k = cot(r) if lit else None
    return vs, ts, mode, (o, d, t, n_obj, hit, inst), cots, g_k


def _staged(ts, mode, level, cots, g_k):
    """What the redesign stages of every lane, from the plain stage: the
    points and samples it records and the cotangents autograd gives there
    (None where the mode reads none)."""
    o, d, t, n_obj, hit, inst = level
    seen = {"samples": []}
    tex, to_world, to_object = (tren._tex, tren._object_normal_to_world,
                                tren._world_to_object)

    class Tex:
        # the texture module, its triplanar samples recorded
        def __getattr__(self, name):
            return getattr(tex, name)

        def tri_sample(self, *args, **kw):
            out = tex.tri_sample(*args, **kw)
            seen["obj_pos"] = args[4]
            seen["samples"].append(out.detach())
            return out

        def tri_sample_normal(self, *args, **kw):
            seen["obj_pos"] = args[4]
            return tex.tri_sample_normal(*args, **kw)

    def normal_to_world(rot, scale, n_shade):
        seen["n_shade"] = n_shade.detach()
        seen["n_w"] = to_world(rot, scale, n_shade)
        return seen["n_w"]

    def world_to_object(*args):
        seen["o"], seen["d"] = to_object(*args)
        return seen["o"], seen["d"]

    leaves = [x.detach().requires_grad_(True) for x in (o, d, t, n_obj)]
    tren._tex, tren._object_normal_to_world = Tex(), normal_to_world
    tren._world_to_object = world_to_object
    try:
        with torch.enable_grad():
            rec = tren.shade_surface_reference(ts, *leaves, hit, inst, mode,
                                               bool(ts.any_reflective),
                                               False)
    finally:
        tren._tex, tren._object_normal_to_world = tex, to_world
        tren._world_to_object = to_object
    outs, gs = [], []
    for name, g in zip(RECORD_GRAD_FIELDS + ("k",), (*cots, g_k)):
        x = getattr(rec, name)
        if g is not None and x is not None and x.requires_grad:
            keep = hit.hit.reshape(hit.hit.shape + (1,) * (g.ndim - 1))
            outs.append(x)
            gs.append(torch.where(keep, g, 0.0))
    at = [k for k in ("obj_pos", "n_w", "o", "d") if k in seen]
    grads = dict(zip(at, torch.autograd.grad(outs, [seen[k] for k in at], gs,
                                             allow_unused=True))) if at \
        else {}
    colors = ts.use_voxel_colors
    st = {}
    if mode.lit:
        st["n_shade"], st["g_nw"] = seen["n_shade"], grads["n_w"]
    if mode.textured and (mode.lit or not colors):
        st["g_pos"] = grads["obj_pos"]
    if colors:
        st["g_o"], st["g_d"] = grads["o"], grads["d"]
    if mode.textured and not colors:
        st["albedo_sample"] = seen["samples"][0]
    if mode.textured and mode.lit:
        st["rm"] = seen["samples"][1][:, :2]
    return st


def _pass_clip(x, lo, hi, g):
    """clip's cotangent in x for g, vrt's side of the kinks (``shade.cu``'s
    ``pass_clip``): whole inside, half at a bound, none outside."""
    inside = (x > lo) & (x < hi)
    tie = (x == lo) | (x == hi)
    return torch.where(inside, g, torch.where(tie, 0.5 * g, 0.0))


def _outer(a, g):
    """a g^T a lane, [H,3,3]."""
    return a[:, :, None] * g[:, None, :]


def _rotate_bwd_summed(qv, qw, m):
    """``shade.cu``'s ``rotate_bwd_summed``: ``rotate_bwd``'s quaternion
    cotangent summed over lanes from m = sum of v g^T ([..., 3, 3])."""
    w = torch.stack([m[..., 1, 2] - m[..., 2, 1], m[..., 2, 0] - m[..., 0, 2],
                     m[..., 0, 1] - m[..., 1, 0]], -1)
    tr = m.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True)
    sym = (m + m.transpose(-1, -2)) @ qv[..., None]
    return torch.cat([2.0 * ((sym[..., 0] - 2.0 * tr * qv) + qw * w),
                      2.0 * (qv * w).sum(-1, keepdim=True)], -1)


def _from_stats(rot, scale, m, g, n):
    """``inst_from_stats``: a transform's cotangents [..., 10] (pos, rot,
    scale) from its statistics m, g, n."""
    r = torch.stack([vq.rotate(rot, torch.eye(3, dtype=rot.dtype)[j]
                               .expand(rot.shape[:-1] + (3,)))
                     for j in range(3)], -1)             # r[..., k, j]
    qv, qw = rot[..., :3], rot[..., 3:]
    g_obj = _rotate_bwd_summed(-qv, qw, m)
    g_nrm = _rotate_bwd_summed(qv, qw, n * scale[..., None, :])
    pos = -(r @ g[..., None])[..., 0] / scale
    rot_g = torch.cat([g_nrm[..., :3] - g_obj[..., :3],
                       g_nrm[..., 3:] + g_obj[..., 3:]], -1)
    sc = (r * n.transpose(-1, -2)).sum(-1) - (r * m).sum(-1) / scale
    return torch.cat([pos, rot_g, sc], -1)



def _epilogue(ts, mode, level, st, cots, g_k):
    """``sums_epilogue``'s algebra in float64 on every hit lane: (the lanes'
    instance [H], transform statistics (m [H,3,3], g [H,3], n [H,3,3]),
    volume [H], material cotangents [H,6] (tint 3, roughness, metallic,
    k))."""
    o, d, t, _, hit, inst = level
    f64 = torch.float64
    on = hit.hit
    a = inst.clamp_min(0).long()[on]
    pos, rot, scale = (getattr(ts, f).double()[a] for f in INSTANCE_FIELDS)
    o_w, d_w, tt = o.double()[on], d.double()[on], t.double()[on]
    h = a.shape[0]
    m = torch.zeros((h, 3, 3), dtype=f64)
    g = torch.zeros((h, 3), dtype=f64)
    n = torch.zeros((h, 3, 3), dtype=f64)
    if "g_nw" in st:
        n += _outer(st["n_shade"].double()[on], st["g_nw"].double()[on])
    places = []
    if "g_pos" in st:
        places.append(((o_w + tt[:, None] * d_w - pos) / scale,
                       st["g_pos"], True))
    if "g_o" in st:
        places += [((o_w - pos) / scale, st["g_o"], True),
                   (d_w / scale, st["g_d"], False)]
    for a_x, g_x, point in places:
        m += _outer(a_x, g_x.double()[on])
        if point:
            g += g_x.double()[on]
    vol = ts.inst_volume.long()[a]
    gm = torch.zeros((h, 6), dtype=f64)
    if mode.lit:
        g_rough, g_metal = (c.double()[on] for c in cots[3:5])
        r0, m0 = ts.roughness.double()[vol], ts.metallic.double()[vol]
        if mode.textured:
            rm = st["rm"].double()[on]
            moved = (g_rough != 0) | (g_metal != 0)
            gm[:, 3] = torch.where(moved, _pass_clip(
                r0 * rm[:, 0], 0.0, 1.0, g_rough) * rm[:, 0], 0.0)
            gm[:, 4] = torch.where(moved, _pass_clip(
                m0 * rm[:, 1], 0.0, 1.0, g_metal) * rm[:, 1], 0.0)
        else:
            gm[:, 3] = _pass_clip(r0, 0.0, 1.0, g_rough)
            gm[:, 4] = _pass_clip(m0, 0.0, 1.0, g_metal)
        gm[:, 5] = g_k.double()[on]
    if not ts.use_voxel_colors:
        g_alb = cots[0].double()[on]
        gm[:, :3] = g_alb * st["albedo_sample"].double()[on] \
            if mode.textured else g_alb
    return a, (m, g, n), vol, gm


@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_epilogue_matches_plain_backward(case, lit):
    """The epilogue's transform and material cotangents from the staged
    values, summed over the lanes by instance and volume in float64,
    against ``shade_surface_backward_reference(instances=True,
    material=True)``: each entry within 1e-5 of its lanes' |terms| +
    1e-12; the instances and volumes the frame sees get nonzero sums."""
    _, ts, mode, level, cots, g_k = _inputs(case, lit)
    st = _staged(ts, mode, level, cots, g_k)
    a, stats, vol, gm = _epilogue(ts, mode, level, st, cots, g_k)
    want = tren.shade_surface_backward_reference(
        ts, *level, mode, bool(ts.any_reflective), cots, g_k=g_k,
        material=True, instances=True)
    # the statistics summed by instance, the cotangents formed once each
    sums = [torch.zeros((ts.num_instances,) + x.shape[1:],
                        dtype=torch.float64).index_add_(0, a, x)
            for x in stats]
    seen = torch.zeros(ts.num_instances, dtype=torch.bool)
    seen[a] = True
    inst_sums = torch.where(seen[:, None], _from_stats(
        ts.inst_rot.double(), ts.inst_scale.double(), *sums), 0.0)
    got = torch.split(inst_sums, [3, 4, 3], dim=1)
    for name, g, w, terms in zip(INSTANCE_FIELDS, got, want[10:13],
                                 want[13]):
        err = (g - w.double()).abs()
        assert bool((err <= TERMS_RTOL * terms + TERMS_ATOL).all()), name
        # the stage reads the position at the textures' hit point and the
        # colour sample's ray, the rotation and scale at the normal too
        read = mode.textured or ts.use_voxel_colors or (
            lit and name != "inst_pos")
        assert bool(g[torch.unique(a)].any(dim=-1).all()) == read, name
    mat_sums = torch.zeros((ts.tint.shape[0], 6), dtype=torch.float64)
    mat_sums.index_add_(0, vol, gm)
    tint = torch.cat([mat_sums[:, :3], torch.zeros_like(mat_sums[:, :1])], 1)
    for name, g, w, terms in zip(MATERIAL_FIELDS,
                                 (tint, *mat_sums[:, 3:].unbind(1)),
                                 want[5:9], want[9]):
        err = (g - w.double().reshape(g.shape)).abs()
        bound = TERMS_RTOL * terms.reshape(g.shape) + TERMS_ATOL
        assert bool((err <= bound).all()), name
    # an unlit frame under per-voxel colours reads no material constant
    assert bool(mat_sums.any()) == (lit or not ts.use_voxel_colors)


@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_epilogue_matches_jax_vjp(case, lit):
    """Lane by lane, the epilogue's transform cotangents from the staged
    values against ``jax.vjp`` of ``vrt``'s ``_object_normal_to_world``
    (at ``n_shade``, for ``n_w``'s cotangent) and ``_world_to_object`` (at
    the textures' hit point for the object position's cotangent, at the
    colour sample's ray for its origin's and direction's), in the lanes'
    own transforms."""
    _, ts, mode, level, cots, g_k = _inputs(case, lit)
    st = _staged(ts, mode, level, cots, g_k)
    a, (m, g, n), _, _ = _epilogue(ts, mode, level, st, cots, g_k)
    gi = _from_stats(ts.inst_rot.double()[a], ts.inst_scale.double()[a], m,
                     g, n)
    o, d, t, _, hit, _ = level
    on = hit.hit

    def lanes(x):
        return jnp.asarray(x[on].detach().numpy())

    table = [jnp.asarray(getattr(ts, f).numpy()[a.numpy()])
             for f in INSTANCE_FIELDS]
    zeros = jnp.zeros((int(on.sum()), 3), jnp.float32)

    def transformed(pos, rot, scale):
        outs = []
        if "g_nw" in st:
            outs.append(vren._object_normal_to_world(rot, scale,
                                                     lanes(st["n_shade"])))
        if "g_pos" in st:
            hit_pos = lanes(o + t[:, None] * d)
            outs.append(vren._world_to_object(pos, rot, scale, hit_pos,
                                              zeros)[0])
        if "g_o" in st:
            outs += list(vren._world_to_object(pos, rot, scale, lanes(o),
                                               lanes(d)))
        return tuple(outs)

    if not st.keys() & {"g_nw", "g_pos", "g_o"}:
        # unlit and untextured without colours: the stage reads no
        # transform
        assert not bool(gi.any())
        return
    _, vjp = jax.vjp(transformed, *table)
    g = [lanes(st[k]) for k in ("g_nw", "g_pos", "g_o", "g_d") if k in st]
    want = np.concatenate([np.asarray(x, np.float64)
                           for x in vjp(tuple(g))], axis=1)
    got = gi.numpy()
    top = np.abs(want).max()
    assert top > 0
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= 1.0 - COS_F32, 1.0 - cos
    assert np.abs(got - want).max() <= DIFF_F32 * top, \
        np.abs(got - want).max() / top
