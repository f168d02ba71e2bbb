"""A fit's gradient in the instance transforms: the port's loss gradient in
``inst_pos``, ``inst_rot`` and ``inst_scale`` (``gpuscene.INSTANCE_FIELDS``),
on the CPU.

- a whole level with its shadow traces and its bounce (``trace_radiance``
  at depth 0) on the two-instance scene of ``tests/test_torch_shade.py``
  (a directional light, a point and a spot light, checker textures),
  textured, untextured and with per-voxel colours in their corner-packed
  view, and on a three-instance scene whose instances are rotated and
  scaled unevenly, one by a quaternion of norm 1.05: every level resolves
  through ``ResolveScene`` and shades through the ``autograd.Function``
  pair (nothing routes a graph through a transform elsewhere), and the
  gradient of a seeded weighting of the radiance in each transform is held
  against ``jax.value_and_grad`` of ``vrt``'s ``trace_radiance`` on the same
  numpy inputs, at ``tests/test_torch_grad.py``'s f32 gates (``COS_F32``,
  ``DIFF_F32``: a cosine of at least 1 - 1e-6 and a largest difference of
  at most 1e-4 * max|g|); the same level on the plain pair over the plain
  resolve under autograd gives the same gradients at the same gates;
- the closed form ``resolve_scene_backward_reference(instances=True)``
  against ``jax.vjp`` of ``vrt``'s ``resolve_scene`` in the transforms, and
  against autograd of ``resolve_scene_reference``;
- the plain surface backward ``shade_surface_backward_reference(
  instances=True)`` against autograd of ``shade_surface_reference`` in the
  transforms, in every case; each entry within 1e-5 of the sum of its
  lanes' |terms| that each closed form returns (the gate the card holds
  the kernels' instance variants to).

On the card the two backward kernels' instance variants are held against
these plain versions (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_golden_full import _scene_pair
from tests.test_torch_grad import COS_F32, DIFF_F32
from tests.test_torch_host import scene_fields
from tests.test_torch_shade import _vrt_scene
from vrt.core import quat as vq
from vrt.march.types import MarchHit as VHit
from vrt.render import renderer as vren
from vrt.render.gpuscene import RenderMode as VMode
from vrt.render.gpuscene import build_scene as vbuild
from vrt_torch.march.types import RECORD_GRAD_FIELDS, MarchHit
from vrt_torch.render import renderer as tren
from vrt_torch.render.camera import camera_rays
from vrt_torch.render.gpuscene import (INSTANCE_FIELDS, RenderMode,
                                       scene_from_numpy)

torch.set_num_threads(2)

WIDTH, HEIGHT = 24, 16
# the gate of an entry against its lanes' |terms| (chip_smoke.py's
# SCATTER_RTOL and TABLE_ATOL)
TERMS_RTOL, TERMS_ATOL = 1e-5, 1e-12

# (textured, per-voxel colours, the three-instance scene)
CASES = {"textured": (True, False, False), "untextured": (False, False, False),
         "packed-colours": (True, True, False),
         "three-instances": (True, False, True)}
PLAIN = (tren.shade_surface_reference, tren.shade_combine_reference)
FUNCTIONS = (tren._shade_surface_function, tren._shade_combine_function)


def _three_instance_scene():
    """vrt's scene of ``_scene_pair``'s sphere and slab as three instances,
    each rotated and scaled unevenly, the first by a quaternion of norm
    1.05 (``vq.rotate``'s formula then also scales by 1.05^2, in both
    packages alike)."""
    (sphere, slab, _, cam_pos, cam_rot, light_dir, point, spot,
     env) = _scene_pair()
    albedo = np.full((8, 8, 3), 0.8, np.float32)
    albedo[::2, ::2] = 0.4
    rm = np.full((8, 8, 3), (0.9, 0.4, 0.0), np.float32)
    rm[1::2] = (0.6, 0.7, 0.0)
    normal = np.full((8, 8, 3), (0.5, 0.5, 1.0), np.float32)
    normal[::2, :, 0] = 0.6
    q0 = np.asarray(vq.from_euler_degrees(15.0, 25.0, -10.0), np.float32)
    insts = [
        dict(volume=0, position=(40.0, -60.0, 10.0),
             rotation=(q0 * np.float32(1.05)).astype(np.float32),
             scale=(1.1, 0.85, 1.2)),
        dict(volume=1, position=(-60.0, 65.0, 0.0),
             rotation=np.asarray(vq.from_euler_degrees(0.0, 25.0, 12.0),
                                 np.float32), scale=(0.8, 1.15, 0.95)),
        dict(volume=0, position=(-20.0, 40.0, -80.0),
             rotation=np.asarray(vq.from_euler_degrees(-30.0, 0.0, 40.0),
                                 np.float32), scale=(0.6, 0.75, 0.5)),
    ]
    return vbuild(
        [sphere, slab], insts,
        camera=dict(position=cam_pos, rotation=cam_rot, fov=60.0),
        dir_light=dict(direction=light_dir, strength=5.0),
        point_lights=[point], spot_lights=[spot], env=env,
        textures=np.stack([albedo, normal, rm]),
        tex_sizes=np.asarray([[8, 8]] * 3, np.int32),
        texture_ids=[(0, 1, 2), (0, 1, 2)])


_CASES = {}


def _case(name):
    """The case's vrt scene, the port's scene on the CPU from its leaves,
    the mode, the primary rays and the weights of the loss."""
    if name not in _CASES:
        textured, colors, three = CASES[name]
        vs = _three_instance_scene() if three \
            else _vrt_scene(points=1, spots=1, colors=colors)
        ts = scene_from_numpy(scene_fields(vs), device="cpu")
        if colors:
            # the corner-packed view, as vrt packs a small colour field
            assert ts.voxel_color_corners is not None
        o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, WIDTH, HEIGHT)
        weights = np.random.default_rng(13).normal(
            size=(o.shape[0], 3)).astype(np.float32)
        _CASES[name] = (vs, ts, RenderMode(textured=textured), o, d,
                        weights)
    return _CASES[name]


def _port_grads(ts, mode, o, d, weights, plain=False):
    """The loss and its gradient in every transform, the level shaded on
    the pair ``shade_stages`` picks and resolved by ``resolve_scene`` (with
    ``plain``: on the plain pair over ``resolve_scene_reference``); also the
    pairs taken and the resolves' backward nodes."""
    leaves = {f: getattr(ts, f).detach().clone().requires_grad_(True)
              for f in INSTANCE_FIELDS}
    scene = dataclasses.replace(ts, **leaves)
    seen, resolved = [], []
    picked, resolve = tren.shade_stages, tren.resolve_scene

    def spy(*args):
        seen.append(PLAIN if plain else picked(*args))
        return seen[-1]

    def resolve_spy(*args):
        out = (tren.resolve_scene_reference if plain else resolve)(*args)
        resolved.append(type(out[0].grad_fn).__name__)
        return out

    tren.shade_stages, tren.resolve_scene = spy, resolve_spy
    try:
        rgb = tren.trace_radiance(scene, o, d, 0, mode)
    finally:
        tren.shade_stages, tren.resolve_scene = picked, resolve
    loss = (rgb * torch.from_numpy(weights)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads)), seen, resolved


def _assert_close(got, want, name):
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    assert np.isfinite(a).all(), name
    scale = np.abs(b).max()
    assert scale > 0, name
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 1.0 - COS_F32, (name, 1.0 - cos)
    assert np.abs(a - b).max() <= DIFF_F32 * scale, (
        name, np.abs(a - b).max() / scale)


def _assert_within_terms(got, want, terms, name):
    """Each entry of ``got`` within ``TERMS_RTOL`` of its lanes' |terms| of
    ``want`` (the f32 sums of the other route)."""
    err = (got.double() - want.double()).abs()
    bound = TERMS_RTOL * terms.double() + TERMS_ATOL
    assert bool((err <= bound).all()), (name, float((err / bound).max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_instance_grads_match_vrt(case):
    vs, ts, mode, o, d, weights = _case(case)
    loss, got, seen, resolved = _port_grads(ts, mode, o, d, weights)
    levels = tren.MAX_RAY_RECURSION_DEPTH
    assert seen == [FUNCTIONS] * levels
    assert resolved == ["ResolveSceneBackward"] * levels

    def vloss(tables):
        v2 = dataclasses.replace(vs, **tables)
        return jnp.sum(vren.trace_radiance(
            v2, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 0,
            VMode(textured=mode.textured)) * weights)

    want_loss, want = jax.value_and_grad(vloss)(
        {f: getattr(vs, f) for f in INSTANCE_FIELDS})
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for f in INSTANCE_FIELDS:
        _assert_close(got[f].numpy(), np.asarray(want[f]), f)
        # every instance the frame sees moves the loss
        assert bool(got[f].any(dim=-1).all()), f
    # the same level on the plain pair over the plain resolve
    plain_loss, plain, seen, resolved = _port_grads(ts, mode, o, d, weights,
                                                    plain=True)
    assert seen == [PLAIN] * levels
    assert "ResolveSceneBackward" not in resolved
    assert plain_loss == loss
    for f in INSTANCE_FIELDS:
        _assert_close(got[f].numpy(), plain[f].numpy(), f)


def _level(ts, mode):
    """The primary level's rays, march and resolve (no graph), and seeded
    cotangents of the resolve's t and normal."""
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, WIDTH, HEIGHT)
    hit, inst = tren.march_scene(ts, o, d, torch.full((o.shape[0],),
                                                      tren.RADIANCE_TMAX),
                                 mode.interp)
    rng = np.random.default_rng(29)
    g_t = torch.from_numpy(rng.normal(size=o.shape[0]).astype(np.float32))
    g_n = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
    return o, d, hit, inst, g_t, g_n


def test_resolve_closed_form_matches_jax_vjp():
    """The closed form's transform gradients against ``jax.vjp`` of vrt's
    ``resolve_scene`` on the three-instance scene, the same hits and
    cotangents; its ray and table gradients are the closed form's without
    ``instances``."""
    vs, ts, mode, *_ = _case("three-instances")
    o, d, hit, inst, g_t, g_n = _level(ts, mode)
    assert {0, 1, 2} <= set(inst[hit.hit].tolist())
    vh = VHit(**{f.name: jnp.asarray(getattr(hit, f.name).numpy())
                 for f in dataclasses.fields(MarchHit)})

    def f(pos, rot, scale):
        s = dataclasses.replace(vs, inst_pos=pos, inst_rot=rot,
                                inst_scale=scale)
        t, n, _ = vren.resolve_scene(s, jnp.asarray(o.numpy()),
                                     jnp.asarray(d.numpy()), vh,
                                     jnp.asarray(inst.numpy()))
        return t, n

    _, vjp = jax.vjp(f, *(getattr(vs, k) for k in INSTANCE_FIELDS))
    want = vjp((jnp.asarray(g_t.numpy()), jnp.asarray(g_n.numpy())))
    got = tren.resolve_scene_backward_reference(ts, o, d, hit, inst, g_t, g_n,
                                                instances=True)
    plain = tren.resolve_scene_backward_reference(ts, o, d, hit, inst, g_t,
                                                  g_n)
    assert len(got) == 7
    for a, b in zip(got[:3], plain):
        assert torch.equal(a, b)
    for name, a, b, terms in zip(INSTANCE_FIELDS, got[3:6], want, got[6]):
        assert a.dtype == torch.float32 and terms.dtype == torch.float64
        assert a.shape == terms.shape == getattr(ts, name).shape
        _assert_close(a.numpy(), np.asarray(b), name)


@pytest.mark.parametrize("case", ["three-instances", "textured"])
def test_resolve_closed_form_matches_autograd(case):
    """The closed form's transform gradients against autograd of
    ``resolve_scene_reference``, each entry within 1e-5 of its lanes'
    |terms|."""
    _, ts, mode, *_ = _case(case)
    o, d, hit, inst, g_t, g_n = _level(ts, mode)
    inst[::5] = -1                  # lanes without an instance read the 0th
    got = tren.resolve_scene_backward_reference(ts, o, d, hit, inst, g_t, g_n,
                                                instances=True)
    leaves = {f: getattr(ts, f).clone().requires_grad_(True)
              for f in INSTANCE_FIELDS}
    t, n, _ = tren.resolve_scene_reference(dataclasses.replace(ts, **leaves),
                                           o, d, hit, inst)
    want = torch.autograd.grad([t, n], list(leaves.values()), [g_t, g_n])
    for name, a, b, terms in zip(INSTANCE_FIELDS, got[3:6], want, got[6]):
        _assert_within_terms(a, b, terms, name)
        assert bool(a.any()), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_backward_matches_autograd(case):
    """The plain surface backward's transform gradients (its lanes' reads
    of the transforms as leaves, summed in float64) against autograd of
    ``shade_surface_reference`` in the transforms, for seeded cotangents of
    every record field, the primary level with its mirror ray; each entry
    within 1e-5 of its lanes' |terms|.  The rest of its outputs are the
    plain backward's without ``instances``."""
    _, ts, mode, *_ = _case(case)
    o, d, hit, inst, _, _ = _level(ts, mode)
    t, n_obj, _ = tren.resolve_scene(ts, o, d, hit, inst)
    rng = np.random.default_rng(31)

    def cot(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    r = o.shape[0]
    cots = [cot((r,) if f in ("roughness", "metallic") else (r, 3))
            for f in RECORD_GRAD_FIELDS]
    bounce = bool(ts.any_reflective)
    got = tren.shade_surface_backward_reference(
        ts, o, d, t, n_obj, hit, inst, mode, bounce, cots, instances=True)
    plain = tren.shade_surface_backward_reference(
        ts, o, d, t, n_obj, hit, inst, mode, bounce, cots)
    for a, b in zip(got[:5], plain):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    leaves = {f: getattr(ts, f).clone().requires_grad_(True)
              for f in INSTANCE_FIELDS}
    rec = tren.shade_surface_reference(dataclasses.replace(ts, **leaves), o,
                                       d, t, n_obj, hit, inst, mode, bounce,
                                       False)
    outs, gs = [], []
    for f, g in zip(RECORD_GRAD_FIELDS, cots):
        x = getattr(rec, f)
        if x is not None and x.requires_grad:
            keep = hit.hit.reshape(hit.hit.shape + (1,) * (g.ndim - 1))
            outs.append(x)
            gs.append(torch.where(keep, g, 0.0))
    want = torch.autograd.grad(outs, list(leaves.values()), gs,
                               allow_unused=True)
    # the stage reads the position through the textures' hit point and the
    # colour sample alone: an untextured lane without colours, none
    used = {"inst_pos": mode.textured or ts.use_voxel_colors,
            "inst_rot": True, "inst_scale": True}
    for name, a, b, terms in zip(INSTANCE_FIELDS, got[5:8], want, got[8]):
        assert (b is not None) == used[name], name
        _assert_within_terms(a, torch.zeros_like(a) if b is None else b,
                             terms, name)
        assert bool(a.any()) == used[name], name
