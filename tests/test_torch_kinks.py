"""The port's gradients at the kinks of |a|, max, min and clip, against
``jax.grad`` of ``vrt``'s functions on the CPU.

``vrt`` takes d|a|/da as 1 where a >= 0 (at 0 and -0 too) and splits a
cotangent 0.5/0.5 at a tie of ``maximum`` / ``minimum`` / ``clip``; torch's
``abs`` and ``clamp`` family do neither.  The port takes ``vrt``'s side
(``vrt_torch/core/kinks.py`` in the plain stages and closed forms, the same
rules in the kernels' backward passes).  Every input below sits exactly on a
kink, built so, not searched for in random data:

- the ops themselves at 0, -0 and at their bounds;
- the trilinear weights with a coordinate of p exactly 0 or 1, in the
  plain field under autograd and in the closed form's jvp;
- the resolve's backward on lanes whose hit point lies on a face of its
  cell (``on_cell_faces``), closed form and autograd, against ``jax.vjp``
  of ``vrt``'s ``resolve_scene``;
- a level through the Function pair (resolve, colour sample and triplanar
  blend at cell faces and zero normal components) against ``jax.grad`` of
  ``vrt``'s ``trace_radiance``;
- the triplanar blend and ``sample_env`` at zero components;
- the BRDF at n.wo = 0, n.wi = 0, n.h = 0 and 1 - wo.h = 0;
- a spot light at the falloff's bound (q = 1);
- the mirror term's clamp where the bounce's radiance is 0.

Tolerances: where the two compute the same expression in float32, 1e-5 of
the largest |g| (1e-6 for the ops); a whole level, a cosine within 1e-9 of
1 and 1e-4 of the largest |g| (XLA's CPU backend contracts multiply-adds
into FMAs, ROADMAP Queue 3).  The ops' cases, the resolve's and the level's
fail with torch's conventions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_host import scene_fields
from tests.test_torch_kernels import on_cell_faces
from tests.test_torch_resolve import _autograd, _marched, _scenes
from tests.test_torch_shade import _vrt_scene
from vrt.march import isosurface as viso
from vrt.render import renderer as vren
from vrt.render.gpuscene import RenderMode as VMode
from vrt.shade import brdf as vbrdf
from vrt.shade import lights as vlights
from vrt.shade import texture as vtex
from vrt_torch.core import kinks
from vrt_torch.march import isosurface as iso
from vrt_torch.march import resolve as tres
from vrt_torch.march.types import MarchHit
from vrt_torch.render import renderer as tren
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
from vrt_torch.shade import brdf as tbrdf
from vrt_torch.shade import lights as tlights
from vrt_torch.shade import texture as ttex

torch.set_num_threads(2)

VALUES = np.asarray([-2.0, -1.0, -0.0, 0.0, 0.25, 1.0, 3.0], np.float32)


def _torch_grads(fn, arrays, weights):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True)
              for a in arrays]
    out = fn(*leaves)
    g = torch.autograd.grad((out * torch.from_numpy(weights)).sum(), leaves,
                            allow_unused=True)
    return [np.zeros_like(a) if x is None else x.numpy()
            for a, x in zip(arrays, g)]


def _jax_grads(fn, arrays, weights):
    def loss(*xs):
        return jnp.sum(fn(*xs) * weights)
    g = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    return [np.asarray(x) for x in g]


def _hold(got, want, rtol, names):
    scale = max(np.abs(w).max() for w in want)
    assert scale > 0
    for name, a, b in zip(names, got, want):
        assert np.isfinite(a).all(), name
        err = np.abs(np.asarray(a, np.float64) - b).max()
        assert err <= rtol * scale, (name, err, scale)


def _weights(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---- the ops ----------------------------------------------------------------

OPS = {
    "abs": (kinks.abs_, jnp.abs),
    "maximum-0": (lambda x: kinks.maximum(x, 0.0),
                  lambda x: jnp.maximum(x, 0.0)),
    "minimum-1": (lambda x: kinks.minimum(x, 1.0),
                  lambda x: jnp.minimum(x, 1.0)),
    "clip-0-1": (lambda x: kinks.clip(x, 0.0, 1.0),
                 lambda x: jnp.clip(x, 0.0, 1.0)),
    "maximum-0.25": (lambda x: kinks.maximum(x, 0.25),
                     lambda x: jnp.maximum(x, 0.25)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax_at_its_kinks(op):
    """Each op on 0, -0, its bounds and values on either side: the same
    values as torch's own op (-0 equal to 0), the gradient ``jax.grad``'s
    (1 at |0|, one half at a tie)."""
    mine, theirs = OPS[op]
    ones = np.ones_like(VALUES)
    got = _torch_grads(mine, [VALUES], ones)[0]
    want = _jax_grads(theirs, [VALUES], ones)[0]
    np.testing.assert_array_equal(got, want)
    value = mine(torch.from_numpy(VALUES)).numpy()
    np.testing.assert_array_equal(value, np.asarray(theirs(VALUES)))
    assert np.isin(want, [-1.0, 0.0, 0.5, 1.0]).all()
    assert (want == (0.5 if op != "abs" else 1.0))[VALUES == (
        1.0 if op == "minimum-1" else 0.25 if op == "maximum-0.25"
        else 0.0)].all()


def test_dabs_is_the_derivative_abs_takes():
    x = torch.from_numpy(VALUES)
    got = _torch_grads(kinks.abs_, [VALUES], np.ones_like(VALUES))[0]
    np.testing.assert_array_equal(kinks.dabs(x).numpy(), got)
    assert kinks.dabs(x.double()).dtype == torch.float64


# ---- the trilinear weights ----------------------------------------------------

def _face_points(seed=0):
    """Cell-space points with coordinates exactly 0 or 1 (one, two or three
    of them), and corner values."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.95, size=(48, 3)).astype(np.float32)
    for i in range(48):
        axes = rng.permutation(3)[:1 + i % 3]
        p[i, axes] = rng.integers(0, 2, size=axes.size)
    v = rng.normal(size=(48, 8)).astype(np.float32)
    return p, v


def test_trilinear_rows_at_cell_faces():
    """``iso.trilinear_rows`` under autograd in p and the corner values,
    and the closed form's jvp ``_trilinear_rows_dt`` along each axis,
    against ``jax.grad`` / ``jax.jvp`` of ``vrt``'s ``trilinear_rows``."""
    p, v = _face_points()
    w = _weights(48, 1)
    got = _torch_grads(lambda v_, p_: iso.trilinear_rows(v_, p_), [v, p], w)
    want = _jax_grads(lambda v_, p_: viso.trilinear_rows(v_, p_), [v, p], w)
    _hold(got, want, 1e-6, ("v", "p"))
    for k in range(3):
        dp = np.zeros_like(p)
        dp[:, k] = 1.0
        mine = tres._trilinear_rows_dt(torch.from_numpy(v),
                                       torch.from_numpy(p),
                                       torch.from_numpy(dp)).numpy()
        _, theirs = jax.jvp(lambda p_: viso.trilinear_rows(v, p_),
                            (jnp.asarray(p),), (jnp.asarray(dp),))
        np.testing.assert_allclose(mine, np.asarray(theirs), rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(np.asarray(theirs)).max() > 0


# ---- the resolve ------------------------------------------------------------

def test_resolve_on_cell_faces_matches_jax_vjp():
    """The closed form (``resolve_scene_backward_reference``) and autograd
    through ``resolve_scene_reference``, with cotangents on 96 lanes put on
    faces of their cells, against ``jax.vjp`` of ``vrt``'s
    ``resolve_scene`` on the same hits (the overlap crowd of
    tests/test_torch_resolve.py, f32 table): within a cosine of 1e-8 and
    1e-5 of the largest |g|."""
    from vrt.march.types import MarchHit as VHit

    vs, ts = _scenes("octree-f32")
    o, d, hit, inst, g_t, g_n = _marched(ts)
    lanes = torch.arange(5, 5 + 3 * 96, 3)
    on_cell_faces(ts, o, d, hit, inst, lanes, 7)
    keep = torch.zeros(o.shape[0], dtype=torch.bool)
    keep[lanes] = True
    g_t, g_n = g_t * keep, g_n * keep[:, None]
    vh = VHit(**{f.name: jnp.asarray(getattr(hit, f.name).numpy())
                 for f in dataclasses.fields(MarchHit)})

    def f(o_w, d_w, corners):
        s = dataclasses.replace(vs, volumes=dataclasses.replace(
            vs.volumes, corners=corners))
        t, n, _ = vren.resolve_scene(s, o_w, d_w, vh,
                                     jnp.asarray(inst.numpy()))
        return t, n

    _, vjp = jax.vjp(jax.jit(f), jnp.asarray(o.numpy()),
                     jnp.asarray(d.numpy()), vs.volumes.corners)
    want = vjp((jnp.asarray(g_t.numpy()), jnp.asarray(g_n.numpy())))
    closed = tren.resolve_scene_backward_reference(ts, o, d, hit, inst, g_t,
                                                   g_n)
    auto = _autograd(ts, o, d, hit, inst, g_t, g_n)
    for got in (closed, auto):
        for name, a, b in zip(("g_o_w", "g_d_w", "g_corners"), got, want):
            a = a.double().numpy().ravel()
            b = np.asarray(b, np.float64).ravel()
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos >= 1.0 - 1e-8, (name, 1.0 - cos)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    assert np.abs(np.asarray(want[0])[lanes.numpy()]).max() > 0


# ---- a level ----------------------------------------------------------------

def _face_rays(ts):
    """Rays along -x at the sphere (instance 0 of ``_vrt_scene``: not
    rotated, unit scale) whose y and z lie on its cells' faces."""
    h = float(ts.volumes.cell_size[0])
    pos = ts.inst_pos[0].numpy()
    yz = [(a * h, b * h) for a in range(-3, 4) for b in range(-3, 4)
          if (a * a + b * b) * h * h < 40.0 ** 2]
    o = np.asarray([(pos[0] + 300.0, pos[1] + y, pos[2] + z)
                    for y, z in yz], np.float32)
    d = np.tile(np.asarray([-1.0, 0.0, 0.0], np.float32), (len(yz), 1))
    return torch.from_numpy(o), torch.from_numpy(d)


def test_level_on_cell_faces_matches_vrt(depth=2):
    """``trace_radiance`` at depth 2 (one level: the march, the resolve
    and the shading, no trace of its own) through the Function pair on rays
    whose hit points
    lie on faces of their cells (the resolve's weights, the colour sample's
    weights; the central rays' normals have zero components, the triplanar
    blend's kink) against ``jax.grad`` of ``vrt``'s: the gradients in the
    rays and the colour table."""
    from tests.test_torch_shade_grad import (VRT_COS_TOL, VRT_GRAD_RTOL,
                                             _assert_grads_close)

    vs = _vrt_scene(colors=True)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    o, d = _face_rays(ts)
    t_max = torch.full((o.shape[0],), tren.RADIANCE_TMAX)
    hit, inst = tren.march_scene(ts, o, d, t_max)
    assert bool(hit.hit.all()) and bool((inst == 0).all())
    weights = _weights((o.shape[0], 3), 2)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (o, d, ts.voxel_color_corners)]
    scene = dataclasses.replace(ts, voxel_color_corners=leaves[2])
    rgb = tren.trace_radiance(scene, leaves[0], leaves[1], depth,
                              RenderMode())
    got = torch.autograd.grad((rgb * torch.from_numpy(weights)).sum(),
                              leaves)

    def loss(o_, d_, pcc):
        v2 = dataclasses.replace(vs, voxel_color_corners=pcc)
        return jnp.sum(vren.trace_radiance(v2, o_, d_, depth, VMode())
                       * weights)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        vs.voxel_color_corners)
    _assert_grads_close(got, [torch.from_numpy(np.array(w)) for w in want],
                        VRT_GRAD_RTOL, VRT_COS_TOL, ("o_w", "d_w", "colors"))


# ---- texture and env --------------------------------------------------------

def _textures(seed=3):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0.1, 1.0, size=(2, 8, 8, 3)).astype(np.float32)
    return tex, np.asarray([[8, 8], [4, 8]], np.int32)


def _zero_component_normals(rays=24, seed=4):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(rays, 3)).astype(np.float32)
    n[0::3, 0] = 0.0
    n[1::3, 1] = -0.0
    n[2::6, 2] = 0.0
    n[5::6, 1:] = 0.0
    return n


@pytest.mark.parametrize("fn", ["tri_sample", "tri_sample_normal"])
def test_triplanar_blend_at_zero_normal_components(fn):
    """``tri_sample`` / ``tri_sample_normal`` with seeded textures at
    normals with components of exactly 0 and -0: the gradients in the
    position and the normal against ``jax.grad`` of ``vrt``'s."""
    tex, sizes = _textures()
    normal = _zero_component_normals()
    pos = np.random.default_rng(5).uniform(-60, 60, size=normal.shape).astype(
        np.float32)
    ids = (np.arange(normal.shape[0]) % 2).astype(np.int32)
    scale = np.asarray([37.0, 23.0], np.float32)
    w = _weights(normal.shape, 6)
    mine, theirs = getattr(ttex, fn), getattr(vtex, fn)
    got = _torch_grads(lambda p, n: mine(
        torch.from_numpy(tex), torch.from_numpy(sizes), torch.from_numpy(ids),
        torch.from_numpy(scale), p, n), [pos, normal], w)
    want = _jax_grads(lambda p, n: theirs(
        jnp.asarray(tex), jnp.asarray(sizes), jnp.asarray(ids),
        jnp.asarray(scale), p, n), [pos, normal], w)
    _hold(got, want, 1e-5, ("obj_pos", "normal"))


def test_sample_env_at_zero_components():
    """``sample_env`` on directions with zero components (and ties of two
    components' magnitudes): the gradient in the direction against
    ``jax.grad`` of ``vrt``'s."""
    env = np.random.default_rng(8).uniform(0.1, 1.0, size=(6, 4, 4, 3)
                                           ).astype(np.float32)
    d = _zero_component_normals(seed=9)
    d[3] = (0.5, -0.5, 0.25)
    d[4] = (0.0, 0.7, -0.7)
    w = _weights(d.shape, 10)
    got = _torch_grads(lambda x: ttex.sample_env(torch.from_numpy(env), x),
                       [d], w)
    want = _jax_grads(lambda x: vtex.sample_env(jnp.asarray(env), x), [d], w)
    _hold(got, want, 1e-5, ("dir",))


# ---- BRDF, lights and the mirror term --------------------------------------

def _brdf_ties():
    """Lanes at the BRDF's ties, n = +z: n.wo = 0 (grazing view), n.wi = 0
    (grazing light), n.h = 0, 1 - wo.h = 0 (wi = wo), and two off every
    tie."""
    s = np.float32(np.sqrt(0.5))
    wo = np.asarray([[1, 0, 0], [0.6, 0, 0.8], [1, 0, 0], [0, 0.6, 0.8],
                     [0.6, 0, 0.8], [0, s, s]], np.float32)
    wi = np.asarray([[0.6, 0, 0.8], [0, 1, 0], [0, 1, 0], [0, 0.6, 0.8],
                     [0, 0.8, 0.6], [s, 0, s]], np.float32)
    n = np.tile(np.asarray([0, 0, 1], np.float32), (len(wo), 1))
    albedo = np.tile(np.asarray([0.8, 0.5, 0.3], np.float32), (len(wo), 1))
    li = np.full((len(wo), 3), 2.0, np.float32)
    return li, wi, wo, n, albedo


def test_brdf_at_its_ties():
    """``radiance`` (the BRDF times the light times n.wi) at n.wo = 0, n.wi
    = 0, n.h = 0 and 1 - wo.h = 0: the gradients in the light, both
    directions, the normal, the albedo, roughness and metallic against
    ``jax.grad`` of ``vrt``'s."""
    li, wi, wo, n, albedo = _brdf_ties()
    r = np.full(len(wo), 0.45, np.float32)
    m = np.full(len(wo), 0.3, np.float32)
    k = ((r + 1.0) ** 2 / 8.0).astype(np.float32)
    w = _weights(li.shape, 11)
    got = _torch_grads(tbrdf.radiance, [li, wi, wo, n, albedo, r, m, k], w)
    want = _jax_grads(vbrdf.radiance, [li, wi, wo, n, albedo, r, m, k], w)
    _hold(got, want, 1e-5, ("li", "wi", "wo", "n", "albedo", "roughness",
                            "metallic", "k"))
    assert np.abs(want[2][0]).max() > 0          # the grazing view's tie


def test_spot_light_at_the_falloffs_bound():
    """``spot_light_intensity`` where the cone's falloff reaches its bound
    (q = (cos - cos_angle) / (cos_falloff - cos_angle) = 1 exactly: the
    surface point straight below the light, cos = 0.8 = cos_falloff) and
    off it: the gradients in the surface point, the distance, the light's
    direction and its cone against ``jax.grad`` of ``vrt``'s."""
    sp = np.asarray([[0, 0, -5], [0, 0, -5], [1, 2, -5], [0, 0, -5]],
                    np.float32)
    dist = np.asarray([5.0, 5.0, 5.5, 5.0], np.float32)
    lpos = np.zeros((4, 3), np.float32)
    ldir = np.asarray([[0, 0.6, -0.8]] * 4, np.float32)
    inten = np.full(4, 50.0, np.float32)
    att_l = np.full(4, 0.05, np.float32)
    att_e = np.full(4, 0.0005, np.float32)
    cos_a = np.asarray([0.5, 0.6, 0.5, 0.2], np.float32)
    cos_f = np.asarray([0.8, 0.8, 0.95, 0.8], np.float32)
    arrays = [sp, dist, lpos, ldir, inten, att_l, att_e, cos_a, cos_f]
    w = _weights(4, 12)
    got = _torch_grads(tlights.spot_light_intensity, arrays, w)
    want = _jax_grads(vlights.spot_light_intensity, arrays, w)
    _hold(got, want, 1e-5, ("surface_point", "distance", "light_pos",
                            "light_dir", "intensity", "att_linear", "att_exp",
                            "cos_angle", "cos_falloff"))


def test_mirror_term_where_the_bounce_is_black():
    """The combine stage's mirror term, max(refl_rgb * (1 - 2.2 r), 0),
    where the bounce's radiance is exactly 0 (a tie) and elsewhere: the
    gradient in ``refl_rgb`` of the plain stage's ``_lit_radiance`` against
    ``jax.grad`` of ``vrt``'s ``compose_deferred_reflection`` with the
    weight ``vrt``'s BRDF gives the same lanes."""
    from vrt_torch.march.types import SurfaceRecord
    from vrt_torch.scenes import flagship_scene

    li, wi, wo, n, albedo = _brdf_ties()
    rays = len(wo)
    ts = flagship_scene(4, device="cpu")
    rough = np.asarray([0.1, 0.2, 0.1, 0.25, 0.5, 0.1], np.float32)
    metal = np.full(rays, 0.4, np.float32)
    k = ((rough + 1.0) ** 2 / 8.0).astype(np.float32)
    refl = np.random.default_rng(13).uniform(0.2, 1.0, size=(rays, 3)
                                             ).astype(np.float32)
    refl[::2] = 0.0
    refl[1, 1] = -0.0
    w = _weights((rays, 3), 14)
    t = torch.from_numpy
    rec = SurfaceRecord(albedo=t(albedo), shadow_origin=torch.zeros(rays, 3),
                        n_w=t(n), roughness=t(rough), metallic=t(metal),
                        k=t(k), refl_dir=t(wi))
    got = _torch_grads(lambda r: tren._lit_radiance(
        ts, rec, -t(wo), r, [torch.ones(rays, dtype=torch.bool)]), [refl],
        w)[0]
    weight = vbrdf.brdf(wi, wo, n, albedo, rough, metal, k) * np.sum(
        n * wi, -1, keepdims=True)
    aux = dict(gate=jnp.asarray(rough < 0.3), weight=weight,
               scale=jnp.asarray(1.0 - rough * 2.2))
    want = _jax_grads(lambda r: vren.compose_deferred_reflection(
        jnp.zeros((rays, 3)), aux, r), [refl], w)[0]
    _hold([got], [want], 1e-5, ("refl_rgb",))
    assert np.abs(want[0]).max() > 0
