"""A fit's gradient in the scene's sampled tables: the port's loss gradient
in ``tex_scale``, the stacked ``textures`` and the ``env`` cube
(``gpuscene.TEXTURE_FIELDS``), on the CPU.

- a whole level with its shadow traces and its bounce (``trace_radiance``
  at depth 0) on the two-instance scene of ``tests/test_torch_shade.py``
  (a directional light, 2 point lights and a spot light, checker textures,
  the env cube), lit and textured, unlit and textured, and lit and
  textured with per-voxel colours: every level shades through the
  ``autograd.Function`` pair (``shade_stages`` routes a graph through those
  tables there), and the gradient of a seeded weighting of the radiance in
  each table is held against ``jax.value_and_grad`` of ``vrt``'s
  ``trace_radiance`` on the same numpy inputs, at
  ``tests/test_torch_grad.py``'s f32 gates (``COS_F32``, ``DIFF_F32``);
  under per-voxel colours the albedo texture shades nothing in either
  package;
- the same level through the Function pair against the plain pair under
  autograd;
- the padding of the stacked table gets exactly zero, and a texture one
  texel wide, whose two horizontal taps wrap onto one texel, gets both;
- an env direction on a face seam, where the clamped taps fall on one
  texel, adds both taps (the plain backward against ``jax.grad`` of
  ``vrt``'s ``sample_env``);
- a graph through an instance's position beside the textures shades on
  the Function pair, with its gradient in the tables as without the
  position and the position's as the plain pair's;
- a fit step that also optimizes the textures and the env shades through
  the Function pair and gives the 64x36 fixture's loss and gradients.

On the card the backward kernels' texture and env variants are held
against the plain versions (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_grad import COS_F32, DIFF_F32
from tests.test_torch_host import scene_fields
from tests.test_torch_shade import _fit_through, _vrt_scene
from vrt.render import renderer as vren
from vrt.render.gpuscene import RenderMode as VMode
from vrt.shade import texture as vtex
from vrt_torch.kernels import shade as k4
from vrt_torch.march.types import SurfaceRecord
from vrt_torch.render import renderer as tren
from vrt_torch.render.camera import camera_rays
from vrt_torch.render.gpuscene import (TEXTURE_FIELDS, RenderMode,
                                       scene_from_numpy)

torch.set_num_threads(2)

WIDTH, HEIGHT = 24, 16

# (lit, per-voxel colours)
CASES = {"lit-textured": (True, False), "unlit-textured": (False, False),
         "lit-textured-colours": (True, True)}
PLAIN = (tren.shade_surface_reference, tren.shade_combine_reference)
FUNCTIONS = (tren._shade_surface_function, tren._shade_combine_function)


def _case(name, width=WIDTH, height=HEIGHT, **tables):
    """The case's vrt scene (with ``tables`` replacing its own), the port's
    scene on the CPU from its leaves, the mode, the primary rays of a
    ``width`` x ``height`` frame and the weights of the loss."""
    lit, colors = CASES[name]
    vs = _vrt_scene(points=2, spots=1, colors=colors)
    vs = dataclasses.replace(vs, **{k: jnp.asarray(v)
                                    for k, v in tables.items()})
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, width, height)
    weights = np.random.default_rng(7).normal(
        size=(o.shape[0], 3)).astype(np.float32)
    return vs, ts, RenderMode(lit=lit), o, d, weights


def _port_grads(ts, mode, o, d, weights, pair=None, fields=TEXTURE_FIELDS):
    """The loss and its gradient in every table of ``fields``, the level
    shaded on the pair ``shade_stages`` picks (or on ``pair``); also the
    pairs taken."""
    leaves = {f: getattr(ts, f).detach().clone().requires_grad_(True)
              for f in fields}
    scene = dataclasses.replace(ts, **leaves)
    seen = []
    picked = tren.shade_stages

    def spy(*args):
        seen.append(pair or picked(*args))
        return seen[-1]

    tren.shade_stages = spy
    try:
        rgb = tren.trace_radiance(scene, o, d, 0, mode)
    finally:
        tren.shade_stages = picked
    loss = (rgb * torch.from_numpy(weights)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {f: torch.zeros_like(x) if g is None else g
             for (f, x), g in zip(leaves.items(), grads)}
    return float(loss.detach()), grads, seen


def _vrt_grads(vs, mode, o, d, weights):
    def vloss(tables):
        v2 = dataclasses.replace(vs, **tables)
        return jnp.sum(vren.trace_radiance(
            v2, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 0,
            VMode(lit=mode.lit)) * weights)

    loss, grads = jax.value_and_grad(vloss)(
        {f: getattr(vs, f) for f in TEXTURE_FIELDS})
    return float(loss), {f: np.asarray(g) for f, g in grads.items()}


def _assert_close(got, want, name, diff=DIFF_F32):
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    assert np.isfinite(a).all(), name
    scale = np.abs(b).max()
    if scale == 0.0:
        assert not a.any(), name
        return
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 1.0 - COS_F32, (name, 1.0 - cos)
    assert np.abs(a - b).max() <= diff * scale, (
        name, np.abs(a - b).max() / scale)


def _levels(mode):
    return tren.MAX_RAY_RECURSION_DEPTH if mode.lit else 1


# the texture scales of the sampled-table cases: the shading scene's (a
# warp's lanes on a few texels, the card's shared-path merges) and half a
# unit (every lane of a warp on a footprint of its own)
SCALES = {"37x23": (37.0, 23.0), "0.5x0.5": (0.5, 0.5)}
# At half a unit a texel coordinate (|pos| / 0.5 times 8 texels, less a
# half) reaches 2^10 to 2^11, whose f32 spacing is 2^-12: XLA's fused
# multiply-adds round each tap's weight apart from torch's separate
# products by up to that, and a texel's gradient sums such weights, so
# there the textures are held at 4 * 2^-12 of their largest entry (5.9e-4
# measured); the cosine stays at COS_F32, the other tables at DIFF_F32.
DIFF_FINE_TEXELS = 4 * 2.0 ** -12


@pytest.mark.parametrize("side", [4, 8, 64])
@pytest.mark.parametrize("scale", sorted(SCALES))
def test_plain_sampled_backward_matches_vrt(scale, side):
    """The inputs of the card's checks of the texture and env variants'
    designs, on the CPU: a 23 x 15 frame (345 rays, not a multiple of a
    warp), the texture scale at ``scale`` and a seeded env cube of ``side``
    texels a face (64 past the shared-memory budget: the card's global
    path), unlit and textured (the albedo texture and the env).  The
    port's plain backward (through the Function pair on CPU tensors) in
    ``tex_scale``, the textures and the env against ``jax.value_and_grad``
    of ``vrt``'s ``trace_radiance`` on the same numpy inputs at
    ``tests/test_torch_grad.py``'s f32 gates (``COS_F32``, ``DIFF_F32``;
    the textures at half a unit at ``DIFF_FINE_TEXELS``): the yardstick
    the card holds both designs to is held to ``vrt``."""
    env = np.random.default_rng(side).uniform(
        0.1, 1.0, size=(6, side, side, 3)).astype(np.float32)
    vs, ts, mode, o, d, weights = _case(
        "unlit-textured", width=23, height=15, env=env,
        tex_scale=np.tile(np.float32(SCALES[scale]), (2, 1)))
    assert o.shape[0] % 32 != 0
    assert k4.table_path(ts.env, k4.ENV_SHARED_BYTES) == (
        "global" if side == 64 else "shared")
    loss, got, seen = _port_grads(ts, mode, o, d, weights)
    assert seen == [FUNCTIONS]
    want_loss, want = _vrt_grads(vs, mode, o, d, weights)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for f in TEXTURE_FIELDS:
        fine = f == "textures" and scale == "0.5x0.5"
        _assert_close(got[f].numpy(), want[f], f,
                      DIFF_FINE_TEXELS if fine else DIFF_F32)
        assert bool(got[f].any()), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_texture_and_env_grads_match_vrt(case):
    vs, ts, mode, o, d, weights = _case(case)
    loss, got, seen = _port_grads(ts, mode, o, d, weights)
    assert seen == [FUNCTIONS] * _levels(mode)
    want_loss, want = _vrt_grads(vs, mode, o, d, weights)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for f in TEXTURE_FIELDS:
        _assert_close(got[f].numpy(), want[f], f)
    # every table carries a gradient; under per-voxel colours the albedo
    # texture (0) shades nothing, unlit the normal (1) and rm (2) textures
    for f in TEXTURE_FIELDS:
        assert bool(got[f].any()), f
    used = {"lit-textured": (0, 1, 2), "unlit-textured": (0,),
            "lit-textured-colours": (1, 2)}[case]
    for i in range(3):
        assert bool(got["textures"][i].any()) == (i in used), i
        assert bool(np.asarray(want["textures"][i]).any()) == (i in used), i


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_pair_matches_plain_autograd(case):
    _, ts, mode, o, d, weights = _case(case)
    loss_f, got, seen = _port_grads(ts, mode, o, d, weights)
    loss_p, want, plain = _port_grads(ts, mode, o, d, weights, PLAIN)
    assert seen == [FUNCTIONS] * _levels(mode)
    assert plain == [PLAIN] * _levels(mode)
    assert loss_f == loss_p
    for f in TEXTURE_FIELDS:
        _assert_close(got[f].numpy(), want[f].numpy(), f)


def test_padding_of_the_stack_gets_zero():
    """The same textures stacked into a larger table (rows and columns of
    padding past each texture's size): the padding's gradient is exactly
    zero through the Function pair and the plain pair, and the textures'
    own texels get the unpadded table's gradient."""
    vs, ts, mode, o, d, weights = _case("lit-textured")
    _, want, _ = _port_grads(ts, mode, o, d, weights)
    padded = torch.zeros((3, 11, 13, 3))
    padded[:, :8, :8] = ts.textures
    ts = dataclasses.replace(ts, textures=padded)
    for pair in (None, PLAIN):
        _, got, _ = _port_grads(ts, mode, o, d, weights, pair)
        g = got["textures"]
        assert not bool(g[:, 8:].any()) and not bool(g[:, :, 8:].any())
        _assert_close(g[:, :8, :8].numpy(), want["textures"].numpy(),
                      "textures")
        for f in ("tex_scale", "env"):
            _assert_close(got[f].numpy(), want[f].numpy(), f)


def test_one_texel_wide_texture_adds_both_taps():
    """Textures one texel wide (each texture's first column, sizes 8 x 1):
    a tap and its right neighbour wrap onto one texel, whose gradient is
    the sum of both, as in ``vrt``; the rest of the stack gets zero."""
    sizes = np.asarray([[8, 1]] * 3, np.int32)
    vs, ts, mode, o, d, weights = _case("lit-textured", tex_sizes=sizes)
    loss, got, seen = _port_grads(ts, mode, o, d, weights)
    assert seen == [FUNCTIONS] * _levels(mode)
    want_loss, want = _vrt_grads(vs, mode, o, d, weights)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for f in TEXTURE_FIELDS:
        _assert_close(got[f].numpy(), want[f], f)
    g = got["textures"]
    assert bool(g[:, :, 0].any()) and not bool(g[:, :, 1:].any())


def test_instance_transform_graph_takes_the_plain_pair():
    """A graph through the textures and an instance's position at once:
    every level shades on the Function pair (the surface backward's texture
    and instance variants, on the CPU the plain backward with both), whose
    gradient in the sampled tables is the one without the position, and in
    the position the plain pair's."""
    _, ts, mode, o, d, weights = _case("lit-textured")
    _, want, _ = _port_grads(ts, mode, o, d, weights)
    fields = TEXTURE_FIELDS + ("inst_pos",)
    _, got, seen = _port_grads(ts, mode, o, d, weights, fields=fields)
    _, plain, plain_seen = _port_grads(ts, mode, o, d, weights, PLAIN,
                                       fields=fields)
    assert seen == [FUNCTIONS] * _levels(mode)
    assert plain_seen == [PLAIN] * _levels(mode)
    assert bool(got["inst_pos"].any())
    _assert_close(got["inst_pos"].numpy(), plain["inst_pos"].numpy(),
                  "inst_pos")
    for f in TEXTURE_FIELDS:
        _assert_close(got[f].numpy(), want[f].numpy(), f)


def _seam_directions():
    """Directions on the cube's face seams and corners (a major axis tied
    with another: the face's edge texels, where the clamped taps fall on
    one texel), then seeded ones."""
    seams = [(1.0, 1.0, 0.3), (-1.0, 0.2, 1.0), (0.4, -1.0, -1.0),
             (1.0, 1.0, 1.0), (-1.0, -1.0, 1.0), (0.7, 0.1, -0.7),
             (1.0, -0.5, -1.0), (0.25, 1.0, -1.0)]
    rng = np.random.default_rng(11)
    d = np.concatenate([np.asarray(seams, np.float32),
                        rng.normal(size=(24, 3)).astype(np.float32)])
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_env_seam_adds_the_clamped_taps():
    """Miss lanes whose directions lie on the env cube's seams: the
    combine's plain backward with ``env`` (and the Function pair's
    gradient in the env) against ``jax.grad`` of ``vrt``'s ``sample_env``
    on the same cube, the clamped duplicate taps of a seam adding into one
    texel; the miss lanes' direction gradients too."""
    vs = _vrt_scene(points=2, spots=1)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    d = torch.from_numpy(_seam_directions())
    r = d.shape[0]
    g_rgb = torch.from_numpy(np.random.default_rng(12).normal(
        size=(r, 3)).astype(np.float32))
    env = np.asarray(vs.env)

    def vloss(env, dirs):
        return jnp.sum(vtex.sample_env(env, dirs) * g_rgb.numpy())

    want_env, want_d = jax.grad(vloss, argnums=(0, 1))(
        jnp.asarray(env), jnp.asarray(d.numpy()))
    miss = torch.zeros(r, dtype=torch.bool)
    rec = SurfaceRecord(albedo=torch.zeros(r, 3))
    mode = RenderMode(lit=False)
    got = tren.shade_combine_backward_reference(
        ts, rec, d, torch.zeros(r, 3), miss, miss, None, None, mode, g_rgb,
        env=True)
    g_env, terms = got[-2:]
    _assert_close(g_env.numpy(), want_env, "env")
    _assert_close(got[6].numpy(), want_d, "d_w")
    # the sum of |terms| bounds the f32 sum, to its rounding
    assert bool((terms * (1 + 1e-6) >= g_env.double().abs()).all())
    # the first direction lies on the +X face's seam with +Z: both its
    # horizontal taps clamp onto the face's first column
    assert bool(g_env[0, :, 0].any())
    leaf = ts.env.detach().clone().requires_grad_(True)
    scene = dataclasses.replace(ts, env=leaf)
    rgb = tren._shade_combine_function(scene, rec, d, torch.zeros(r, 3),
                                       miss, miss, None, None, mode)
    (g,) = torch.autograd.grad((rgb * g_rgb).sum(), [leaf])
    _assert_close(g.numpy(), want_env, "env through ShadeCombine")


def test_fit_step_through_textures_and_env_takes_the_function_pair():
    """A fit step that also optimizes the texture scale, the textures and
    the env shades every level through the Function pair (their gradients
    come back from the backward kernels' texture and env variants, on the
    CPU from the plain backward), and its loss and SDF and colour
    gradients are the fixture's."""
    grads = _fit_through(TEXTURE_FIELDS, FUNCTIONS)
    # the flagship's textures are one texel each, so the texture scale
    # moves no sample; the textures shade the hits, the env the misses
    assert not bool(grads["tex_scale"].any())
    assert bool(grads["textures"].any()) and bool(grads["env"].any())


def test_wrappers_name_the_table_path():
    """``table_path``: the shared-memory sums up to the budget's bytes, the
    global atomics past it; the texture and env variants of the shading
    scene's tables, and the padded table the card tests force onto the
    global path."""
    assert k4.table_path(torch.zeros(3, 16, 16, 3),
                         k4.TEXTURE_SHARED_BYTES) == "shared"
    assert k4.table_path(torch.zeros(3, 256, 256, 3),
                         k4.TEXTURE_SHARED_BYTES) == "global"
    assert k4.table_path(torch.zeros(6, 8, 8, 3),
                         k4.ENV_SHARED_BYTES) == "shared"
    assert k4.table_path(torch.zeros(6, 16, 16, 3),
                         k4.ENV_SHARED_BYTES) == "global"
    words = k4.TEXTURE_SHARED_BYTES // 4
    assert k4.table_path(torch.zeros(words), k4.TEXTURE_SHARED_BYTES) \
        == "shared"
    assert k4.table_path(torch.zeros(words + 1),
                         k4.TEXTURE_SHARED_BYTES) == "global"
