"""A fit's gradient in the scene's material constants and lights: the
port's loss gradient in ``tint``, ``roughness``, ``metallic``, ``k`` and the
15 light tables (``gpuscene.MATERIAL_FIELDS``, ``LIGHT_FIELDS``), on the CPU.

- a whole level with its shadow traces and its bounce (``trace_radiance``
  at depth 0) on the two-instance scene of ``tests/test_torch_shade.py``
  (a directional light, 2 point lights and a spot light, checker textures),
  textured and untextured, without and with per-voxel colours: every level
  shades through the ``autograd.Function`` pair (``shade_stages`` routes a
  graph through those tables there), and the gradient of a seeded weighting
  of the radiance in each table is held against ``jax.value_and_grad`` of
  ``vrt``'s ``trace_radiance`` on the same numpy inputs, at
  ``tests/test_torch_grad.py``'s f32 gates (``COS_F32``, ``DIFF_F32``: a
  cosine of at least 1 - 1e-6 and a largest difference of at most 1e-4 *
  max|g|); a table whose gradient is zero in one package is zero in the
  other (the tint under per-voxel colours, the unused light rows);
- the same level through the Function pair against the plain pair under
  autograd: the gradients in every table at the same gates.

On the card the backward kernels' material and light variants are held
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
from tests.test_torch_shade import _vrt_scene
from vrt.render import renderer as vren
from vrt.render.gpuscene import RenderMode as VMode
from vrt_torch.render import renderer as tren
from vrt_torch.render.camera import camera_rays
from vrt_torch.render.gpuscene import (LIGHT_FIELDS, MATERIAL_FIELDS,
                                       RenderMode, scene_from_numpy)

torch.set_num_threads(2)

FIELDS = MATERIAL_FIELDS + LIGHT_FIELDS
WIDTH, HEIGHT = 24, 16

# (textured, per-voxel colours)
CASES = {"textured": (True, False), "untextured": (False, False),
         "textured-colours": (True, True),
         "untextured-colours": (False, True)}
PLAIN = (tren.shade_surface_reference, tren.shade_combine_reference)
FUNCTIONS = (tren._shade_surface_function, tren._shade_combine_function)


def _case(name):
    textured, colors = CASES[name]
    vs = _vrt_scene(points=2, spots=1, colors=colors)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    assert (ts.num_point, ts.num_spot) == (2, 1)
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, WIDTH, HEIGHT)
    weights = np.random.default_rng(5).normal(
        size=(o.shape[0], 3)).astype(np.float32)
    return vs, ts, RenderMode(textured=textured), o, d, weights


def _port_grads(ts, mode, o, d, weights, pair=None):
    """The loss and its gradient in every table of ``FIELDS``, the level
    shaded on the pair ``shade_stages`` picks (or on ``pair``); also the
    pairs taken."""
    leaves = {f: getattr(ts, f).detach().clone().requires_grad_(True)
              for f in FIELDS}
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


def _assert_close(got, want, name):
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    assert np.isfinite(a).all(), name
    scale = np.abs(b).max()
    if scale == 0.0:
        assert not a.any(), name
        return
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 1.0 - COS_F32, (name, 1.0 - cos)
    assert np.abs(a - b).max() <= DIFF_F32 * scale, (
        name, np.abs(a - b).max() / scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_material_and_light_grads_match_vrt(case):
    vs, ts, mode, o, d, weights = _case(case)
    loss, got, seen = _port_grads(ts, mode, o, d, weights)
    assert seen == [FUNCTIONS] * 3

    def vloss(tables):
        v2 = dataclasses.replace(vs, **tables)
        return jnp.sum(vren.trace_radiance(
            v2, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 0,
            VMode(textured=mode.textured)) * weights)

    want_loss, want = jax.value_and_grad(vloss)(
        {f: getattr(vs, f) for f in FIELDS})
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for f in FIELDS:
        _assert_close(got[f].numpy(), np.asarray(want[f]), f)
    colors = CASES[case][1]
    # the tint shades nothing under per-voxel colours; every other material
    # constant and every live light carries a gradient
    assert bool(got["tint"].any()) != colors
    for f in ("roughness", "metallic", "k", "dir_light_dir",
              "dir_light_strength", "point_pos", "point_intensity",
              "point_color", "spot_pos", "spot_fwd", "spot_cos_angle"):
        assert bool(got[f].any()), f
    assert not bool(got["point_pos"][2:].any())
    assert not bool(got["spot_color"][1:].any())


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_pair_matches_plain_autograd(case):
    _, ts, mode, o, d, weights = _case(case)
    loss_f, got, seen = _port_grads(ts, mode, o, d, weights)
    loss_p, want, plain = _port_grads(ts, mode, o, d, weights, PLAIN)
    assert seen == [FUNCTIONS] * 3 and plain == [PLAIN] * 3
    assert loss_f == loss_p
    for f in FIELDS:
        _assert_close(got[f].numpy(), want[f].numpy(), f)
