"""Per-voxel colours above ``COLOR_CORNER_BUDGET_BYTES`` and the corner
table's pack, against ``vrt`` on the CPU.

- the budget rule of ``gpuscene.packs_voxel_colors`` against ``vrt``'s
  arithmetic in its ``build_scene`` on the shapes of config4 (257^3 bf16:
  unpacked), config6 (2 x 65^3 f32: packed) and the budget's edge, without
  building a scene;
- with the budget at 0 in both packages (each package's constant patched
  in the test), config4 at resolution 4: the scenes equal leaf by leaf with
  no packed colour view in either, and with seeded colours grafted into
  both, a 32x32 frame against ``vrt.render_image`` at the f32 golden
  tolerances and a fit step's loss and SDF and colour gradients against
  ``jax.value_and_grad`` of ``vrt``'s (rtol 1e-4, 1 - cos < 1e-5 as
  tests/test_torch_bench.py holds the packed step); the colour gradient is
  f32 and the step never repacks the colours;
- ``scene_from_numpy`` keeps ``vrt``'s None, and under the budget ``vrt``'s
  packed view; ``graft_params`` grafts the grid as it is, and a graph
  through it takes the shade Function pair;
- ``PackCorners``' CPU branch bit-equal to ``vrt``'s ``pack_cell_corners``
  for f32 9-channel and bf16 8-channel tables, its backward to ``jax.vjp``
  of it (bit for bit, or 1e-6 * max|g| where XLA sums in another order);
- the plain surface stage on the unpacked grid, and its VJP through
  ``ShadeSurface``'s CPU branch, against autograd of the plain stage; its
  colour sample against ``vrt``'s ``_voxel_color_sample`` on hit cells of
  the grid's first and last voxel layers.

The kernels' side is in tests/test_torch_kernels.py (``gpu``) and
``chip_smoke.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vrt.render.gpuscene as vgs
import vrt_torch.render.gpuscene as tgs
from tests.test_torch_bench import STEP_COS_TOL, _vrt_cell_scenes
from tests.test_torch_host import as_numpy, scene_fields
from tests.test_torch_render import assert_close_f32
from tests.test_torch_scene import assert_scene_equal
from tests.test_torch_shade import _level_inputs
from vrt_torch.apps import bench
from vrt_torch.kernels.pack import PackCorners
from vrt_torch.march.types import RECORD_GRAD_FIELDS
from vrt_torch.render import renderer as tren
from vrt_torch.render.gpuscene import RenderMode

torch.set_num_threads(2)

SIZE = 32
STEP_RTOL = 1e-4
PACK_GRAD_RTOL = 1e-6


def _vrt_rule(shape, march_dtype):
    """``vrt``'s test in its ``build_scene`` on colours of ``shape``, read
    off a broadcast view (no array of that size is made)."""
    colors = np.broadcast_to(np.float32(0.5), shape)
    return (np.asarray(colors).size * 8
            * np.dtype(march_dtype or np.float32).itemsize
            <= vgs.COLOR_CORNER_BUDGET_BYTES)


@pytest.mark.parametrize("shape,dtype,packs", [
    ((1, 257, 257, 257, 3), "bf16", False),     # config4
    ((1, 257, 257, 257, 3), "f32", False),
    ((2, 65, 65, 65, 3), "f32", True),          # config6
    ((1, 17, 17, 17, 3), "bf16", True),         # config4 at resolution 4
    ((2, 129, 129, 129, 3), "f32", False),
    ((2, 200, 200, 200, 1), "bf16", True),      # 256,000,000 bytes
    ((2, 200, 200, 201, 1), "bf16", False)],
    ids=["config4", "config4-f32", "config6", "config4-r4", "config6-r7",
         "at-budget", "over-budget"])
def test_budget_rule_is_vrts(shape, dtype, packs):
    tdt = torch.bfloat16 if dtype == "bf16" else None
    vdt = jnp.bfloat16 if dtype == "bf16" else None
    assert tgs.COLOR_CORNER_BUDGET_BYTES == vgs.COLOR_CORNER_BUDGET_BYTES
    assert _vrt_rule(shape, vdt) == packs
    assert tgs.packs_voxel_colors(shape, tdt) == packs


@pytest.fixture(scope="module")
def unpacked():
    """config4 at resolution 4 in both packages, built with the budget at 0
    in both: (vrt's scene and cameras, the port's scene and cameras)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vgs, "COLOR_CORNER_BUDGET_BYTES", 0)
        mp.setattr(tgs, "COLOR_CORNER_BUDGET_BYTES", 0)
        _, vs, vcams = _vrt_cell_scenes(4)[4]
        ts, cams = bench.config4_scene(4, device="cpu")
    return vs, vcams, ts, cams


def _seeded_colors(scene, seed=3):
    n = scene.volumes.sdf.shape[-1]
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, size=(1, n, n, n, 3)).astype(np.float32)


def test_scenes_equal_without_packed_colours(unpacked):
    vs, _, ts, _ = unpacked
    assert vs.voxel_color_corners is None and ts.voxel_color_corners is None
    assert ts.use_voxel_colors and vs.use_voxel_colors
    assert_scene_equal(ts, vs)
    assert ts.voxel_colors.dtype == torch.float32
    assert tgs.color_table(ts) is ts.voxel_colors
    # the same scene under the budget packs, in the corner table's dtype
    packed, _ = bench.config4_scene(4, device="cpu")
    assert packed.voxel_color_corners.dtype == torch.bfloat16
    assert tgs.color_table(packed) is packed.voxel_color_corners


def test_frame_matches_vrt_unpacked(unpacked):
    """A 32x32 frame of the seeded colours, both packages sampling the f32
    voxel grid."""
    from vrt.render.gpuscene import RenderMode as VMode
    from vrt.render.renderer import render_image as vrender

    vs, _, ts, _ = unpacked
    colors = _seeded_colors(ts)
    vs = dataclasses.replace(vs, voxel_colors=jnp.asarray(colors))
    ts = dataclasses.replace(ts, voxel_colors=torch.from_numpy(colors))
    for mode, vmode in ((RenderMode(), VMode()),
                        (RenderMode(lit=False), VMode(lit=False))):
        want = np.asarray(vrender(vs, SIZE, SIZE, vmode))[..., :3]
        got = tren.render_image(ts, SIZE, SIZE, mode).numpy()
        assert got.shape == (SIZE, SIZE, 4) and np.isfinite(got).all()
        assert_close_f32(got[..., :3], want, f"unpacked colours {mode}")
        assert want.std() > 0.05


def test_fit_step_matches_vrt_unpacked(unpacked, monkeypatch):
    """config4's loss (zero targets) and its SDF and colour gradients with
    seeded colours, both packages grafting the colours directly: the port's
    ``make_fit_step`` loss and ``_value_and_grad`` against
    ``jax.value_and_grad`` of ``vrt``'s step; the colour gradient is f32 and
    no step repacks the colours."""
    from vrt.render.gpuscene import RenderMode as VMode
    from vrt_torch.diff import fit as tfit
    from vrt_torch.diff.optim import sgd

    vfit = importlib.import_module("vrt.diff.fit")
    vs, vcams, ts, cams = unpacked
    colors = _seeded_colors(ts)

    def vloss(p):
        s = vfit.rebuild_accel(vfit.graft_params(vs, p))
        return jnp.mean(vfit.render_views(s, vcams, SIZE, SIZE,
                                          VMode()) ** 2)

    value, vgrads = jax.jit(jax.value_and_grad(vloss))(
        {"sdf": vs.volumes.sdf, "voxel_colors": jnp.asarray(colors)})

    def no_repack(*a, **k):
        raise AssertionError("the step repacked the colours")

    monkeypatch.setattr(tfit, "pack_voxel_color_corners", no_repack)
    params = {"sdf": ts.volumes.sdf.clone(),
              "voxel_colors": torch.from_numpy(colors)}
    loss, grads = tfit._value_and_grad(
        lambda p: torch.mean(tfit.render_views(
            tfit.graft_and_rebuild(ts, p), cams, SIZE, SIZE,
            RenderMode()) ** 2), params)
    opt = sgd(0.0)
    step = tfit.make_fit_step(ts, cams, SIZE, SIZE, RenderMode(), opt)
    targets = torch.zeros((len(cams), SIZE * SIZE, 3))
    _, _, step_loss = step(params, opt.init(params), targets)
    for got in (loss, step_loss):
        assert float(got) == pytest.approx(float(value), rel=STEP_RTOL)
    assert grads["voxel_colors"].dtype == torch.float32
    assert grads["voxel_colors"].shape == params["voxel_colors"].shape
    for k in ("sdf", "voxel_colors"):
        a = grads[k].double().numpy().ravel()
        b = np.asarray(vgrads[k], np.float64).ravel()
        assert np.abs(b).max() > 0, k
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert 1.0 - cos < STEP_COS_TOL, (k, 1.0 - cos)


@pytest.mark.parametrize("budget", ["unpacked", "packed"])
def test_scene_from_numpy_keeps_vrts_view(unpacked, budget):
    """A bridged scene carries ``vrt``'s colour view as it is: None above
    the budget (the port samples the f32 grid), the packed view under it."""
    if budget == "unpacked":
        vs = unpacked[0]
    else:
        vs = _vrt_cell_scenes(4)[4][1]
        assert vs.voxel_color_corners is not None
    got = tgs.scene_from_numpy(scene_fields(vs), device="cpu")
    assert_scene_equal(got, vs)
    assert (got.voxel_color_corners is None) == (budget == "unpacked")
    assert tgs.color_table(got) is (got.voxel_colors if budget == "unpacked"
                                    else got.voxel_color_corners)


@pytest.mark.parametrize("dtype,fold", [("f32", True), ("bf16", False),
                                        ("f32", False), ("bf16", True)])
def test_pack_corners_cpu_branch_is_vrts(dtype, fold):
    """``PackCorners`` on CPU tensors: the table equals ``vrt``'s
    ``pack_cell_corners`` bit for bit, and its backward ``jax.vjp`` of it
    (each SDF entry a sum of at most 8 table cotangents)."""
    import vrt.march.types as vtypes

    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    vdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    rng = np.random.default_rng(11)
    sdf = rng.normal(size=(2, 9, 9, 9)).astype(np.float32)
    accel = rng.integers(0, 600, size=(2, 8, 8, 8)).astype(np.int32) \
        if fold else None
    x = torch.from_numpy(sdf).requires_grad_(True)
    got = PackCorners.apply(x, None if accel is None
                            else torch.from_numpy(accel), tdt)

    def vpack(s):
        if accel is None:
            return jax.vmap(lambda v: vtypes.pack_cell_corners(
                v, dtype=vdt))(s)
        return jax.vmap(lambda v, a: vtypes.pack_cell_corners(
            v, a, dtype=vdt))(s, jnp.asarray(accel))

    want, vjp = jax.vjp(vpack, jnp.asarray(sdf))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(as_numpy(got.detach()), np.asarray(want))
    g = rng.normal(size=want.shape).astype(np.float32)
    (g_want,) = vjp(jnp.asarray(g, vdt))
    (g_got,) = torch.autograd.grad(got, x, torch.from_numpy(g).to(tdt))
    a, b = g_got.double().numpy(), np.asarray(g_want, np.float64)
    assert g_got.dtype == torch.float32
    assert np.abs(a - b).max() <= PACK_GRAD_RTOL * np.abs(b).max()


@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
def test_unpacked_surface_stage_vjp_through_the_function(lit):
    """One level of ``shading_scene`` with its seeded colours unpacked: the
    plain surface stage through ``ShadeSurface``'s CPU branch equals it
    under autograd, and the branch's VJP (``shade_surface_backward_reference``
    over 8 voxel rows a hit) equals autograd of the plain stage in the rays,
    ``t``, ``n_obj`` and the grid, which gets an f32 gradient of its own
    shape."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.scenes import shading_scene

    mode = RenderMode(lit=lit)
    packed = shading_scene(4, 1, 1, colors=True, device="cpu")
    scene = dataclasses.replace(packed, voxel_color_corners=None)
    assert tgs.color_table(scene) is scene.voxel_colors
    assert k4.color_layout(scene) == "voxels f32"
    o, d, hit, inst, t, n_obj, _ = _level_inputs(scene, mode)
    assert int(hit.hit.sum()) > 50
    rng = np.random.default_rng(5)
    weights = {f: torch.from_numpy(rng.normal(
        size=(o.shape[0],) if f in ("roughness", "metallic")
        else (o.shape[0], 3)).astype(np.float32)) for f in RECORD_GRAD_FIELDS}

    def run(function):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (o, d, t, n_obj, scene.voxel_colors)]
        s = dataclasses.replace(scene, voxel_colors=leaves[4])
        if function:
            rec = tren._shade_surface_function(s, *leaves[:4], hit, inst,
                                               mode, lit, lit)
        else:
            rec = tren.shade_surface_reference(s, *leaves[:4], hit, inst,
                                               mode, lit, lit)
        loss = 0.0
        for f in RECORD_GRAD_FIELDS:
            x = getattr(rec, f)
            if x is not None and x.requires_grad:
                on = hit.hit.reshape(hit.hit.shape + (1,) * (x.ndim - 1))
                loss = loss + (torch.where(on, x, 0.0) * weights[f]).sum()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return rec, [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads)]

    rec_f, got = run(True)
    rec_p, want = run(False)
    on = hit.hit
    assert torch.equal(rec_f.albedo[on], rec_p.albedo[on])
    assert got[4].dtype == torch.float32
    assert got[4].shape == scene.voxel_colors.shape
    for name, a, b in zip(("o_w", "d_w", "t", "n_obj", "voxel_colors"),
                          got, want):
        scale = b.abs().max().item()
        if name == "n_obj" and not lit:     # the unlit albedo reads no normal
            assert scale == 0 and not bool(a.any())
            continue
        assert scale > 0, name
        assert (a - b).abs().max().item() <= 1e-6 * scale, name


@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
def test_unpacked_sample_at_the_grid_edges_is_vrts(unpacked, lit):
    """The plain surface stage's albedo on the unpacked grid against
    ``vrt``'s ``_voxel_color_sample`` on the same seeded f32 lanes, every
    hit cell on the grid's first or last voxel layers along at least one
    axis (cell -1, 0, n - 2 or n - 1, the others inside), the hit point
    inside the cell: corners outside the volume read zero in both.  Within
    1e-6 of the largest |sample| (the 8-term sum may round in another
    order)."""
    from vrt.march.types import MarchHit as VHit
    from vrt.render import renderer as vren
    from vrt_torch.march.types import MarchHit

    vs, _, ts, _ = unpacked
    colors = _seeded_colors(ts)
    vs = dataclasses.replace(vs, voxel_colors=jnp.asarray(colors))
    ts = dataclasses.replace(ts, voxel_colors=torch.from_numpy(colors))
    # one instance at the origin, unrotated, unscaled: object = world space
    assert ts.inst_pos.shape[0] == 1 and not bool(ts.inst_pos.any())
    assert torch.equal(ts.inst_rot[0], torch.tensor([0.0, 0.0, 0.0, 1.0]))
    assert bool((ts.inst_scale == 1.0).all())
    n = int(ts.volumes.n[0])
    h, ext = float(ts.volumes.cell_size[0]), float(ts.volumes.extends[0])
    rng = np.random.default_rng(11)
    rays = 512
    cell = rng.integers(0, n - 1, size=(rays, 3))
    axis = rng.integers(0, 3, size=rays)
    cell[np.arange(rays), axis] = rng.choice([-1, 0, n - 2, n - 1],
                                             size=rays)
    cell = cell.astype(np.int32)
    hit_point = ((cell + rng.uniform(0.0, 1.0, size=(rays, 3))) * h
                 - ext).astype(np.float32)
    d = rng.normal(size=(rays, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = rng.uniform(5.0, 50.0, size=rays).astype(np.float32)
    o = (hit_point - d * t[:, None]).astype(np.float32)
    n_obj = -d
    fields = dict(hit=np.ones(rays, bool), t=t,
                  kind=np.zeros(rays, np.int32), cell=cell, t_in=t, t_out=t,
                  face_normal=np.zeros((rays, 3), np.float32))
    hit = MarchHit(**{k: torch.from_numpy(v) for k, v in fields.items()})
    inst = torch.zeros(rays, dtype=torch.int32)
    rec = tren.shade_surface_reference(
        ts, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
        torch.from_numpy(n_obj), hit, inst, RenderMode(lit=lit), False, False)
    vhit = VHit(**{k: jnp.asarray(v) for k, v in fields.items()})
    pr = vren._per_ray_instance(vs, jnp.asarray(inst.numpy()))
    want = np.asarray(vren._voxel_color_sample(
        vs, pr, vhit, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)))
    got = rec.albedo.numpy()
    outside = ((cell < 0) | (cell + 1 >= n)).any(axis=1)
    assert outside.sum() > rays // 4 and (~outside).sum() > rays // 4
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_graft_and_dispatch_unpacked(unpacked):
    """``graft_params`` grafts the colour grid as it is (no packed view to
    repack), and a graph through the grid takes the shade Function pair."""
    from vrt_torch.diff.fit import graft_and_rebuild, graft_params

    ts = unpacked[2]
    leaf = ts.voxel_colors.clone().requires_grad_(True)
    for scene in (graft_params(ts, {"voxel_colors": leaf}),
                  graft_and_rebuild(ts, {"voxel_colors": leaf,
                                         "sdf": ts.volumes.sdf})):
        assert scene.voxel_colors is leaf
        assert scene.voxel_color_corners is None
        assert tgs.color_table(scene) is leaf
        rays = [torch.zeros((4, 3)) for _ in range(2)]
        stages = tren.shade_stages(scene, *rays, torch.zeros(4),
                                   torch.zeros((4, 3)))
        assert stages == (tren._shade_surface_function,
                          tren._shade_combine_function)
