"""The differentiable fit of vrt_torch (``vrt_torch.diff``) against vrt's.

- the device-side tables the fit rebuilds every step — the corner table
  (``pack_cell_corners``), the octree accel (``build_accel``) and the
  packed colours (``pack_voxel_color_corners``) — equal vrt's bit for bit;
- K3's plain version ``gather_rows_reference`` equals ``jnp.take`` with
  the mask, forward and backward (its transpose, by ``jax.vjp``), exactly
  in f32;
- the functional Adam equals ``optax.adam`` (rtol 1e-6); three
  ``make_fit_step`` steps track vrt's (losses rtol 1e-4);
- ``smooth3``, ``upsample_params`` and ``psnr`` equal vrt's;
- checkpoints cross between the packages both ways;
- the port's fit loss and gradients on the flagship at resolution 4 with
  colours, 64x36, equal vrt's (``jax.value_and_grad``): the loss to rtol
  1e-5, each gradient to a cosine of 0.999999 and 1e-4 * max|g| (measured:
  cosine within 1e-10 of 1, differences below 1e-5 * max|g|);
- the fixture ``tests/fixtures/fit_flagship_r4_colors_64x36.npz``, which
  ``chip_smoke.py`` holds the card against, is that loss and gradient of
  vrt on the CPU (``test_fit_fixture_is_vrt_grad``; regenerate it with
  ``JAX_PLATFORMS=cpu python -m tests.test_torch_fit``);
- the ``TestFitConverges`` analog and the CLI at a tiny size.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from tests.test_torch_host import as_numpy, assert_same, scene_fields
from vrt.march import march as vmarch
from vrt.march import types as vtypes
from vrt.render import gpuscene as vgs
from vrt.render.gpuscene import RenderMode as VMode
from vrt.volume import accel as vaccel
from vrt.volume import sdf as vsdf
from vrt.core.grid import GridLaw as VGridLaw
from vrt_torch.diff import checkpoint as tckpt
from vrt_torch.diff import fit as tfit
from vrt_torch.diff.optim import AdamState, adam, apply_updates
from vrt_torch.kernels import rows as K3
from vrt_torch.march import types as ttypes
from vrt_torch.render import gpuscene as tgs
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
from vrt_torch.volume import accel as taccel

vfit = __import__("vrt.diff.fit", fromlist=["fit"])
vckpt = __import__("vrt.diff.checkpoint", fromlist=["checkpoint"])

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "fit_flagship_r4_colors_64x36.npz")
# config6's camera (vrt/apps/bench.py bench_fit) at 64x36, targets 0.25
FIT_CAMS = [dict(position=np.asarray([320.0, 0.0, 40.0], np.float32),
                 rotation=np.asarray([0.0, 0.0, 1.0, 0.0], np.float32),
                 fov=60.0)]
FIT_W, FIT_H, FIT_TARGET = 64, 36, 0.25


def _csg_sdf(resolution):
    csg = vsdf.CSG(shape=vsdf.Box(extends=(40.0, 40.0, 40.0)))
    csg.add_child(vsdf.Sphere(radius=50.0), vsdf.SUBTRACT)
    a, _ = vsdf.bake(csg, VGridLaw(resolution, 100.0))
    b, _ = vsdf.bake(vsdf.Sphere(radius=30.0), VGridLaw(resolution, 100.0))
    return np.stack([a, b])


def assert_grads_close(got, want, tag, cos_tol=1e-6, diff_tol=1e-4):
    a = np.asarray(want, np.float64).ravel()
    b = got.detach().double().cpu().numpy().ravel()
    assert np.isfinite(b).all(), tag
    scale = np.abs(a).max()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 1.0 - cos_tol, (tag, 1.0 - cos)
    assert np.abs(a - b).max() <= diff_tol * scale, (
        tag, np.abs(a - b).max() / scale)


# ---- the tables the fit rebuilds on the device -------------------------------

class TestDeviceTables:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("fold", [False, True])
    def test_pack_cell_corners_equals_vrt(self, dtype, fold):
        """Two stacked volumes at once, as the fit repacks them."""
        sdf = _csg_sdf(4)
        accel = np.stack([np.asarray(vaccel.build_accel(s, 4), np.int32)
                          for s in sdf])
        accel[0, 0, 0, 0] = (200 << 1) | 1      # exercises the bf16 clamp
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        vdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        got = ttypes.pack_cell_corners(
            torch.from_numpy(sdf), torch.from_numpy(accel) if fold else None,
            tdt)
        want = jax.vmap(lambda s, a: vtypes.pack_cell_corners(
            s, a if fold else None, dtype=vdt))(jnp.asarray(sdf),
                                                jnp.asarray(accel))
        assert_same(got, want, "corners")

    def test_pack_cell_corners_gradient_is_the_slices_transpose(self):
        sdf = _csg_sdf(3)
        w = np.random.default_rng(1).normal(
            size=(2, 8, 8, 8, 8)).astype(np.float32)
        _, vjp = jax.vjp(jax.vmap(lambda s: vtypes.pack_cell_corners(s)),
                         jnp.asarray(sdf))
        (want,) = vjp(jnp.asarray(w))
        x = torch.from_numpy(sdf).requires_grad_(True)
        (got,) = torch.autograd.grad(
            (ttypes.pack_cell_corners(x) * torch.from_numpy(w)).sum(), x)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    @pytest.mark.parametrize("resolution", [3, 4, 5])
    def test_build_accel_on_device_equals_vrt(self, resolution):
        sdf = _csg_sdf(resolution)
        got = taccel.build_accel(torch.from_numpy(sdf), resolution)
        want = jax.vmap(lambda s: vaccel.build_accel(s, resolution))(
            jnp.asarray(sdf))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_pack_voxel_color_corners_equals_vrt(self, dtype):
        colors = np.random.default_rng(2).uniform(
            size=(2, 9, 9, 9, 3)).astype(np.float32)
        tdt = torch.bfloat16 if dtype == "bf16" else None
        vdt = jnp.bfloat16 if dtype == "bf16" else None
        want = vgs.pack_voxel_color_corners(jnp.asarray(colors), dtype=vdt)
        assert_same(tgs.pack_voxel_color_corners(torch.from_numpy(colors),
                                                 tdt), want, "tensor")
        assert_same(tgs.pack_voxel_color_corners(colors, tdt), want, "numpy")

    def test_rebuild_accel_equals_vrt(self):
        """The rebuilt scene's accel, u8 accel, corner table and mode."""
        vs = ge._flagship_scene(resolution=4, accel_mode="chebyshev")
        want = vfit.rebuild_accel(vs).volumes
        got = tfit.rebuild_accel(
            scene_from_numpy(scene_fields(vs), device="cpu")).volumes
        assert got.accel_mode == want.accel_mode == "octree"
        assert_same(got.accel, want.accel, "accel")
        assert_same(got.corners, want.corners, "corners")
        assert_same(got.accel_u8.reshape(-1), np.asarray(
            vmarch._accel_u8(want.accel)), "accel_u8")

    def test_graft_and_rebuild_equals_the_chain(self):
        """One pack (``graft_and_rebuild``) gives the scene and the SDF
        gradient of ``rebuild_accel(graft_params(...))``, which packs twice."""
        ts = scene_from_numpy(
            scene_fields(ge._flagship_scene(resolution=3)), device="cpu")
        sdf = ts.volumes.sdf.detach() + 0.5
        w = torch.from_numpy(np.random.default_rng(4).normal(
            size=tuple(ts.volumes.corners.shape)).astype(np.float32))
        out = []
        for build in (tfit.graft_and_rebuild,
                      lambda s, p: tfit.rebuild_accel(tfit.graft_params(s, p))):
            x = sdf.clone().requires_grad_(True)
            vols = build(ts, {"sdf": x}).volumes
            (g,) = torch.autograd.grad((vols.corners.float() * w).sum(), x)
            out.append((vols, g))
        (a, ga), (b, gb) = out
        assert a.accel_mode == b.accel_mode == "octree"
        assert torch.equal(a.accel, b.accel)
        assert torch.equal(a.corners, b.corners)
        assert torch.equal(ga, gb)


# ---- K3's plain version -----------------------------------------------------

GATHER_CASES = {"f32x8": (torch.float32, 8, 8), "f32x9": (torch.float32, 9, 8),
                "bf16x8": (torch.bfloat16, 8, 8),
                "bf16x9": (torch.bfloat16, 9, 8),
                "f32x24": (torch.float32, 24, 24),
                "bf16x24": (torch.bfloat16, 24, 24)}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_rows_reference_matches_jnp_take(case):
    """Forward, and backward against the transpose of ``jnp.take`` with
    the mask (``jax.vjp``), with duplicate rows and ``-1`` lanes; exact in
    f32, to bf16 rounding for bf16 tables (both scatter in bf16, in
    different orders)."""
    dtype, ch, out_ch = GATHER_CASES[case]
    rng = np.random.default_rng(3)
    table = rng.normal(size=(64, ch)).astype(np.float32)
    idx = rng.integers(-1, 64, size=500).astype(np.int32)
    idx[:50] = 7                                   # a hot row
    g = rng.normal(size=(500, out_ch)).astype(np.float32)
    vdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def vgather(t):
        rows = jnp.take(t, jnp.maximum(jnp.asarray(idx), 0), axis=0)
        return jnp.where(jnp.asarray(idx)[:, None] >= 0,
                         rows[:, :out_ch].astype(jnp.float32), 0.0)

    want, vjp = jax.vjp(vgather, jnp.asarray(table, vdt))
    (want_g,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).to(dtype).requires_grad_(True)
    got = K3.gather_rows_reference(t, torch.from_numpy(idx), out_ch)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got_g,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    assert got_g.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got_g.float().numpy(),
                                   np.asarray(want_g, np.float32),
                                   rtol=2e-2, atol=2e-2)
    # the scatter's plain version is the same transpose, in f32
    acc = K3.scatter_rows_reference(torch.from_numpy(g), torch.from_numpy(idx),
                                    64, ch)
    np.testing.assert_allclose(acc.numpy(), np.asarray(
        jax.vjp(vgather, jnp.asarray(table))[1](jnp.asarray(g))[0]),
        rtol=1e-6, atol=1e-5)


def test_gather_rows_cpu_takes_the_plain_version():
    table = torch.rand(32, 8, requires_grad=True)
    idx = torch.tensor([3, -1, 3, 31], dtype=torch.int32)
    before = dict(K3.LAUNCHES)
    out = K3.gather_rows(table, idx, 8)
    out.sum().backward()
    assert K3.LAUNCHES == before
    assert torch.equal(out[1], torch.zeros(8))
    assert torch.equal(table.grad[3], torch.full((8,), 2.0))
    with pytest.raises(ValueError):
        K3.gather_rows_cuda(table.detach(), idx, 8)
    with pytest.raises(ValueError):
        K3.scatter_rows_cuda(torch.zeros(4, 8), idx, 32, 8)


# ---- the optimizer and the fit tools ----------------------------------------

def test_adam_matches_optax():
    rng = np.random.default_rng(4)
    params = {"sdf": rng.normal(size=(2, 5, 5, 5)).astype(np.float32),
              "voxel_colors": rng.uniform(size=(2, 5, 5, 5, 3)).astype(
                  np.float32)}
    vopt, topt = optax.adam(1e-2), adam(1e-2)
    vp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    vs, ts = vopt.init(vp), topt.init(tp)
    for step in range(5):
        grads = {k: rng.normal(scale=10.0 ** -step, size=v.shape).astype(
            np.float32) for k, v in params.items()}
        vu, vs = vopt.update({k: jnp.asarray(g) for k, g in grads.items()},
                             vs, vp)
        vp = optax.apply_updates(vp, vu)
        tu, ts = topt.update({k: torch.from_numpy(g)
                              for k, g in grads.items()}, ts, tp)
        tp = apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(vu[k]),
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(vp[k]),
                                       rtol=1e-6)
    assert int(ts.count) == int(vs[0].count) == 5


def test_smooth3_upsample_psnr_match_vrt():
    rng = np.random.default_rng(5)
    for shape in [(1, 5, 5, 5), (2, 5, 5, 5, 3)]:
        x = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_allclose(
            tfit.smooth3(torch.from_numpy(x), 0.3).numpy(),
            np.asarray(vfit.smooth3(jnp.asarray(x), 0.3)), rtol=1e-6,
            atol=1e-6)
    p = {"sdf": rng.normal(size=(1, 5, 5, 5)).astype(np.float32),
         "voxel_colors": rng.normal(size=(1, 3, 3, 3, 3)).astype(np.float32),
         "cam_pos": np.asarray([1.0, 2.0, 3.0], np.float32)}
    got = tfit.upsample_params({k: torch.from_numpy(v) for k, v in p.items()})
    want = vfit.upsample_params({k: jnp.asarray(v) for k, v in p.items()})
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["sdf"].shape == (1, 9, 9, 9)
    a = rng.uniform(size=(64, 3)).astype(np.float32)
    b = rng.uniform(size=(64, 3)).astype(np.float32)
    for x, y in [(a, b), (a, a)]:
        np.testing.assert_allclose(
            float(tfit.psnr(torch.from_numpy(x), torch.from_numpy(y))),
            float(vfit.psnr(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)


# ---- checkpoints ------------------------------------------------------------

def _state_pair(seed):
    """The same params and Adam state in both packages, after two steps."""
    rng = np.random.default_rng(seed)
    params = {"sdf": rng.normal(size=(1, 5, 5, 5)).astype(np.float32),
              "voxel_colors": rng.uniform(size=(1, 5, 5, 5, 3)).astype(
                  np.float32)}
    vopt, topt = optax.adam(1e-2), adam(1e-2)
    vp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    vs, ts = vopt.init(vp), topt.init(tp)
    for _ in range(2):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        vu, vs = vopt.update({k: jnp.asarray(x) for k, x in g.items()}, vs)
        vp = optax.apply_updates(vp, vu)
        tu, ts = topt.update({k: torch.from_numpy(x) for k, x in g.items()},
                             ts)
        tp = apply_updates(tp, tu)
    return vp, vs, tp, ts


def _assert_state_equal(tp, ts, vp, vs):
    for k in vp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(vp[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(vs[0].mu[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(vs[0].nu[k]),
                                   rtol=1e-6)
    assert ts.count.dtype == torch.int32
    assert int(ts.count) == int(vs[0].count)


def test_vrt_checkpoint_resumes_in_port(tmp_path):
    vp, vs, _, _ = _state_pair(6)
    path = str(tmp_path / "vrt.npz")
    vckpt.save_checkpoint(path, vp, vs, 2, extra={"run": "a"})
    like_p = {k: torch.zeros(v.shape) for k, v in vp.items()}
    p, s, step, extra = tckpt.load_checkpoint(path, like_p,
                                              adam(1e-2).init(like_p))
    assert isinstance(s, AdamState) and step == 2 and extra == {"run": "a"}
    _assert_state_equal(p, s, vp, vs)
    # and the resumed state steps on like vrt's
    g = {k: np.full(v.shape, 0.5, np.float32) for k, v in vp.items()}
    vu, vs2 = optax.adam(1e-2).update({k: jnp.asarray(x)
                                       for k, x in g.items()}, vs)
    tu, s2 = adam(1e-2).update({k: torch.from_numpy(x)
                                for k, x in g.items()}, s)
    _assert_state_equal(apply_updates(p, tu), s2,
                        optax.apply_updates(vp, vu), vs2)
    assert tckpt.params_from_numpy(
        {k: np.asarray(v) for k, v in vp.items()},
        device="cpu")["sdf"].dtype \
        == torch.float32


def test_port_checkpoint_loads_in_vrt(tmp_path):
    vp, vs, tp, ts = _state_pair(7)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, tp, ts, 2)
    p, s, step, extra = vckpt.load_checkpoint(path, vp, vs)
    assert step == 2 and extra == {}
    for k in vp:
        np.testing.assert_allclose(np.asarray(p[k]), np.asarray(vp[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s[0].nu[k]),
                                   np.asarray(vs[0].nu[k]), rtol=1e-6)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, {"sdf": tp["sdf"]}, ts)


# ---- fit steps --------------------------------------------------------------

def test_three_fit_steps_match_vrt():
    """Three ``make_fit_step`` steps on the flagship at resolution 3 with
    colours, SDF and colours both fitted: the losses to rtol 1e-4, and the
    parameters where the first step's gradient is at least 1e-3 of its
    largest (Adam turns a near-zero gradient's rounding noise into a full
    step of either sign)."""
    vs = ge._flagship_scene(resolution=3, use_colors=True)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    cams = FIT_CAMS
    targets = np.full((1, 24 * 24, 3), 0.25, np.float32)
    vstep = vfit.make_fit_step(vs, cams, 24, 24, VMode(), optax.adam(1e-2))
    topt = adam(1e-2)
    tstep = tfit.make_fit_step(ts, cams, 24, 24, RenderMode(), topt)
    vp = {"sdf": vs.volumes.sdf, "voxel_colors": vs.voxel_colors}
    tp = {"sdf": ts.volumes.sdf, "voxel_colors": ts.voxel_colors}
    vstate, tstate = optax.adam(1e-2).init(vp), topt.init(tp)
    # the first step's gradient, from the port (test_fit_grads_match_vrt
    # holds it against vrt's)
    _, g0 = tfit._value_and_grad(
        lambda p: torch.mean((tfit.render_views(
            tfit.rebuild_accel(tfit.graft_params(ts, p)), cams, 24, 24,
            RenderMode()) - 0.25) ** 2), tp)
    vl, tl = [], []
    for _ in range(3):
        vp, vstate, loss = vstep(vp, vstate, jnp.asarray(targets))
        vl.append(float(loss))
        tp, tstate, loss = tstep(tp, tstate, torch.from_numpy(targets))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, vl, rtol=1e-4)
    assert tl[-1] < tl[0]
    for k in vp:
        g = np.abs(g0[k].numpy())
        big = g >= 1e-3 * g.max()
        assert big.sum() > 20, k
        np.testing.assert_allclose(tp[k].numpy()[big], np.asarray(vp[k])[big],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_fit_converges():
    """``TestFitConverges``: recover per-voxel colours from a grey start."""
    from vrt_torch.core import quat as tq
    from vrt_torch.core.material import Material
    from vrt_torch.render.gpuscene import build_scene
    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    vol = VoxelVolume.from_generator(
        S.Sphere(radius=50.0), 3, 100.0,
        material=Material(albedo=(0.8, 0.3, 0.3, 1.0), roughness=0.8))
    n = vol.n_voxels
    colors = np.random.default_rng(0).uniform(
        0.2, 0.8, size=(1, n, n, n, 3)).astype(np.float32)
    scene = build_scene(
        [vol], [{"volume": 0}],
        camera={"position": (300.0, 0.0, 0.0),
                "rotation": tq.from_euler_degrees(0.0, 180.0, 0.0)},
        dir_light={"direction": tq.forward_vector(
            tq.from_euler_degrees(0.0, 45.0, -30.0)), "strength": 3.0},
        voxel_colors=colors, device="cpu")
    cams = [dict(position=(300.0, 0.0, 0.0),
                 rotation=tq.from_euler_degrees(0.0, 180.0, 0.0), fov=60.0)]
    with torch.no_grad():
        targets = tfit.render_views(scene, cams, 24, 24, RenderMode())
    params = {"voxel_colors": torch.full_like(scene.voxel_colors, 0.5)}
    _, losses = tfit.fit(scene, params, cams, targets, 24, 24, steps=30,
                         learning_rate=5e-2)
    assert losses[-1] < 0.25 * losses[0], losses[::10]


def test_fit_cli_on_cpu():
    from vrt_torch.apps import fit as app

    losses = app.main(["--device", "cpu", "--resolution", "3", "--views",
                       "2", "--size", "16", "--steps", "6", "--fit-sdf"])
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    with pytest.raises(NotImplementedError):
        app.main(["--device", "cpu", "--out", "x"])


# ---- the fixture and the flagship fit gradient ------------------------------

def vrt_fit_value_and_grad():
    """vrt's loss and gradients (sdf, voxel_colors) of
    mean((render_views - 0.25)^2) on ``_flagship_scene(4, use_colors=True)``
    at 64x36 from config6's camera, on the CPU."""
    vs = ge._flagship_scene(resolution=4, use_colors=True)

    def loss(p):
        s = vfit.rebuild_accel(vfit.graft_params(vs, p))
        return jnp.mean((vfit.render_views(s, FIT_CAMS, FIT_W, FIT_H,
                                           VMode()) - FIT_TARGET) ** 2)

    params = {"sdf": vs.volumes.sdf, "voxel_colors": vs.voxel_colors}
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return vs, float(value), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def flagship_fit_grads():
    return vrt_fit_value_and_grad()


def test_fit_fixture_is_vrt_grad(flagship_fit_grads):
    _, loss, grads = flagship_fit_grads
    data = np.load(FIXTURE)
    assert os.path.getsize(FIXTURE) < 200_000
    assert float(data["loss"]) == pytest.approx(loss, rel=1e-6)
    for k in grads:
        want = data[f"grad_{k}"]
        assert want.dtype == np.float32 and want.shape == grads[k].shape
        np.testing.assert_allclose(want, grads[k], rtol=0,
                                   atol=1e-5 * np.abs(grads[k]).max())


def test_fit_grads_match_vrt(flagship_fit_grads):
    vs, want_loss, want = flagship_fit_grads
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    params = {"sdf": ts.volumes.sdf, "voxel_colors": ts.voxel_colors}

    def loss(p):
        s = tfit.rebuild_accel(tfit.graft_params(ts, p))
        return torch.mean((tfit.render_views(s, FIT_CAMS, FIT_W, FIT_H,
                                             RenderMode()) - FIT_TARGET) ** 2)

    got_loss, got = tfit._value_and_grad(loss, params)
    assert float(got_loss) == pytest.approx(want_loss, rel=1e-5)
    for k in params:
        assert_grads_close(got[k], want[k], k)
    # the same scene built by the port itself
    from vrt_torch.scenes import flagship_scene

    own = flagship_scene(4, use_colors=True, device="cpu")
    assert torch.equal(own.voxel_color_corners, ts.voxel_color_corners)
    assert torch.equal(own.volumes.corners, ts.volumes.corners)


if __name__ == "__main__":
    _, value, g = vrt_fit_value_and_grad()
    np.savez_compressed(FIXTURE, loss=np.float64(value),
                        **{f"grad_{k}": v for k, v in g.items()})
    print(f"wrote {FIXTURE}: loss {value}", file=sys.stderr)
    os._exit(0)
