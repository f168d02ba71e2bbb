"""The differentiable resolve of vrt_torch: the closed-form backward
(``resolve_scene_backward_reference``, the plain version of the fused
resolve's backward kernel) against ``torch.autograd`` through
``resolve_scene_reference`` and against ``jax.vjp`` of
``vrt.render.renderer.resolve_scene`` on the same scene state
(``scene_from_numpy``), and the dispatch of ``resolve_scene``.

The scene is ``test_torch_march.py``'s "overlap" crowd: four instances over
two resolution-4 volumes, one rotated and scaled, one inactive; 48x48 rays.

Tolerances.  Closed form against autograd (both float32, the same rows and
weights, sums in another order): every gradient within rtol 1e-5 plus
1e-6 * max|g|.  Against ``jax.vjp``: a cosine within 1e-8 of 1 and 1e-5 *
max|g| for the rays and an f32 table; a bf16 table's cotangents are summed
in bf16 by vrt and in f32 (then cast once) by the port, so its gradient
agrees to bf16 rounding: cosine 0.999, 2e-2 * max|g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_host import scene_fields
from tests.test_torch_kernels import _special_lanes
from vrt.core import quat as vq
from vrt.march.types import MarchHit as VHit
from vrt.render import renderer as vren
from vrt.render.camera import camera_rays as vrays
from vrt.render.gpuscene import build_scene as vbuild
from vrt.volume import sdf as S
from vrt.volume.volume import VoxelVolume
from vrt_torch.kernels import resolve as kr
from vrt_torch.kernels import rows as k3
from vrt_torch.march.types import MarchHit
from vrt_torch.render import renderer as tren
from vrt_torch.render.gpuscene import scene_from_numpy

torch.set_num_threads(2)

TABLES = {"octree-f32": ("octree", None), "chebyshev-bf16": ("chebyshev",
                                                             jnp.bfloat16)}
_SCENES = {}


def _scenes(config):
    """(vrt scene, the port's scene on the CPU) of the overlap crowd in
    ``config``; the corner table has 9 channels (the folded accel)."""
    if config not in _SCENES:
        mode, dtype = TABLES[config]
        sphere = VoxelVolume.from_generator(S.Sphere(radius=45.0), 4, 100.0)
        csg = S.CSG(shape=S.Box(extends=(40.0, 40.0, 40.0)))
        csg.add_child(S.Sphere(radius=50.0), S.SUBTRACT)
        box = VoxelVolume.from_generator(csg, 4, 100.0)
        insts = [{"volume": 0, "position": (0.0, -20.0, 0.0)},
                 {"volume": 1, "position": (0.0, -20.0, 0.0)},
                 {"volume": 0, "position": (30.0, 40.0, 10.0),
                  "rotation": np.asarray(vq.from_euler_degrees(0.0, 30.0,
                                                               10.0)),
                  "scale": (1.2, 0.8, 1.0)},
                 {"volume": 1, "position": (150.0, 0.0, 30.0)}]
        cam = {"position": (320.0, 0.0, 40.0), "fov": 60.0,
               "rotation": np.asarray(vq.from_euler_degrees(0.0, 180.0, 0.0))}
        vs = vbuild([sphere, box], insts, camera=cam, accel_mode=mode,
                    march_dtype=dtype)
        vs = dataclasses.replace(
            vs, inst_active=jnp.asarray([True, True, True, False]))
        _SCENES[config] = vs, scene_from_numpy(scene_fields(vs), device="cpu")
    return _SCENES[config]


def _with_corners(ts, corners):
    return dataclasses.replace(
        ts, volumes=dataclasses.replace(ts.volumes, corners=corners))


def _marched(ts, size=48):
    """Camera rays of the scene, the hits of a real march and random
    cotangents from a numpy seed; every third hit lane with inst = -1."""
    vs_cam = (ts.cam_pos.numpy(), ts.cam_rot.numpy(), ts.cam_fov.numpy())
    o, d = vrays(*(jnp.asarray(x) for x in vs_cam), size, size)
    o, d = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    t_max = torch.full((o.shape[0],), 1e4)
    hit, inst = tren.march_scene(ts, o, d, t_max)
    assert set(hit.kind.unique().tolist()) >= {0, 1}
    assert {0, 1, 2} <= set(inst[hit.hit].unique().tolist())
    inst[::3] = -1
    rng = np.random.default_rng(17)
    g_t = torch.from_numpy(rng.normal(size=o.shape[0]).astype(np.float32))
    g_n = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
    return o, d, hit, inst, g_t, g_n


def _autograd(ts, o, d, hit, inst, g_t, g_n):
    """(g_o_w, g_d_w, g_corners f32) by autograd through
    ``resolve_scene_reference``, the table widened to f32 first (exact), so
    that its cotangents add in f32 as the closed form's do."""
    leaves = [o.clone().requires_grad_(True), d.clone().requires_grad_(True),
              ts.volumes.corners.detach().float().clone().requires_grad_(True)]
    t, n, _ = tren.resolve_scene_reference(_with_corners(ts, leaves[2]),
                                           leaves[0], leaves[1], hit, inst)
    g = torch.autograd.grad([t, n], leaves, [g_t, g_n])
    return g[0], g[1], g[2].reshape(-1, g[2].shape[-1])


def _assert_close(got, want, tag):
    assert got.shape == want.shape and got.dtype == want.dtype, tag
    assert bool(torch.isfinite(got).all()), tag
    scale = want.abs().max().item()
    assert scale > 0, tag
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale,
                               msg=lambda m: f"{tag}: {m}")


@pytest.mark.parametrize("channels", [9, 8])
@pytest.mark.parametrize("config", sorted(TABLES))
def test_closed_form_matches_autograd(config, channels):
    ts = _scenes(config)[1]
    ts = _with_corners(ts, ts.volumes.corners[..., :channels].contiguous())
    o, d, hit, inst, g_t, g_n = _marched(ts)
    got = tren.resolve_scene_backward_reference(ts, o, d, hit, inst, g_t,
                                                g_n)
    want = _autograd(ts, o, d, hit, inst, g_t, g_n)
    for name, a, b in zip(("g_o_w", "g_d_w", "g_corners"), got, want):
        _assert_close(a, b, name)
    surface = hit.kind == 1
    assert bool((got[0][surface] != 0).any(dim=-1).float().mean() > 0.9)
    assert not bool(got[0][hit.kind == 0].any())
    assert not bool(got[2][:, 8:].any())


def test_special_lanes_match_autograd():
    """Non-finite hit t, a zero component of d, F'(t0) = 0 (d = 0), an
    out-of-range neighbour on either side, solid entries with and without
    a tie of two slabs, inst = -1: finite gradients equal to autograd's,
    and the tie's cotangent split evenly."""
    ts = _scenes("octree-f32")[1]
    o, d, hit, inst, g_t, g_n = _marched(ts, 64)
    lanes = _special_lanes(ts, o, d, hit, inst, 3, group=24)
    got = tren.resolve_scene_backward_reference(ts, o, d, hit, inst, g_t,
                                                g_n)
    want = _autograd(ts, o, d, hit, inst, g_t, g_n)
    for name, a, b in zip(("g_o_w", "g_d_w", "g_corners"), got, want):
        _assert_close(a, b, name)
    for name, idx in lanes.items():
        for a, b in zip(got[:2], want[:2]):
            assert bool(torch.isfinite(b[idx]).all()), name
            torch.testing.assert_close(a[idx], b[idx], rtol=1e-5,
                                       atol=1e-6 * b.abs().max().item())
    tie = lanes["tie"]
    assert torch.equal(got[0][tie, 0], -0.5 * g_t[tie])
    assert torch.equal(got[0][tie, 1], -0.5 * g_t[tie])
    assert torch.equal(want[0][tie, :2], got[0][tie, :2])
    assert (inst[lanes["edge_low"]] == -1).any()


@pytest.mark.parametrize("config", sorted(TABLES))
def test_closed_form_matches_jax_vjp(config):
    """The closed form against ``jax.vjp`` of vrt's ``resolve_scene`` on
    the bridged scene and the same hits and cotangents."""
    vs, ts = _scenes(config)
    o, d, hit, inst, g_t, g_n = _marched(ts)
    vh = VHit(**{f.name: jnp.asarray(getattr(hit, f.name).numpy())
                 for f in dataclasses.fields(MarchHit)})

    def f(o_w, d_w, corners):
        s = dataclasses.replace(vs, volumes=dataclasses.replace(
            vs.volumes, corners=corners))
        t, n, _ = vren.resolve_scene(s, o_w, d_w, vh, jnp.asarray(inst.numpy()))
        return t, n

    _, vjp = jax.vjp(f, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                     vs.volumes.corners)
    want = vjp((jnp.asarray(g_t.numpy()), jnp.asarray(g_n.numpy())))
    g_o, g_d, acc = tren.resolve_scene_backward_reference(
        ts, o, d, hit, inst, g_t, g_n)
    got = (g_o, g_d, acc.to(ts.volumes.corners.dtype))
    bf16 = ts.volumes.corners.dtype == torch.bfloat16
    for name, a, b in zip(("g_o_w", "g_d_w", "g_corners"), got, want):
        a = a.double().numpy().ravel()
        b = np.asarray(b.astype(jnp.float32), np.float64).ravel()
        loose = bf16 and name == "g_corners"
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 1.0 - (1e-3 if loose else 1e-8), (name, 1.0 - cos)
        assert np.abs(a - b).max() <= (2e-2 if loose else 1e-5) \
            * np.abs(b).max(), name


# A camera 275 units off instance 0's sphere (radius 45 at (0, -20, 0)),
# looking at its +x pole through a 2.5 degree field: the rays fall on the
# 2x2 block of resolution-4 cells (12.5 units) around the pole and their
# neighbours, the contention the backward kernel merges.
CONTENTION_CAMERA = dict(position=(320.0, -20.0, 0.0), fov=2.5)


def _contended(ts, size=32):
    """Rays from ``CONTENTION_CAMERA`` into the overlap crowd, their hits
    and random cotangents from a numpy seed."""
    cam_pos = np.asarray(CONTENTION_CAMERA["position"], np.float32)
    o, d = vrays(jnp.asarray(cam_pos), jnp.asarray(ts.cam_rot.numpy()),
                 jnp.asarray(np.float32(CONTENTION_CAMERA["fov"])), size,
                 size)
    o, d = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    hit, inst = tren.march_scene(ts, o, d, torch.full((o.shape[0],), 1e4))
    rng = np.random.default_rng(23)
    g_t = torch.from_numpy(rng.normal(size=o.shape[0]).astype(np.float32))
    g_n = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
    return o, d, hit, inst, g_t, g_n


@pytest.mark.parametrize("channels", [9, 8])
def test_closed_form_matches_jax_vjp_on_contended_hits(channels):
    """The closed form against ``jax.vjp`` of vrt's ``resolve_scene`` when
    nearly every ray hits one of a few neighbouring cells, so that the
    rows' cotangents of many rays add into the same rows.  On the f32
    table: vrt adds a bf16 table's cotangents in bf16, whose rounding grows
    with the number of rays a row sums (3% of max|g| here), where the port
    adds in f32 and casts once."""
    vs, ts = _scenes("octree-f32")
    vs = dataclasses.replace(vs, volumes=dataclasses.replace(
        vs.volumes, corners=vs.volumes.corners[..., :channels]))
    ts = _with_corners(ts, ts.volumes.corners[..., :channels].contiguous())
    o, d, hit, inst, g_t, g_n = _contended(ts)
    surface = hit.kind == 1
    assert surface.float().mean().item() > 0.95
    cells = torch.unique(hit.cell[surface], dim=0)
    assert cells.shape[0] <= 4 and bool((inst[surface] == 0).all())
    vh = VHit(**{f.name: jnp.asarray(getattr(hit, f.name).numpy())
                 for f in dataclasses.fields(MarchHit)})

    def f(o_w, d_w, corners):
        s = dataclasses.replace(vs, volumes=dataclasses.replace(
            vs.volumes, corners=corners))
        t, n, _ = vren.resolve_scene(s, o_w, d_w, vh, jnp.asarray(inst.numpy()))
        return t, n

    _, vjp = jax.vjp(f, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                     vs.volumes.corners)
    want = vjp((jnp.asarray(g_t.numpy()), jnp.asarray(g_n.numpy())))
    g_o, g_d, acc = tren.resolve_scene_backward_reference(
        ts, o, d, hit, inst, g_t, g_n)
    # the rows of the cells around the pole carry the sums of many rays
    assert int((acc != 0).any(-1).sum()) <= 7 * 4 * 2
    for name, a, b in zip(("g_o_w", "g_d_w", "g_corners"), (g_o, g_d, acc),
                          want):
        a = a.double().numpy().ravel()
        b = np.asarray(b, np.float64).ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 1.0 - 1e-8, (name, 1.0 - cos)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name


@pytest.mark.parametrize("ch,width", [(8, 8), (9, 12)])
def test_accumulator_rows_are_16_bytes(ch, width):
    """The redesigned backward's accumulator: zeroed rows of ``width``
    floats (16-byte rows for its vector reductions), and the [rows, ch]
    view the caller gets, on the same storage."""
    buf, acc = kr.accumulator(1000, ch, "cpu")
    assert buf.shape == (1000, width) and buf.dtype == torch.float32
    assert acc.shape == (1000, ch) and acc.stride() == (width, 1)
    assert acc.data_ptr() == buf.data_ptr() and not bool(buf.any())
    assert buf.stride(0) * buf.element_size() % 16 == 0
    assert acc.is_contiguous() == (ch == width)


class _ViewGrad(torch.autograd.Function):
    """Identity in the corner table whose backward hands autograd the
    accumulator's view, as ``ResolveScene`` does on the card."""

    @staticmethod
    def forward(ctx, corners):
        ctx.shape = corners.shape
        return corners.sum()

    @staticmethod
    def backward(ctx, g):
        rows, ch = int(np.prod(ctx.shape[:-1])), ctx.shape[-1]
        buf, acc = kr.accumulator(rows, ch, "cpu")
        acc.copy_(torch.arange(rows * ch, dtype=torch.float32).reshape(
            rows, ch) * g)
        buf[:, ch:] = float("nan")             # never read through the view
        return acc.reshape(ctx.shape)


@pytest.mark.parametrize("ch", [8, 9])
def test_accumulator_view_flows_through_the_corner_pack(ch):
    """The view as the corner table's gradient, through the fit's repack
    (``pack_cell_corners``: slices of the SDF, stacked) and its sum over
    three uses, gives the SDF the gradient a contiguous table gradient
    gives."""
    from vrt_torch.march.types import pack_cell_corners

    rng = np.random.default_rng(4)
    sdf = torch.from_numpy(rng.normal(size=(2, 9, 9, 9)).astype(np.float32))
    accel = torch.from_numpy(rng.integers(0, 40, (2, 8, 8, 8)).astype(
        np.int32)) if ch == 9 else None
    grads = []
    for view in (True, False):
        leaf = sdf.clone().requires_grad_(True)
        corners = pack_cell_corners(leaf, accel)
        assert corners.shape[-1] == ch
        if view:
            loss = sum(_ViewGrad.apply(corners) for _ in range(3))
        else:
            want = torch.arange(corners.numel(), dtype=torch.float32
                                ).reshape(corners.shape)
            loss = sum((corners * want).sum() for _ in range(3))
        (g,) = torch.autograd.grad(loss, [leaf])
        grads.append(g)
    assert bool(torch.isfinite(grads[0]).all())
    assert torch.equal(grads[0], grads[1])


class TestDispatch:
    """``resolve_scene``: everything goes through ``ResolveScene`` (on CPU
    tensors its plain versions), a caller whose instance transforms require
    a gradient too."""

    def _counted(self, monkeypatch):
        calls = {"forward": 0, "backward": 0}
        fwd = tren.resolve_scene_reference
        bwd = tren.resolve_scene_backward_reference

        def forward(*args):
            calls["forward"] += 1
            return fwd(*args)

        def backward(*args, **kwargs):
            calls["backward"] += 1
            return bwd(*args, **kwargs)

        monkeypatch.setattr(tren, "resolve_scene_reference", forward)
        monkeypatch.setattr(tren, "resolve_scene_backward_reference",
                            backward)
        return calls

    def test_cpu_graph_takes_the_closed_form(self, monkeypatch):
        ts = _scenes("chebyshev-bf16")[1]
        o, d, hit, inst, g_t, g_n = _marched(ts)
        want = _autograd(ts, o, d, hit, inst, g_t, g_n)
        with torch.no_grad():
            plain = tren.resolve_scene_reference(ts, o, d, hit, inst)
        calls = self._counted(monkeypatch)
        launches = (dict(kr.LAUNCHES), dict(k3.LAUNCHES))
        leaves = [o.clone().requires_grad_(True),
                  d.clone().requires_grad_(True),
                  ts.volumes.corners.clone().requires_grad_(True)]
        t, n, unlit = tren.resolve_scene(_with_corners(ts, leaves[2]),
                                         leaves[0], leaves[1], hit, inst)
        assert type(t.grad_fn).__name__ == "ResolveSceneBackward"
        assert t.requires_grad and n.requires_grad
        assert not unlit.requires_grad
        for a, b in zip((t, n, unlit), plain):
            assert torch.equal(a.detach().nan_to_num(), b.nan_to_num())
        got = torch.autograd.grad([t, n], leaves, [g_t, g_n])
        assert calls == {"forward": 1, "backward": 1}
        assert (kr.LAUNCHES, k3.LAUNCHES) == launches
        _assert_close(got[0], want[0], "g_o_w")
        _assert_close(got[1], want[1], "g_d_w")
        # the f32 sums, cast once to the table's dtype
        assert got[2].dtype == torch.bfloat16
        assert got[2].shape == leaves[2].shape
        assert torch.equal(got[2].reshape(want[2].shape),
                           tren.resolve_scene_backward_reference(
                               ts, o, d, hit, inst, g_t, g_n)[2].bfloat16())

    def test_no_graph_and_partial_gradients(self, monkeypatch):
        """Without anything to differentiate the forward runs alone; a
        fit of the table alone gets no ray gradients, a fit of the camera
        alone no table gradient."""
        ts = _scenes("octree-f32")[1]
        o, d, hit, inst, g_t, g_n = _marched(ts)
        calls = self._counted(monkeypatch)
        t, n, _ = tren.resolve_scene(ts, o, d, hit, inst)
        assert not t.requires_grad and not n.requires_grad
        assert calls == {"forward": 1, "backward": 0}
        want = tren.resolve_scene_backward_reference(ts, o, d, hit, inst,
                                                     g_t, g_n)
        corners = ts.volumes.corners.clone().requires_grad_(True)
        t, n, _ = tren.resolve_scene(_with_corners(ts, corners), o, d, hit,
                                     inst)
        (g_c,) = torch.autograd.grad([t, n], [corners], [g_t, g_n])
        assert torch.equal(g_c.reshape(want[2].shape), want[2])
        ow = o.clone().requires_grad_(True)
        t, n, _ = tren.resolve_scene(ts, ow, d, hit, inst)
        (g_o,) = torch.autograd.grad([t, n], [ow], [g_t, g_n])
        assert torch.equal(g_o, want[0])
        # a strided ray tensor (a light direction expanded over the rays)
        dw = d[0].clone().requires_grad_(True)
        t, n, _ = tren.resolve_scene(ts, o, dw.expand(d.shape), hit, inst)
        (g_d,) = torch.autograd.grad([t, n], [dw], [g_t, g_n])
        assert g_d.shape == (3,) and bool(torch.isfinite(g_d).all())

    def test_instance_transforms_take_the_plain_path(self, monkeypatch):
        """A caller whose instance transforms require a gradient goes
        through ``ResolveScene`` too (on CPU tensors: the closed form with
        ``instances``), and gets what autograd over
        ``resolve_scene_reference`` gives, the transforms' and the table's
        gradients within the closed form's gates."""
        ts = _scenes("octree-f32")[1]
        o, d, hit, inst, g_t, g_n = _marched(ts)
        calls = self._counted(monkeypatch)
        grads = []
        for fn, node in ((tren.resolve_scene, "ResolveSceneBackward"),
                         (tren.resolve_scene_reference, None)):
            leaves = [ts.inst_pos.clone().requires_grad_(True),
                      ts.inst_scale.clone().requires_grad_(True),
                      ts.volumes.corners.clone().requires_grad_(True)]
            scene = dataclasses.replace(
                _with_corners(ts, leaves[2]), inst_pos=leaves[0],
                inst_scale=leaves[1])
            t, n, _ = fn(scene, o, d, hit, inst)
            assert (type(t.grad_fn).__name__ == "ResolveSceneBackward") \
                == (node is not None)
            grads.append(torch.autograd.grad([t, n], leaves, [g_t, g_n]))
        assert calls == {"forward": 2, "backward": 1}
        for name, a, b in zip(("inst_pos", "inst_scale", "corners"),
                              *grads):
            _assert_close(a, b, name)
            assert bool(a.any()), name

    def test_resolve_scene_rejects_foreign_tables(self):
        ts = _scenes("octree-f32")[1]
        o, d, hit, inst, _, _ = _marched(ts)
        transforms = [ts.inst_pos, ts.inst_rot, ts.inst_scale]
        with pytest.raises(ValueError, match="corner"):
            kr.ResolveScene.apply(o, d, ts.volumes.corners.clone(),
                                  *transforms, ts, hit, inst)
        transforms[1] = transforms[1].clone()
        with pytest.raises(ValueError, match="inst_rot"):
            kr.ResolveScene.apply(o, d, ts.volumes.corners, *transforms, ts,
                                  hit, inst)


@pytest.mark.parametrize("rays_grad", [True, False])
def test_instance_variant_refuses_the_first_design(rays_grad):
    """The backward's first design has no instance variant: asking for one
    raises before anything is checked, built or launched."""
    ts = _scenes("octree-f32")[1]
    o, d, hit, inst, g_t, g_n = _marched(ts, size=16)
    before = (dict(kr.LAUNCHES), dict(kr.VARIANT_LAUNCHES))
    with pytest.raises(ValueError, match="first design has no instance"):
        kr.resolve_scene_backward_cuda(ts, o, d, hit, inst, g_t, g_n,
                                       rays_grad, _old_design=True,
                                       instances=True)
    assert (kr.LAUNCHES, kr.VARIANT_LAUNCHES) == before


# The forward's first design stays behind ``_old_design``, the comparator
# of ``chip_smoke.py``; neither design has a CPU path.

@pytest.mark.parametrize("old_design", [False, True], ids=["new", "old"])
@pytest.mark.parametrize("wrapper", ["scene", "slab"])
def test_forward_wrappers_refuse_cpu_tensors(wrapper, old_design):
    """Either design of the fused resolve forward takes CUDA tensors only:
    on CPU tensors both wrappers raise and launch nothing (the dispatcher
    runs the plain version there)."""
    ts = _scenes("octree-f32")[1]
    o, d, hit, inst, _, _ = _marched(ts, size=16)
    before = dict(kr.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "scene":
            kr.resolve_scene_cuda(ts, o, d, hit, inst,
                                  _old_design=old_design)
        else:
            kr.resolve_slab_cuda(ts, None, o, d, hit, inst,
                                 _old_design=old_design)
    assert kr.LAUNCHES == before
