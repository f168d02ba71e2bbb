"""Gradients of vrt_torch's frame: the port's own IFT-at-the-root gradients
against central finite differences of the port (the ``tests/test_grad.py``
analogs, at its thresholds), and the port's loss and gradients against
``jax.value_and_grad`` of the same loss in ``vrt`` on the same scene state
(``scene_from_numpy``).

Tolerances against vrt: the loss to rtol 1e-5; each gradient tensor to a
cosine of at least 0.999999 and a largest difference of at most
1e-4 * max|g| (f32).  Both packages differentiate the same arithmetic in
float32; they differ only by summation order and by XLA's CPU FMAs in the
march (ROADMAP, Queue 3), which move t in its last bits.  Measured on these
scenes: cosines within 1e-9 of 1 and differences below 1e-5 * max|g|.
bf16 corner tables accumulate their cotangents in bf16 in both packages
(the plain scatter; ``vrt``'s active transpose, isosurface.py:157) in
different orders, so their gradients agree to bf16 rounding: cosine 0.999
and 2e-2 * max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_host import scene_fields
from vrt.core import quat as vq
from vrt.core.material import Material
from vrt.render.gpuscene import RenderMode as VMode
from vrt.render.gpuscene import build_scene as vbuild
from vrt.render.camera import camera_rays as vrays
from vrt.render.renderer import tonemap as vtonemap
from vrt.render.renderer import trace_radiance as vtrace
from vrt.volume import sdf as S
from vrt.volume.volume import VoxelVolume
from vrt_torch.diff import fit as tfit
from vrt_torch.diff.optim import adam
from vrt_torch.march import isosurface as tiso
from vrt_torch.march import march as tmarch
from vrt_torch.march import resolve as tresolve
from vrt_torch.march.types import DeviceVolume, pack_cell_corners
from vrt_torch.render.camera import camera_rays
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
from vrt_torch.render.renderer import tonemap, trace_radiance
from vrt_torch.volume.volume import VoxelVolume as TVolume
from vrt_torch.volume import sdf as TS

vfit = __import__("vrt.diff.fit", fromlist=["fit"])

torch.set_num_threads(2)

COS_F32, DIFF_F32 = 1e-6, 1e-4
COS_BF16, DIFF_BF16 = 1e-3, 2e-2


def _sphere_scene(resolution=3, use_colors=False, march_dtype=None):
    """``tests/test_grad.py``'s scene, built by vrt."""
    vol = VoxelVolume.from_generator(
        S.Sphere(radius=50.0), resolution, 100.0,
        material=Material(albedo=(0.8, 0.3, 0.3, 1.0), roughness=0.8))
    colors = None
    if use_colors:
        n = vol.n_voxels
        colors = np.random.default_rng(0).uniform(
            0.2, 0.8, size=(1, n, n, n, 3)).astype(np.float32)
    return vbuild(
        [vol], [{"volume": 0}],
        camera={"position": (300.0, 0.0, 0.0),
                "rotation": np.asarray(vq.from_euler_degrees(0.0, 180.0,
                                                             0.0)),
                "fov": 60.0},
        dir_light={"direction": np.asarray(vq.forward_vector(
            vq.from_euler_degrees(0.0, 45.0, -30.0))), "strength": 3.0},
        voxel_colors=colors, march_dtype=march_dtype)


def _port_loss(ts, width=24, height=24):
    """``sum(tonemap(rgb)^2)`` of the frame, as a function of params; the
    rays come from the grafted camera, so 'cam_pos' has a gradient."""

    def loss(params):
        s = tfit.rebuild_accel(tfit.graft_params(ts, params))
        o, d = camera_rays(s.cam_pos, s.cam_rot, s.cam_fov, width, height)
        return torch.sum(tonemap(trace_radiance(s, o, d, 0, RenderMode()))
                         ** 2)

    return loss


def _vrt_loss(vs, width=24, height=24):

    def loss(params):
        s = vfit.rebuild_accel(vfit.graft_params(vs, params))
        o, d = vrays(s.cam_pos, s.cam_rot, s.cam_fov, width, height)
        return jnp.sum(vtonemap(vtrace(s, o, d, 0, VMode())) ** 2)

    return loss


def _value(loss, params):
    with torch.no_grad():
        return float(loss(params))


def assert_grads_close(got, want, cos_tol, diff_tol, tag):
    a = np.asarray(want, np.float64).ravel()
    b = got.detach().double().numpy().ravel()
    assert np.isfinite(b).all(), tag
    scale = np.abs(a).max()
    assert scale > 0, tag
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 1.0 - cos_tol, (tag, 1.0 - cos)
    assert np.abs(a - b).max() <= diff_tol * scale, (
        tag, np.abs(a - b).max() / scale)


class TestHitTGradient:
    """d t_hit / d sdf against finite differences of the whole march."""

    def test_ift_matches_finite_difference(self):
        vol = TVolume.from_generator(TS.Sphere(radius=50.0), 4, 100.0)
        dv = DeviceVolume.from_volume(vol, device="cpu")
        rng = np.random.default_rng(5)
        dirs = rng.normal(size=(6, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        o = torch.from_numpy(-dirs * 280.0)
        d = torch.from_numpy(dirs)
        tm = torch.full((6,), 1e4)
        vid = torch.zeros(6, dtype=torch.int32)
        n = dv.n[None].expand(6)

        def t_sum(sdf):
            corners = pack_cell_corners(sdf)
            vols = DeviceVolume(
                sdf=sdf[None], materials=dv.materials[None],
                accel=dv.accel[None], n=dv.n[None],
                cell_size=dv.cell_size[None], extends=dv.extends[None],
                corners=corners[None])
            with torch.no_grad():
                hit = tmarch.march_lanes(vols, vid, o, d, tm)
            cfetch = tiso.make_stacked_corner_fetch(vols.corners, n,
                                                    vid.long())
            t, _, _ = tresolve.resolve_hits(
                cfetch, dv.cell_size.expand(6), dv.extends.expand(6), o, d,
                hit)
            return torch.sum(torch.where(hit.hit, t, 0.0))

        sdf = dv.sdf.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(t_sum(sdf), sdf)
        g = g.numpy()
        assert (np.abs(g) > 1e-4).sum() >= 8, "no gradient on hit corners"
        base = dv.sdf.numpy()
        eps = 0.05
        for flat_idx in np.argsort(-np.abs(g).ravel())[:5]:
            idx = np.unravel_index(flat_idx, g.shape)
            p, m = base.copy(), base.copy()
            p[idx] += eps
            m[idx] -= eps
            with torch.no_grad():
                fd = (float(t_sum(torch.from_numpy(p)))
                      - float(t_sum(torch.from_numpy(m)))) / (2 * eps)
            assert fd == pytest.approx(float(g[idx]), rel=0.08, abs=1e-3), idx

    def test_forward_value_is_the_march_t(self):
        """The IFT correction is zero-valued: with a graph recorded, the
        frame's pixels equal the no-graph frame's bit for bit."""
        ts = scene_from_numpy(
            scene_fields(_sphere_scene(use_colors=True)), device="cpu")
        loss = _port_loss(ts)
        params = {"sdf": ts.volumes.sdf.clone().requires_grad_(True)}
        assert float(loss(params).detach()) == _value(loss, params)


class TestPixelGradients:
    """The port's pixel gradients against central finite differences of
    the port, at ``tests/test_grad.py``'s thresholds."""

    def test_sdf_pixel_grad_vs_fd(self):
        ts = scene_from_numpy(scene_fields(_sphere_scene()), device="cpu")
        loss = _port_loss(ts)
        _, g = tfit._value_and_grad(loss, {"sdf": ts.volumes.sdf})
        g = g["sdf"].numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 1e-5
        base = ts.volumes.sdf.numpy()
        eps = 0.1
        for flat_idx in np.argsort(-np.abs(g).ravel())[:3]:
            idx = np.unravel_index(flat_idx, g.shape)
            p, m = base.copy(), base.copy()
            p[idx] += eps
            m[idx] -= eps
            fd = (_value(loss, {"sdf": torch.from_numpy(p)})
                  - _value(loss, {"sdf": torch.from_numpy(m)})) / (2 * eps)
            assert fd == pytest.approx(float(g[idx]), rel=0.15, abs=5e-4), idx

    def test_voxel_color_grad_vs_fd(self):
        ts = scene_from_numpy(
            scene_fields(_sphere_scene(use_colors=True)), device="cpu")
        loss = _port_loss(ts)
        _, g = tfit._value_and_grad(loss, {"voxel_colors": ts.voxel_colors})
        g = g["voxel_colors"].numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 1e-6
        base = ts.voxel_colors.numpy()
        idx = np.unravel_index(int(np.argmax(np.abs(g))), g.shape)
        eps = 0.05
        p, m = base.copy(), base.copy()
        p[idx] += eps
        m[idx] -= eps
        fd = (_value(loss, {"voxel_colors": torch.from_numpy(p)})
              - _value(loss, {"voxel_colors": torch.from_numpy(m)})) / (2 * eps)
        assert fd == pytest.approx(float(g[idx]), rel=0.05, abs=1e-5)

    def test_camera_pos_grad_vs_fd(self):
        ts = scene_from_numpy(scene_fields(_sphere_scene()), device="cpu")
        base = ts.cam_pos.numpy()
        loss = _port_loss(ts)
        _, g = tfit._value_and_grad(loss, {"cam_pos": ts.cam_pos})
        g = g["cam_pos"].numpy()
        assert np.isfinite(g).all()
        eps = 0.5
        for axis in range(3):
            p, m = base.copy(), base.copy()
            p[axis] += eps
            m[axis] -= eps
            fd = (_value(loss, {"cam_pos": torch.from_numpy(p)})
                  - _value(loss, {"cam_pos": torch.from_numpy(m)})) / (2 * eps)
            # traversal choices carry no gradient: loose agreement, as in vrt
            if abs(fd) > 1e-3:
                assert np.sign(fd) == np.sign(g[axis]) or \
                    fd == pytest.approx(float(g[axis]), rel=0.5, abs=2e-3)

    def test_tint_grad(self):
        ts = scene_from_numpy(scene_fields(_sphere_scene()), device="cpu")
        _, g = tfit._value_and_grad(_port_loss(ts), {"tint": ts.tint})
        g = g["tint"].numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 1e-4


@pytest.fixture(scope="module")
def sphere_grads():
    """vrt's loss and gradients of the sphere scene with colours for the
    SDF, the colours and the camera at once (one JAX compile); the colours
    replace the tint as albedo, so the tint has no gradient here."""
    vs = _sphere_scene(use_colors=True)
    params = {"sdf": vs.volumes.sdf, "voxel_colors": vs.voxel_colors,
              "cam_pos": vs.cam_pos}
    loss, grads = jax.jit(jax.value_and_grad(_vrt_loss(vs)))(params)
    return vs, float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_grads_match_vrt(sphere_grads):
    vs, want_loss, want = sphere_grads
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    params = {"sdf": ts.volumes.sdf, "voxel_colors": ts.voxel_colors,
              "cam_pos": ts.cam_pos}
    got_loss, got = tfit._value_and_grad(_port_loss(ts), params)
    assert float(got_loss) == pytest.approx(want_loss, rel=1e-5)
    for k in params:
        assert_grads_close(got[k], want[k], COS_F32, DIFF_F32, k)


def test_bf16_table_grads_match_vrt():
    """bf16 corner and colour tables (the benched fast-march layout):
    gradients through the bf16 repacks and the bf16 scatters."""
    vs = _sphere_scene(use_colors=True, march_dtype=jnp.bfloat16)
    params = {"sdf": vs.volumes.sdf, "voxel_colors": vs.voxel_colors}
    want_loss, want = jax.jit(jax.value_and_grad(_vrt_loss(vs, 16, 16)))(params)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    assert ts.volumes.corners.dtype == torch.bfloat16
    assert ts.voxel_color_corners.dtype == torch.bfloat16
    got_loss, got = tfit._value_and_grad(
        _port_loss(ts, 16, 16),
        {"sdf": ts.volumes.sdf, "voxel_colors": ts.voxel_colors})
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-4)
    for k in params:
        assert_grads_close(got[k], want[k], COS_BF16, DIFF_BF16, k)


def test_fit_step_view_matches_vrt():
    """``make_fit_step_view`` with the camera as a step argument, the
    headlamp light and update smoothing: three steps over two alternating
    views (the second looks away from the volume) against vrt's, losses
    to rtol 1e-4."""
    vs = _sphere_scene(use_colors=True)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    kw = dict(light_follows_camera=True, sdf_smooth=0.3)
    vstep = vfit.make_fit_step_view(vs, 16, 16, VMode(), optax.adam(1e-2),
                                    **kw)
    opt = adam(1e-2)
    tstep = tfit.make_fit_step_view(ts, 16, 16, RenderMode(), opt, **kw)
    vp = {"sdf": vs.volumes.sdf, "voxel_colors": vs.voxel_colors}
    tp = {"sdf": ts.volumes.sdf, "voxel_colors": ts.voxel_colors}
    vstate, tstate = optax.adam(1e-2).init(vp), opt.init(tp)
    rots = [np.asarray([0.0, 0.0, 1.0, 0.0], np.float32),
            np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)]
    pos = np.asarray([300.0, 0.0, 0.0], np.float32)
    tgt = np.zeros((256, 3), np.float32)
    vl, tl = [], []
    for i in range(3):
        vp, vstate, loss = vstep(vp, vstate, jnp.asarray(pos),
                                 jnp.asarray(rots[i % 2]), jnp.asarray(60.0),
                                 jnp.asarray(tgt))
        vl.append(float(loss))
        tp, tstate, loss = tstep(tp, tstate, torch.from_numpy(pos),
                                 torch.from_numpy(rots[i % 2]),
                                 torch.tensor(60.0), torch.from_numpy(tgt))
        tl.append(float(loss))
    assert all(np.isfinite(tl)) and tl[0] != tl[1]
    np.testing.assert_allclose(tl, vl, rtol=1e-4)
