"""The march and resolve of vrt_torch against vrt.

``march_lanes_reference`` (K1's plain twin) against ``vrt``'s
``march_lanes`` on two stacked resolution-5 volumes, and against the
retired Pallas kernel in interpret mode; the isosurface maths and the hit
resolve against ``vrt``'s.  K1 itself is held against the twin in
tests/test_torch_kernels.py, which runs on the card.

Tolerances: hit and kind agree on every lane (``LANE_BUDGET`` 0; up to
0.5% would be defensible, and none is needed on these lanes).  t is not
bit-exact: XLA's CPU backend contracts some multiply-adds into FMAs (the
leave-one-out sums of the cubic coefficients) where the eager twin rounds
each operation, so t differs in its last bits on about a fifth of surface
hits.  Where both hit with the same kind, t agrees to rtol 1e-4, the cell
exactly, the face normal with NaNs equal (the reference's zero-sign-triple
entry face), and the step counts exactly.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from vrt.march import isosurface as viso
from vrt.march import march as vmarch
from vrt.march import resolve as vresolve
from vrt.render import renderer as vren
from vrt_torch.march import isosurface as tiso
from vrt_torch.march import march as tmarch
from vrt_torch.march import resolve as tresolve
from vrt_torch.march.types import DeviceVolume
from vrt_torch.render import renderer as tren
from vrt_torch.render.gpuscene import scene_from_numpy
from tests.test_torch_host import scene_fields

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from pallas_march import march_volume_pallas  # noqa: E402

torch.set_num_threads(2)

LANE_BUDGET = 0.0
CONFIGS = {"octree-f32": ("octree", None),
           "chebyshev-f32": ("chebyshev", None),
           "chebyshev-bf16": ("chebyshev", jnp.bfloat16)}


def random_lanes(seed, n=6144):
    """Rays aimed near the volumes from outside and from inside the box
    (the origin-inside branch), a third with finite t_max clamps."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(40.0, 260.0, size=(n, 1)).astype(np.float32)
    o = (-d * dist + rng.normal(scale=30.0, size=(n, 3))).astype(np.float32)
    # a few unnormalised directions, as camera rays are
    d[: n // 8] *= rng.uniform(0.5, 2.0, size=(n // 8, 1)).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.35,
                     rng.uniform(0.0, 300.0, size=n), 1e4).astype(np.float32)
    vid = rng.integers(0, 2, size=n).astype(np.int32)
    return o, d, t_max, vid


def assert_march_close(got, want, budget=LANE_BUDGET, min_hits=100):
    """Both MarchHits as numpy dicts."""
    agree = (got["hit"] == want["hit"]) & (got["kind"] == want["kind"])
    assert agree.mean() >= 1.0 - budget, 1.0 - agree.mean()
    both = agree & want["hit"]
    assert both.sum() > min_hits
    np.testing.assert_allclose(got["t"][both], want["t"][both], rtol=1e-4)
    np.testing.assert_array_equal(got["cell"][both], want["cell"][both])
    np.testing.assert_allclose(got["face_normal"][both],
                               want["face_normal"][both], rtol=1e-6,
                               equal_nan=True)
    if "steps" in want:
        np.testing.assert_array_equal(got["steps"][agree],
                                      want["steps"][agree])


def hit_np(h, fields=("hit", "t", "kind", "cell", "face_normal", "steps")):
    out = {}
    for f in fields:
        v = getattr(h, f)
        if v is not None:
            out[f] = v.cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


_PAIRS = {}


def _pair(config):
    """The flagship at resolution 5 in ``config``, as (vrt scene, the
    port's scene on the CPU); built once per config."""
    if config not in _PAIRS:
        mode, dtype = CONFIGS[config]
        vs = ge._flagship_scene(resolution=5, accel_mode=mode,
                                march_dtype=dtype)
        _PAIRS[config] = vs, scene_from_numpy(scene_fields(vs), device="cpu")
    return _PAIRS[config]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def stacked(request):
    return _pair(request.param)


_vrt_march_lanes = jax.jit(vmarch.march_lanes,
                           static_argnames=("interp", "debug_overlay"))


class TestMarchTwin:
    def test_matches_vrt_march_lanes(self, stacked):
        vs, ts = stacked
        o, d, t_max, vid = random_lanes(0)
        want = _vrt_march_lanes(vs.volumes, jnp.asarray(vid), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(t_max))
        got = tmarch.march_lanes(ts.volumes, torch.from_numpy(vid),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(t_max))
        w, g = hit_np(want), hit_np(got)
        assert set(np.unique(w["kind"])) >= {0, 1}
        t_enter = vmarch.ray_aabb(jnp.asarray(o), jnp.asarray(d), -100.0,
                                  100.0, jnp.inf)[1]
        assert (np.asarray(t_enter) < 0).sum() > 100   # origins inside
        assert ((t_max < 1e4) & w["hit"]).sum() > 50   # clamped hits
        assert_march_close(g, w)
        hit = w["hit"] & (w["kind"] == 1)
        np.testing.assert_allclose(g["t"][hit], w["t"][hit], rtol=1e-4)
        np.testing.assert_array_equal(hit_np(got, ("t_in",))["t_in"][hit],
                                      np.asarray(want.t_in)[hit])

    @pytest.mark.parametrize("accel_mode", ["octree", "chebyshev"])
    def test_exhausted_and_solid_entry_lanes(self, accel_mode):
        """On a slab that fills the volume's sides: diagonal rays skimming
        just above its top take one step per cell crossing, run out of
        steps and report the red hit at t = 10; rays entering a side face
        below the top start in a solid cell and report a solid-entry hit
        with the box-face normal; like vrt."""
        from vrt.render.gpuscene import build_scene as vbuild
        from vrt.volume import sdf as S
        from vrt.volume.volume import VoxelVolume

        slab = S.Box(extends=(500.0, 500.0, 10.0))
        vol = VoxelVolume.from_generator(slab, 7, 100.0)
        vs = vbuild([vol], [{"volume": 0}], camera={}, accel_mode=accel_mode)
        ts = scene_from_numpy(scene_fields(vs), device="cpu")
        o = np.asarray([[-150.0, -149.7, 12.2], [-150.0, -149.2, 11.6],
                        [-150.0, -150.0, 30.0], [-150.0, 3.0, 0.0],
                        [20.0, 160.0, -5.0], [-150.0, 3.0, 0.0]], np.float32)
        d = np.asarray([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [1.0, 1.0, -0.1],
                        [1.0, 0.01, 0.02], [0.1, -2.0, 0.0],
                        [1.0, 0.01, 0.02]], np.float32)
        t_max = np.asarray([1e4] * 5 + [20.0], np.float32)
        vid = np.zeros(6, np.int32)
        want = _vrt_march_lanes(vs.volumes, jnp.asarray(vid), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(t_max))
        got = tmarch.march_lanes(ts.volumes, torch.from_numpy(vid),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(t_max))
        w, g = hit_np(want), hit_np(got)
        assert set(w["kind"][:5]) == {1, 2, 3}
        assert not w["hit"][5]  # solid entry beyond t_max: no hit
        for k in ("hit", "kind", "steps", "cell"):
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_allclose(g["t"], w["t"], rtol=1e-4)
        np.testing.assert_array_equal(g["face_normal"], w["face_normal"])

    def test_matches_pallas_kernel(self):
        """The twin on one volume against the retired Pallas kernel in
        interpret mode, under the assertions of tests/test_pallas.py."""
        from vrt.march.types import DeviceVolume as VDeviceVolume
        from vrt.volume import sdf as S
        from vrt.volume.volume import VoxelVolume

        vvol = VDeviceVolume.from_volume(
            VoxelVolume.from_generator(S.Sphere(radius=50.0), 4, 100.0))
        tvol = DeviceVolume(**{
            f.name: (getattr(vvol, f.name) if f.name == "accel_mode" else
                     torch.from_numpy(np.array(getattr(vvol, f.name)))[None])
            for f in dataclasses.fields(DeviceVolume)})
        rng = np.random.default_rng(0)
        r = 256
        dirs = rng.normal(size=(r, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        o = (-dirs * 280.0
             + rng.normal(scale=20, size=(r, 3)).astype(np.float32))
        tm = np.full(r, 1e4, np.float32)

        ref = march_volume_pallas(vvol, jnp.asarray(o), jnp.asarray(dirs),
                                  jnp.asarray(tm), interpret=True)
        pk = tmarch.march_lanes(tvol, torch.zeros(r, dtype=torch.int32),
                                torch.from_numpy(o), torch.from_numpy(dirs),
                                torch.from_numpy(tm))

        np.testing.assert_array_equal(np.asarray(ref.hit), pk.hit.numpy())
        np.testing.assert_array_equal(np.asarray(ref.kind), pk.kind.numpy())
        both = np.asarray(ref.hit)
        assert both.sum() > 50
        np.testing.assert_allclose(np.asarray(ref.t)[both],
                                   pk.t.numpy()[both], rtol=1e-4)
        np.testing.assert_array_equal(np.asarray(ref.cell)[both],
                                      pk.cell.numpy()[both])

    def test_dispatch(self, stacked):
        """On the CPU every mode goes to the twin; K1's wrapper refuses CPU
        tensors instead of falling back."""
        _, ts = stacked
        o, d, t_max, vid = (torch.from_numpy(x) for x in random_lanes(1, 64))
        for interp, debug in [(True, False), (False, False), (True, True)]:
            got = tmarch.march_lanes(ts.volumes, vid, o, d, t_max,
                                     interp=interp, debug_overlay=debug)
            want = tmarch.march_lanes_reference(ts.volumes, vid, o, d, t_max,
                                                interp, debug)
            assert_march_close(hit_np(got), hit_np(want), budget=0.0,
                               min_hits=1)
        with pytest.raises(ValueError):
            from vrt_torch.kernels import march as k1
            k1.march_lanes_cuda(ts.volumes, vid, o, d, t_max)

    @pytest.mark.parametrize("interp,debug", [(False, False), (True, True),
                                              (False, True)],
                             ids=["cube", "interp-overlay", "cube-overlay"])
    def test_cube_and_overlay_match_vrt(self, stacked, interp, debug):
        """Cube mode and the debug overlay against vrt's march_lanes on the
        same lanes: hit and kind on every lane; where they agree, t_in,
        t_out, the cell, the face normal (NaN for the zero-sign-triple
        entry face) and steps exactly; t to rtol 1e-4 (XLA's CPU FMAs can
        move an interp root's last bits; cube and overlay hits take a node
        entry t, which is exact)."""
        vs, ts = stacked
        o, d, t_max, vid = random_lanes(2)
        want = _vrt_march_lanes(vs.volumes, jnp.asarray(vid), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(t_max),
                                interp=interp, debug_overlay=debug)
        got = tmarch.march_lanes(ts.volumes, torch.from_numpy(vid),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(t_max), interp=interp,
                                 debug_overlay=debug)
        fields = ("hit", "t", "kind", "cell", "face_normal", "steps", "t_in",
                  "t_out")
        w, g = hit_np(want, fields), hit_np(got, fields)
        kinds = set(np.unique(w["kind"][w["hit"]]))
        assert (4 if not interp else 1) in kinds, kinds
        if debug:
            assert 5 in kinds, kinds
        assert_march_close(g, w)
        agree = (g["hit"] == w["hit"]) & (g["kind"] == w["kind"])
        for f in ("t_in", "t_out"):
            np.testing.assert_array_equal(g[f][agree], w[f][agree])
        exact = agree & w["hit"] & (w["kind"] != 1)
        np.testing.assert_array_equal(g["t"][exact], w["t"][exact])


class TestMarchScene:
    def test_scene_march_and_resolve(self, stacked):
        """march_scene (entry-t candidate order, t_max clamps) and
        resolve_scene on primary and shadow rays."""
        vs, ts = stacked
        from vrt.render.camera import camera_rays

        o, d = camera_rays(vs.cam_pos, vs.cam_rot, vs.cam_fov, 48, 48)
        o, d = np.array(o), np.array(d)
        t_max = np.full(o.shape[0], 1e4, np.float32)
        vh, vinst = jax.jit(vren.march_scene, static_argnames=(
            "interp", "debug_overlay", "lane_marcher"))(
            vs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), True)
        to, td = torch.from_numpy(o), torch.from_numpy(d)
        th, tinst = tren.march_scene(ts, to, td, torch.from_numpy(t_max))
        w, g = hit_np(vh), hit_np(th)
        assert_march_close(g, w)
        np.testing.assert_array_equal(tinst.numpy(), np.asarray(vinst))

        vt, vn, vu = vren.resolve_scene(vs, jnp.asarray(o), jnp.asarray(d),
                                        vh, vinst)
        tt, tn, tu = tren.resolve_scene(ts, to, td, th, tinst)
        hit = w["hit"] & g["hit"]
        np.testing.assert_allclose(tt.numpy()[hit], np.asarray(vt)[hit],
                                   rtol=1e-4)
        np.testing.assert_allclose(tn.numpy()[hit], np.asarray(vn)[hit],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(vu))

        so = o + np.where(w["hit"], np.asarray(vt), 0.0)[:, None] * d - d * 0.1
        sd = np.broadcast_to(np.asarray(vs.dir_light_dir), so.shape).copy()
        sm = np.where(w["hit"], 5000.0, -np.inf).astype(np.float32)
        vsh = vren.trace_shadow(vs, jnp.asarray(so), jnp.asarray(sd),
                                jnp.asarray(sm), 1, True)
        tsh = tren.trace_shadow(ts, torch.from_numpy(so),
                                torch.from_numpy(sd), torch.from_numpy(sm),
                                1, True)
        assert (tsh.numpy() == np.asarray(vsh)).mean() >= 1.0 - LANE_BUDGET
        assert tren.trace_shadow(ts, torch.from_numpy(so),
                                 torch.from_numpy(sd), torch.from_numpy(sm),
                                 3, True).sum() == 0


def _crowd_scene(name):
    """vrt scenes of many instances over two resolution-4 volumes.
    "overlap": a sphere and a holed box at the same position (equal boxes,
    so equal entry t: the stable order decides), a rotated, scaled sphere
    overlapping them, and an inactive box in front of all three.
    "twelve": ``vrt/apps/bench.py``'s 12-instance grid."""
    from vrt.core import quat as vq
    from vrt.render.gpuscene import build_scene as vbuild
    from vrt.volume import sdf as S
    from vrt.volume.volume import VoxelVolume

    sphere = VoxelVolume.from_generator(S.Sphere(radius=45.0), 4, 100.0)
    csg = S.CSG(shape=S.Box(extends=(40.0, 40.0, 40.0)))
    csg.add_child(S.Sphere(radius=50.0), S.SUBTRACT)
    box = VoxelVolume.from_generator(csg, 4, 100.0)
    if name == "overlap":
        insts = [{"volume": 0, "position": (0.0, -20.0, 0.0)},
                 {"volume": 1, "position": (0.0, -20.0, 0.0)},
                 {"volume": 0, "position": (30.0, 40.0, 10.0),
                  "rotation": np.asarray(vq.from_euler_degrees(0.0, 30.0,
                                                               10.0)),
                  "scale": (1.2, 0.8, 1.0)},
                 {"volume": 1, "position": (150.0, 0.0, 30.0)}]
        active = [True, True, True, False]
        cam = {"position": (320.0, 0.0, 40.0), "fov": 60.0}
    else:
        insts = []
        for i in range(12):
            gx, gy = divmod(i, 4)
            insts.append({"volume": i % 2,
                          "position": (-160.0 * gx, 170.0 * (gy - 1.5),
                                       60.0 * ((i % 3) - 1))})
        active = [True] * 12
        cam = {"position": (430.0, 0.0, 60.0), "fov": 70.0}
    cam["rotation"] = np.asarray(vq.from_euler_degrees(0.0, 180.0, 0.0))
    vs = vbuild([sphere, box], insts, camera=cam, accel_mode="chebyshev")
    return dataclasses.replace(vs, inst_active=jnp.asarray(active))


def _torch_hit(vh):
    """A vrt MarchHit as the port's, on the CPU."""
    from vrt_torch.march.types import MarchHit

    return MarchHit(**{f.name: torch.from_numpy(np.array(getattr(vh, f.name)))
                       for f in dataclasses.fields(MarchHit)})


_vrt_march_scene = jax.jit(vren.march_scene, static_argnames=(
    "interp", "debug_overlay", "lane_marcher"))


class TestSceneMarchPlain:
    """``march_scene_reference`` (the scene march kernel's plain version)
    and the no-graph ``resolve_scene`` against vrt's.  Same tolerances as
    above: hit, kind, cell, the winning instance and the summed steps agree
    on every lane, t to rtol 1e-4 (XLA's CPU FMAs)."""

    @pytest.mark.parametrize("interp", [True, False], ids=["interp", "cube"])
    @pytest.mark.parametrize("name", ["overlap", "twelve"])
    def test_matches_vrt_march_scene(self, name, interp):
        from vrt.render.camera import camera_rays

        vs = _crowd_scene(name)
        ts = scene_from_numpy(scene_fields(vs), device="cpu")
        o, d = camera_rays(vs.cam_pos, vs.cam_rot, vs.cam_fov, 56, 56)
        o, d = np.array(o), np.array(d)
        rng = np.random.default_rng(11)
        r = o.shape[0]
        t_max = np.where(rng.uniform(size=r) < 0.2,
                         rng.uniform(200.0, 500.0, size=r),
                         1e4).astype(np.float32)
        t_max[rng.uniform(size=r) < 0.1] = -np.inf
        vh, vinst = _vrt_march_scene(vs, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t_max), interp)
        args = (ts, torch.from_numpy(o), torch.from_numpy(d),
                torch.from_numpy(t_max), interp)
        th, tinst = tren.march_scene(*args)
        w, g = hit_np(vh), hit_np(th)
        for f in ("hit", "kind", "cell", "steps"):
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
        np.testing.assert_array_equal(tinst.numpy(), np.asarray(vinst))
        hit = w["hit"]
        np.testing.assert_allclose(g["t"][hit], w["t"][hit], rtol=1e-4)
        assert np.isinf(g["t"][~hit]).all()
        assert not hit[np.isneginf(t_max)].any()
        winners = set(np.unique(np.asarray(vinst)[hit]))
        if name == "overlap":
            # both of the tied pair win somewhere, the inactive one never
            assert winners == {0, 1, 2}, winners
            assert (hit & (t_max < 1e4)).sum() > 20
        else:
            assert len(winners) >= 10, winners
        # the any-hit variant's plain version is the hit field
        any_hit = tren.march_scene_any_hit(*args)
        assert any_hit.dtype == torch.bool
        np.testing.assert_array_equal(any_hit.numpy(), g["hit"])

    @pytest.mark.parametrize("case,config", [("slab", None)] + [
        (c, k) for c in ("overlay", "cube") for k in sorted(CONFIGS)])
    def test_no_graph_resolve_matches_vrt(self, case, config):
        """``resolve_scene`` with nothing to differentiate, on every hit
        kind (surface, solid entry, exhausted on the slab; debug with the
        overlay; cube), with ``inst = -1`` on some lanes, against vrt's on
        the same hits: unlit equal, t and the normal to rtol 1e-5 (f32 on
        both sides, no root to refine)."""
        from vrt.render.camera import camera_rays

        if case == "slab":
            from vrt.render.gpuscene import build_scene as vbuild
            from vrt.volume import sdf as S
            from vrt.volume.volume import VoxelVolume

            vol = VoxelVolume.from_generator(
                S.Box(extends=(500.0, 500.0, 10.0)), 7, 100.0)
            vs = vbuild([vol], [{"volume": 0}], camera={})
            ts = scene_from_numpy(scene_fields(vs), device="cpu")
            o = np.asarray([[-150.0, -149.7, 12.2], [-150.0, -149.2, 11.6],
                            [-150.0, -150.0, 30.0], [-150.0, 3.0, 0.0],
                            [20.0, 160.0, -5.0], [-150.0, 3.0, 0.0]],
                           np.float32)
            d = np.asarray([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0],
                            [1.0, 1.0, -0.1], [1.0, 0.01, 0.02],
                            [0.1, -2.0, 0.0], [1.0, 0.01, 0.02]], np.float32)
            interp, overlay, kinds = True, False, {1, 2, 3}
        else:
            vs, ts = _pair(config)
            o, d = camera_rays(vs.cam_pos, vs.cam_rot, vs.cam_fov, 40, 40)
            o, d = np.array(o), np.array(d)
            interp, overlay = case == "overlay", case == "overlay"
            kinds = {1, 5} if overlay else {4}
        t_max = np.full(o.shape[0], 1e4, np.float32)
        vh, vinst = _vrt_march_scene(vs, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t_max), interp,
                                     debug_overlay=overlay)
        assert set(np.unique(np.asarray(vh.kind))) >= kinds
        inst = np.array(vinst)
        inst[::3] = -1
        assert (inst[np.asarray(vh.hit)] == -1).any()
        vt, vn, vu = vren.resolve_scene(vs, jnp.asarray(o), jnp.asarray(d),
                                        vh, jnp.asarray(inst))
        with torch.no_grad():
            tt, tn, tu = tren.resolve_scene(
                ts, torch.from_numpy(o), torch.from_numpy(d), _torch_hit(vh),
                torch.from_numpy(inst))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(vu))
        np.testing.assert_allclose(tt.numpy(), np.asarray(vt), rtol=1e-5)
        hit = np.asarray(vh.hit)
        np.testing.assert_allclose(tn.numpy()[hit], np.asarray(vn)[hit],
                                   rtol=1e-5, atol=1e-6, equal_nan=True)


class TestIsosurface:
    def _cubic_inputs(self, n=4096):
        rng = np.random.default_rng(3)
        v = rng.normal(size=(n, 8)).astype(np.float32)
        v[:16] = np.nan  # NaN coefficients: no hit, as jnp.sign(nan) = nan
        a1 = rng.uniform(size=(n, 3)).astype(np.float32)
        b1 = rng.normal(size=(n, 3)).astype(np.float32)
        t_in = rng.uniform(-5.0, 50.0, size=n).astype(np.float32)
        t_out = t_in + rng.uniform(0.1, 3.0, size=n).astype(np.float32)
        return v, a1, b1, t_in, t_out

    def test_cubic_and_root(self):
        v, a1, b1, t_in, t_out = self._cubic_inputs()
        vc = jax.jit(viso.cubic_coefficients)(v, a1, b1)
        tc = tiso.cubic_coefficients(*(torch.from_numpy(x)
                                       for x in (v, a1, b1)))
        for g, w in zip(tc, vc):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        # the root from the same coefficients
        vh, vt = jax.jit(viso.surface_intersection)(*vc, t_in, t_out)
        th, tt = tiso.surface_intersection(
            *(torch.from_numpy(np.array(c)) for c in vc),
            torch.from_numpy(t_in), torch.from_numpy(t_out))
        vh, vt = np.asarray(vh), np.asarray(vt)
        assert (th.numpy() == vh).mean() >= 0.999
        assert not th.numpy()[:16].any()
        both = vh & th.numpy()
        np.testing.assert_allclose(tt.numpy()[both], vt[both], rtol=1e-5)

    def test_sign_propagates_nan(self):
        x = torch.tensor([-2.0, -0.0, 0.0, 3.0, float("nan")])
        got = tiso.sign(x).numpy()
        want = np.asarray(jnp.sign(jnp.asarray(x.numpy())))
        np.testing.assert_array_equal(got, want)

    def test_trilinear_and_normal(self):
        rng = np.random.default_rng(4)
        rows = rng.normal(size=(512, 6, 8)).astype(np.float32)
        p = rng.uniform(-0.2, 1.2, size=(512, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tiso.trilinear_rows(torch.from_numpy(rows[:, 0]),
                                torch.from_numpy(p)).numpy(),
            np.asarray(viso.trilinear_rows(rows[:, 0], p)), rtol=1e-5,
            atol=1e-6)
        rows[:4] = 0.0  # zero gradient -> zero normal
        np.testing.assert_allclose(
            tiso.central_difference_normal_rows(torch.from_numpy(rows),
                                                torch.from_numpy(p)).numpy(),
            np.asarray(viso.central_difference_normal_rows(rows, p)),
            rtol=1e-5, atol=1e-5)

    def test_stacked_fetches(self, stacked):
        """Voxel and corner-row fetches with per-ray volumes, including
        out-of-range indices (which read 0), exactly as vrt's."""
        vs, ts = stacked
        rng = np.random.default_rng(8)
        r = 512
        vol = rng.integers(0, 2, size=r).astype(np.int32)
        n = np.asarray(vs.volumes.n)[vol]
        idx = rng.integers(-2, 36, size=(r, 7, 3)).astype(np.int32)
        want = viso.make_stacked_fetch(vs.volumes.sdf, jnp.asarray(n),
                                       jnp.asarray(vol))(jnp.asarray(idx))
        got = tiso.make_stacked_fetch(ts.volumes.sdf, torch.from_numpy(n),
                                      torch.from_numpy(vol))(
            torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = viso.make_stacked_corner_fetch(
            vs.volumes.corners, jnp.asarray(n), jnp.asarray(vol))(
            jnp.asarray(idx))
        got = tiso.make_stacked_corner_fetch(
            ts.volumes.corners, torch.from_numpy(n), torch.from_numpy(vol))(
            torch.from_numpy(idx))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).astype(np.float32))

    def test_slab_enter(self):
        rng = np.random.default_rng(5)
        o = rng.normal(scale=200.0, size=(256, 3)).astype(np.float32)
        d = rng.normal(size=(256, 3)).astype(np.float32)
        d[:8, 0] = 0.0
        ext = np.full((256, 1), 100.0, np.float32)
        np.testing.assert_allclose(
            tresolve._slab_enter(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(ext)).numpy(),
            np.asarray(vresolve._slab_enter(o, d, ext)), rtol=1e-6)


# ---- what the scene march's kernels rely on ----------------------------------

def _tied_scene(march_dtype):
    """Three instances over the port's resolution-4 sphere and holed box:
    the sphere and the box at one position (equal boxes, so equal entry t:
    the stable order keeps the lower index first), and a rotated, scaled
    sphere over them that is inactive."""
    from vrt_torch.core import quat as tq
    from vrt_torch.render.gpuscene import build_scene
    from vrt_torch.volume import sdf as TS
    from vrt_torch.volume.volume import VoxelVolume as TVolume

    sphere = TVolume.from_generator(TS.Sphere(radius=45.0), 4, 100.0)
    csg = TS.CSG(shape=TS.Box(extends=(40.0, 40.0, 40.0)))
    csg.add_child(TS.Sphere(radius=50.0), TS.SUBTRACT)
    box = TVolume.from_generator(csg, 4, 100.0)
    insts = [{"volume": 0, "position": (0.0, -20.0, 0.0)},
             {"volume": 1, "position": (0.0, -20.0, 0.0)},
             {"volume": 0, "position": (30.0, 40.0, 10.0),
              "rotation": np.asarray(tq.from_euler_degrees(0.0, 30.0, 10.0)),
              "scale": (1.2, 0.8, 1.0)}]
    cam = {"position": (320.0, 0.0, 40.0), "fov": 30.0,
           "rotation": np.asarray(tq.from_euler_degrees(0.0, 180.0, 0.0))}
    ts = build_scene([sphere, box], insts, camera=cam,
                     accel_mode="chebyshev", march_dtype=march_dtype,
                     device="cpu")
    return dataclasses.replace(
        ts, inst_active=torch.tensor([True, True, False]))


def _bits(x):
    """A tensor's bits, so that equality is bit for bit (NaN payloads and
    the sign of zero included)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


class TestSceneMarchPermutes:
    """The scene march's kernels may hand rays to threads in any order and
    group them into blocks of any size, writing each result to its ray's own
    index: that is sound because ``march_scene_reference`` is a function of
    each ray alone.  On a permutation of the rays it gives the same
    permutation of its result, bit for bit, the winning instance and the
    steps included."""

    @pytest.mark.parametrize("rays", [1, 31, 33, 1000])
    @pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("interp,debug", [(True, False), (False, False),
                                              (True, True)],
                             ids=["interp", "cube", "overlay"])
    def test_permuted_rays_permute_the_result(self, interp, debug, dtype,
                                              rays):
        from vrt_torch.render.camera import camera_rays

        ts = _tied_scene(dtype)
        o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, 48, 32)
        rng = np.random.default_rng(rays)
        pick = torch.from_numpy(rng.choice(o.shape[0], rays, replace=False))
        o, d = o[pick].contiguous(), d[pick].contiguous()
        t_max = np.where(rng.uniform(size=rays) < 0.2,
                         rng.uniform(200.0, 500.0, size=rays),
                         1e4).astype(np.float32)
        t_max[rng.uniform(size=rays) < 0.1] = -np.inf
        t_max = torch.from_numpy(t_max)
        perm = torch.from_numpy(rng.permutation(rays))
        want, winst = tren.march_scene_reference(ts, o, d, t_max, interp,
                                                 debug)
        got, inst = tren.march_scene_reference(ts, o[perm], d[perm],
                                               t_max[perm], interp, debug)
        for f in dataclasses.fields(got):
            assert torch.equal(_bits(getattr(got, f.name)),
                               _bits(getattr(want, f.name)[perm])), f.name
        assert torch.equal(inst, winst[perm])
        assert not bool((winst == 2).any())
        if rays == 1000:
            # the tied pair's lower index is marched first and wins
            assert bool((winst == 0).any()) and int(want.hit.sum()) > 100
            assert int(want.steps.sum()) > 3 * rays
