"""vrt_torch's frame against vrt's, end to end at 64x64.

Both packages render the same scene state (``scene_from_numpy`` carries
``vrt``'s leaves across): the flagship at resolution 5 (octree, f32), the
benched configuration (resolution 7, chebyshev, bf16 corner table), and the
textured two-instance scene with point and spot lights.  vrt renders its
unchunked path.  Thresholds: ``_assert_close`` of tests/test_golden_full.py
(q98 < 6e-3, mean < 2.5e-3, under 0.5% of pixels off by more than 0.05) for
the f32 scenes, and the wider ``TestGoldenBenchedConfig`` ones for bf16.
All 8 render modes (``RenderMode.from_enum``) and the debug overlay are
held against vrt as ``TestGoldenAllModes``, ``TestGoldenTextured`` and
``TestDebugOverlay`` hold vrt against the scalar oracle: cube-lit frames go
through ``_assert_cube_lit`` (the oracle, with its shadow-acne masking),
the other modes through ``_assert_close`` against vrt's frame.  Also
checked: the two 160x90 fixtures ``chip_smoke.py`` holds the card against
still equal vrt's renders, and the shading modules match vrt's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests.test_golden_full import (_assert_close, _assert_cube_lit,
                                    _checker, _np_scene, _scene_pair)
from tests.test_torch_host import scene_fields
from vrt.render.gpuscene import RenderMode as VMode
from vrt.render.gpuscene import build_scene as vbuild
from vrt.render.renderer import render_image as vrender
from vrt.render.renderer import tonemap as vtonemap
from vrt.shade import brdf as vbrdf
from vrt.shade import lights as vlights
from vrt.shade import texture as vtex
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
from vrt_torch.render.renderer import render_image, tonemap
from vrt_torch.shade import brdf as tbrdf
from vrt_torch.shade import lights as tlights
from vrt_torch.shade import texture as ttex

torch.set_num_threads(2)

FIXTURES = {
    "flagship_r7_cheb_bf16_160x90.npy": VMode(),
    "flagship_r7_cheb_bf16_cube_unlit_160x90.npy": VMode(interp=False,
                                                         lit=False)}


def assert_close_f32(got, want, tag):
    """``_assert_close`` of tests/test_golden_full.py."""
    diff = np.abs(got - want)
    assert np.quantile(diff, 0.98) < 6e-3, (tag, np.quantile(diff, 0.98))
    assert diff.mean() < 2.5e-3, (tag, diff.mean())
    assert (diff.max(axis=-1) > 0.05).mean() < 0.005, tag


def assert_close_bf16(got, want, tag):
    """The ``TestGoldenBenchedConfig`` thresholds."""
    diff = np.abs(got - want)
    assert np.quantile(diff, 0.90) < 0.015, (tag, np.quantile(diff, 0.90))
    assert diff.mean() < 0.01, (tag, diff.mean())
    assert (diff.max(axis=-1) > 0.1).mean() < 0.03, tag


def _textured_scene(notex=False):
    """The scene of ``TestGoldenTextured`` (``TestGoldenAllModes`` with
    ``notex``) and its scalar-oracle twin."""
    (sphere, slab, instances, cam_pos, cam_rot, light_dir, point, spot,
     env) = _scene_pair()
    albedo_tex = _checker(8, (1.0, 1.0, 1.0), (0.45, 0.45, 0.45))
    rm_tex = _checker(8, (1.0, 1.0, 0.0), (0.75, 0.5, 0.0))
    normal_tex = np.full((8, 8, 3), (0.5, 0.5, 1.0), np.float32)
    normal_tex[::2, :, 0] = 0.58
    normal_tex[1::2, :, 1] = 0.42
    tex = {} if notex else dict(
        textures=np.stack([albedo_tex, normal_tex, rm_tex]),
        tex_sizes=np.asarray([[8, 8]] * 3, np.int32),
        texture_ids=[(0, 1, 2), (0, 1, 2)])
    vs = vbuild(
        [sphere, slab], instances,
        camera=dict(position=cam_pos, rotation=cam_rot, fov=60.0),
        dir_light=dict(direction=light_dir, strength=5.0),
        point_lights=[point], spot_lights=[spot], env=env, **tex)
    np_scene = _np_scene(sphere, slab, instances, light_dir, point, spot,
                         env, textures=None if notex else
                         (albedo_tex, normal_tex, rm_tex))
    return vs, np_scene, cam_pos, cam_rot


SCENES = {
    "flagship-r5-octree-f32": (lambda: ge._flagship_scene(resolution=5),
                               assert_close_f32),
    "flagship-r7-cheb-bf16": (
        lambda: ge._flagship_scene(resolution=7, accel_mode="chebyshev",
                                   march_dtype=jnp.bfloat16),
        assert_close_bf16),
    "textured-point-spot": (lambda: _textured_scene()[0], assert_close_f32),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_matches_vrt(name):
    make, check = SCENES[name]
    vs = make()
    want = np.asarray(vrender(vs, 64, 64, VMode()))
    got = render_image(scene_from_numpy(scene_fields(vs)), 64, 64,
                       RenderMode()).numpy()
    assert got.shape == want.shape == (64, 64, 4)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 3], 1.0)
    check(got[..., :3], want[..., :3], name)


def test_unlit_notex_frame_matches_vrt():
    vs = _textured_scene()[0]
    mode = dict(lit=False, textured=False)
    want = np.asarray(vrender(vs, 48, 48, VMode(**mode)))[..., :3]
    got = render_image(scene_from_numpy(scene_fields(vs)), 48, 48,
                       RenderMode(**mode)).numpy()[..., :3]
    assert_close_f32(got, want, "unlit notex")


def test_empty_scene_matches_vrt():
    """No instances: every ray misses and shows the env cube."""
    from tests.test_golden_full import _env_pattern
    from vrt.volume import sdf as S
    from vrt.volume.volume import VoxelVolume

    vol = VoxelVolume.from_generator(S.Sphere(radius=50.0), 3, 100.0)
    vs = vbuild([vol], [], camera=dict(position=(300.0, 0.0, 0.0)),
                env=_env_pattern())
    want = np.asarray(vrender(vs, 32, 32, VMode()))
    got = render_image(scene_from_numpy(scene_fields(vs)), 32, 32,
                       RenderMode()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _check_fixture(name):
    """A fixture is vrt.render_image of the benched configuration at
    160x90 on the CPU, in its mode.  Compared with a fresh render: a pixel
    may move only by float rounding (1e-5), so a fixture cannot drift from
    vrt."""
    want = np.load(os.path.join(os.path.dirname(__file__), "fixtures", name))
    assert want.shape == (90, 160, 3) and want.dtype == np.float32
    vs = ge._flagship_scene(resolution=7, accel_mode="chebyshev",
                            march_dtype=jnp.bfloat16)
    got = np.asarray(vrender(vs, 160, 90, FIXTURES[name]))[..., :3]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fixture_is_vrt_render():
    _check_fixture("flagship_r7_cheb_bf16_160x90.npy")


def test_cube_fixture_is_vrt_render():
    _check_fixture("flagship_r7_cheb_bf16_cube_unlit_160x90.npy")


def test_cube_mode_and_overlay_render():
    vs = ge._flagship_scene(resolution=3)
    ts = scene_from_numpy(scene_fields(vs))
    for mode in (RenderMode(interp=False), RenderMode(debug_overlay=True)):
        assert render_image(ts, 8, 8, mode).shape == (8, 8, 4)


def test_voxel_colors_raise():
    """Per-voxel colours, which raised before the fit (M8), now render:
    the lit and the unlit frame of a scene with random colours against
    vrt's, under ``_assert_close``'s thresholds."""
    from tests.test_torch_grad import _sphere_scene

    vs = _sphere_scene(use_colors=True)
    ts = scene_from_numpy(scene_fields(vs))
    assert ts.use_voxel_colors
    for mode in (dict(), dict(lit=False)):
        want = np.asarray(vrender(vs, 32, 32, VMode(**mode)))[..., :3]
        got = render_image(ts, 32, 32, RenderMode(**mode)).numpy()[..., :3]
        assert_close_f32(got, want, f"voxel colours {mode}")


def test_from_enum_matches_vrt():
    for m in range(8):
        want = VMode.from_enum(m)
        got = RenderMode.from_enum(m)
        assert (got.interp, got.textured, got.lit, got.debug_overlay) == (
            want.interp, want.textured, want.lit, want.debug_overlay), m


def _mode_frame(notex, size, interp, lit):
    vs, np_scene, cam_pos, cam_rot = _textured_scene(notex)
    mode = dict(interp=interp, lit=lit, textured=not notex)
    got = render_image(scene_from_numpy(scene_fields(vs)), size, size,
                       RenderMode(**mode)).numpy()[..., :3]
    assert np.isfinite(got).all()
    tag = f"notex={notex} interp={interp} lit={lit}"
    if interp or not lit:
        want = np.asarray(vrender(vs, size, size, VMode(**mode)))[..., :3]
        _assert_close(got, want, tag)
    else:
        _assert_cube_lit(got, np_scene, size, size, cam_pos, cam_rot,
                         textured=not notex)


MODES = [(True, True), (True, False), (False, True), (False, False)]


class TestAllModes:
    """``TestGoldenAllModes``: the untextured modes at 64x64."""

    @pytest.mark.parametrize("interp,lit", MODES)
    def test_notex_modes_64(self, interp, lit):
        _mode_frame(True, 64, interp, lit)


class TestTexturedModes:
    """``TestGoldenTextured``: the textured modes at 48x48."""

    @pytest.mark.parametrize("interp,lit", MODES)
    def test_textured_modes_48(self, interp, lit):
        _mode_frame(False, 48, interp, lit)


class TestDebugOverlay:
    """``TestDebugOverlay`` of tests/test_render.py on the port, and the
    overlay frame against vrt's under ``_assert_close``."""

    def test_octree_bounds_drawn_red(self):
        from tests.test_render import _simple_scene

        vs = _simple_scene()
        ts = scene_from_numpy(scene_fields(vs))
        img = render_image(ts, 49, 49, RenderMode(debug_overlay=True)).numpy()
        plain = render_image(ts, 49, 49, RenderMode()).numpy()
        assert np.isfinite(img).all()
        red = (0.5 ** (1 / 2.2))
        red_px = (np.abs(img[..., 0] - red) < 1e-3) & (img[..., 1] < 1e-3)
        assert red_px.sum() > 10
        assert not np.allclose(img, plain)
        want = np.asarray(vrender(vs, 49, 49, VMode(debug_overlay=True)))
        _assert_close(img[..., :3], want[..., :3], "debug overlay")


class TestShade:
    """The shading modules against vrt's on random inputs (float32 on both
    sides; 1e-5 relative)."""

    def _inputs(self, n=1024):
        rng = np.random.default_rng(6)

        def unit(x):
            return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
                np.float32)

        return dict(
            wi=unit(rng.normal(size=(n, 3))), wo=unit(rng.normal(size=(n, 3))),
            n=unit(rng.normal(size=(n, 3))),
            albedo=rng.uniform(size=(n, 3)).astype(np.float32),
            rough=rng.uniform(0.05, 1.0, size=n).astype(np.float32),
            metal=rng.uniform(size=n).astype(np.float32),
            k=rng.uniform(0.1, 0.5, size=n).astype(np.float32),
            li=rng.uniform(0, 5, size=(n, 3)).astype(np.float32),
            pos=rng.normal(scale=50.0, size=(n, 3)).astype(np.float32))

    def test_brdf_and_lights(self):
        x = self._inputs()
        t = {k: torch.from_numpy(v) for k, v in x.items()}
        args = ("wi", "wo", "n", "albedo", "rough", "metal", "k")
        np.testing.assert_allclose(
            tbrdf.radiance(t["li"], *(t[a] for a in args)).numpy(),
            np.asarray(vbrdf.radiance(x["li"], *(x[a] for a in args))),
            rtol=1e-5, atol=1e-6)
        dist = np.linalg.norm(x["pos"], axis=-1).astype(np.float32)
        np.testing.assert_allclose(
            tlights.point_light_intensity(60.0, torch.from_numpy(dist), 0.05,
                                          0.0005).numpy(),
            np.asarray(vlights.point_light_intensity(60.0, dist, 0.05,
                                                     0.0005)), rtol=1e-6)
        fwd = np.asarray([0.3, -0.5, -0.8], np.float32)
        fwd /= np.linalg.norm(fwd)
        lp = np.asarray([10.0, 20.0, 150.0], np.float32)
        spot = (dist, lp, fwd, 80.0, 0.05, 0.0005,
                np.float32(np.cos(np.deg2rad(25.0))),
                np.float32(np.cos(np.deg2rad(12.5))))
        np.testing.assert_allclose(
            tlights.spot_light_intensity(
                t["pos"], *(torch.as_tensor(a) for a in spot)).numpy(),
            np.asarray(vlights.spot_light_intensity(x["pos"], *spot)),
            rtol=1e-5, atol=1e-7)

    def test_textures_and_env(self):
        x = self._inputs()
        rng = np.random.default_rng(7)
        tex = rng.uniform(size=(3, 8, 8, 3)).astype(np.float32)
        sizes = np.asarray([[8, 8], [4, 8], [8, 2]], np.int32)
        tid = rng.integers(0, 3, size=1024).astype(np.int32)
        scale = np.asarray([60.0, 60.0], np.float32)
        env = rng.uniform(size=(6, 8, 8, 3)).astype(np.float32)
        targs = (torch.from_numpy(tex), torch.from_numpy(sizes),
                 torch.from_numpy(tid), torch.from_numpy(scale),
                 torch.from_numpy(x["pos"]), torch.from_numpy(x["n"]))
        vargs = (tex, sizes, tid, scale, x["pos"], x["n"])
        for tf, vf in [(ttex.tri_sample, vtex.tri_sample),
                       (ttex.tri_sample_normal, vtex.tri_sample_normal)]:
            np.testing.assert_allclose(tf(*targs).numpy(),
                                       np.asarray(vf(*vargs)), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(
            ttex.sample_env(torch.from_numpy(env),
                            torch.from_numpy(x["wi"])).numpy(),
            np.asarray(vtex.sample_env(env, x["wi"])), rtol=1e-5, atol=1e-6)

    def test_tonemap(self):
        rgb = np.asarray([[-2.0, -0.5, 0.0], [0.3, 1.0, 50.0],
                          [np.nan, np.inf, -np.inf]], np.float32)
        np.testing.assert_allclose(tonemap(torch.from_numpy(rgb)).numpy(),
                                   np.asarray(vtonemap(rgb)), rtol=1e-6)
