"""The two stages of a level's shading (``shade_surface_reference`` then
``shade_combine_reference``, the plain versions of the shade kernels)
against vrt on the CPU, and the rule that picks between the stage pairs.

- one level on the same hits, from seeded scenes: the stage pair against
  vrt's ``_shade_lit`` / ``_shade_unlit_mode`` + the selects of
  ``trace_radiance`` + ``tonemap`` in all 8 render modes, on the hit lanes
  the port's march and resolve give (passed to vrt as numpy).  Tolerance:
  1e-4 relative + 1e-5 absolute on linear radiance — XLA's CPU backend
  contracts multiply-adds into FMAs where eager torch rounds each operation
  (ROADMAP Queue 3), which moves a Cook-Torrance term in its last bits;
- whole frames at 32x32 (march, shadows and the bounce inside) with 0, 1
  and 2 point and spot lights, per-voxel colours on and off, a scene
  without reflective material and the empty scene against ``vrt``'s
  ``render_image`` under the thresholds of tests/test_golden_full.py;
- the surface record's shapes and dtypes per flag set;
- the dispatch rule ``shade_stages``, one case per tensor the level reads:
  a graph through the rays, t, n_obj, the corner table, a colour table, a
  material constant, a light, the texture scale, a texture, the env or an
  instance transform takes the Function pair, no graph the plain pair on
  CPU tensors and the kernel pair on CUDA tensors; another device raises;
- a fit step of the SDF and the colours runs the Function pair, so do one
  that also optimizes the material constants and the lights and one that
  also optimizes the instance transforms (whose gradients equal the plain
  pair's over the plain resolve); all give the loss and gradients of the
  64x36 fixture ``chip_smoke.py`` holds the card against;
- a tracer that overrides only ``march`` and ``resolve`` renders the default
  tracer's frame through the stages;
- the wrappers raise on a wrong device, dtype or shape.
"""

import dataclasses
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_golden_full import _assert_close, _checker, _scene_pair
from tests.test_torch_host import scene_fields
from vrt.march.types import MarchHit as VHit
from vrt.render import renderer as vren
from vrt.render.gpuscene import RenderMode as VMode
from vrt.render.gpuscene import build_scene as vbuild
from vrt_torch.diff.fit import (_value_and_grad, graft_and_rebuild,
                                render_views)
from vrt_torch.kernels import shade as k4
from vrt_torch.march.types import MarchHit, SurfaceRecord
from vrt_torch.render import renderer as tren
from vrt_torch.render.camera import camera_rays
from vrt_torch.render.gpuscene import (INSTANCE_FIELDS, LIGHT_FIELDS,
                                       MATERIAL_FIELDS, TEXTURE_FIELDS,
                                       RenderMode, scene_from_numpy)
from vrt_torch.scenes import flagship_scene

torch.set_num_threads(2)

FIT_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                           "fit_flagship_r4_colors_64x36.npz")
FIT_CAMS = [dict(position=(320.0, 0.0, 40.0), rotation=(0.0, 0.0, 1.0, 0.0),
                 fov=60.0)]


def _vrt_scene(points=1, spots=1, colors=False, reflective=True,
               instances=True):
    """The two-instance scene of tests/test_golden_full.py with checker
    textures, ``points`` point and ``spots`` spot lights and, with
    ``colors``, seeded per-voxel colours, built by vrt."""
    (sphere, slab, inst, cam_pos, cam_rot, light_dir, point, spot,
     env) = _scene_pair()
    if not reflective:
        sphere.material.roughness = 0.45
    albedo_tex = _checker(8, (1.0, 1.0, 1.0), (0.45, 0.45, 0.45))
    rm_tex = _checker(8, (1.0, 1.0, 0.0), (0.75, 0.5, 0.0))
    normal_tex = np.full((8, 8, 3), (0.5, 0.5, 1.0), np.float32)
    normal_tex[::2, :, 0] = 0.58
    normal_tex[1::2, :, 1] = 0.42
    second_point = dict(point, position=(120.0, 90.0, 160.0),
                        color=(0.5, 1.0, 0.6, 1.0), intensity=45.0)
    second_spot = dict(spot, position=(170.0, -60.0, 150.0),
                       color=(1.0, 0.9, 0.3, 1.0), intensity=70.0)
    voxel_colors = None
    if colors:
        n = sphere.n_voxels
        voxel_colors = np.random.default_rng(3).uniform(
            0.1, 0.9, size=(2, n, n, n, 3)).astype(np.float32)
    return vbuild(
        [sphere, slab], inst if instances else [],
        camera=dict(position=cam_pos, rotation=cam_rot, fov=60.0),
        dir_light=dict(direction=light_dir, strength=5.0),
        point_lights=[point, second_point][:points],
        spot_lights=[spot, second_spot][:spots], env=env,
        textures=np.stack([albedo_tex, normal_tex, rm_tex]),
        tex_sizes=np.asarray([[8, 8]] * 3, np.int32),
        texture_ids=[(0, 1, 2), (0, 1, 2)], voxel_colors=voxel_colors)


def _level_inputs(ts, mode, width=48, height=32):
    """The port's primary rays, their march and their resolve."""
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, width, height)
    o = o.contiguous()
    t_max = torch.full((o.shape[0],), tren.RADIANCE_TMAX)
    hit, inst = tren.march_scene(ts, o, d, t_max, mode.interp,
                                 debug_overlay=mode.debug_overlay)
    t, n_obj, unlit_attr = tren.resolve_scene(ts, o, d, hit, inst)
    return o, d, hit, inst, t, n_obj, unlit_attr


# ---- one level against vrt ----------------------------------------------------

@pytest.fixture(scope="module")
def lit_scenes():
    vs = _vrt_scene()
    return vs, scene_from_numpy(scene_fields(vs), device="cpu")


@pytest.mark.parametrize("mode_id", range(8))
def test_stage_pair_matches_vrt_level(lit_scenes, mode_id):
    """A level without traces of its own (depth 2: no shadow ray, no
    bounce): the stage pair, tonemapped, against vrt's shading of the same
    hits."""
    vs, ts = lit_scenes
    mode = RenderMode.from_enum(mode_id)
    vmode = VMode.from_enum(mode_id)
    o, d, hit, inst, t, n_obj, unlit_attr = _level_inputs(ts, mode)
    assert 100 < int(hit.hit.sum()) < hit.hit.numel()

    rec = tren.shade_surface_reference(ts, o, d, t, n_obj, hit, inst, mode,
                                       False, False)
    got = tren.shade_combine_reference(ts, rec, d, n_obj, hit.hit, unlit_attr,
                                       None, None, mode, final=True)
    assert got.shape == (o.shape[0], 4) and bool((got[:, 3] == 1.0).all())
    lin = tren.shade_combine_reference(ts, rec, d, n_obj, hit.hit, unlit_attr,
                                       None, None, mode)

    # vrt on the same hits: the sanitising and the selects of trace_radiance
    # around _shade_lit / _shade_unlit_mode at depth 2
    vhit = VHit(**{f: jnp.asarray(getattr(hit, f).numpy())
                   for f in ("hit", "t", "kind", "cell", "t_in", "t_out",
                             "face_normal")})
    jo, jd, jinst = (jnp.asarray(x.numpy()) for x in (o, d, inst))
    jt = jnp.where(vhit.hit, jnp.asarray(t.numpy()), 0.0)
    jn = jnp.where(vhit.hit[:, None], jnp.asarray(n_obj.numpy()),
                   jnp.asarray([0.0, 0.0, 1.0]))
    if vmode.lit:
        shaded = vren._shade_lit(vs, jo, jd, jt, jn, jinst, vhit, 2, vmode)[0]
    else:
        shaded = vren._shade_unlit_mode(vs, jo, jd, jt, jn, jinst, vhit,
                                        vmode)
    shaded = jnp.where(jnp.asarray(unlit_attr.numpy())[:, None], jn, shaded)
    want = jnp.where(vhit.hit[:, None], shaded,
                     vren._tex.sample_env(vs.env, jd))
    np.testing.assert_allclose(lin.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, :3].numpy(),
                               np.asarray(vren.tonemap(want)), rtol=1e-4,
                               atol=2e-5)


# ---- whole frames against vrt --------------------------------------------------

FRAMES = {
    "no-lights-nonreflective": dict(points=0, spots=0, reflective=False),
    "one-point-one-spot": dict(points=1, spots=1),
    "two-points-two-spots-colours": dict(points=2, spots=2, colors=True),
    "empty-scene": dict(points=1, spots=1, instances=False),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_through_stages_matches_vrt(name):
    vs = _vrt_scene(**FRAMES[name])
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    assert ts.num_point == FRAMES[name]["points"]
    assert ts.use_voxel_colors == FRAMES[name].get("colors", False)
    assert ts.any_reflective == FRAMES[name].get("reflective", True)
    seen = []
    plain = tren.shade_stages

    def spy(*args):
        seen.append(plain(*args))
        return seen[-1]

    tren.shade_stages = spy
    try:
        got = tren.render_image(ts, 32, 32, RenderMode()).numpy()
    finally:
        tren.shade_stages = plain
    levels = 3 if ts.any_reflective else 1
    assert seen == [(tren.shade_surface_reference,
                     tren.shade_combine_reference)] * levels
    want = np.asarray(vren.render_image(vs, 32, 32, VMode()))
    assert got.shape == want.shape == (32, 32, 4)
    assert np.isfinite(got).all() and (got[..., 3] == 1.0).all()
    if ts.num_instances == 0:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        _assert_close(got[..., :3], want[..., :3], name)


# ---- the surface record ----------------------------------------------------------

@pytest.mark.parametrize("lit,bounce,shadows", [
    (True, True, True), (True, False, True), (True, False, False),
    (False, False, False)])
def test_surface_record_shapes(lit_scenes, lit, bounce, shadows):
    ts = lit_scenes[1]
    mode = RenderMode(lit=lit)
    o, d, hit, inst, t, n_obj, _ = _level_inputs(ts, mode, 16, 12)
    rec = tren.shade_surface_reference(ts, o, d, t, n_obj, hit, inst, mode,
                                       bounce, shadows)
    assert isinstance(rec, SurfaceRecord)
    r = o.shape[0]
    want = dict(albedo=(r, 3))
    if lit:
        want.update(shadow_origin=(r, 3), n_w=(r, 3), roughness=(r,),
                    metallic=(r,), k=(r,))
    if bounce:
        want.update(refl_dir=(r, 3), gate=(r,))
    for f in dataclasses.fields(SurfaceRecord):
        x = getattr(rec, f.name)
        if f.name in ("shadow_tmax", "shadow_dir", "lights"):
            continue
        assert (x is None) == (f.name not in want), f.name
        if x is not None:
            assert tuple(x.shape) == want[f.name], f.name
            assert x.dtype == (torch.bool if f.name == "gate"
                               else torch.float32), f.name
    if shadows:
        lights = ts.num_point + ts.num_spot
        assert len(rec.shadow_tmax) == 1 + lights
        assert len(rec.shadow_dir) == lights
        assert all(x.shape == (r,) and x.dtype == torch.float32
                   and not x.requires_grad for x in rec.shadow_tmax)
        assert all(x.shape == (r, 3) for x in rec.shadow_dir)
        # each light's direction, distance and intensity, kept for the
        # combine stage
        assert len(rec.lights) == lights
        for (sdir, dist, inten), x in zip(rec.lights, rec.shadow_dir):
            assert torch.equal(sdir, x)
            assert dist.shape == inten.shape == (r,)
        # a miss lane's shadow is never read
        for x in rec.shadow_tmax:
            assert bool((x[~hit.hit] == -float("inf")).all())
        assert bool((rec.shadow_tmax[0][hit.hit]
                     == tren.DIR_SHADOW_TMAX).all())
    else:
        assert rec.shadow_tmax is None and rec.shadow_dir is None
        assert rec.lights is None


# ---- the dispatch rule -------------------------------------------------------------

def _fake(device="cuda", requires_grad=False):
    """What ``shade_stages`` looks at in a tensor."""
    return types.SimpleNamespace(device=types.SimpleNamespace(type=device),
                                 requires_grad=requires_grad)


def _fake_level(device="cuda", grad_on=None):
    """(scene, o_w, d_w, t, n_obj) of stand-ins on ``device``; the one
    named ``grad_on`` requires a gradient."""
    def make(name):
        return _fake(device, name == grad_on)
    scene = types.SimpleNamespace(
        volumes=types.SimpleNamespace(corners=make("corners")),
        **{f: make(f) for f in tren._KERNEL_GRAD_FIELDS})
    return (scene,) + tuple(make(n) for n in ("o_w", "d_w", "t", "n_obj"))


PLAIN = (tren.shade_surface_reference, tren.shade_combine_reference)
KERNELS = (tren._shade_surface_kernel, tren._shade_combine_kernel)
FUNCTIONS = (tren._shade_surface_function, tren._shade_combine_function)
# the tensors whose gradient the Function pair returns: every tensor the
# level reads and a fit may optimize
GRAD_CARRIERS = ("o_w", "d_w", "t", "n_obj", "corners") \
    + tren._KERNEL_GRAD_FIELDS


def test_shaded_fields_are_scene_tensors():
    ts = flagship_scene(3, device="cpu")
    for f in tren._KERNEL_GRAD_FIELDS:
        assert getattr(ts, f) is None or isinstance(getattr(ts, f),
                                                    torch.Tensor), f
    assert {"tint", "voxel_color_corners", "inst_rot", "point_pos",
            "spot_fwd", "dir_light_dir", "env"} <= set(
                tren._KERNEL_GRAD_FIELDS)
    assert set(tren._KERNEL_GRAD_FIELDS) == {
        "voxel_colors", "voxel_color_corners", *MATERIAL_FIELDS,
        *LIGHT_FIELDS, *TEXTURE_FIELDS, *INSTANCE_FIELDS}
    assert set(TEXTURE_FIELDS) == {"tex_scale", "textures", "env"}
    assert INSTANCE_FIELDS == ("inst_pos", "inst_rot", "inst_scale")
    # no tensor of the level is left to the plain pair under a graph
    assert not hasattr(tren, "_PLAIN_GRAD_FIELDS")


@pytest.mark.parametrize("name", GRAD_CARRIERS)
def test_dispatch_takes_autograd_for(name):
    """CUDA tensors with a graph through ``name``: the Function pair for the
    rays, ``t``, ``n_obj``, the corner table, the colour tables, the
    material constants, the lights, the texture scale, the textures, the
    env and the instance transforms; the same tensors without a graph being
    recorded: the kernels.  On CPU tensors the same rule, with the plain
    pair where no graph is recorded."""
    want = FUNCTIONS
    assert tren.shade_stages(*_fake_level(grad_on=name)) == want
    assert tren.shade_stages(*_fake_level("cpu", grad_on=name)) == want
    with torch.no_grad():
        assert tren.shade_stages(*_fake_level(grad_on=name)) == KERNELS
        assert tren.shade_stages(*_fake_level("cpu", grad_on=name)) == PLAIN


def test_dispatch_plain_fields_win():
    """A graph through the rays, the textures and an instance's position
    at once: the Function pair, whose backward kernels' variants return
    every one of those gradients (no tensor is left to the plain pair)."""
    level = _fake_level(grad_on="inst_pos")
    level[1].requires_grad = True
    level[0].textures.requires_grad = True
    assert tren.shade_stages(*level) == FUNCTIONS
    cpu = _fake_level("cpu", grad_on="inst_scale")
    cpu[0].tint.requires_grad = True
    assert tren.shade_stages(*cpu) == FUNCTIONS


def test_dispatch_by_device():
    assert tren.shade_stages(*_fake_level()) == KERNELS
    assert tren.shade_stages(*_fake_level("cpu")) == PLAIN
    with torch.no_grad():
        assert tren.shade_stages(*_fake_level("cpu")) == PLAIN
    with pytest.raises(ValueError):
        tren.shade_stages(*_fake_level("meta"))
    # a missing optional table (no per-voxel colours) carries no graph
    level = _fake_level()
    level[0].voxel_color_corners = None
    assert tren.shade_stages(*level) == KERNELS


def test_resolve_shares_the_rule():
    """``shade_stages``' test of a graph is ``_needs_autograd``; resolve
    needs none (every call goes through ``ResolveScene``, the instance
    transforms among its inputs)."""
    assert tren._needs_autograd(_fake(requires_grad=True))
    assert not tren._needs_autograd(_fake(), None)
    with torch.no_grad():
        assert not tren._needs_autograd(_fake(requires_grad=True))
    import inspect

    assert "_needs_autograd" not in inspect.getsource(tren.resolve_scene)
    assert "INSTANCE_FIELDS" in inspect.getsource(tren.resolve_scene)


def _fit_through(params, want_pair, force_plain=False):
    """vrt's 64x36 fit loss and gradients (the fixture) at the flagship with
    colours, ``params`` naming the leaves besides the SDF and the colours;
    every level must shade on ``want_pair``.  ``force_plain`` shades every
    level on the plain pair and resolves it by autograd over
    ``resolve_scene_reference``."""
    scene = flagship_scene(4, use_colors=True, device="cpu")
    fixture = np.load(FIT_FIXTURE)
    seen = []
    plain, resolve = tren.shade_stages, tren.resolve_scene

    def spy(*args):
        seen.append((PLAIN if force_plain else plain(*args),
                     args[3].requires_grad))
        return seen[-1][0]

    def loss(p):
        s = graft_and_rebuild(scene, p)
        return torch.mean((render_views(s, FIT_CAMS, 64, 36, RenderMode())
                           - 0.25) ** 2)

    tren.shade_stages = spy
    if force_plain:
        tren.resolve_scene = tren.resolve_scene_reference
    try:
        got, grads = _value_and_grad(
            loss, {"sdf": scene.volumes.sdf,
                   "voxel_colors": scene.voxel_colors,
                   **{k: getattr(scene, k) for k in params}})
    finally:
        tren.shade_stages, tren.resolve_scene = plain, resolve
    assert seen == [(want_pair, True)] * 3
    np.testing.assert_allclose(float(got), float(fixture["loss"]), rtol=1e-5)
    for k in ("sdf", "voxel_colors"):
        a = fixture[f"grad_{k}"].astype(np.float64).ravel()
        b = grads[k].double().numpy().ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 1.0 - 1e-6, (k, 1.0 - cos)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), k
    return grads


def test_fit_step_takes_the_plain_pair_and_the_fixture():
    """A fit step that also optimizes the instance transforms shades every
    level through the Function pair (their gradients come back from the
    backward kernels' instance variants, on the CPU from the closed form
    and the plain backward) and resolves through ``ResolveScene``; its loss
    and SDF and colour gradients are the fixture's (vrt's, on the CPU), and
    its gradients in the transforms equal those of the same step on the
    plain pair over the plain resolve under autograd, at
    ``tests/test_torch_grad.py``'s f32 gates."""
    from tests.test_torch_grad import COS_F32, DIFF_F32

    grads = _fit_through(INSTANCE_FIELDS, FUNCTIONS)
    want = _fit_through(INSTANCE_FIELDS, PLAIN, force_plain=True)
    for f in INSTANCE_FIELDS:
        a = grads[f].double().numpy().ravel()
        b = want[f].double().numpy().ravel()
        # the hit points move with the instances
        assert bool(grads[f].any()), f
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 1.0 - COS_F32, (f, 1.0 - cos)
        assert np.abs(a - b).max() <= DIFF_F32 * np.abs(b).max(), f


def test_fit_step_through_materials_and_lights_takes_the_function_pair():
    """A fit step that also optimizes the material constants and the
    lights shades every level through the Function pair (their gradients
    come back from the backward kernels' variants, on the CPU from the
    plain backward), and its loss and SDF and colour gradients are the
    fixture's."""
    grads = _fit_through(MATERIAL_FIELDS + LIGHT_FIELDS, FUNCTIONS)
    # with per-voxel colours the tint shades nothing; the rest does
    assert not bool(grads["tint"].any())
    for f in ("roughness", "metallic", "k", "dir_light_dir",
              "dir_light_strength"):
        assert bool(grads[f].any()), f


def test_fit_step_takes_the_function_pair_and_the_fixture():
    """A fit step of the SDF and the colours shades every level through the
    Function pair (on the CPU: the plain stages forward, their plain
    backward), and its loss and gradients are the fixture's."""
    _fit_through((), FUNCTIONS)


# ---- the seam -----------------------------------------------------------------------

def test_tracer_with_march_and_resolve_only(lit_scenes):
    """A tracer in vrt's shape (no ``march_any_hit``) whose results are not
    contiguous renders the default tracer's frame: the stages take what the
    seam returns and write what it traces next."""
    ts = lit_scenes[1]
    calls = dict(march=0, resolve=0)

    def strided(x):
        return torch.stack([x, x], dim=-1)[..., 0]

    class Tracer(tren.SceneTracer):
        def march(self, scene, o_w, d_w, t_max, interp, debug_overlay=False):
            calls["march"] += 1
            assert o_w.shape == d_w.shape and t_max.shape == o_w.shape[:1]
            hit, inst = tren.march_scene(scene, o_w, d_w, t_max, interp,
                                         debug_overlay=debug_overlay)
            return dataclasses.replace(hit, hit=strided(hit.hit),
                                       cell=strided(hit.cell)), strided(inst)

        def resolve(self, scene, o_w, d_w, hit, inst):
            calls["resolve"] += 1
            t, n, unlit = tren.resolve_scene(scene, o_w, d_w, hit, inst)
            return strided(t), strided(n), strided(unlit)

    for mode in (RenderMode(), RenderMode(lit=False)):
        base = tren.render_image(ts, 24, 16, mode)
        assert torch.equal(tren.render_image(ts, 24, 16, mode,
                                             tracer=Tracer()), base)
    # lit: 3 levels and (1 + 1 + 1) shadow traces at two of them; unlit: 1
    assert calls == dict(march=3 + 6 + 1, resolve=3 + 1)


def test_render_image_is_a_view_of_the_last_stage(lit_scenes):
    ts = lit_scenes[1]
    img = tren.render_image(ts, 16, 12, RenderMode())
    assert img.shape == (12, 16, 4) and img._base is not None
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, 16, 12)
    rgb = tren.trace_radiance(ts, o, d, 0, RenderMode())
    assert rgb.shape == (16 * 12, 3)
    assert torch.equal(tren.tonemap(rgb).reshape(12, 16, 3), img[..., :3])


# ---- the wrappers' checks --------------------------------------------------------------

class TestWrapperChecks:
    """Without a card only the checks run: a CPU tensor never reaches a
    launch, and a tensor of the wrong dtype or shape is named."""

    def _level(self, ts):
        mode = RenderMode()
        o, d, hit, inst, t, n_obj, unlit = _level_inputs(ts, mode, 8, 6)
        return mode, o, d, hit, inst, t, n_obj, unlit

    def test_cpu_tensors_raise(self, lit_scenes):
        ts = lit_scenes[1]
        mode, o, d, hit, inst, t, n_obj, unlit = self._level(ts)
        with pytest.raises(ValueError, match="CUDA"):
            k4.shade_surface_cuda(ts, o, d, t, n_obj, hit, inst, mode, True,
                                  True)
        rec = tren.shade_surface_reference(ts, o, d, t, n_obj, hit, inst,
                                           mode, False, False)
        with pytest.raises(ValueError, match="CUDA"):
            k4.shade_combine_cuda(ts, rec, d, n_obj, hit.hit, unlit, None,
                                  None, mode)
        assert k4.LAUNCHES == {"surface": 0, "combine": 0, "surface_bwd": 0,
                               "combine_bwd": 0}

    @pytest.mark.parametrize("bad,match", [
        (lambda x: x.double(), "dtype"),
        (lambda x: x[:-1], "shape"),
        (lambda x: torch.stack([x, x], -1)[..., 0], "contiguous"),
        (lambda x: x.to("meta"), "is on")])
    def test_check_names_the_fault(self, bad, match):
        x = torch.zeros((6, 3))
        k4._check(x, "d_w", torch.float32, (6, 3), x.device)
        with pytest.raises(ValueError, match=match):
            k4._check(bad(x), "d_w", torch.float32, (6, 3), x.device)

    def test_light_tables_are_checked(self, lit_scenes):
        ts = lit_scenes[1]
        assert len(k4._light_ptrs(ts, ts.tint.device)) == 15
        with pytest.raises(ValueError, match="point_pos"):
            k4._light_ptrs(dataclasses.replace(
                ts, point_pos=ts.point_pos[:, :2]), ts.tint.device)
        with pytest.raises(ValueError, match="lights"):
            k4._light_ptrs(dataclasses.replace(ts, num_point=6),
                           ts.tint.device)


def test_build_scene_tables_are_contiguous():
    """The kernels index every table by its shape alone: ``build_scene``
    makes a strided host array (a cube map as the DDS reader hands it out)
    contiguous on its way to the device."""
    from vrt_torch.render.gpuscene import build_scene
    from vrt_torch.scenes import flagship_volumes

    env = np.random.default_rng(0).uniform(
        size=(4, 4, 3, 6)).astype(np.float32).transpose(3, 0, 1, 2)
    tex = np.ones((3, 2, 2, 2), np.float32).transpose(3, 1, 2, 0)
    assert not env.flags.c_contiguous and not tex.flags.c_contiguous
    ts = build_scene(list(flagship_volumes(3)), [{"volume": 0}],
                     camera={"position": (300.0, 0.0, 0.0)}, env=env,
                     textures=tex, tex_sizes=np.asarray([[2, 2]] * 2),
                     device="cpu")
    assert ts.env.is_contiguous() and ts.textures.is_contiguous()
    assert ts.tex_sizes.dtype == torch.int32
    np.testing.assert_array_equal(ts.env.numpy(), env)
    for f in dataclasses.fields(ts):
        x = getattr(ts, f.name)
        if isinstance(x, torch.Tensor):
            assert x.is_contiguous(), f.name


def test_march_hit_is_what_the_stages_read():
    """The stages read ``hit.hit`` and, with per-voxel colours,
    ``hit.cell``: a hit that carries nothing else shades the same."""
    ts = flagship_scene(3, device="cpu")
    mode = RenderMode()
    o, d, hit, inst, t, n_obj, unlit = _level_inputs(ts, mode, 12, 8)
    bare = MarchHit(hit=hit.hit, t=None, kind=None, cell=hit.cell, t_in=None,
                    t_out=None, face_normal=None)
    a = tren.shade_surface_reference(ts, o, d, t, n_obj, hit, inst, mode,
                                     True, True)
    b = tren.shade_surface_reference(ts, o, d, t, n_obj, bare, inst, mode,
                                     True, True)
    assert torch.equal(a.albedo, b.albedo) and torch.equal(a.n_w, b.n_w)
    assert torch.equal(a.gate, b.gate)


# ---- hit patterns: the plain stages against vrt, lane by lane ----------------
#
# The lanes of one level (the port's march and resolve of the 48x32 frame)
# regrouped into R rays with a chosen pattern of hits: none, all, every other
# lane, one lane in 32 (the patterns of a warp that the kernels' vector path
# and miss path take apart), at R = 1, 31, 33 (a warp's edges) and 2,331
# (63x37: a partial last warp, stacked shadow rows off 16-byte boundaries).
# Lit with the level's bounce and shadows (vrt's _shade_lit at depth 0 with
# both deferred and a tracer that hits nothing, the port's combine with no
# shadow blocked and a black bounce), lit without traces (depth 2) and
# unlit.  Tolerances as in test_stage_pair_matches_vrt_level.

HIT_PATTERNS = {
    "all-miss": lambda r: np.zeros(r, bool),
    "all-hit": lambda r: np.ones(r, bool),
    "every-other": lambda r: np.arange(r) % 2 == 0,
    "one-per-32": lambda r: np.arange(r) % 32 == 0,
}
# (lit, bounce and shadows)
STAGE_VARIANTS = {"lit-traces": (True, True), "lit": (True, False),
                  "unlit": (False, False)}


class _NoHits:
    """A vrt tracer whose march hits nothing: every shadow unblocked."""

    def march(self, scene, o_w, d_w, t_max, interp, debug_overlay=False):
        return types.SimpleNamespace(hit=jnp.zeros(o_w.shape[0], bool)), None


@pytest.fixture(scope="module")
def lane_pool(lit_scenes):
    return _level_inputs(lit_scenes[1], RenderMode())


def _regrouped(pool, pattern, rays):
    """R lanes of the pool, hit where ``HIT_PATTERNS[pattern]`` says."""
    o, d, hit, inst, t, n_obj, unlit = pool
    mask = hit.hit.numpy()
    hits, misses = np.flatnonzero(mask), np.flatnonzero(~mask)
    want = HIT_PATTERNS[pattern](rays)
    k = np.arange(rays)
    idx = torch.from_numpy(np.where(want, hits[k % len(hits)],
                                    misses[k % len(misses)]))
    sel = MarchHit(**{f.name: None if getattr(hit, f.name) is None
                      else getattr(hit, f.name)[idx]
                      for f in dataclasses.fields(hit)})
    assert torch.equal(sel.hit, torch.from_numpy(want))
    return (o[idx], d[idx], sel, inst[idx], t[idx], n_obj[idx], unlit[idx])


@pytest.mark.parametrize("rays", [1, 31, 33, 2331])
@pytest.mark.parametrize("pattern", sorted(HIT_PATTERNS))
@pytest.mark.parametrize("variant", sorted(STAGE_VARIANTS))
def test_stage_pair_hit_patterns_match_vrt(lit_scenes, lane_pool, variant,
                                           pattern, rays):
    """The stage pair on regrouped lanes against vrt's shading of the same
    lanes, and the miss-lane contract of the plain surface stage field by
    field: the shadow origin o - 0.1 d, a closed gate, every shadow's t_max
    -inf, finite (sanitised) material and rays, the env on the combine's
    miss lanes."""
    vs, ts = lit_scenes
    lit, traces = STAGE_VARIANTS[variant]
    mode, vmode = RenderMode(lit=lit), VMode(lit=lit)
    o, d, hit, inst, t, n_obj, unlit = _regrouped(lane_pool, pattern, rays)
    rec = tren.shade_surface_reference(ts, o, d, t, n_obj, hit, inst, mode,
                                       traces, traces)
    lights = 1 + ts.num_point + ts.num_spot
    blocked = [torch.zeros(rays, dtype=torch.bool)] * lights if traces \
        else None
    refl = torch.zeros((rays, 3)) if traces else None
    lin = tren.shade_combine_reference(ts, rec, d, n_obj, hit.hit, unlit,
                                       refl, blocked, mode)
    got = tren.shade_combine_reference(ts, rec, d, n_obj, hit.hit, unlit,
                                       refl, blocked, mode, final=True)

    vhit = VHit(**{f: jnp.asarray(getattr(hit, f).numpy())
                   for f in ("hit", "t", "kind", "cell", "t_in", "t_out",
                             "face_normal")})
    jo, jd, jinst = (jnp.asarray(x.numpy()) for x in (o, d, inst))
    jt = jnp.where(vhit.hit, jnp.asarray(t.numpy()), 0.0)
    jn = jnp.where(vhit.hit[:, None], jnp.asarray(n_obj.numpy()),
                   jnp.asarray([0.0, 0.0, 1.0]))
    on = hit.hit.numpy()
    if traces:
        shaded, refl_aux, shadow_aux = vren._shade_lit(
            vs, jo, jd, jt, jn, jinst, vhit, 0, vmode, defer_reflection=True,
            defer_dir_shadow=True, tracer=_NoHits())
        shaded = shaded + shadow_aux["add"]
        # the rays the level's traces take, against vrt's
        np.testing.assert_allclose(rec.shadow_origin.numpy(),
                                   np.asarray(refl_aux["origin"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rec.refl_dir.numpy()[on],
                                   np.asarray(refl_aux["dir"])[on],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(rec.gate.numpy(),
                                      np.asarray(refl_aux["gate"]))
        assert len(rec.shadow_tmax) == lights
        assert bool((rec.shadow_tmax[0][hit.hit]
                     == tren.DIR_SHADOW_TMAX).all())
    elif lit:
        shaded = vren._shade_lit(vs, jo, jd, jt, jn, jinst, vhit, 2,
                                 vmode)[0]
    else:
        shaded = vren._shade_unlit_mode(vs, jo, jd, jt, jn, jinst, vhit,
                                        vmode)
    shaded = jnp.where(jnp.asarray(unlit.numpy())[:, None], jn, shaded)
    want = jnp.where(vhit.hit[:, None], shaded,
                     vren._tex.sample_env(vs.env, jd))
    np.testing.assert_allclose(lin.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[:, :3].numpy(),
                               np.asarray(vren.tonemap(want)), rtol=1e-4,
                               atol=2e-5)
    assert bool((got[:, 3] == 1.0).all())

    # the miss-lane contract of the plain surface stage
    miss = ~hit.hit
    for name in ("albedo", "n_w", "roughness", "metallic", "k"):
        x = getattr(rec, name)
        assert (x is None) == (not lit and name != "albedo"), name
        if x is not None:
            assert bool(torch.isfinite(x[miss]).all()), name
    if lit:
        assert torch.equal(rec.shadow_origin[miss], o[miss] - d[miss] * 0.1)
    assert (rec.gate is None) == (not traces)
    if traces:
        assert not bool(rec.gate[miss].any())
        assert bool(torch.isfinite(rec.refl_dir[miss]).all())
        for x in rec.shadow_tmax:
            assert bool((x[miss] == -float("inf")).all())
        for x in rec.shadow_dir:
            assert bool(torch.isfinite(x[miss]).all())
    else:
        assert rec.shadow_tmax is None and rec.shadow_dir is None


# ---- the forward kernels' path ----------------------------------------------------

@pytest.mark.parametrize("rays,lights,shadows,want", [
    (2304, 3, True, "v4"), (2331, 3, True, "scalar"), (2331, 2, True,
                                                          "scalar"),
    (2331, 1, True, "v4"), (2331, 3, False, "v4"), (1, 3, True, "scalar"),
    (33, 2, True, "scalar")])
def test_surface_path_of_the_stacked_shadow_rows(rays, lights, shadows,
                                                 want):
    """A surface launch takes the vector path where every tensor it moves
    in 16-byte words starts on a 16-byte boundary: row j of the stacked
    shadow directions starts 12 j R bytes in, off a boundary from j = 1 when
    R is not a multiple of 4."""
    rec, tmax, sdir = k4._surface_record(rays, torch.device("cpu"), True,
                                         True, shadows, lights)
    o, d, n = (torch.zeros((rays, 3)) for _ in range(3))
    hit = torch.zeros(rays, dtype=torch.bool)
    assert k4.shade_path(k4.surface_vectors(o, d, n, hit, rec)) == want
    if shadows:
        assert all(x._base is sdir for x in rec.shadow_dir)
        assert [x.data_ptr() % 16 for x in rec.shadow_dir] == [
            12 * j * rays % 16 for j in range(lights)]


def test_path_of_an_input_off_a_boundary():
    """An input that starts off a 16-byte boundary (a view one row in)
    takes the scalar path; the combine's own output and flags do not."""
    rays = 64
    rec, _, _ = k4._surface_record(rays, torch.device("cpu"), True, True,
                                   True, 2)
    o = torch.zeros((rays + 1, 3))[1:]
    d, n = torch.zeros((rays, 3)), torch.zeros((rays, 3))
    hit = torch.zeros(rays, dtype=torch.bool)
    assert o.is_contiguous() and o.data_ptr() % 16 == 12
    assert k4.shade_path(k4.surface_vectors(o, d, n, hit, rec)) == "scalar"
    assert k4.shade_path(k4.surface_vectors(d, d, n, hit, rec)) == "v4"
    flags = torch.zeros(rays + 1, dtype=torch.bool)[1:]
    out = torch.empty((rays, 3))
    assert k4.shade_path(k4.combine_vectors(d, flags, hit, out)) == "scalar"
    assert k4.shade_path(k4.combine_vectors(d, hit, hit, out)) == "v4"


@pytest.mark.parametrize("rays", [2331, 2304])
def test_path_of_the_fit_steps_packed_record(rays):
    """The fit step's record travels as ``SurfaceRecord.pack``'s tuple
    (``ShadeSurface``): the stacked shadow tensors are the kernel's own
    (no copy), so its rows keep their addresses through ``unpack``; the
    bounce level reads the record's mirror rays (their own tensors, on
    16-byte boundaries) and the combine its fresh output."""
    cpu = torch.device("cpu")
    rec, tmax, sdir = k4._surface_record(rays, cpu, True, True, True, 3)
    packed = rec.pack()
    assert packed[-2] is tmax and packed[-1] is sdir
    back = SurfaceRecord.unpack(packed)
    assert [x.data_ptr() for x in back.shadow_dir] == [
        x.data_ptr() for x in rec.shadow_dir]
    o = d = torch.zeros((rays, 3))
    hit = torch.zeros(rays, dtype=torch.bool)
    want = "scalar" if rays % 4 else "v4"
    assert k4.shade_path(k4.surface_vectors(o, d, d, hit, back)) == want
    # the bounce level: its rays are the record's, with shadows of its own
    nxt, _, _ = k4._surface_record(rays, cpu, True, True, True, 3)
    assert k4.shade_path(k4.surface_vectors(
        back.shadow_origin, back.refl_dir, d, hit, nxt)) == want
    nxt, _, _ = k4._surface_record(rays, cpu, True, True, False, 3)
    assert k4.shade_path(k4.surface_vectors(
        back.shadow_origin, back.refl_dir, d, hit, nxt)) == "v4"
    out = torch.empty((rays, 3))
    assert k4.shade_path(k4.combine_vectors(back.refl_dir, hit, hit,
                                            out)) == "v4"
