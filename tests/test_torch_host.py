"""vrt_torch host side against vrt: quaternions, SDF bake, accel fields,
corner packing, scene assembly, the scene bridge, camera rays and the
instance transform.  Host assembly is numpy in both packages, so those
comparisons are exact; camera rays and transforms are float32 device math
on both sides and agree to 1e-6.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from vrt.core import quat as vq
from vrt.march import types as vtypes
from vrt.render import camera as vcam
from vrt.render import renderer as vren
from vrt.volume import accel as vaccel
from vrt.volume import sdf as vsdf
from vrt.core.grid import GridLaw as VGridLaw
from vrt_torch.core import quat as tq
from vrt_torch.core.grid import GridLaw
from vrt_torch.march import types as ttypes
from vrt_torch.render import camera as tcam
from vrt_torch.render import renderer as tren
from vrt_torch.render.gpuscene import scene_from_numpy
from vrt_torch.scenes import flagship_scene
from vrt_torch.volume import accel as taccel
from vrt_torch.volume import sdf as tsdf

torch.set_num_threads(2)

CONFIGS = {"octree-f32": dict(accel_mode="octree"),
           "chebyshev-bf16": dict(accel_mode="chebyshev", bf16=True),
           "octree-f32-colors": dict(accel_mode="octree", use_colors=True)}


def scene_fields(obj):
    """A vrt dataclass (GPUScene / DeviceVolume) as nested numpy leaves,
    every field carried: the per-voxel colours and their corner-packed
    view (None where vrt left it unpacked) among them."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = scene_fields(v)
        elif v is None or isinstance(v, (bool, int, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def as_numpy(x):
    """A tensor as numpy; bf16 as ml_dtypes bf16 (vrt's numpy dtype)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(jnp.bfloat16)
    return x.numpy()


def assert_same(got, want, name):
    want = np.asarray(want)
    got = as_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.name == "bfloat16":
        got, want = got.view(np.uint16), want.view(np.uint16)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _csg(mod):
    csg = mod.CSG(shape=mod.Box(extends=(40.0, 40.0, 40.0)))
    csg.add_child(mod.Sphere(radius=50.0), mod.SUBTRACT)
    csg.add_child(mod.Cylinder(radius=20.0, height=60.0,
                               position=np.array([10.0, 0.0, 5.0],
                                                 np.float32)), mod.ADD)
    return csg


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def scene_pair(request):
    cfg = CONFIGS[request.param]
    colors = cfg.get("use_colors", False)
    vs = ge._flagship_scene(resolution=5, accel_mode=cfg["accel_mode"],
                            march_dtype=jnp.bfloat16 if cfg.get("bf16")
                            else None, use_colors=colors)
    ts = flagship_scene(5, cfg["accel_mode"],
                        torch.bfloat16 if cfg.get("bf16") else None,
                        use_colors=colors, device="cpu")
    return vs, ts


class TestQuat:
    def test_host_functions_match(self):
        rng = np.random.default_rng(0)
        for roll, yaw, pitch in rng.uniform(-180, 180, size=(5, 3)):
            assert_same(tq.from_euler_degrees(roll, yaw, pitch),
                        vq.from_euler_degrees(roll, yaw, pitch), "euler")
        q = vq.normalize(rng.normal(size=(7, 4)).astype(np.float32))
        v = rng.normal(size=(7, 3)).astype(np.float32)
        w = rng.normal(size=(7, 3)).astype(np.float32)
        assert_same(tq.rotate(q, v), vq.rotate(q, v), "rotate")
        assert_same(tq.multiply(q, q[::-1]), vq.multiply(q, q[::-1]), "mul")
        assert_same(tq.inverse(q), vq.inverse(q), "inverse")
        assert_same(tq.forward_vector(q), vq.forward_vector(q), "fwd")
        assert_same(tq.up_vector(q), vq.up_vector(q), "up")
        u1 = vq.normalize(v)
        u2 = vq.normalize(w)
        assert_same(tq.from_two_vectors(u1, u2), vq.from_two_vectors(u1, u2),
                    "two vectors")

    def test_tensor_functions_match(self):
        # device math: float32 on both sides, agreement to 1e-6
        rng = np.random.default_rng(1)
        q = vq.normalize(rng.normal(size=(64, 4)).astype(np.float32))
        v = rng.normal(size=(64, 3)).astype(np.float32)
        u1 = vq.normalize(v)
        u2 = vq.normalize(np.roll(v, 1, axis=0))
        u2[0] = -u1[0]  # antiparallel fallback
        qr = q[::-1].copy()
        cases = [
            (tq.rotate(torch.from_numpy(q), torch.from_numpy(v)),
             vq.rotate(jnp.asarray(q), jnp.asarray(v))),
            (tq.conjugate(torch.from_numpy(q)), vq.conjugate(jnp.asarray(q))),
            (tq.inverse(torch.from_numpy(q)), vq.inverse(jnp.asarray(q))),
            (tq.multiply(torch.from_numpy(q), torch.from_numpy(qr)),
             vq.multiply(jnp.asarray(q), jnp.asarray(qr))),
            (tq.up_vector(torch.from_numpy(q)), vq.up_vector(jnp.asarray(q))),
            (tq.from_two_vectors(torch.from_numpy(u1), torch.from_numpy(u2)),
             vq.from_two_vectors(jnp.asarray(u1), jnp.asarray(u2))),
            (tq.from_euler_degrees(torch.tensor(10.0), 20.0, -30.0),
             vq.from_euler_degrees(jnp.asarray(10.0), 20.0, -30.0)),
            (tq.from_axis_angle(torch.from_numpy(u1), torch.ones(64)),
             vq.from_axis_angle(jnp.asarray(u1), jnp.ones(64))),
        ]
        for got, want in cases:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


class TestVolumeBuild:
    @pytest.mark.parametrize("resolution", [3, 5])
    def test_bake_equal(self, resolution):
        for mod_t, mod_v in [(tsdf.Sphere(radius=50.0),
                              vsdf.Sphere(radius=50.0)),
                             (_csg(tsdf), _csg(vsdf))]:
            got = tsdf.bake(mod_t, GridLaw(resolution, 100.0))
            want = vsdf.bake(mod_v, VGridLaw(resolution, 100.0))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("resolution", [4, 5])
    def test_accel_fields_equal(self, resolution):
        sdf, _ = vsdf.bake(_csg(vsdf), VGridLaw(resolution, 100.0))
        np.testing.assert_array_equal(
            taccel.cell_corner_signs_differ(sdf),
            np.asarray(vaccel.cell_corner_signs_differ(sdf)))
        np.testing.assert_array_equal(
            taccel.build_accel(sdf, resolution),
            np.asarray(vaccel.build_accel(sdf, resolution)))
        np.testing.assert_array_equal(
            taccel.build_accel_chebyshev(sdf),
            np.asarray(vaccel.build_accel_chebyshev(sdf)))

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("fold", [False, True])
    def test_pack_cell_corners_equal(self, dtype, fold):
        sdf, _ = vsdf.bake(_csg(vsdf), VGridLaw(4, 100.0))
        accel = np.asarray(vaccel.build_accel_chebyshev(sdf), np.int32)
        # a skip above 127 exercises the bf16 clamp
        accel[0, 0, 0] = (200 << 1) | 1
        acc = accel if fold else None
        got = ttypes.pack_cell_corners(
            sdf, acc, torch.bfloat16 if dtype == "bf16" else torch.float32)
        want = vtypes.pack_cell_corners(
            sdf, acc, jnp.bfloat16 if dtype == "bf16" else None)
        assert_same(got, want, "corners")


class TestScene:
    def test_build_scene_fields_equal(self, scene_pair):
        vs, ts = scene_pair
        for f in dataclasses.fields(ts.volumes):
            if f.name == "accel_mode":
                assert ts.volumes.accel_mode == vs.volumes.accel_mode
            else:
                assert_same(getattr(ts.volumes, f.name),
                            getattr(vs.volumes, f.name), f.name)
        # resolution 5 tables fold the accel into a 9th channel, as in vrt
        assert ts.volumes.corners.shape[-1] == 9
        for f in dataclasses.fields(ts):
            if f.name == "volumes":
                continue
            got, want = getattr(ts, f.name), getattr(vs, f.name)
            if isinstance(got, torch.Tensor):
                assert_same(got, want, f.name)
            else:
                assert got == want, f.name

    def test_flagship_r7_table_layout(self):
        # the benched configuration keeps 8 channels (no accel fold)
        vs = ge._flagship_scene(resolution=6, accel_mode="chebyshev",
                                march_dtype=jnp.bfloat16)
        ts = flagship_scene(6, "chebyshev", torch.bfloat16, device="cpu")
        assert ts.volumes.corners.shape == vs.volumes.corners.shape
        assert_same(ts.volumes.corners, vs.volumes.corners, "corners r6")
        assert_same(ts.volumes.accel, vs.volumes.accel, "accel r6")

    def test_scene_from_numpy_equals_build_scene(self, scene_pair):
        vs, ts = scene_pair
        bridged = scene_from_numpy(scene_fields(vs), device="cpu")
        for f in dataclasses.fields(ts.volumes):
            a, b = getattr(bridged.volumes, f.name), getattr(ts.volumes,
                                                             f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
            else:
                assert a == b, f.name
        for f in dataclasses.fields(ts):
            if f.name == "volumes":
                continue
            a, b = getattr(bridged, f.name), getattr(ts, f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
            else:
                assert a == b and type(a) is type(b), f.name

    def test_accel_u8_equals_vrt(self, scene_pair):
        """The u8 accel the march reads is derived once per DeviceVolume
        (built or bridged) and equals vrt's ``_accel_u8`` byte for byte."""
        from vrt.march.march import _accel_u8

        vs, ts = scene_pair
        want = np.asarray(_accel_u8(vs.volumes.accel))
        bridged = scene_from_numpy(scene_fields(vs), device="cpu")
        for vols in (ts.volumes, bridged.volumes):
            assert vols.accel_u8.shape == vols.accel.shape
            assert_same(vols.accel_u8.reshape(-1), want, "accel_u8")

    def test_voxel_colors_not_ported(self):
        """Per-voxel colours, unported before the fit (M8), now build as in
        vrt: the colour grid and its corner-packed view in the corner
        table's dtype, equal to vrt's bit for bit."""
        from vrt.render.gpuscene import build_scene as vbuild
        from vrt.volume.volume import VoxelVolume as VVolume
        from vrt_torch.render.gpuscene import build_scene
        from vrt_torch.volume.volume import VoxelVolume

        colors = np.random.default_rng(3).uniform(
            size=(1, 9, 9, 9, 3)).astype(np.float32)
        kw = dict(camera={}, voxel_colors=colors)
        ts = build_scene([VoxelVolume.from_generator(
            tsdf.Sphere(radius=50.0), 3, 100.0)], [{"volume": 0}],
            march_dtype=torch.bfloat16, device="cpu", **kw)
        vs = vbuild([VVolume.from_generator(vsdf.Sphere(radius=50.0), 3,
                                            100.0)], [{"volume": 0}],
                    march_dtype=jnp.bfloat16, **kw)
        assert ts.use_voxel_colors and vs.use_voxel_colors
        assert ts.voxel_color_corners.dtype == torch.bfloat16
        assert_same(ts.voxel_colors, vs.voxel_colors, "voxel_colors")
        assert_same(ts.voxel_color_corners, vs.voxel_color_corners,
                    "voxel_color_corners")
        # a bridged scene whose packed view vrt left out (above its
        # COLOR_CORNER_BUDGET_BYTES) keeps none: it samples the f32 grid
        fields = scene_fields(vs)
        fields["voxel_color_corners"] = None
        bridged = scene_from_numpy(fields, device="cpu")
        assert bridged.voxel_color_corners is None
        assert torch.equal(bridged.voxel_colors, ts.voxel_colors)


class TestRaysAndTransforms:
    @pytest.mark.parametrize("size", [(64, 64), (160, 90)])
    def test_camera_rays(self, scene_pair, size):
        vs, ts = scene_pair
        w, h = size
        o_v, d_v = vcam.camera_rays(vs.cam_pos, vs.cam_rot, vs.cam_fov, w, h)
        o_t, d_t = tcam.camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, w, h)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_v), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_v), rtol=1e-6,
                                   atol=1e-6)

    def test_world_to_object(self, scene_pair):
        vs, ts = scene_pair
        rng = np.random.default_rng(2)
        o = rng.normal(scale=100.0, size=(256, 3)).astype(np.float32)
        d = rng.normal(size=(256, 3)).astype(np.float32)
        scale = np.asarray([1.5, 0.5, 2.0], np.float32)
        for i in range(ts.num_instances):
            got = tren._world_to_object(ts.inst_pos[i], ts.inst_rot[i],
                                        torch.from_numpy(scale),
                                        torch.from_numpy(o),
                                        torch.from_numpy(d))
            want = vren._world_to_object(vs.inst_pos[i], vs.inst_rot[i],
                                         jnp.asarray(scale), jnp.asarray(o),
                                         jnp.asarray(d))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
            n = rng.normal(size=(256, 3)).astype(np.float32)
            np.testing.assert_allclose(
                tren._object_normal_to_world(ts.inst_rot[i],
                                             torch.from_numpy(scale),
                                             torch.from_numpy(n)).numpy(),
                np.asarray(vren._object_normal_to_world(
                    vs.inst_rot[i], jnp.asarray(scale), jnp.asarray(n))),
                rtol=1e-6, atol=1e-6)


ENGINE_PATH_MODULES = (
    "core.aabb", "core.color", "core.config", "core.logging",
    "core.platform", "core.tick", "utils.profiling", "io.image",
    "io.voxfile", "render.textures", "render.texture_factory", "render.api",
    "scene.scene", "engine.engine", "ui.window", "apps.demo", "apps.render",
    "apps.fit")


def test_port_imports_without_jax():
    """vrt_torch and every submodule — the engine path's among them — import
    with JAX made unimportable, and pull in nothing of ``vrt``."""
    root = os.path.join(os.path.dirname(__file__), "..")
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import vrt_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    vrt_torch.__path__, 'vrt_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k == 'vrt'\n"
        "               or k.startswith(('jax.', 'vrt.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(' '.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 45, names
    for mod in ENGINE_PATH_MODULES:
        assert f"vrt_torch.{mod}" in names, mod


def _imported_roots(path):
    """Top-level names of every module a source file imports, wherever the
    import statement stands."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax_or_vrt():
    """No import statement of ``chip_smoke.py`` or of any file under
    ``vrt_torch/`` — at module level or inside a function — names ``jax`` or
    the ``vrt`` package."""
    root = os.path.join(os.path.dirname(__file__), "..")
    files = [os.path.join(root, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(root, "vrt_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) >= 55
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "vrt", "optax",
                                       "flax"}
        assert not bad, (path, bad)


def test_constructors_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU: every constructor of device state defaults to ``cuda`` (as the
    fit CLI's ``--device`` does)."""
    import inspect

    from vrt_torch.diff.checkpoint import params_from_numpy
    from vrt_torch.render.gpuscene import build_scene

    from vrt_torch.engine.engine import Engine
    from vrt_torch.render.api import Renderer
    from vrt_torch.scene.scene import Scene

    for fn in (flagship_scene, build_scene, scene_from_numpy,
               ttypes.DeviceVolume.from_volume, params_from_numpy,
               Scene.to_gpu, Scene.sync_gpu, Renderer, Engine):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", (fn.__qualname__,
                                                      default)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_engine_entry_points_raise_without_a_card(tmp_path):
    """With the default device and no card the engine path raises; it never
    carries on on the CPU."""
    from tests.test_torch_scene import T, simple_graph
    from vrt_torch.apps import demo, render

    scene = simple_graph(T)[0]
    errors = (RuntimeError, AssertionError)
    with pytest.raises(errors):
        scene.to_gpu()
    with pytest.raises(errors):
        scene.sync_gpu(None)
    renderer = T.api.Renderer(8, 8)
    renderer.start()
    renderer.set_scene_to_render(scene)
    with pytest.raises(errors):
        renderer.render()
    engine = T.engine.Engine(T.engine.EngineInstance(), 8, 8)
    engine.set_scene(scene)
    with pytest.raises(errors):
        engine.render_frame()
    with pytest.raises(errors):
        demo.main(["--frames", "1", "--width", "8", "--height", "8"])
    with pytest.raises(errors):
        render.main(["--width", "8", "--height", "8", "-o",
                     str(tmp_path / "x.png")])


# ---- the host copies the engine path stands on ------------------------------

from vrt.core import grid as vgrid  # noqa: E402
from vrt_torch.core import grid as tgrid  # noqa: E402


class TestGridLaw:
    """``tests/test_core.py::TestGridLaw`` on the port's copy, each value
    equal to vrt's (numpy float32 against jax.numpy float32)."""

    def test_size_law(self):
        for r, n in ((1, 3), (6, 65), (8, 257)):
            law = GridLaw(r, 100.0)
            assert law.n_voxels == n == VGridLaw(r, 100.0).n_voxels
            assert law.n_cells == n - 1 == VGridLaw(r, 100.0).n_cells
        assert tgrid.MAX_RESOLUTION == vgrid.MAX_RESOLUTION
        assert tgrid.DEFAULT_DENSITY == vgrid.DEFAULT_DENSITY

    def test_cell_size(self):
        law = GridLaw(6, 100.0)
        assert law.cell_size == pytest.approx(200.0 / 64.0)
        assert law.cell_size == VGridLaw(6, 100.0).cell_size
        assert law.origin == -100.0

    def test_voxel_positions_span_volume(self):
        law, vlaw = GridLaw(4, 50.0), VGridLaw(4, 50.0)
        assert float(law.voxel_to_position(np.zeros(3))[0]) == -50.0
        p = law.voxel_to_position(np.full(3, law.n_voxels - 1))
        assert float(p[0]) == pytest.approx(50.0)
        idx = np.random.default_rng(0).integers(0, 17, size=(9, 3))
        assert_same(law.voxel_to_position(idx), vlaw.voxel_to_position(idx),
                    "voxel_to_position")

    def test_position_to_cell_floor(self):
        law, vlaw = GridLaw(4, 50.0), VGridLaw(4, 50.0)
        c = law.position_to_cell(np.array([-50.0 + 0.5 * law.cell_size,
                                           0.0, 49.9]))
        assert [int(x) for x in c] == [0, 8, 15]
        pos = np.random.default_rng(1).uniform(-60, 60, size=(64, 3))
        pos[:4] = [[-50, 0, 50], [3.125, 6.25, -3.125],
                   [1.5625, 4.6875, -1.5625], [49.999, -49.999, 0]]
        assert_same(law.position_to_cell(pos), vlaw.position_to_cell(pos),
                    "position_to_cell")
        assert_same(law.position_to_voxel(pos), vlaw.position_to_voxel(pos),
                    "position_to_voxel")     # half-way cases round to even

    def test_flat_order_roundtrip(self):
        n = 5
        arr = np.random.default_rng(0).normal(size=(n, n, n)).astype(
            np.float32)
        assert np.array_equal(tgrid.flat_to_xyz(tgrid.xyz_to_flat(arr), n),
                              arr)
        assert_same(tgrid.xyz_to_flat(arr), vgrid.xyz_to_flat(arr), "flat")
        assert_same(tgrid.flat_to_xyz(arr.reshape(-1), n),
                    vgrid.flat_to_xyz(arr.reshape(-1), n), "xyz")

    def test_flat_order_is_x_major_then_z_then_y(self):
        n = 4
        arr = np.zeros((n, n, n), np.float32)
        x, y, z = 1, 2, 3
        arr[x, y, z] = 7.0
        assert tgrid.xyz_to_flat(arr)[x * n * n + z * n + y] == 7.0

    def test_quantize(self):
        q = tgrid.quantize_density_like_reference(
            np.array([0.1234, -5.6789, 400.0]))
        assert np.allclose(q, [0.12, -5.67, 327.67], atol=1e-6)
        d = np.random.default_rng(2).normal(scale=40.0, size=(9, 9, 9)).astype(
            np.float32)
        d[0, 0, :3] = [0.0, -0.0, -400.0]
        assert_same(tgrid.quantize_density_like_reference(d),
                    vgrid.quantize_density_like_reference(d), "quantize")


class TestQuatHelpers:
    def test_dot_and_right_vector_match(self):
        rng = np.random.default_rng(4)
        q = vq.normalize(rng.normal(size=(7, 4)).astype(np.float32))
        v = rng.normal(size=(7, 3)).astype(np.float32)
        w = rng.normal(size=(7, 3)).astype(np.float32)
        assert_same(tq.dot(v, w), vq.dot(v, w), "dot")
        assert_same(tq.right_vector(q), vq.right_vector(q), "right")
        assert_same(tq.right_vector(q[0]), vq.right_vector(q[0]), "right 1")
        got = tq.right_vector(torch.from_numpy(q))
        np.testing.assert_allclose(got.numpy(), vq.right_vector(q),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            tq.dot(torch.from_numpy(v), torch.from_numpy(w)).numpy(),
            vq.dot(v, w), rtol=1e-6, atol=1e-6)

    def test_host_path_stays_numpy(self):
        q = tq.from_euler_degrees(0.0, 90.0, 0.0)
        assert isinstance(tq.right_vector(q), np.ndarray)
        assert isinstance(tq.dot(tq.RIGHT, tq.UP), np.floating)


class TestVolumeEdits:
    def _pair(self):
        from vrt.volume.volume import VoxelVolume as VVolume
        from vrt_torch.volume.volume import VoxelVolume

        return VoxelVolume(2, 10.0), VVolume(2, 10.0)

    def test_edit_and_dirty_methods_match(self):
        for vol in self._pair():
            assert vol.dirty                      # a new volume is dirty
            vol.clear_dirty()
            assert not vol.dirty
            vol.set_voxel((9, 0, 0), -1.0)        # out of range: ignored
            assert not vol.dirty
            assert vol.get_voxel((9, 0, 0)) == (30.0, 0)
            vol.set_voxel((1, 2, 3), -2.5, 4)
            assert vol.dirty and vol.get_voxel((1, 2, 3)) == (-2.5, 4)
            vol.clear_dirty()
            vol.fill(1.5, 2)
            assert vol.dirty and vol.get_voxel((0, 0, 0)) == (1.5, 2)
            vol.clear_dirty()
            vol.make_dirty()
            assert vol.dirty
        t, v = self._pair()
        for vol in (t, v):
            vol.set_voxel((1, 2, 3), -2.5, 4)
            vol.set_voxel((4, 4, 4), 0.25, 1)
        assert_same(t.sdf, v.sdf, "sdf")
        assert_same(t.voxel_materials, v.voxel_materials, "materials")

    def test_unpack_accel_matches(self):
        sdf = tsdf.bake(_csg(tsdf), GridLaw(4, 100.0))[0]
        for build, vbuild in ((taccel.build_accel, vaccel.build_accel),
                              (taccel.build_accel_chebyshev,
                               vaccel.build_accel_chebyshev)):
            accel = build(sdf, 4)
            skip, surf = taccel.unpack_accel(accel)
            vskip, vsurf = vaccel.unpack_accel(np.asarray(vbuild(sdf, 4)))
            assert_same(skip, vskip, "skip")
            assert_same(surf, vsurf, "has_surface")
            assert surf.any() and (skip[surf] == 0).all()
            ts, tf = taccel.unpack_accel(torch.from_numpy(accel))
            assert_same(ts, vskip, "skip (tensor)")
            assert_same(tf, vsurf, "has_surface (tensor)")


class TestBuildSceneArguments:
    """Fault F1: ``pad_volumes_to`` and ``quantize_densities``, every table
    equal to vrt's."""

    @pytest.mark.parametrize("kw", [
        dict(pad_volumes_to=17), dict(quantize_densities=True),
        dict(pad_volumes_to=33, quantize_densities=True,
             accel_mode="chebyshev", bf16=True)], ids=str)
    def test_tables_equal_vrt(self, kw):
        from tests.test_torch_scene import assert_scene_equal
        from vrt.render.gpuscene import build_scene as vbuild
        from vrt.volume.volume import VoxelVolume as VVolume
        from vrt_torch.render.gpuscene import build_scene
        from vrt_torch.volume.volume import VoxelVolume

        kw = dict(kw)
        bf16 = kw.pop("bf16", False)
        scenes = []
        for build, Volume, S, extra in (
                (build_scene, VoxelVolume, tsdf,
                 dict(device="cpu",
                      march_dtype=torch.bfloat16 if bf16 else None)),
                (vbuild, VVolume, vsdf,
                 dict(march_dtype=jnp.bfloat16 if bf16 else None))):
            vols = [Volume.from_generator(S.Sphere(radius=51.237), 3, 100.0),
                    Volume.from_generator(_csg(S), 4, 100.0)]
            scenes.append(build(
                vols, [{"volume": 1}, {"volume": 0, "position": (0, 90, 0)}],
                camera={}, **kw, **extra))
        ts, vs = scenes
        assert_scene_equal(ts, vs)
        assert ts.volumes.sdf.shape[1] == kw.get("pad_volumes_to", 17)
        if kw.get("quantize_densities"):
            live = ts.volumes.sdf[0, :9, :9, :9].numpy()
            assert np.allclose(live * 100, np.round(live * 100), atol=1e-3)

    def test_pad_below_the_largest_volume_raises(self):
        from vrt_torch.render.gpuscene import build_scene
        from vrt_torch.volume.volume import VoxelVolume

        vol = VoxelVolume.from_generator(tsdf.Sphere(radius=50.0), 4, 100.0)
        with pytest.raises(ValueError):
            build_scene([vol], [{"volume": 0}], camera={}, pad_volumes_to=9,
                        device="cpu")


class TestSmallCopies:
    def test_aabb_matches(self):
        from vrt.core.aabb import AABB as VAABB
        from vrt_torch.core.aabb import AABB

        rng = np.random.default_rng(6)
        pos = rng.normal(size=3).astype(np.float32)
        scale = rng.uniform(0.5, 2.0, size=3).astype(np.float32)
        rot = np.asarray(vq.from_euler_degrees(10.0, 40.0, -20.0))
        out = []
        for cls in (AABB, VAABB):
            a = cls.from_min_max((-1, -2, -3), (1, 2, 3))
            b = cls(center=np.asarray([4, 0, 0], np.float32),
                    extends=np.ones(3, np.float32))
            u = a.combine(b)
            w = a.transform(pos, scale, rot)
            assert u.contains((4.5, 0, 0)) and not a.contains((4.5, 0, 0))
            out.append((u.min, u.max, w.center, w.extends))
        for got, want in zip(*out):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        w2 = AABB.from_min_max((-1, -2, -3), (1, 2, 3)).transform(
            torch.from_numpy(pos), torch.from_numpy(scale),
            torch.from_numpy(rot))
        np.testing.assert_allclose(w2.extends, out[0][3], rtol=1e-6)

    def test_colors_and_tick_manager(self):
        from vrt.core import color as vcolor
        from vrt_torch.core import color as tcolor
        from vrt_torch.core.tick import Tickable, TickManager

        for name in ("WHITE", "BLACK", "RED", "GREEN", "BLUE",
                     "TRANSPARENT"):
            assert_same(getattr(tcolor, name), getattr(vcolor, name), name)
        assert_same(tcolor.lerp(tcolor.RED, tcolor.BLUE, 0.25),
                    vcolor.lerp(vcolor.RED, vcolor.BLUE, 0.25), "lerp")

        class Obj:
            ticks = posts = 0
            should_tick = True

            def tick(self, dt):
                self.ticks += 1

            def post_render(self):
                self.posts += 1

        tm = TickManager()
        a, b = Obj(), Obj()
        b.should_tick = False
        assert isinstance(a, Tickable)
        tm.register(a)
        tm.register(a)
        tm.register(b)
        tm.tick_all(0.1)
        tm.post_render_all()
        assert (a.ticks, b.ticks, a.posts, b.posts) == (1, 0, 1, 1)
        tm.unregister(a)
        tm.clear()
        tm.tick_all(0.1)
        assert a.ticks == 1
        assert TickManager.instance() is TickManager.instance()

    def test_logger_and_platform(self, tmp_path, monkeypatch):
        from vrt_torch.core import logging as tlog
        from vrt_torch.core.platform import apply_platform_env

        monkeypatch.setattr(tlog, "_LOGGER", None)
        log = tlog.get_logger(str(tmp_path))
        assert tlog.get_logger() is log
        log.info("hello")
        for h in list(log.handlers):
            h.flush()
            log.removeHandler(h)
        (name,) = os.listdir(tmp_path)
        assert name.startswith("RendererLog_")
        assert "hello" in open(tmp_path / name).read()
        monkeypatch.setenv("JAX_PLATFORMS", "tpu")
        assert apply_platform_env() is None      # a no-op that stays callable


class TestProfiler:
    """``tests/test_aux.py::TestProfiler`` on the port's profiler."""

    def test_phases_nest_and_accumulate(self):
        import time

        from vrt_torch.utils.profiling import Profiler

        for annotate in (False, True):
            p = Profiler(annotate_device=annotate, sync_device=annotate)
            with p.phase("frame"):
                with p.phase("march"):
                    time.sleep(0.01)
                with p.phase("shade"):
                    time.sleep(0.005)
            with p.phase("frame"):
                pass
            assert p.counts["frame"] == 2
            assert p.counts["frame/march"] == 1
            assert p.totals["frame/march"] >= 0.01
            assert "frame/shade" in p.report()

    def test_rays_per_second(self):
        import time

        from vrt_torch.utils.profiling import Profiler

        p = Profiler(annotate_device=False)
        with p.phase("render"):
            time.sleep(0.01)
        assert 1e4 < p.rays_per_second("render", 10000) < 1e7
        assert p.rays_per_second("never", 10) == 0.0

    def test_frame_stats(self):
        from vrt_torch.utils import FrameStats

        fs = FrameStats()
        for _ in range(3):
            fs.tick()
        assert fs.fps == 0.0  # window not elapsed yet
        fs._window_start -= 2.0
        fs.tick()
        assert fs.fps > 0

    def test_annotation_and_device_trace(self, tmp_path):
        """The spans reach ``torch.profiler``, and a device trace is written
        as a Chrome trace."""
        import json

        from vrt_torch.utils.profiling import Profiler, trace_annotation

        Profiler.start_device_trace(str(tmp_path / "trace"))
        with trace_annotation("outer"):
            with Profiler().phase("inner"):
                torch.ones(8).sum()
        path = Profiler.stop_device_trace()
        names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
        assert {"outer", "inner"} <= names
        with pytest.raises(RuntimeError):
            Profiler.stop_device_trace()


class TestConfig:
    """``tests/test_aux.py::TestConfig`` on the port's copy; the JSON
    crosses between the packages."""

    def test_json_roundtrip(self):
        from vrt.core.config import Config as VConfig
        from vrt_torch.core.config import Config, FitConfig

        c = Config()
        c.render.width = 1920
        c.fit = FitConfig(steps=42, learning_rate=0.5)
        c.dist.model_parallel = 4
        text = c.to_json()
        c2 = Config.from_json(text)
        assert c2.render.width == 1920
        assert c2.fit.steps == 42
        assert c2.dist.model_parallel == 4
        assert VConfig.from_json(text).to_json() == text
        assert Config().to_json() == VConfig().to_json()

    def test_unknown_key_rejected(self):
        from vrt_torch.core.config import Config

        with pytest.raises(ValueError):
            Config.from_json('{"render": {"nope": 1}}')

    def test_file_io(self, tmp_path):
        from vrt_torch.core.config import Config

        path = str(tmp_path / "cfg.json")
        Config().save(path)
        assert Config.load(path).render.width == 512
