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
        # a bridged scene whose packed view vrt left out gets one packed
        fields = scene_fields(vs)
        fields["voxel_color_corners"] = None
        bridged = scene_from_numpy(fields, device="cpu")
        assert torch.equal(bridged.voxel_color_corners,
                           ts.voxel_color_corners)


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


def test_port_imports_without_jax():
    """vrt_torch and every submodule import with JAX made unimportable."""
    root = os.path.join(os.path.dirname(__file__), "..")
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import vrt_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    vrt_torch.__path__, 'vrt_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'vrt.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20, proc.stdout


def test_constructors_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU: every constructor of device state defaults to ``cuda`` (as the
    fit CLI's ``--device`` does)."""
    import inspect

    from vrt_torch.diff.checkpoint import params_from_numpy
    from vrt_torch.render.gpuscene import build_scene

    for fn in (flagship_scene, build_scene, scene_from_numpy,
               ttypes.DeviceVolume.from_volume, params_from_numpy):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", (fn.__qualname__,
                                                      default)
