"""The ray-sharded frame and the mesh of ``vrt_torch.dist`` against
``vrt.dist``, and F3's tail (the single-volume march and resolve, the
unpacked-voxel helpers, ``MarchHit.none``) against their ``vrt``
namesakes.

The port's ranks are gloo processes on the CPU (``spawn_world``: a
``FileStore`` in a temporary directory, every world joined with a
timeout); ``vrt``'s side runs in this process.  The sharded frame must
equal the port's ``render_image`` bit for bit: each ray's row depends on
that ray alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests import torch_dist_workers as workers
from tests.test_torch_host import scene_fields
from vrt.dist import sharding as vsharding
from vrt.march import isosurface as viso
from vrt.march import march as vmarch
from vrt.march import resolve as vresolve
from vrt.march import types as vtypes
from vrt.volume import sdf as VS
from vrt.volume.volume import VoxelVolume as VVolume
from vrt_torch.dist import mesh
from vrt_torch.dist import sharding
from vrt_torch.march import isosurface as tiso
from vrt_torch.march import march as tmarch
from vrt_torch.march import resolve as tresolve
from vrt_torch.march import types as ttypes
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
from vrt_torch.render.renderer import render_image
from vrt_torch.volume import sdf as TS
from vrt_torch.volume.volume import VoxelVolume as TVolume

torch.set_num_threads(2)
TIMEOUT = 240.0


@pytest.mark.parametrize("padded,shards", [(12, 3), (16, 4), (1364, 2),
                                           (1365, 3)])
def test_interleave_perm_matches_vrt(padded, shards):
    vp, vi = vsharding._interleave_perm(padded, shards)
    tp, ti = sharding._interleave_perm(padded, shards)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(vp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(vi))


@pytest.mark.parametrize("total,shards", [(10, 3), (12, 4), (7, 1)])
def test_pad_rays_matches_vrt(total, shards):
    rng = np.random.default_rng(total)
    arrays = [rng.normal(size=(total, 3)).astype(np.float32),
              rng.normal(size=(total, 3)).astype(np.float32),
              rng.normal(size=(total,)).astype(np.float32)]
    want = vsharding._pad_rays(total, shards, *map(jnp.asarray, arrays))
    got = sharding._pad_rays(total, shards, *map(torch.from_numpy, arrays))
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mesh_and_collectives():
    """A (1, 3) mesh: coordinates, the axis groups, all-gather, the sum
    all-reduce and the neighbour pair, with their counts."""
    out = mesh.spawn_world(workers.mesh_world, 3, timeout=TIMEOUT)
    xs = [r["x"] for r in out]
    for rank, r in enumerate(out):
        assert r["backend"] == "gloo"
        assert r["coord"] == (0, rank) and r["index"] == rank
        assert r["size"] == 3 and r["flat"] == rank and r["total"] == 3
        assert r["shape"] == (1, 3)
        np.testing.assert_array_equal(r["gathered"], np.stack(xs))
        np.testing.assert_array_equal(r["summed"], sum(xs))
        # rank i receives what i-1 sent right (x + 100) and i+1 sent left
        want_l = None if rank == 0 else xs[rank - 1] + 100
        want_r = None if rank == 2 else xs[rank + 1] - 100
        for got, want in ((r["left"], want_l), (r["right"], want_r)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
        assert r["stats"]["all_gather"] == 1
        assert r["stats"]["all_reduce"] == 1
        assert r["stats"]["send_recv"] == 1
        assert r["stats"]["staged"] == 0   # CPU tensors: nothing staged


def test_make_render_mesh_checks_the_world():
    """A mesh larger than the world is refused on the rank, and the rank's
    error reaches the caller of ``spawn_world``."""
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="needs 4 ranks"):
        mesh.spawn_world(_bad_mesh, 2, timeout=TIMEOUT)


def _bad_mesh(rank, world):
    mesh.make_render_mesh(2, 2, "cpu")


def test_make_render_mesh_defaults_to_the_card():
    """The mesh runs on the card unless the caller asks for the CPU, as
    every constructor of the port does (``test_constructors_default_to_the
    _card``): its ``device_type`` defaults to ``cuda``."""
    import inspect

    default = inspect.signature(mesh.make_render_mesh).parameters[
        "device_type"].default
    assert default == "cuda"


_FLAGSHIP = {}


def _flagship():
    if not _FLAGSHIP:
        vs = ge._flagship_scene(resolution=4, accel_mode="chebyshev")
        _FLAGSHIP["fields"] = scene_fields(vs)
    return _FLAGSHIP["fields"]


@pytest.mark.parametrize("world,interleave,mode", [
    (2, True, {}), (3, True, {}), (3, False, {}),
    (2, True, {"interp": False}), (2, True, {"debug_overlay": True})])
def test_render_image_sharded_equals_render_image(world, interleave, mode):
    """47x29 (1,363 rays: neither 2 nor 3 divides it) over 2 and 3 data
    ranks.  The frame each rank returns is, bit for bit, its slices of the
    padded (and interleaved) camera rays rendered by ``render_rays`` in this
    process and put back in pixel order.  Against ``render_image`` of the
    whole frame it differs on the CPU in at most 0.5% of the values by at
    most 2 ulp of 1.0: torch's CPU kernels take vectorised transcendental
    and scalar tail paths that round differently, by where a ray falls in
    its batch (on the card every kernel is per lane, and the frame is
    bit-equal: ``chip_smoke.py`` phase 11)."""
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.renderer import render_rays

    fields = _flagship()
    w, h = 47, 29
    scene = scene_from_numpy(fields, device="cpu")
    rmode = RenderMode(**mode)
    whole = render_image(scene, w, h, rmode).numpy()
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, w, h)
    o, d, pad = sharding._pad_rays(w * h, world, o, d)
    assert pad == (-w * h) % world > 0
    inv = torch.arange(o.shape[0])
    if interleave:
        perm, inv = sharding._interleave_perm(o.shape[0], world)
        o, d = o[perm], d[perm]
    local = o.shape[0] // world
    rows = torch.cat([render_rays(scene, o[i * local:(i + 1) * local].clone(),
                                  d[i * local:(i + 1) * local].clone(),
                                  rmode) for i in range(world)])
    want = rows[inv][:w * h].reshape(h, w, 4).numpy()
    out = mesh.spawn_world(workers.sharded_world, world,
                           args=(fields, w, h, mode, interleave),
                           timeout=TIMEOUT)
    for img in out:
        assert img.shape == (h, w, 4)
        np.testing.assert_array_equal(img, want)
    assert (want != whole).mean() < 0.005
    np.testing.assert_allclose(want, whole, rtol=0, atol=2.4e-7)
    assert whole[..., :3].std() > 0.05


# ---- F3's tail: the single-volume entry points and unpacked helpers --------

def _volumes(resolution=4):
    def build(S, Vol):
        csg = S.CSG(shape=S.Sphere(radius=55.0))
        csg.add_child(S.Box(extends=(70.0, 25.0, 25.0),
                            position=np.array([0.0, 0.0, 40.0], np.float32)),
                      S.ADD)
        return Vol.from_generator(csg, resolution, 100.0)
    return build(VS, VVolume), build(TS, TVolume)


def _rays(n=512, seed=5):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-d * rng.uniform(130.0, 300.0, size=(n, 1))
         + rng.normal(scale=30.0, size=(n, 3))).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.3, 150.0, 1e4
                     ).astype(np.float32)
    return o, d, t_max


def test_march_hit_none_matches_vrt():
    want = vtypes.MarchHit.none(5)
    got = ttypes.MarchHit.none(5)
    for f in ("hit", "t", "kind", "cell", "t_in", "t_out", "face_normal"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w)


def test_voxel_fetch_helpers_match_vrt():
    """``make_fetch``, ``gather_corners``, ``corner_fetch_from_voxels``,
    ``trilinear_density`` and ``central_difference_normal`` on cells in and
    around the volume (out-of-range voxels read 0)."""
    vv, tv = _volumes()
    n = tv.n_voxels
    rng = np.random.default_rng(1)
    cell = rng.integers(-2, n + 1, size=(300, 3)).astype(np.int32)
    p = rng.uniform(-0.2, 1.2, size=(300, 3)).astype(np.float32)
    vf = viso.make_fetch(jnp.asarray(vv.sdf), n)
    tf = tiso.make_fetch(torch.from_numpy(tv.sdf), n)
    np.testing.assert_array_equal(tf(torch.from_numpy(cell)).numpy(),
                                  np.asarray(vf(jnp.asarray(cell))))
    vc = viso.corner_fetch_from_voxels(vf)
    tc = tiso.corner_fetch_from_voxels(tf)
    tcell, tp = torch.from_numpy(cell), torch.from_numpy(p)
    np.testing.assert_array_equal(
        tiso.gather_corners(tf, tcell).numpy(),
        np.asarray(viso.gather_corners(vf, jnp.asarray(cell))))
    np.testing.assert_array_equal(tc(tcell).numpy(),
                                  np.asarray(vc(jnp.asarray(cell))))
    np.testing.assert_allclose(
        tiso.trilinear_density(tc, tcell, tp).numpy(),
        np.asarray(viso.trilinear_density(vc, jnp.asarray(cell),
                                          jnp.asarray(p))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tiso.central_difference_normal(tc, tcell, tp).numpy(),
        np.asarray(viso.central_difference_normal(vc, jnp.asarray(cell),
                                                  jnp.asarray(p))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("accel_mode", ["octree", "chebyshev"])
@pytest.mark.parametrize("interp,debug", [(True, False), (False, False),
                                          (True, True)])
def test_march_volume_and_resolve_match_vrt(accel_mode, interp, debug):
    """``march_volume`` (the twin on CPU tensors) against ``vrt``'s, every
    integer field equal and t within the FMA allowance (rtol 1e-4), then
    ``resolve_volume_hits`` on those hits against ``vrt``'s."""
    vv, tv = _volumes(5)
    o, d, t_max = _rays()
    vdv = vtypes.DeviceVolume.from_volume(vv, accel_mode=accel_mode)
    tdv = ttypes.DeviceVolume.from_volume(tv, accel_mode=accel_mode,
                                          device="cpu")
    want = vmarch.march_volume(vdv, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_max), interp=interp,
                               debug_overlay=debug)
    to, td, tt = (torch.from_numpy(x) for x in (o, d, t_max))
    got = tmarch.march_volume(tdv, to, td, tt, interp, debug)
    for f in ("hit", "kind", "cell", "steps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    hit = got.hit.numpy()
    assert hit.sum() > 100
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-4)
    np.testing.assert_allclose(got.face_normal.numpy(),
                               np.asarray(want.face_normal), rtol=1e-6,
                               equal_nan=True)
    vt, vn, vu = vresolve.resolve_volume_hits(vdv, jnp.asarray(o),
                                              jnp.asarray(d), want)
    tt_, tn, tu = tresolve.resolve_volume_hits(tdv, to, td, got)
    np.testing.assert_array_equal(tu.numpy()[hit], np.asarray(vu)[hit])
    np.testing.assert_allclose(tt_.numpy()[hit], np.asarray(vt)[hit],
                               rtol=1e-4)
    np.testing.assert_allclose(tn.numpy()[hit], np.asarray(vn)[hit],
                               rtol=1e-3, atol=1e-4, equal_nan=True)


def test_dist_modules_import_neither_jax_nor_vrt():
    """No module under ``vrt_torch/dist`` (nor ``vrt_torch/apps/scaling.py``
    nor ``chip_smoke.py``) has an import statement naming ``jax`` or
    ``vrt``, and importing them with JAX made unimportable pulls in nothing
    of either."""
    import ast
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.path.join(root, "vrt_torch", "dist")
    paths = [os.path.join(base, f) for f in sorted(os.listdir(base))
             if f.endswith(".py")] + [
        os.path.join(root, "vrt_torch", "apps", "scaling.py"),
        os.path.join(root, "chip_smoke.py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & {"jax", "jaxlib", "vrt"}, path
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "for name in ('vrt_torch.dist', 'vrt_torch.dist.mesh',\n"
        "             'vrt_torch.dist.brick', 'vrt_torch.dist.sharding',\n"
        "             'vrt_torch.dist.slab_render', 'vrt_torch.apps.scaling',\n"
        "             'chip_smoke',\n"
        "             'tests.torch_dist_workers'):\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       (m == 'vrt' or m.startswith(('vrt.', 'jax')))]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
