"""The slab-sharded frame of ``vrt_torch.dist.slab_render`` against
``vrt.dist.slab_render`` and against the port's replicated frame (the
sizes of tests/test_slab_render.py: resolution 5, 48x48).

The port's ranks are gloo processes on the CPU (``spawn_world``); ``vrt``'s
side runs under ``shard_map`` over this process's virtual devices.  Against
``vrt``'s slab frame the port's is held to the f32 frame tolerance of
tests/test_torch_render.py (``assert_close_f32``); against the port's
replicated ``render_image`` to ``_compare``'s gates of
tests/test_slab_render.py (interior hits equal, boundary-cell brackets
within the cell).  ``python -m tests.test_torch_slab_render`` rewrites the
config5 fixture ``tests/fixtures/config5_r9_slab4_160x90.npy``: ``vrt``'s
``render_slab_image`` of config5 at resolution 9 (513^3) over 4 of the 8
virtual devices, 160x90, ``RenderMode()``, RGB.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests import torch_dist_workers as workers
from tests.test_torch_host import scene_fields
from tests.test_torch_render import assert_close_f32
from vrt.core import quat as vq
from vrt.core.material import Material
from vrt.dist import slab_render as vslab
from vrt.dist.brick import shard_volume as vshard
from vrt.dist.mesh import make_render_mesh as vmesh
from vrt.render.gpuscene import RenderMode as VMode
from vrt.render.gpuscene import build_scene as vbuild
from vrt.volume import sdf as VS
from vrt.volume.volume import VoxelVolume as VVolume
from vrt_torch import scenes
from vrt_torch.dist import brick, mesh
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy
from vrt_torch.render.renderer import render_image

torch.set_num_threads(2)
TIMEOUT = 300.0
W = H = 48
CONFIG5_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                               "config5_r9_slab4_160x90.npy")


def _compare(img_ref, img_sh, max_band=0.25):
    """tests/test_slab_render.py's gates: at least 97% of pixels within
    1e-5, the largest difference under ``max_band``, and fewer than 1% of
    pixels off by more than 0.25."""
    diff = np.abs(img_ref[..., :3] - img_sh[..., :3]).max(axis=-1)
    assert (diff < 1e-5).mean() > 0.97, (diff.mean(), (diff >= 1e-5).mean())
    if max_band is not None:
        assert diff.max() < max_band, diff.max()
    assert (diff > 0.25).mean() < 0.01, (diff > 0.25).mean()


def _scene_and_volume(reflective=False):
    """tests/test_slab_render.py's scene: a CSG sphere-plus-box at
    resolution 5, camera at (300, 40, 60)."""
    csg = VS.CSG(shape=VS.Sphere(radius=55.0))
    csg.add_child(VS.Box(extends=(70.0, 25.0, 25.0),
                         position=np.array([0.0, 0.0, 40.0], np.float32)),
                  VS.ADD)
    mat = Material(albedo=(0.8, 0.45, 0.25, 1.0),
                   roughness=0.12 if reflective else 0.7,
                   metallic=0.5 if reflective else 0.0)
    vol = VVolume.from_generator(csg, 5, 100.0, material=mat)
    env = np.zeros((6, 4, 4, 3), np.float32)
    env[:] = (0.25, 0.45, 0.85)
    scene = vbuild(
        [vol], [{"volume": 0}],
        camera={"position": (300.0, 40.0, 60.0),
                "rotation": np.asarray(vq.from_euler_degrees(0.0, 180.0,
                                                             -10.0))},
        dir_light={"direction": np.asarray(vq.forward_vector(
            vq.from_euler_degrees(0.0, 45.0, -30.0))), "strength": 6.0},
        env=env)
    return scene, vol


def _slab_fields(slabs):
    return {f: np.asarray(getattr(slabs, f)) for f in brick._FIELDS}


CASES = {
    "interp": dict(reflective=False, mode={}, accel="octree"),
    "reflective": dict(reflective=True, mode={}, accel="octree"),
    "cube": dict(reflective=False, mode={"interp": False}, accel="octree"),
    "cube_unlit": dict(reflective=False, mode={"interp": False,
                                               "lit": False},
                       accel="octree"),
    "chebyshev": dict(reflective=False, mode={}, accel="chebyshev"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_frame_matches_vrt_and_the_replicated_frame(case):
    """``render_slab_image`` over 4 gloo ranks: every rank holds the same
    frame, within the f32 frame tolerance of ``vrt``'s slab frame, and
    within ``_compare``'s gates of the port's replicated frame (cube mode
    without the largest-difference band, as in ``vrt``'s test); each rank
    marched its slab once per trace and resolved once per level.

    The lit cube frame is held to the port's replicated frame only: a cube
    hit's shadow origin (hit - 0.1 d, the hit 0.1 past a node exit) lies on
    a voxel face by construction, so the last bit of its arithmetic picks
    the start cell of the shadow ray (tests/test_golden_full.py's
    ``_assert_cube_lit`` masks that acne); XLA's CPU backend and eager torch
    round it differently on some 1.4% of this frame's pixels.  The unlit
    cube frame, without shadows, is held to ``vrt``'s."""
    c = CASES[case]
    vscene, vol = _scene_and_volume(c["reflective"])
    vslabs = vshard(vol, 4, accel_mode=c["accel"])
    vmode = VMode(**c["mode"])
    want = np.asarray(vslab.render_slab_image(vscene, vslabs, vmesh(1, 4),
                                              W, H, vmode))
    fields = scene_fields(vscene)
    out = mesh.spawn_world(
        workers.slab_render_world, 4,
        args=(fields, _slab_fields(vslabs), c["accel"], W, H, c["mode"]),
        timeout=TIMEOUT)
    got = out[0]["img"]
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    for r in out[1:]:
        np.testing.assert_array_equal(r["img"], got)
    if case != "cube":
        assert_close_f32(got[..., :3], want[..., :3], f"{case} vs vrt")
    replicated = render_image(scene_from_numpy(fields, device="cpu"), W, H,
                              RenderMode(**c["mode"])).numpy()
    _compare(replicated, got, max_band=None if case == "cube" else 0.25)
    # a lit frame: a march, a resolve and a shadow march (unlit: no shadow);
    # with the mirror bounce two levels more, the last without shadows
    # (recursion cap 3)
    want_calls = ({"march": 5, "resolve": 3} if c["reflective"]
                  else {"march": 1 + c["mode"].get("lit", True),
                        "resolve": 1})
    for r in out:
        assert r["calls"] == want_calls, r["calls"]


def test_config5_volume_is_vrts():
    """``scenes.config5_slab_volume`` bakes ``vrt``'s
    ``scaling.build_volume`` grid bit for bit (resolution 6, 65^3)."""
    from vrt.apps.scaling import build_volume

    want = build_volume(6)
    got = scenes.config5_slab_volume(6)
    np.testing.assert_array_equal(got.sdf, want.sdf)
    np.testing.assert_array_equal(got.voxel_materials, want.voxel_materials)
    assert got.extends == want.extends


def _vrt_config5(resolution):
    """``vrt``'s config5 volume and its stub scene (``scaling.run``'s
    ``default_fit_scene`` and light); the volume baked a slab of x-planes
    at a time through ``vrt``'s own generator (its one-shot bake of 513^3
    would hold some 20 GB)."""
    from vrt.core.grid import GridLaw

    ext = 100.0
    csg = VS.CSG(shape=VS.Sphere(radius=0.62 * ext))
    csg.add_child(VS.Box(extends=(0.75 * ext, 0.3 * ext, 0.3 * ext),
                         position=np.array([0.0, 0.0, 0.45 * ext],
                                           np.float32)), VS.ADD)
    csg.add_child(VS.Sphere(radius=0.35 * ext,
                            position=np.array([0.3 * ext, 0.0, 0.0],
                                              np.float32)), VS.SUBTRACT)
    law = GridLaw(resolution, ext)
    n = law.n_voxels
    sdf = np.empty((n, n, n), np.float32)
    yz = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  axis=-1)
    step = max(1, (1 << 22) // (n * n))
    for x0 in range(0, n, step):
        xs = np.arange(x0, min(n, x0 + step))
        idx = np.concatenate(
            [np.broadcast_to(xs[:, None, None, None], (len(xs), n, n, 1)),
             np.broadcast_to(yz[None], (len(xs), n, n, 2))], axis=-1)
        pos = np.asarray(idx, np.float32) * law.cell_size + law.origin
        sdf[x0:x0 + len(xs)] = csg.evaluate(pos)
    vol = VVolume(resolution, ext, sdf=sdf)
    light = np.asarray(vq.forward_vector(vq.from_euler_degrees(
        *scenes.CONFIG5_LIGHT_EULER)), np.float32)
    scene = vslab.default_fit_scene(vol.n_voxels, vol.cell_size,
                                    vol.extends, light)
    return vol, scene


@pytest.mark.parametrize("resolution", [5])
def test_config5_slab_frame_matches_vrt(resolution):
    """config5 at resolution 5 through the port's slab frame (the stub
    scene of ``scenes.config5_scene``) over 4 gloo ranks, against ``vrt``'s
    ``render_slab_image`` of the same, at the f32 frame tolerance."""
    vol, vscene = _vrt_config5(resolution)
    vslabs = vshard(vol, 4)
    want = np.asarray(vslab.render_slab_image(vscene, vslabs, vmesh(1, 4),
                                              64, 36, VMode()))
    tvol = scenes.config5_slab_volume(resolution)
    np.testing.assert_array_equal(tvol.sdf, vol.sdf)
    fields = scene_fields(vscene)
    mine = scenes.config5_scene(tvol, device="cpu")
    for name in ("cam_pos", "cam_rot", "tint", "roughness", "env",
                 "dir_light_dir", "dir_light_strength"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      fields[name], err_msg=name)
    out = mesh.spawn_world(
        workers.slab_render_world, 4,
        args=(fields, _slab_fields(vslabs), "octree", 64, 36, {}),
        timeout=TIMEOUT)
    assert_close_f32(out[0]["img"][..., :3], want[..., :3],
                     "config5 r5 vs vrt")


def test_config5_fixture_is_vrt_render():
    """The 160x90 config5 fixture is ``vrt``'s slab frame at resolution 9
    over 4 virtual devices: a fresh render may move a pixel only by float
    rounding."""
    want = np.load(CONFIG5_FIXTURE)
    assert want.shape == (90, 160, 3) and want.dtype == np.float32
    assert np.isfinite(want).all() and want.std() > 0.05
    got = write_fixture(None)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def write_fixture(path=CONFIG5_FIXTURE):
    """``vrt``'s ``render_slab_image`` of config5 at resolution 9 (513^3)
    over 4 of the 8 virtual devices, 160x90, ``RenderMode()``, RGB; saved
    to ``path`` unless it is None."""
    assert len(jax.devices()) >= 4
    vol, scene = _vrt_config5(9)
    assert vol.n_voxels == 513
    slabs = vshard(vol, 4)
    del vol
    img = np.asarray(vslab.render_slab_image(scene, slabs, vmesh(1, 4), 160,
                                             90, VMode()))[..., :3]
    if path is not None:
        np.save(path, img.astype(np.float32))
    return img


if __name__ == "__main__":
    # the virtual devices of tests/conftest.py (read when JAX first starts
    # its CPU backend, after this module's import)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
