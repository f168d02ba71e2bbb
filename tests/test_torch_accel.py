"""The fit step's accel rebuild (``vrt_torch.kernels.accel``) on the CPU,
against ``vrt``'s.

- the plain twin of the kernels' pyramid walk (``occupancy_pyramid_reference``
  and ``skip_from_pyramid_reference``: the 2x2x2 OR pyramid, each cell
  walking it up until a block is occupied) gives ``vrt.volume.accel``'s
  ``build_accel`` bit for bit at R = 2-5 over 1 and 2 volumes, and on the
  edge cases: exactly-zero and -0.0 corners (one sign class), NaN corners
  (a NaN differs from every corner, one sits at a cell's corner 0), an
  all-positive volume (skip = R everywhere) and a single surface cell; it
  refuses a side that is no power of two;
- the fused plain rebuild (``RebuildAccel`` on CPU tensors: the accel, its
  u8 view and the table, f32 x 9 and bf16 x 8) against
  ``vrt/diff/fit.py::rebuild_accel``, bit for bit, and its backward against
  ``jax.vjp`` of ``vrt``'s pack;
- the new wrappers refuse CPU tensors, and ``DeviceVolume`` takes a given
  u8 view and derives one where none is given.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests.test_torch_host import assert_same, scene_fields
from vrt.march import march as vmarch
from vrt.march import types as vtypes
from vrt.volume import accel as vaccel
from vrt_torch.diff import fit as tfit
from vrt_torch.kernels import accel as ka
from vrt_torch.render.gpuscene import scene_from_numpy
from vrt_torch.volume import accel as taccel

vfit = __import__("vrt.diff.fit", fromlist=["fit"])

torch.set_num_threads(2)


def _twin_accel(sdf: torch.Tensor, levels: int) -> torch.Tensor:
    """The kernels' accel by their plain twin: flag, pyramid, walk."""
    flag = taccel.cell_corner_signs_differ(sdf)
    pyramid = ka.occupancy_pyramid_reference(flag, levels)
    skip = ka.skip_from_pyramid_reference(flag, pyramid)
    return (skip << 1) | flag.to(torch.int32)


def _vrt_accel(sdf: np.ndarray, levels: int) -> np.ndarray:
    return np.asarray(jax.vmap(lambda s: vaccel.build_accel(s, levels))(
        jnp.asarray(sdf)))


def _spheres(volumes: int, r: int, seed: int) -> np.ndarray:
    """Seeded SDFs of a sphere each over 2^r + 1 voxels a side, with noise
    so that surface cells scatter."""
    rng = np.random.default_rng(seed)
    n = (1 << r) + 1
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    out = []
    for _ in range(volumes):
        centre = rng.uniform(0, n - 1, 3)
        radius = rng.uniform(0.6, (n - 1) / 3)
        s = np.linalg.norm(grid - centre, axis=-1) - radius
        out.append(s + rng.normal(scale=0.05, size=s.shape))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("volumes", [1, 2])
@pytest.mark.parametrize("r", [2, 3, 4, 5])
def test_pyramid_twin_equals_vrt(r, volumes):
    sdf = _spheres(volumes, r, seed=10 * r + volumes)
    got = _twin_accel(torch.from_numpy(sdf), r)
    want = _vrt_accel(sdf, r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the twin reaches skips above 0 and below R: the walk is exercised
    skips = set(np.unique(want >> 1).tolist())
    assert 0 in skips and len(skips) > 1


def _edge_case(case: str) -> np.ndarray:
    r = 3
    n = (1 << r) + 1
    rng = np.random.default_rng(7)
    if case == "all-positive":
        return np.abs(rng.normal(size=(2, n, n, n))).astype(np.float32) + 1
    if case == "single-surface-cell":
        sdf = np.ones((1, n, n, n), np.float32)
        sdf[0, 8, 8, 8] = -1.0  # the corner voxel: one cell, (7, 7, 7)
        return sdf
    sdf = _spheres(2, r, seed=3)
    idx = rng.integers(0, n, size=(12, 3))
    if case == "zeros":
        # exactly-zero and -0.0 corners, in place of negative and positive
        # samples alike, and a region of the two zeros alone
        for k, (x, y, z) in enumerate(idx):
            sdf[k % 2, x, y, z] = 0.0 if k % 3 else -0.0
        sdf[0, :3, :3, :3] = 0.0
        sdf[0, :3, :3, :2] = -0.0
        return sdf
    if case == "nan":
        for k, (x, y, z) in enumerate(idx[:4]):
            sdf[k % 2, x, y, z] = np.nan
        # cell (2, 3, 4): a NaN at corner 0, the other 7 corners positive;
        # cell (5, 5, 5): a NaN at corner 0, the other 7 corners zeros of
        # either sign (torch.sign(nan) is 0: the NaN must still differ)
        sdf[1, 2:4, 3:5, 4:6] = 5.0
        sdf[1, 2, 3, 4] = np.nan
        sdf[1, 5:7, 5:7, 5:7] = 0.0
        sdf[1, 6, 5:7, 5:7] = -0.0
        sdf[1, 5, 5, 5] = np.nan
        return sdf
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["zeros", "nan", "all-positive",
                                  "single-surface-cell"])
def test_pyramid_twin_edge_cases(case):
    sdf = _edge_case(case)
    r = sdf.shape[-1].bit_length() - 1
    got = _twin_accel(torch.from_numpy(sdf), r)
    want = _vrt_accel(sdf, r)
    np.testing.assert_array_equal(got.numpy(), want)
    flag, skip = want & 1, want >> 1
    if case == "all-positive":
        assert not flag.any() and (skip == r).all()
    elif case == "single-surface-cell":
        assert flag.sum() == 1 and flag[0, 7, 7, 7]
        assert skip[0, 0, 0, 0] == r - 1 and skip[0, 7, 7, 7] == 0
    elif case == "nan":
        # the NaN at corner 0 sets the flag, beside signs or zeros
        assert flag[1, 2, 3, 4] == 1 and flag[1, 5, 5, 5] == 1
    elif case == "zeros":
        # a cell whose corners are +0.0 and -0.0 alone is one sign class
        assert flag[0, 0, 0, 0] == 0


def test_twin_refuses_a_side_not_a_power_of_two():
    flag = torch.zeros((1, 6, 6, 6), dtype=torch.bool)
    with pytest.raises(ValueError):
        ka.occupancy_pyramid_reference(flag, 2)
    with pytest.raises(ValueError):
        ka.occupancy_pyramid_reference(torch.zeros((1, 8, 8, 8),
                                                   dtype=torch.bool), 4)


@pytest.mark.parametrize("table", ["f32x9", "bf16x8"])
def test_fused_plain_rebuild_equals_vrt(table, monkeypatch):
    """``RebuildAccel`` on CPU tensors (the plain rebuild) against
    ``vrt``'s ``rebuild_accel`` of the same scene: the accel, the march's
    u8 view and the corner table bit for bit."""
    if table == "bf16x8":
        # no 9th channel: the budget at 0 in vrt, as a 257^3 table is
        monkeypatch.setattr(vtypes.DeviceVolume, "FUSE_BUDGET_BYTES", 0)
        vs = ge._flagship_scene(resolution=4, march_dtype=jnp.bfloat16)
    else:
        vs = ge._flagship_scene(resolution=4)
    want = vfit.rebuild_accel(vs).volumes
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    dtype = ts.volumes.corners.dtype
    channels = ts.volumes.corners.shape[-1]
    assert (str(dtype), channels) == (
        ("torch.bfloat16", 8) if table == "bf16x8" else ("torch.float32", 9))
    corners, accel, u8 = ka.RebuildAccel.apply(
        ts.volumes.sdf.contiguous(), 4, dtype, channels)
    assert_same(accel, want.accel, "accel")
    assert_same(corners, want.corners, "corners")
    assert_same(u8.reshape(-1), np.asarray(vmarch._accel_u8(want.accel)),
                "accel_u8")
    # and the port's own rebuild_accel, which takes RebuildAccel
    got = tfit.rebuild_accel(ts).volumes
    assert torch.equal(got.accel, accel) and torch.equal(got.accel_u8, u8)
    assert torch.equal(got.corners.view(torch.uint8),
                       corners.view(torch.uint8))


@pytest.mark.parametrize("table", ["f32x9", "bf16x8"])
def test_fused_plain_rebuild_backward_equals_vrt(table):
    """``RebuildAccel``'s backward on CPU tensors (the slices' transpose,
    corner 7 first) against ``jax.vjp`` of ``vrt``'s pack: f32 sums of the
    same f32 terms, within an ulp of order."""
    sdf = _spheres(2, 3, seed=5)
    dtype, jdt, channels = ((torch.float32, jnp.float32, 9)
                            if table == "f32x9"
                            else (torch.bfloat16, jnp.bfloat16, 8))
    g = np.random.default_rng(6).normal(
        size=sdf.shape[:1] + (8, 8, 8, channels)).astype(np.float32)
    leaf = torch.from_numpy(sdf).requires_grad_(True)
    table_t, _, _ = ka.RebuildAccel.apply(leaf, 3, dtype, channels)
    gt = torch.from_numpy(g).to(dtype)
    (got,) = torch.autograd.grad(table_t, leaf, gt)
    accel = _vrt_accel(sdf, 3)

    def pack(s):
        if channels == 9:
            return jax.vmap(lambda a, b: vtypes.pack_cell_corners(
                a, b, dtype=jdt))(s, jnp.asarray(accel))
        return jax.vmap(lambda a: vtypes.pack_cell_corners(a, dtype=jdt))(s)

    _, vjp = jax.vjp(pack, jnp.asarray(sdf))
    (want,) = vjp(jnp.asarray(gt.float().numpy()).astype(jdt))
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("call", [
    lambda s: ka.accel_pyramid_cuda(s, 2),
    lambda s: ka.rebuild_accel_cuda(s, 2, torch.float32, 9),
    lambda s: ka.build_accel_cuda(s, 2),
], ids=["pyramid", "rebuild", "build_accel"])
def test_wrappers_refuse_cpu_tensors(call):
    before = dict(ka.LAUNCHES)
    with pytest.raises(ValueError):
        call(torch.zeros((1, 5, 5, 5)))
    assert ka.LAUNCHES == before


@pytest.mark.parametrize("given", [True, False])
def test_device_volume_takes_a_given_u8_view(given):
    """``u8_view`` is used as it is; a replace without it derives the view
    from the accel anew (so a new accel never keeps a stale view)."""
    from vrt_torch.march.types import _accel_u8
    from vrt_torch.scenes import flagship_scene

    vols = flagship_scene(4, device="cpu").volumes
    accel = torch.zeros_like(vols.accel) + 5
    view = _accel_u8(accel)
    kw = dict(u8_view=view) if given else {}
    got = dataclasses.replace(vols, accel=accel, **kw)
    assert (got.accel_u8 is view) == given
    assert torch.equal(got.accel_u8, view)
    assert "u8_view" not in {f.name for f in dataclasses.fields(got)}
