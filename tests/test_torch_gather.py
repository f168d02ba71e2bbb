"""The gather probe's plain versions against the Pallas gather probes.

Each Pallas probe function of ``scripts/probe_gather{,2,4,5}.py`` is one
case of ``vrt_torch.apps.probe_gather.CASES``.  Its kernel body is
transcribed below with its ``file:line`` (importing a script prints and
configures JAX at module level), run with ``interpret=True`` on the CPU,
and held against the port's plain version (``run_plain``) on the same
numpy inputs, made by the case from ``default_rng(0)``.
Tolerance 0: every probe is an exact gather; the sums of the looped cases
run in the same order on both sides.  For the one-hot matrix-unit cases
the result is also the bf16-rounded rows.  The looped cases keep the
scripts' round counts (256, and 16 for k3).

The kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels.py, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vrt_torch.apps import probe_gather as P
from vrt_torch.kernels import gather as G

torch.set_num_threads(2)

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _call(body, out_shape, *args, in_specs=None, scratch=()):
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=in_specs or [VMEM] * len(args), out_specs=VMEM,
        scratch_shapes=list(scratch), interpret=True)(*args))


def _prefetch_rows(body, tile, width, idx, src):
    gs = pltpu.PrefetchScalarGridSpec(num_scalar_prefetch=1, grid=(1,),
                                      in_specs=[VMEM], out_specs=VMEM)
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((tile, width), jnp.float32),
        grid_spec=gs, interpret=True)(idx, src))


def take_along(axis):
    """probe_gather.py:51-52 (axis 0), probe_gather2.py:39-40 (axis 0) and
    :58-59 (axis 1), probe_gather4.py:86-87 (axis 0), :101-102 (axis 1)."""
    def run(g):
        def k(s_ref, i_ref, o_ref):
            o_ref[:] = jnp.take_along_axis(s_ref[:], i_ref[:], axis=axis)
        return _call(k, g["idx"].shape, g["src"], g["idx"])
    return run


def flat_take(g):
    """probe_gather.py:83-84, case_c."""
    def k(s_ref, i_ref, o_ref):
        o_ref[:] = jnp.take(s_ref[:], i_ref[:], axis=0)
    return _call(k, g["idx"].shape, g["src"], g["idx"])


def row_index(space):
    """probe_gather.py:99-100 (case_d, table in HBM: ``pltpu.ANY``, now
    ``pl.ANY``) and :116-117 (case_d2, table in VMEM)."""
    def run(g):
        def k(s_ref, i_ref, o_ref):
            o_ref[:] = s_ref[i_ref[:]]
        spec = pl.BlockSpec(memory_space=space)
        return _call(k, (len(g["idx"]), 8), g["src"], g["idx"],
                     in_specs=[spec, VMEM])
    return run


def scalar_rows(g):
    """probe_gather.py:133-140, case_e."""
    tile = len(g["idx"])

    def k(s_ref, i_ref, o_ref, sidx_ref):
        sidx_ref[:] = i_ref[:]

        def body(r, _):
            o_ref[pl.ds(r, 1), :] = s_ref[pl.ds(sidx_ref[r], 1), :]
            return 0

        jax.lax.fori_loop(0, tile, body, 0)

    return _call(k, (tile, 8), g["src"], g["idx"],
                 scratch=[pltpu.SMEM((tile,), jnp.int32)])


def prefetch_rows(g):
    """probe_gather4.py:118-122 (p3) and :141-145 (p3b)."""
    tile, width = len(g["idx"]), g["src"].shape[1]

    def k(i_ref, s_ref, o_ref):
        def body(r, _):
            o_ref[pl.ds(r, 1), :] = s_ref[pl.ds(i_ref[r], 1), :]
            return 0
        jax.lax.fori_loop(0, tile, body, 0)

    return _prefetch_rows(k, tile, width, g["idx"], g["src"])


def onehot(g):
    """probe_gather4.py:164-169 (p4) and probe_gather5.py:146-155 (k4)."""
    kk, tile, iters = g["src"].shape[0], len(g["idx"]), g.get("iters", 0)

    def k(s_ref, i_ref, o_ref):
        if not iters:
            ids = i_ref[:]
            cols = jax.lax.broadcasted_iota(jnp.int32, (tile, kk), 1)
            oh = (cols == ids[:, None]).astype(jnp.bfloat16)
            o_ref[:] = jnp.dot(oh, s_ref[:].astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32)
            return
        sb = s_ref[:].astype(jnp.bfloat16)

        def body(t, acc):
            ids = (i_ref[:] + t) & (kk - 1)
            cols = jax.lax.broadcasted_iota(jnp.int32, (tile, kk), 1)
            oh = (cols == ids[:, None]).astype(jnp.bfloat16)
            return acc + jnp.dot(oh, sb, preferred_element_type=jnp.float32)
        o_ref[:] = jax.lax.fori_loop(0, iters, body,
                                     jnp.zeros((tile, 8), jnp.float32))

    return _call(k, (tile, 8), g["src"], g["idx"])


def composite(g):
    """probe_gather4.py:184-193 (p5) and probe_gather5.py:88-100 (k2): 8
    static rows, a lane gather and a select, a flat take from 1024
    entries."""
    src = g["src"].reshape(8, 128)
    s, lanes = g["idx"].shape
    iters = g.get("iters", 0)

    def gather(s_ref, ii):
        r, c = ii >> 7, ii & 127
        acc = jnp.zeros((s, lanes), jnp.float32)
        for k_ in range(8):
            row = jnp.broadcast_to(s_ref[k_, :][None, :], (s, lanes))
            acc = jnp.where(r == k_, jnp.take_along_axis(row, c, axis=1), acc)
        return acc

    def k(s_ref, i_ref, o_ref):
        if not iters:
            o_ref[:] = gather(s_ref, i_ref[:])
            return
        o_ref[:] = jax.lax.fori_loop(
            0, iters, lambda t, acc: acc + gather(s_ref, (i_ref[:] + t) & 1023),
            jnp.zeros((s, lanes), jnp.float32))

    return _call(k, (s, lanes), src, g["idx"])


def lane_loop(g):
    """probe_gather5.py:46-51 (k1) and :67-72 (k1b)."""
    s, lanes = g["src"].shape

    def k(s_ref, i_ref, o_ref):
        def body(t, acc):
            i = (i_ref[:] + t) & (lanes - 1)
            return acc + jnp.take_along_axis(s_ref[:], i, axis=1)
        o_ref[:] = jax.lax.fori_loop(0, g["iters"], body,
                                     jnp.zeros((s, lanes), jnp.float32))

    return _call(k, (s, lanes), g["src"], g["idx"])


def row_loop(g):
    """probe_gather5.py:118-126 (k3): the rounds overwrite the output."""
    n_rows, tile = g["src"].shape[0], len(g["idx"])

    def k(i_ref, s_ref, o_ref):
        def outer(t, _):
            def body(r, _):
                o_ref[pl.ds(r, 1), :] = s_ref[pl.ds((i_ref[r] + t)
                                                    % n_rows, 1), :]
                return 0
            jax.lax.fori_loop(0, tile, body, 0)
            return 0
        jax.lax.fori_loop(0, g["iters"], outer, 0)

    return _prefetch_rows(k, tile, 8, g["idx"], g["src"])


PALLAS = {
    "probe_gather.case_a": take_along(0),
    "probe_gather.case_b": take_along(0),
    "probe_gather.case_c": flat_take,
    "probe_gather.case_d": row_index(pl.ANY),
    "probe_gather.case_d2": row_index(pltpu.VMEM),
    "probe_gather.case_e": scalar_rows,
    **{f"probe_gather2.axis0-{s}": take_along(0)
       for s in (8, 64, 512, 2048, 8192)},
    **{f"probe_gather2.axis1-{c}": take_along(1) for c in (128, 512, 2048)},
    "probe_gather4.p1": take_along(0),
    "probe_gather4.p2": take_along(1),
    "probe_gather4.p3": prefetch_rows,
    "probe_gather4.p3b": prefetch_rows,
    "probe_gather4.p4": onehot,
    "probe_gather4.p5": composite,
    "probe_gather5.k1": lane_loop,
    "probe_gather5.k1b": lane_loop,
    "probe_gather5.k2": composite,
    "probe_gather5.k3": row_loop,
    "probe_gather5.k4": onehot,
}


def test_every_pallas_probe_has_a_case():
    assert sorted(PALLAS) == sorted(c.name for c in P.CASES if c.pallas)


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_plain_matches_pallas(name):
    case = P.BY_NAME[name]
    (g,) = case.make()
    want = PALLAS[name](g)
    got = P.run_plain(case, P.to_device(case, "cpu"))[0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case.kernel == "GP-C" and not g.get("iters"):
        rows = torch.from_numpy(g["src"]).bfloat16().float().numpy()
        np.testing.assert_array_equal(got, rows[g["idx"]])


def test_wrappers_refuse_cpu():
    """The kernels' wrappers refuse CPU tensors instead of falling back."""
    src = torch.rand(64, 8)
    idx = torch.randint(0, 64, (32,), dtype=torch.int32)
    before = dict(G.LAUNCHES)
    with pytest.raises(ValueError):
        G.row_gather_cuda(src, idx)
    with pytest.raises(ValueError):
        G.take_along_axis_cuda(src, idx[:, None].expand(32, 8).contiguous(),
                               0)
    with pytest.raises(ValueError):
        G.onehot_gather_cuda(src, idx)
    assert G.LAUNCHES == before
