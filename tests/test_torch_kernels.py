"""K1, the CUDA march, and the gather probe's kernels GP-A, GP-B and GP-C,
against their plain-torch versions.

This file imports no JAX, so it also runs where the card is:

    python -m pytest --noconftest tests/test_torch_kernels.py

The tests marked ``gpu`` skip where there is no CUDA card.  On the card K1
is built with --fmad=false and sums in the twin's order, so hit and kind
may differ on at most 0.1% of lanes (the budget ``chip_smoke.py`` holds it
to); where both hit with the same kind, t agrees to rtol 1e-4 and the cell
and step count exactly.  The same holds in cube mode and with the debug
overlay.  The gathers are exact: each kernel equals its plain version
(``torch.equal``) on every case and load path of the probe at the Pallas
probes' small shapes.
"""

import numpy as np
import pytest
import torch

from vrt_torch.march import march as tmarch
from vrt_torch.render.gpuscene import RenderMode
from vrt_torch.render.renderer import render_image
from vrt_torch.scenes import flagship_scene

torch.set_num_threads(2)

LANE_BUDGET = 1e-3
CONFIGS = {"r5-octree-f32": (5, "octree", None),
           "r5-cheb-bf16": (5, "chebyshev", torch.bfloat16),
           "r7-cheb-bf16": (7, "chebyshev", torch.bfloat16)}


def random_lanes(seed, n):
    """Rays aimed near the volumes from outside and inside their boxes,
    a third with finite t_max clamps, volume ids 0 and 1."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(40.0, 260.0, size=(n, 1)).astype(np.float32)
    o = (-d * dist + rng.normal(scale=30.0, size=(n, 3))).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.35,
                     rng.uniform(0.0, 300.0, size=n), 1e4).astype(np.float32)
    vid = rng.integers(0, 2, size=n).astype(np.int32)
    return [torch.from_numpy(x) for x in (o, d, t_max, vid)]


def assert_hits_close(got, want, budget=LANE_BUDGET):
    g = {f: getattr(got, f).cpu() for f in ("hit", "kind", "t", "cell",
                                             "steps", "face_normal")}
    w = {f: getattr(want, f).cpu() for f in g}
    agree = (g["hit"] == w["hit"]) & (g["kind"] == w["kind"])
    assert agree.float().mean().item() >= 1.0 - budget
    both = agree & w["hit"]
    assert int(both.sum()) > 100
    torch.testing.assert_close(g["t"][both], w["t"][both], rtol=1e-4,
                               atol=0.0)
    assert torch.equal(g["cell"][both], w["cell"][both])
    assert torch.equal(g["steps"][agree], w["steps"][agree])
    torch.testing.assert_close(g["face_normal"][both],
                               w["face_normal"][both], equal_nan=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_cpu_tensors_take_the_twin():
    """On the CPU the dispatcher runs the twin, and K1's wrapper refuses
    CPU tensors instead of falling back."""
    from vrt_torch.kernels import march as k1

    ts = flagship_scene(4)
    o, d, t_max, vid = random_lanes(0, 512)
    before = k1.LAUNCHES
    got = tmarch.march_lanes(ts.volumes, vid, o, d, t_max)
    want = tmarch.march_lanes_reference(ts.volumes, vid, o, d, t_max)
    assert k1.LAUNCHES == before
    assert_hits_close(got, want, budget=0.0)
    with pytest.raises(ValueError):
        k1.march_lanes_cuda(ts.volumes, vid, o, d, t_max)


@pytest.mark.gpu
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("interp,debug", [(True, False), (False, False),
                                          (True, True), (False, True)],
                         ids=["interp", "cube", "interp-overlay",
                              "cube-overlay"])
def test_k1_matches_twin_on_card(config, interp, debug):
    from vrt_torch.kernels import march as k1

    dev = _card()
    res, mode, dtype = CONFIGS[config]
    ts = flagship_scene(res, mode, dtype, device=dev)
    o, d, t_max, vid = (x.to(dev) for x in random_lanes(7, 65536))
    before = k1.LAUNCHES
    got = tmarch.march_lanes(ts.volumes, vid, o, d, t_max, interp, debug)
    assert k1.LAUNCHES == before + 1
    want = tmarch.march_lanes_reference(ts.volumes, vid, o, d, t_max,
                                        interp, debug)
    torch.cuda.synchronize()
    assert_hits_close(got, want)
    if not interp or debug:
        for f in ("t_in", "t_out"):
            assert torch.equal(getattr(got, f), getattr(want, f))


@pytest.mark.gpu
def test_k1_rejects_bad_inputs_on_card():
    from vrt_torch.kernels import march as k1

    dev = _card()
    ts = flagship_scene(4, device=dev)
    o, d, t_max, vid = (x.to(dev) for x in random_lanes(1, 64))
    with pytest.raises(ValueError):
        k1.march_lanes_cuda(ts.volumes, vid.long(), o, d, t_max)
    with pytest.raises(ValueError):
        k1.march_lanes_cuda(ts.volumes, vid, o.double(), d, t_max)
    with pytest.raises(ValueError):
        k1.march_lanes_cuda(ts.volumes, vid, o.t().contiguous().t(), d,
                            t_max)
    ts.volumes.sdf = ts.volumes.sdf[:, :-1].contiguous()
    with pytest.raises(ValueError):
        k1.march_lanes_cuda(ts.volumes, vid, o, d, t_max, interp=False)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["r5-octree-f32", "r7-cheb-bf16"])
def test_frame_on_card_matches_cpu(config):
    """The 64x64 frame through K1 on the card against the same frame on the
    CPU twin, under the ``_assert_close`` thresholds of
    tests/test_golden_full.py (q98 < 6e-3, mean < 2.5e-3, under 0.5% of
    pixels off by more than 0.05)."""
    dev = _card()
    res, mode, dtype = CONFIGS[config]
    got = render_image(flagship_scene(res, mode, dtype, device=dev), 64, 64,
                       RenderMode()).cpu().numpy()
    want = render_image(flagship_scene(res, mode, dtype), 64, 64,
                        RenderMode()).numpy()
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    assert np.quantile(diff, 0.98) < 6e-3
    assert diff.mean() < 2.5e-3
    assert (diff.max(axis=-1) > 0.05).mean() < 0.005


@pytest.mark.gpu
def test_gather_kernels_match_plain_on_card():
    """Every Pallas-probe case of the gather probe, on every load path:
    kernel == plain version, and one launch per gather."""
    from vrt_torch.apps import probe_gather as P
    from vrt_torch.kernels import gather as G

    dev = _card()
    for case in P.CASES:
        if not case.pallas:
            continue
        gathers = P.to_device(case, dev)
        want = P.run_plain(case, gathers)
        for path in P.paths(case, gathers):
            before = G.LAUNCHES[case.kernel]
            got = P.run_kernel(case, gathers, path)
            torch.cuda.synchronize()
            assert G.LAUNCHES[case.kernel] == before + len(gathers)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    (case.name, path)


@pytest.mark.gpu
def test_gather_wrappers_reject_bad_inputs_on_card():
    from vrt_torch.kernels import gather as G

    dev = _card()
    src = torch.rand(512, 8, device=dev)
    idx = torch.randint(0, 512, (64,), dtype=torch.int32, device=dev)
    cases = [
        lambda: G.row_gather_cuda(src, idx.long()),             # idx dtype
        lambda: G.row_gather_cuda(src.double(), idx),           # src dtype
        lambda: G.row_gather_cuda(src, idx.cpu()),              # device
        lambda: G.row_gather_cuda(src.t(), idx),                # layout
        lambda: G.row_gather_cuda(src[:, :3].contiguous(), idx, path="v16"),
        lambda: G.row_gather_cuda(torch.rand(65536, 8, device=dev), idx,
                                  path="smem"),                 # too big
        lambda: G.row_gather_cuda(src.bfloat16(), idx, iters=2,
                                  reduce="sum"),                # sum of bf16
        lambda: G.take_along_axis_cuda(src, idx[:, None], 0),   # shape
        lambda: G.take_along_axis_cuda(src, idx[None, :8], 2),  # axis
        lambda: G.onehot_gather_cuda(torch.rand(500, 8, device=dev), idx),
        lambda: G.onehot_gather_cuda(src[:, :4].contiguous(), idx),
        lambda: G.onehot_gather_cuda(src, idx[:, None]),
    ]
    before = dict(G.LAUNCHES)
    for i, call in enumerate(cases):
        with pytest.raises(ValueError):
            call()
    assert G.LAUNCHES == before
