"""K1, the CUDA march, the gather probe's kernels GP-A, GP-B and GP-C, and
K3, the row gather with its scatter-add backward, against their plain-torch
versions.

This file imports no JAX, so it also runs where the card is:

    python -m pytest --noconftest tests/test_torch_kernels.py

The tests marked ``gpu`` skip where there is no CUDA card.  On the card K1
is built with --fmad=false and sums in the twin's order, so hit and kind
may differ on at most 0.1% of lanes (the budget ``chip_smoke.py`` holds it
to); where both hit with the same kind, t agrees to rtol 1e-4 and the cell
and step count exactly.  The same holds in cube mode and with the debug
overlay.  The gathers are exact: each kernel equals its plain version
(``torch.equal``) on every case and load path of the probe at the Pallas
probes' small shapes.  K3's gather is exact too, on both load paths; its
scatter adds with f32 atomics in an order that changes from run to run, so
it is held to 1e-5 * max|sum| of a float64 ``index_add_`` (and a bf16
table's gradient to that plus its one bf16 rounding).  The fit's loss and
gradients through K1 and K3 on the card agree with the CPU's to rtol 1e-5
(loss), a cosine of 1 - 1e-6 and 1e-3 * max|g| per gradient: the card
rounds the shading's transcendentals and sums in its own order.
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


K3_CASES = {"f32x8": (torch.float32, 8, 8), "f32x9": (torch.float32, 9, 8),
            "bf16x8": (torch.bfloat16, 8, 8),
            "bf16x9": (torch.bfloat16, 9, 8),
            "f32x24": (torch.float32, 24, 24),
            "bf16x24": (torch.bfloat16, 24, 24)}


def _k3_inputs(dtype, ch, out_ch, offset, dev, rows=4096, lanes=200_000):
    """A [rows, ch] table whose base is ``offset`` elements into its
    storage (an offset of 1 breaks 16-byte alignment), indices in
    [-1, rows) with a hot row, and cotangents."""
    gen = torch.Generator().manual_seed(3)
    flat = torch.randn(rows * ch + offset, generator=gen).to(dtype).to(dev)
    table = flat[offset:].view(rows, ch)
    idx = torch.randint(-1, rows, (lanes,), generator=gen, dtype=torch.int32)
    idx[:5000] = 7
    g = torch.randn(lanes, out_ch, generator=gen)
    return table, idx.to(dev), g.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_matches_plain_on_card(case, offset):
    """K3 through ``gather_rows`` (autograd): the gather equals its plain
    version, the table's gradient is the scatter-add; one launch each."""
    from vrt_torch.kernels import rows as K3

    dev = _card()
    dtype, ch, out_ch = K3_CASES[case]
    table, idx, g = _k3_inputs(dtype, ch, out_ch, offset, dev)
    aligned = offset == 0 and (ch * table.element_size()) % 16 == 0
    assert K3.load_path(table, out_ch) == ("v16" if aligned else "ldg")
    t = table.detach().requires_grad_(True)
    before = dict(K3.LAUNCHES)
    got = K3.gather_rows(t, idx, out_ch)
    (grad,) = torch.autograd.grad(got, t, g)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert torch.equal(got, K3.gather_rows_reference(table, idx, out_ch))
    exact = K3.scatter_rows_reference(g, idx, table.shape[0], ch,
                                      torch.float64)
    scale = exact.abs().max().item()
    assert grad.dtype == dtype and grad.shape == table.shape
    err = (grad.double() - exact).abs()
    if dtype == torch.bfloat16:
        err = err - 2.0 ** -8 * exact.abs()
    assert err.max().item() <= 1e-5 * scale
    assert torch.equal(grad[:, out_ch:], torch.zeros_like(grad[:, out_ch:]))


@pytest.mark.gpu
def test_k3_rejects_bad_inputs_on_card():
    from vrt_torch.kernels import rows as K3

    dev = _card()
    table, idx, g = _k3_inputs(torch.float32, 9, 8, 0, dev, lanes=64)
    cases = [
        lambda: K3.gather_rows_cuda(table, idx.long(), 8),          # dtype
        lambda: K3.gather_rows_cuda(table.double(), idx, 8),        # dtype
        lambda: K3.gather_rows_cuda(table, idx.cpu(), 8),           # device
        lambda: K3.gather_rows_cuda(table.t(), idx, 8),             # layout
        lambda: K3.gather_rows_cuda(table, idx[:, None], 8),        # shape
        lambda: K3.gather_rows_cuda(table, idx, 6),                 # out_ch
        lambda: K3.gather_rows_cuda(table, idx, 12),                # out_ch
        lambda: K3.scatter_rows_cuda(g.double(), idx, 4096, 9),     # dtype
        lambda: K3.scatter_rows_cuda(g[:10], idx, 4096, 9),         # lanes
        lambda: K3.scatter_rows_cuda(g, idx, 4096, 4),              # width
        lambda: K3.scatter_rows_cuda(g, idx.cpu(), 4096, 9),        # device
    ]
    before = dict(K3.LAUNCHES)
    for call in cases:
        with pytest.raises(ValueError):
            call()
    assert K3.LAUNCHES == before


@pytest.mark.gpu
def test_fit_grads_on_card_match_cpu():
    """The fit loss (config6's camera, targets 0.25) and its gradients in
    the SDF and the colours on the flagship at resolution 4 with colours,
    64x36, through K1 and K3 on the card against the same on the CPU."""
    from vrt_torch.diff.fit import (_value_and_grad, graft_params,
                                    rebuild_accel, render_views)

    dev = _card()
    cams = [dict(position=(320.0, 0.0, 40.0), rotation=(0.0, 0.0, 1.0, 0.0),
                 fov=60.0)]
    out = []
    for device in (dev, torch.device("cpu")):
        scene = flagship_scene(4, use_colors=True, device=device)

        def loss(p):
            s = rebuild_accel(graft_params(scene, p))
            return torch.mean((render_views(s, cams, 64, 36, RenderMode())
                               - 0.25) ** 2)

        out.append(_value_and_grad(loss, {"sdf": scene.volumes.sdf,
                                          "voxel_colors": scene.voxel_colors}))
    (got_loss, got), (want_loss, want) = out
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in want:
        a = want[k].double().ravel()
        b = got[k].double().cpu().ravel()
        assert torch.isfinite(b).all(), k
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 1.0 - 1e-6, (k, 1.0 - cos)
        assert float((a - b).abs().max()) <= 1e-3 * float(a.abs().max()), k
