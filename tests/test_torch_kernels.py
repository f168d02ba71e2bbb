"""K1, the CUDA march (per lane and over a whole scene), the fused resolve,
the gather probe's kernels GP-A, GP-B and GP-C, and K3, the row gather with
its scatter-add backward, against their plain-torch versions.

This file imports no JAX, so it also runs where the card is:

    python -m pytest --noconftest tests/test_torch_kernels.py

The tests marked ``gpu`` skip where there is no CUDA card.  On the card K1
is built with --fmad=false and sums in the twin's order, so hit and kind
may differ on at most 0.1% of lanes (the budget ``chip_smoke.py`` holds it
to); where both hit with the same kind, t agrees to rtol 1e-4 and the cell
and step count exactly.  The same holds in cube mode and with the debug
overlay, and for the scene march, whose winning instance and summed steps
must also agree on those lanes and whose any-hit variant must equal the
plain version's ``hit`` within the same budget.  The fused resolve is built
the same way and must equal the plain ``resolve_scene_reference`` bit for
bit (NaN equal to NaN).  The gathers are exact: each kernel equals its plain version
(``torch.equal``) on every case and load path of the probe at the Pallas
probes' small shapes.  K3's gather is exact too, on both load paths; its
scatter adds with f32 atomics in an order that changes from run to run, so
it is held to 1e-5 * max|sum| of a float64 ``index_add_`` (and a bf16
table's gradient to that plus its one bf16 rounding).  The fit's loss and
gradients through K1 and K3 on the card agree with the CPU's to rtol 1e-5
(loss), a cosine of 1 - 1e-6 and 1e-3 * max|g| per gradient: the card
rounds the shading's transcendentals and sums in its own order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vrt_torch.march import march as tmarch
from vrt_torch.render import renderer as tren
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

    ts = flagship_scene(4, device="cpu")
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


MODES = pytest.mark.parametrize(
    "interp,debug", [(True, False), (False, False), (True, True),
                     (False, True)],
    ids=["interp", "cube", "interp-overlay", "cube-overlay"])


def _crowd(res, mode, dtype, n_inst, dev):
    """The flagship's two volumes under ``n_inst`` instances: 1, the
    sphere alone; 2, the flagship; 12, ``vrt/apps/bench.py``'s grid pulled
    together until boxes overlap, with instance 1 moved onto instance 0
    (equal entry t: the stable order decides), instance 5 rotated and
    scaled, and instance 3 inactive."""
    scene = flagship_scene(res, mode, dtype, device=dev)
    if n_inst == 2:
        return scene
    pos = np.zeros((n_inst, 3), np.float32)
    for i in range(n_inst):
        gx, gy = divmod(i, 4)
        pos[i] = (-110.0 * gx, 120.0 * (gy - 1.5), 60.0 * ((i % 3) - 1))
    rot = np.tile(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32), (n_inst, 1))
    scale = np.ones((n_inst, 3), np.float32)
    active = np.ones(n_inst, bool)
    if n_inst > 5:
        pos[1] = pos[0]
        rot[5] = (0.0, 0.0, np.sin(0.3), np.cos(0.3))
        scale[5] = (1.2, 0.8, 1.0)
        active[3] = False
    return dataclasses.replace(
        scene,
        inst_volume=(torch.arange(n_inst, dtype=torch.int32) % 2).to(dev),
        inst_pos=torch.from_numpy(pos).to(dev),
        inst_rot=torch.from_numpy(rot).to(dev),
        inst_scale=torch.from_numpy(scale).to(dev),
        inst_active=torch.from_numpy(active).to(dev))


def scene_rays(seed, n, dev):
    """World rays aimed into the cloud of instances from outside and
    inside, a third with finite t_max clamps and a tenth with -inf."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(40.0, 500.0, size=(n, 1)).astype(np.float32)
    aim = rng.normal(scale=(80.0, 150.0, 50.0), size=(n, 3))
    o = (-d * dist + aim - (100.0, 0.0, 0.0)).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.35,
                     rng.uniform(0.0, 600.0, size=n), 1e4).astype(np.float32)
    t_max[rng.uniform(size=n) < 0.1] = -np.inf
    return [torch.from_numpy(x).to(dev) for x in (o, d, t_max)]


def test_scene_wrappers_refuse_cpu_tensors():
    """On the CPU the dispatchers run the plain versions; the scene march's
    and the fused resolve's wrappers refuse CPU tensors instead of falling
    back, and launch nothing."""
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr

    ts = flagship_scene(4, device="cpu")
    o, d, t_max = scene_rays(0, 256, "cpu")
    before = (k1.LAUNCHES, k1.SCENE_LAUNCHES, kr.LAUNCHES)
    hit, inst = tren.march_scene(ts, o, d, t_max)
    want, winst = tren.march_scene_reference(ts, o, d, t_max)
    assert torch.equal(hit.hit, want.hit) and torch.equal(inst, winst)
    assert hit.hit.any()
    assert torch.equal(tren.march_scene_any_hit(ts, o, d, t_max), want.hit)
    got = tren.resolve_scene(ts, o, d, hit, inst)
    for a, b in zip(got, tren.resolve_scene_reference(ts, o, d, hit, inst)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    with pytest.raises(ValueError):
        k1.march_scene_cuda(ts, o, d, t_max)
    with pytest.raises(ValueError):
        k1.march_scene_cuda(ts, o, d, t_max, any_hit=True)
    with pytest.raises(ValueError):
        kr.resolve_scene_cuda(ts, o, d, hit, inst)
    assert (k1.LAUNCHES, k1.SCENE_LAUNCHES, kr.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("n_inst", [1, 2, 12])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@MODES
def test_scene_march_matches_plain_on_card(config, interp, debug, n_inst):
    """One launch of the scene march against its plain version (the
    candidate loop over the twin) on the same rays, and the any-hit
    variant against the plain version's ``hit``."""
    from vrt_torch.kernels import march as k1

    dev = _card()
    res, mode, dtype = CONFIGS[config]
    ts = _crowd(res, mode, dtype, n_inst, dev)
    o, d, t_max = scene_rays(5, 65536, dev)
    before = (k1.LAUNCHES, k1.SCENE_LAUNCHES)
    got, inst = tren.march_scene(ts, o, d, t_max, interp, debug)
    assert (k1.LAUNCHES, k1.SCENE_LAUNCHES) == (before[0], before[1] + 1)
    want, winst = tren.march_scene(ts, o, d, t_max, interp, debug,
                                   lane_marcher=tmarch.march_lanes_reference)
    torch.cuda.synchronize()
    assert_hits_close(got, want)
    agree = (got.hit == want.hit) & (got.kind == want.kind)
    assert torch.equal(inst[agree], winst[agree])
    assert torch.equal(inst >= 0, got.hit)
    if n_inst == 12:
        winners = set(winst[want.hit].unique().tolist())
        assert {0, 1, 5} <= winners and 3 not in winners, winners
    if not debug:
        any_hit = tren.march_scene_any_hit(ts, o, d, t_max, interp)
        assert k1.SCENE_LAUNCHES == before[1] + 2
        flips = (any_hit != want.hit).float().mean().item()
        assert any_hit.dtype == torch.bool and flips <= LANE_BUDGET


RESOLVE_TABLES = {"f32x8": (None, 8), "f32x9": (None, 9),
                  "bf16x8": (torch.bfloat16, 8),
                  "bf16x9": (torch.bfloat16, 9)}


def _with_table(scene, ch, offset):
    """``scene`` with its corner table cut to ``ch`` channels and based
    ``offset`` elements into its storage (1 breaks 16-byte alignment)."""
    corners = scene.volumes.corners[..., :ch]
    flat = torch.empty(corners.numel() + offset, dtype=corners.dtype,
                       device=corners.device)
    table = flat[offset:].view(corners.shape)
    table.copy_(corners)
    return dataclasses.replace(
        scene, volumes=dataclasses.replace(scene.volumes, corners=table))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("table", sorted(RESOLVE_TABLES))
@pytest.mark.parametrize("interp,debug", [(True, False), (False, False),
                                          (True, True)],
                         ids=["interp", "cube", "interp-overlay"])
def test_fused_resolve_matches_plain_on_card(table, offset, interp, debug):
    """The fused resolve against ``resolve_scene_reference`` on the hits of
    a scene march over 12 instances, some lanes with ``inst = -1``: equal
    bit for bit.  The dispatcher takes the kernel when no graph is
    recorded and K3's differentiable path when the table requires one."""
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import rows as k3

    dev = _card()
    dtype, ch = RESOLVE_TABLES[table]
    ts = _with_table(_crowd(5, "chebyshev", dtype, 12, dev), ch, offset)
    corners = ts.volumes.corners
    aligned = offset == 0 and (ch * corners.element_size()) % 16 == 0
    assert kr.load_path(corners) == ("v16" if aligned else "ldg")
    o, d, t_max = scene_rays(6, 65536, dev)
    hit, inst = tren.march_scene(ts, o, d, t_max, interp, debug)
    inst[::5] = -1
    assert int((hit.hit & (inst < 0)).sum()) > 100
    before = (kr.LAUNCHES, k3.LAUNCHES["K3 gather"])
    got = tren.resolve_scene(ts, o, d, hit, inst)
    assert (kr.LAUNCHES, k3.LAUNCHES["K3 gather"]) == (before[0] + 1,
                                                       before[1])
    with torch.no_grad():
        want = tren.resolve_scene_reference(ts, o, d, hit, inst)
    torch.cuda.synchronize()
    kinds = set(hit.kind[hit.hit].unique().tolist())
    assert kinds >= ({1, 5} if debug else {1} if interp else {4}), kinds
    for name, a, b in zip(("t", "normal", "unlit"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        same = (a == b) | ((a != a) & (b != b))
        assert bool(same.all()), (name, int((~same).sum()))
    corners.requires_grad_(True)
    before = (kr.LAUNCHES, k3.LAUNCHES["K3 gather"])
    tren.resolve_scene(ts, o, d, hit, inst)
    assert (kr.LAUNCHES, k3.LAUNCHES["K3 gather"]) == (before[0],
                                                       before[1] + 1)


@pytest.mark.gpu
def test_scene_wrappers_reject_bad_inputs_on_card():
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr

    dev = _card()
    ts = _crowd(4, "octree", None, 2, dev)
    o, d, t_max = scene_rays(1, 64, dev)
    hit, inst = tren.march_scene(ts, o, d, t_max)
    crowd = _crowd(4, "octree", None, 33, dev)
    sliced = dataclasses.replace(ts, inst_pos=ts.inst_pos.t().contiguous().t())
    cases = [
        lambda: k1.march_scene_cuda(ts, o.cpu(), d, t_max),         # device
        lambda: k1.march_scene_cuda(ts, o.double(), d, t_max),      # dtype
        lambda: k1.march_scene_cuda(ts, o, d.t().contiguous().t(), t_max),
        lambda: k1.march_scene_cuda(ts, o, d, t_max[:-1]),          # shape
        lambda: k1.march_scene_cuda(crowd, o, d, t_max),            # > 32
        lambda: k1.march_scene_cuda(sliced, o, d, t_max),           # layout
        lambda: k1.march_scene_cuda(ts, o, d, t_max, debug_overlay=True,
                                    any_hit=True),
        lambda: kr.resolve_scene_cuda(ts, o.cpu(), d, hit, inst),   # device
        lambda: kr.resolve_scene_cuda(ts, o, d, hit, inst.long()),  # dtype
        lambda: kr.resolve_scene_cuda(ts, o, d.t().contiguous().t(), hit,
                                      inst),                        # layout
        lambda: kr.resolve_scene_cuda(ts, o, d, hit, inst[:-1]),    # shape
        lambda: kr.resolve_scene_cuda(sliced, o, d, hit, inst),     # layout
    ]
    before = (k1.LAUNCHES, k1.SCENE_LAUNCHES, kr.LAUNCHES)
    for call in cases:
        with pytest.raises(ValueError):
            call()
    assert (k1.LAUNCHES, k1.SCENE_LAUNCHES, kr.LAUNCHES) == before


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
    want = render_image(flagship_scene(res, mode, dtype, device="cpu"), 64,
                        64, RenderMode()).numpy()
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
