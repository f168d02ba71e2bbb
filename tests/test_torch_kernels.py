"""K1, the CUDA march (per lane and over a whole scene), the fused resolve
and its backward, the gather probe's kernels GP-A, GP-B and GP-C, K3, the
row gather with its scatter-add backward, and K4, the shade kernels with
their backward kernels, against their plain-torch versions.

This file imports no JAX, so it also runs where the card is:

    python -m pytest --noconftest tests/test_torch_kernels.py

The tests marked ``gpu`` skip where there is no CUDA card.  On the card K1
is built with --fmad=false and sums in the twin's order, so hit and kind
may differ on at most 0.1% of lanes (the budget ``chip_smoke.py`` holds it
to); where both hit with the same kind, t agrees to rtol 1e-4 and the cell
and step count exactly.  The same holds in cube mode and with the debug
overlay, and for the scene march, whose winning instance and summed steps
must also agree on those lanes and whose any-hit variant must equal the
plain version's ``hit`` within the same budget; the scene march's capped
kernel must equal its first design field by field.  The fused resolve is
built
the same way and must equal the plain ``resolve_scene_reference`` bit for
bit (NaN equal to NaN), with or without a graph.  Its backward sums in
the closed form's order and adds the corner cotangents with f32 atomics: the
ray gradients are held to 1e-5 * max|g| of the plain closed form
(``resolve_scene_backward_reference``) on the same tensors, the table's to
1e-5 * max|sum| of that closed form summed in float64.  The gathers are exact: each kernel equals its plain version
(``torch.equal``) on every case and load path of the probe at the Pallas
probes' small shapes.  K3's gather is exact too, on both load paths; its
scatter adds with f32 atomics (one per element, or one 16-byte vector
reduction per four channels) in an order that changes from run to run, so
it is held to 1e-5 * max|sum| of a float64 ``index_add_`` (and a bf16
table's gradient to that plus its one bf16 rounding).  The fit's loss and
gradients through K1 and K3 on the card agree with the CPU's to rtol 1e-5
(loss), a cosine of 1 - 1e-6 and 1e-3 * max|g| per gradient: the card
rounds the shading's transcendentals and sums in its own order.  The shade
surface backward's merged kernel gives per-ray cotangents bit-equal to its
first design's, and both colour tables within the backward's tolerance.
The combine backward's and the fused resolve forward's redesigns are
bit-equal to their first designs on every output, with outputs filled
with NaN first.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vrt_torch.march import march as tmarch
from vrt_torch.march.types import MarchHit
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
    sphere alone; 2, the flagship; 3, a grid of three with instance 1 moved
    onto instance 0 (equal entry t: the stable order decides) and instance
    2 inactive; 12 (and 32), ``vrt/apps/bench.py``'s grid pulled together
    until boxes overlap, with instance 1 moved onto instance 0, instance 5
    rotated and scaled, and instance 3 inactive."""
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
    if n_inst == 3:
        pos[1] = pos[0]
        active[2] = False
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


# The contention case of the surface backward: the flagship at resolution 4
# (cells of 12.5 units) with per-voxel colours, seen by its own camera
# rotation (looking along -x) from 30 units off the sphere's +x pole through
# an 8 degree field, so that every ray of a 64x64 frame hits one cell and
# all the colour-row cotangents of the level fall on one row.
CONTENTION_CAMERA = dict(position=(80.0, -66.0, 4.0), fov=8.0)


def contention_scene(scene):
    """``scene`` (the flagship at resolution 4 with colours, of the port or
    of vrt) seen from ``CONTENTION_CAMERA``."""
    pos, fov = scene.cam_pos, scene.cam_fov
    if isinstance(pos, torch.Tensor):
        return dataclasses.replace(
            scene, cam_pos=torch.tensor(CONTENTION_CAMERA["position"],
                                        dtype=pos.dtype, device=pos.device),
            cam_fov=torch.tensor(CONTENTION_CAMERA["fov"], dtype=fov.dtype,
                                 device=fov.device))
    return dataclasses.replace(
        scene, cam_pos=np.asarray(CONTENTION_CAMERA["position"], np.float32),
        cam_fov=np.float32(CONTENTION_CAMERA["fov"]))


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
    before = (k1.LAUNCHES, k1.SCENE_LAUNCHES, dict(kr.LAUNCHES))
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
    with pytest.raises(ValueError):
        kr.resolve_scene_backward_cuda(ts, o, d, hit, inst, hit.t, d)
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


@pytest.mark.gpu
@MODES
def test_config7_scene_march_matches_plain_on_card(interp, debug):
    """config7's 12 instances (``vrt_torch.apps.bench.config7_scene`` at
    resolution 6) through its own camera's 512x512 rays: one launch of the
    scene march against its plain version, and the any-hit variant, as the
    crowd's case above; the camera's rays reach instances of both
    volumes."""
    from vrt_torch.apps import bench
    from vrt_torch.kernels import march as k1
    from vrt_torch.render.camera import camera_rays

    dev = _card()
    ts = bench.config7_scene(6, device=dev)
    o, d = camera_rays(ts.cam_pos, ts.cam_rot, ts.cam_fov, 512, 512)
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.full((o.shape[0],), tren.RADIANCE_TMAX, device=dev)
    before = k1.SCENE_LAUNCHES
    got, inst = tren.march_scene(ts, o, d, t_max, interp, debug)
    assert k1.SCENE_LAUNCHES == before + 1
    want, winst = tren.march_scene(ts, o, d, t_max, interp, debug,
                                   lane_marcher=tmarch.march_lanes_reference)
    torch.cuda.synchronize()
    assert_hits_close(got, want)
    agree = (got.hit == want.hit) & (got.kind == want.kind)
    assert torch.equal(inst[agree], winst[agree])
    assert set(ts.inst_volume[winst[want.hit].long()].tolist()) == {0, 1}
    if not debug:
        any_hit = tren.march_scene_any_hit(ts, o, d, t_max, interp)
        flips = (any_hit != want.hit).float().mean().item()
        assert flips <= LANE_BUDGET


# ---- K1's scene march: the capped kernel against the plain version and the
# first design -------------------------------------------------------------
#
# The capped kernel changes only the block and the register budget: on the
# same rays it equals the first design field by field, and the plain version
# as the first design does.

MARCH_TABLES = {"f32x8": (None, 8, 0), "f32x9": (None, 9, 0),
                "bf16x8": (torch.bfloat16, 8, 0),
                "bf16x8-unaligned": (torch.bfloat16, 8, 1)}


def _assert_march_equal(got, want):
    for f in ("hit", "t", "kind", "cell", "t_in", "t_out", "face_normal",
              "steps"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, f
        if a.is_floating_point():
            assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b)))
                        .all()), f
        else:
            assert torch.equal(a, b), f


@pytest.mark.gpu
@pytest.mark.parametrize("n_inst", [3, 12, 32])
@pytest.mark.parametrize("table", sorted(MARCH_TABLES))
@MODES
def test_scene_march_designs_on_card(table, interp, debug, n_inst):
    """The capped scene march on 1, 31, 33, 1000 and 4096 rays against the
    first design (equal field by field) and the plain version (within the
    lane budget, the winning instance on agreeing lanes); the any-hit
    variant likewise."""
    from vrt_torch.kernels import march as k1

    dev = _card()
    dtype, ch, offset = MARCH_TABLES[table]
    ts = _with_table(_crowd(5, "chebyshev", dtype, n_inst, dev), ch, offset)
    o, d, t_max = scene_rays(9, 4096, dev)
    want, winst = tren.march_scene(ts, o, d, t_max, interp, debug,
                                   lane_marcher=tmarch.march_lanes_reference)
    assert int(want.hit.sum()) > 100
    for rays in (1, 31, 33, 1000, 4096):
        args = (ts, o[:rays], d[:rays], t_max[:rays], interp, debug)
        before = k1.SCENE_LAUNCHES
        got, inst = k1.march_scene_cuda(*args)
        old, old_inst = k1.march_scene_cuda(*args, _old_design=True)
        assert k1.SCENE_LAUNCHES == before + 2
        torch.cuda.synchronize()
        _assert_march_equal(got, old)
        assert torch.equal(inst, old_inst)
        w = dataclasses.replace(want, **{
            f.name: getattr(want, f.name)[:rays]
            for f in dataclasses.fields(want)})
        agree = (got.hit == w.hit) & (got.kind == w.kind)
        assert agree.float().mean().item() >= 1.0 - LANE_BUDGET \
            or int((~agree).sum()) == 0
        assert torch.equal(got.steps[agree], w.steps[agree])
        assert torch.equal(got.cell[agree & w.hit], w.cell[agree & w.hit])
        assert torch.equal(inst[agree], winst[:rays][agree])
        if not debug:
            any_hit = k1.march_scene_cuda(*args[:5], any_hit=True)
            old_any = k1.march_scene_cuda(*args[:5], any_hit=True,
                                          _old_design=True)
            assert torch.equal(any_hit, old_any)
            flips = (any_hit != w.hit).float().mean().item()
            assert flips <= LANE_BUDGET or rays < 1000 and flips == 0.0


# What ptxas prints for two template variants of each scene march, as a
# build log holds it (abridged names).
PTXAS_LOG = """\
ptxas info    : Function properties for _ZN4_GN_25march_scene_capped_kernelIfLb0ELb0ELb0ELb0EEEvNS_11SceneParamsE
    160 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 0 barriers, 160 bytes cumulative stack size
ptxas info    : Function properties for _ZN4_GN_18march_scene_kernelIfLb0ELb0ELb0ELb0EEEvNS_11SceneParamsE
    160 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 74 registers, used 0 barriers, 160 bytes cumulative stack size
ptxas info    : Function properties for _ZN4_GN_25march_scene_capped_kernelI6__halfLb1ELb1ELb0ELb0EEEvNS_11SceneParamsE
    192 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 192 bytes cumulative stack size
ptxas info    : Function properties for _ZN4_GN_18march_scene_kernelI6__halfLb1ELb1ELb0ELb0EEEvNS_11SceneParamsE
    160 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 0 barriers, 160 bytes cumulative stack size
"""


@pytest.mark.parametrize("kernel,want", [
    ("march_scene_capped_kernel", dict(variants=2, registers=[79, 96],
                                       stack_bytes=[160, 192],
                                       spill_bytes=[0, 80])),
    ("march_scene_kernel", dict(variants=2, registers=[74, 118],
                                stack_bytes=[160, 160], spill_bytes=[0, 0])),
    ("surface_bwd_merged_kernel", None)])
def test_ptxas_usage_reads_a_build_log(kernel, want):
    """``_build.ptxas_usage`` spans a kernel's variants in a build log, and
    one kernel's name inside another's does not match it."""
    from vrt_torch.kernels._build import ptxas_usage

    assert ptxas_usage(PTXAS_LOG, kernel) == want


PTXAS_PLAIN_LOG = """\
ptxas info    : Function properties for _ZN4_GN_14combine_kernelENS_13CombineParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 64 bytes smem
ptxas info    : Function properties for _ZN4_GN_18combine_bwd_kernelENS_16CombineBwdParamsE
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Function properties for _ZN4_GN_23combine_resident_kernelILb1EEEvNS_13CombineParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 1536 bytes smem
"""


@pytest.mark.parametrize("kernel,want", [
    ("combine_kernel", dict(variants=1, registers=[62, 62],
                            stack_bytes=[0, 0], spill_bytes=[0, 0])),
    ("combine_resident_kernel", dict(variants=1, registers=[56, 56],
                                     stack_bytes=[0, 0],
                                     spill_bytes=[0, 0]))])
def test_ptxas_usage_reads_a_plain_kernel(kernel, want):
    """A kernel that is no template (its mangled name ends its nested name
    with E) is read as one variant, and no other kernel's lines with it."""
    from vrt_torch.kernels._build import ptxas_usage

    assert ptxas_usage(PTXAS_PLAIN_LOG, kernel) == want


# the shade backward kernels' default launches and their material and light
# variants: the last template argument
PTXAS_VARIANT_LOG = """\
ptxas info    : Function properties for _ZN4_GN_25surface_bwd_merged_kernelILb1ELb1ELb1ELb0EEEvNS_16SurfaceBwdParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Function properties for _ZN4_GN_25surface_bwd_merged_kernelILb1ELb1ELb1ELb1EEEvNS_16SurfaceBwdParamsE
    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Function properties for _ZN4_GN_18combine_bwd_kernelILb0EEEvNS_16CombineBwdParamsE
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 8 bytes cumulative stack size
"""


@pytest.mark.parametrize("kernel,last,want", [
    ("surface_bwd_merged_kernel", None,
     dict(variants=2, registers=[80, 80], stack_bytes=[0, 24],
          spill_bytes=[0, 48])),
    ("surface_bwd_merged_kernel", False,
     dict(variants=1, registers=[80, 80], stack_bytes=[0, 0],
          spill_bytes=[0, 0])),
    ("surface_bwd_merged_kernel", True,
     dict(variants=1, registers=[80, 80], stack_bytes=[24, 24],
          spill_bytes=[48, 48])),
    ("combine_bwd_kernel", False,
     dict(variants=1, registers=[90, 90], stack_bytes=[8, 8],
          spill_bytes=[0, 0])),
    ("combine_bwd_kernel", True, None)])
def test_ptxas_usage_reads_one_variant(kernel, last, want):
    """``last`` keeps the variants whose last template argument is that
    bool: the shade backward kernels' default launches apart from their
    material and light variants."""
    from vrt_torch.kernels._build import ptxas_usage

    assert ptxas_usage(PTXAS_VARIANT_LOG, kernel, last) == want


@pytest.mark.parametrize("regs,threads,want", [
    (118, 256, 16 / 64), (96, 64, 20 / 64), (80, 64, 24 / 64),
    (80, 256, 24 / 64), (32, 256, 1.0), (64, 64, 32 / 64)])
def test_warp_slots_of_registers(regs, threads, want):
    """``_build.warp_slots``: the warp slots of an H100 SM that blocks of a
    kernel's size and registers fill, from the register file alone."""
    from vrt_torch.kernels._build import warp_slots

    assert warp_slots(regs, threads) == want


@pytest.mark.parametrize("probe,source", [
    ("MARCH", "march.cu"), ("SURFACE_BWD", "shade.cu"),
    ("SHADE_FWD", "shade.cu"), ("RESOLVE_BWD", "resolve.cu"),
    ("SLAB", "march.cu"), ("COMBINE_BWD", "shade.cu"),
    ("RESOLVE_FWD", "resolve.cu"), ("SURFACE_VOXELS", "shade.cu"),
    ("TEX_ENV", "shade.cu")])
def test_probe_caps_variants_name_source_constants(probe, source):
    """Every variant of ``vrt_torch.apps.probe_caps`` sets constants that
    its source defines exactly once (the probe rewrites them with this
    pattern and refuses any other count), and the default variant sets
    none."""
    import re

    from vrt_torch.apps import probe_caps
    from vrt_torch.kernels import _build

    text = (_build.CSRC / source).read_text()
    variants = getattr(probe_caps, probe)
    assert variants[0][1] == {}
    for _, consts, _ in variants:
        for name in consts:
            assert len(re.findall(rf"constexpr (int|bool) {name} = \w+;",
                                  text)) == 1, name


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
    bit for bit, without a graph and with one (the table requires a
    gradient).  The dispatcher takes the kernel both times and K3 never;
    instance transforms that require a gradient take the kernel too, and
    the backward its instance variant."""
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
    with torch.no_grad():
        want = tren.resolve_scene_reference(ts, o, d, hit, inst)
    kinds = set(hit.kind[hit.hit].unique().tolist())
    assert kinds >= ({1, 5} if debug else {1} if interp else {4}), kinds
    for graph in (False, True):
        corners.requires_grad_(graph)
        before = (dict(kr.LAUNCHES), dict(k3.LAUNCHES))
        got = tren.resolve_scene(ts, o, d, hit, inst)
        torch.cuda.synchronize()
        assert kr.LAUNCHES == {"forward": before[0]["forward"] + 1,
                               "backward": before[0]["backward"]}
        assert k3.LAUNCHES == before[1]
        assert got[0].requires_grad == graph
        assert got[1].requires_grad == graph and not got[2].requires_grad
        for name, a, b in zip(("t", "normal", "unlit"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            same = (a == b) | ((a != a) & (b != b))
            assert bool(same.all()), (name, graph, int((~same).sum()))
    corners.requires_grad_(False)
    moving = dataclasses.replace(
        ts, inst_pos=ts.inst_pos.clone().requires_grad_(True))
    before = (dict(kr.LAUNCHES), dict(kr.VARIANT_LAUNCHES),
              dict(k3.LAUNCHES))
    t, _, _ = tren.resolve_scene(moving, o, d, hit, inst)
    assert type(t.grad_fn).__name__ == "ResolveSceneBackward"
    (g,) = torch.autograd.grad(t, [moving.inst_pos],
                               torch.isfinite(t).float())
    torch.cuda.synchronize()
    assert kr.LAUNCHES == {"forward": before[0]["forward"] + 1,
                           "backward": before[0]["backward"] + 1}
    assert kr.VARIANT_LAUNCHES == {"backward instances":
                                   before[1]["backward instances"] + 1}
    assert k3.LAUNCHES == before[2]
    # a cube hit (kind 4) carries no gradient; surface and solid-entry
    # hits do
    carries = bool(((hit.kind == 1) | (hit.kind == 2)).any())
    assert bool(torch.isfinite(g).all()) and bool(g.any()) == carries


def _off_boundary(x):
    """A copy of ``x`` based one element into its storage: off every
    16-byte boundary, so a redesign's launch over it takes its scalar
    path."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


def _every_kind(hit):
    """``hit`` with some lanes' kinds rewritten so that every kind the
    fused resolve treats apart occurs: exhausted lanes (3) and solid
    entries (2) among the march's surface, debug and miss lanes."""
    lane = torch.arange(hit.kind.numel(), device=hit.kind.device)
    kind = hit.kind.clone()
    kind[lane % 13 == 4] = 3
    kind[lane % 17 == 6] = 2
    return dataclasses.replace(hit, kind=kind)


RESOLVE_DESIGN_CASES = [f"{table}-{load}-{n}" for table in ("f32", "bf16")
                        for load in ("v16", "ldg") for n in (1, 2, 12, 20)] \
    + ["planes-2", "planes-4"]


def _resolve_designs(kr, call, want, lanes=None):
    """``call(old_design)`` on the redesign and on the first design, one
    launch each, outputs filled with NaN (True) first: bit-equal on every
    lane, and on ``lanes`` (all where None) equal to ``want``, NaN equal to
    NaN."""
    saved = kr._empty
    kr._empty = _nan_outputs(kr)
    try:
        before = kr.LAUNCHES["forward"]
        new = call(False)
        old = call(True)
    finally:
        kr._empty = saved
    torch.cuda.synchronize()
    assert kr.LAUNCHES["forward"] == before + 2
    for name, a, b, w in zip(("t", "normal", "unlit"), new, old, want):
        assert _bit_equal(a, b), name
        if lanes is not None:
            a, w = a[lanes], w[lanes]
        assert _bit_equal(a, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", RESOLVE_DESIGN_CASES)
def test_fused_resolve_designs_on_card(case):
    """The fused resolve's redesign (every lane's kind, t and face normal
    loaded at once, a hit lane's ray, instance and cell at once after them)
    against its first design and its plain version, on rays based on and
    off a 16-byte boundary, outputs filled with NaN first: bit-equal on
    every lane, with f32 and bf16 tables on the 16-byte and the element
    loads, over 1, 2, 12 and 20 instances, lanes of every kind (surface,
    solid entry, debug, exhausted, miss, some with ``inst = -1``); and the
    planes variant over each slab of a volume split in 2 and 4, equal to
    ``resolve_slab_hits`` on the lanes the slab owns."""
    from vrt_torch.kernels import resolve as kr

    dev = _card()
    table, rest = case.split("-", 1)
    if table == "planes":
        from vrt_torch.core import quat as vq
        from vrt_torch.dist import brick
        from vrt_torch.dist.slab_render import SlabTracer, default_fit_scene

        vol = _slab_volume()
        s_count = int(rest)
        slabs = brick.shard_volume(vol, s_count)
        light = np.asarray(vq.forward_vector(vq.from_euler_degrees(
            0, 45, -30)), np.float32)
        scene = default_fit_scene(vol.n_voxels, vol.cell_size, vol.extends,
                                  light, device=dev)
        o_w, d_w, t_max = _slab_rays(dev)
        for s in range(s_count):
            slab = slabs.local(s, dev)
            o, d = SlabTracer(slab, None)._object_rays(scene, o_w, d_w)
            hit = _every_kind(brick.march_volume_slab(slab, o, d, t_max))
            inst = torch.where(hit.hit, 0, -1).to(torch.int32)
            with torch.no_grad():
                want = brick.resolve_slab_hits(slab, o, d, hit)
            owned = (hit.hit & (hit.cell[:, 0] >= slab.cell_lo)
                     & (hit.cell[:, 0] < slab.cell_hi) & (hit.kind == 1))
            assert int(owned.sum()) > 0 or s in (0, s_count - 1)
            for rays in (o_w, _off_boundary(o_w)):
                _resolve_designs(
                    kr, lambda old: kr.resolve_slab_cuda(
                        scene, slab, rays, d_w, hit, inst, _old_design=old),
                    want, owned)
        return
    load, n_inst = rest.split("-")
    dtype = torch.bfloat16 if table == "bf16" else None
    ts = _with_table(_crowd(5, "chebyshev", dtype, int(n_inst), dev), 8,
                     0 if load == "v16" else 1)
    assert kr.load_path(ts.volumes.corners) == load
    o, d, t_max = scene_rays(6, 65536, dev)
    hit, inst = tren.march_scene(ts, o, d, t_max, True, True)
    inst[::5] = -1
    hit = _every_kind(hit)
    kinds = torch.bincount(hit.kind, minlength=6).tolist()
    assert all(kinds[k] > 0 for k in (0, 1, 2, 3, 5)), kinds
    with torch.no_grad():
        want = tren.resolve_scene_reference(ts, o, d, hit, inst)
    for rays in (o, _off_boundary(o)):
        _resolve_designs(
            kr, lambda old: kr.resolve_scene_cuda(ts, rays, d, hit, inst,
                                                  _old_design=old),
            want)


def on_cell_faces(ts, o, d, hit, inst, lanes, seed):
    """Put ``lanes`` of a march's rays and hits on faces of their cells in
    instance 0 (not rotated, unit scale, a whole-numbered position: exact
    in f32): a ray along +x whose y lies on the low y face and whose z on
    the high z face of a seeded cell, t inside that cell, so that the hit
    point's p = (p_x, 0, 1) exactly.  There the trilinear weights |(1-i) -
    p| have their kink, where ``vrt`` takes d|a|/da as 1."""
    rng = np.random.default_rng(seed)
    dev = o.device
    vol = int(ts.inst_volume[0])
    h = ts.volumes.cell_size[vol]
    ext = ts.volumes.extends[vol]
    n = int(ts.volumes.n[vol])
    k = lanes.numel()
    cell = torch.from_numpy(rng.integers(1, n - 2, size=(k, 3)).astype(
        np.int32)).to(dev)
    base = cell.to(torch.float32) * h - ext        # as the kernels form it
    frac = torch.from_numpy(rng.uniform(0.1, 0.9, size=k).astype(
        np.float32)).to(dev)
    pos = ts.inst_pos[0]
    o[lanes] = torch.stack([(pos[0] - 300.0).expand(k), pos[1] + base[:, 1],
                            pos[2] + (base[:, 2] + h)], dim=-1)
    d[lanes] = d.new_tensor([1.0, 0.0, 0.0])
    hit.t[lanes] = 300.0 + base[:, 0] + frac * h
    hit.cell[lanes] = cell
    hit.kind[lanes] = 1
    hit.hit[lanes] = True
    inst[lanes] = 0


def _special_lanes(ts, o, d, hit, inst, seed, group=200):
    """Overwrite some lanes of a march's rays and hits (``group`` surface
    lanes per case) with the cases the backward treats apart; returns the
    lanes by name.  Only what the backward reads (rays, kind, t, cell,
    inst) is touched.  ``face`` lanes lie on faces of their cells
    (``on_cell_faces``)."""
    rng = np.random.default_rng(seed)
    dev = o.device
    surface = (hit.kind == 1).nonzero().ravel()
    assert surface.numel() > 8 * group
    pick = surface[torch.from_numpy(rng.permutation(surface.numel())).to(dev)]
    lanes = {name: pick[group * i:group * (i + 1)] for i, name in enumerate(
        ("bad_t", "zero_d_axis", "unsafe", "edge_low", "edge_high", "tie",
         "solid", "face"))}
    hit.t[lanes["bad_t"][:group // 2]] = float("inf")
    hit.t[lanes["bad_t"][group // 2:]] = float("nan")
    d[lanes["zero_d_axis"], 1] = 0.0
    d[lanes["unsafe"]] = 0.0                 # F'(t0) = 0: no IFT term
    hit.cell[lanes["edge_low"], 0] = 0       # the -x neighbour is outside
    n = ts.volumes.n[ts.inst_volume[inst.clamp_min(0).long()].long()]
    hit.cell[lanes["edge_high"], 2] = n[lanes["edge_high"]] - 2
    # solid entries: a symmetric ray ties the x and y slabs of instance 0
    # (not rotated, unit scale, whole-numbered position: exact in f32);
    # random rays never tie
    for name in ("tie", "solid"):
        hit.kind[lanes[name]] = 2
    o[lanes["tie"]] = ts.inst_pos[0] + o.new_tensor([-300.0, -300.0, 7.0])
    d[lanes["tie"]] = d.new_tensor([1.0, 1.0, 0.0])
    inst[lanes["tie"]] = 0
    d[lanes["solid"][:group // 4], 2] = 0.0
    on_cell_faces(ts, o, d, hit, inst, lanes["face"], seed)
    return lanes


@pytest.mark.gpu
@pytest.mark.parametrize("n_inst", [1, 2, 12])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("table", sorted(RESOLVE_TABLES))
def test_resolve_backward_matches_plain_on_card(table, offset, n_inst):
    """The fused resolve's backward against its plain version, the closed
    form ``resolve_scene_backward_reference``, on the same CUDA tensors: the
    hits of a scene march, some lanes with ``inst = -1``, and the special
    lanes (non-finite t, a zero component of d, F'(t0) = 0, an out-of-range
    neighbour, solid entries with and without a tie).  Ray gradients within
    1e-5 * max|g|, the table's within 1e-5 * max|sum| of the closed form
    summed in float64; finite everywhere; zero off the surface and
    solid-entry lanes."""
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import rows as k3

    dev = _card()
    dtype, ch = RESOLVE_TABLES[table]
    ts = _with_table(_crowd(5, "chebyshev", dtype, n_inst, dev), ch, offset)
    o, d, t_max = scene_rays(8, 65536, dev)
    hit, inst = tren.march_scene(ts, o, d, t_max)
    inst[::5] = -1
    lanes = _special_lanes(ts, o, d, hit, inst, 2)
    gen = torch.Generator().manual_seed(4)
    g_t = torch.randn(o.shape[0], generator=gen).to(dev)
    g_n = torch.randn(o.shape, generator=gen).to(dev)
    g_t[::7] = 0.0
    g_n[::7] = 0.0

    before = (dict(kr.LAUNCHES), dict(k3.LAUNCHES))
    g_o, g_d, acc = kr.resolve_scene_backward_cuda(ts, o, d, hit, inst, g_t,
                                                   g_n)
    torch.cuda.synchronize()
    assert kr.LAUNCHES == {"forward": before[0]["forward"],
                           "backward": before[0]["backward"] + 1}
    assert k3.LAUNCHES == before[1]
    w_o, w_d, w_acc = tren.resolve_scene_backward_reference(
        ts, o, d, hit, inst, g_t, g_n, acc_dtype=torch.float64)
    for name, a, b in (("g_o_w", g_o, w_o), ("g_d_w", g_d, w_d)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        scale = b.abs().max().item()
        assert scale > 0
        assert (a - b).abs().max().item() <= 1e-5 * scale, name
        carries = (hit.kind == 1) | (hit.kind == 2)
        assert not bool(a[~carries].any()), name
    for name, idx in lanes.items():
        if name != "unsafe":
            assert bool((g_o[idx] != 0).any()), name
    tie = lanes["tie"][g_t[lanes["tie"]] != 0]
    assert torch.equal(g_o[tie, 0], -0.5 * g_t[tie])
    assert torch.equal(g_o[tie, 1], -0.5 * g_t[tie])
    assert not bool(g_o[tie, 2].any())
    assert acc.dtype == torch.float32 and acc.shape == w_acc.shape
    assert bool(torch.isfinite(acc).all())
    scale = w_acc.abs().max().item()
    assert scale > 0
    assert (acc.double() - w_acc).abs().max().item() <= 1e-5 * scale
    assert not bool(acc[:, 8:].any())

    # an output nobody needs is skipped
    only_rays = kr.resolve_scene_backward_cuda(ts, o, d, hit, inst, g_t, g_n,
                                               table_grad=False)
    only_table = kr.resolve_scene_backward_cuda(ts, o, d, hit, inst, g_t,
                                                g_n, rays_grad=False)
    torch.cuda.synchronize()
    assert only_rays[2] is None and torch.equal(only_rays[0], g_o)
    assert torch.equal(only_rays[1], g_d)
    assert only_table[0] is None and only_table[1] is None
    assert (only_table[2].double() - w_acc).abs().max().item() <= 1e-5 * scale


CONTENTION_HITS = ("one_cell", "split_warp", "neighbours", "zero_cotangents")


def _contended_hits(ts, case, dev, warps=96, seed=3):
    """A hit set built to contend in the backward's reductions: 32 * warps
    + 13 lanes (a ragged last warp) taken from the surface hits of a scene
    march (rays, t, instance), their cells rewritten by ``case``: all on
    one cell ("one_cell"); each warp split over two cells far apart, a
    third of its lanes on one ("split_warp"); on the 2x2x2 block of
    neighbouring cells, which share rows ("neighbours", also
    "zero_cotangents", whose cotangents are zero on half of the lanes and
    on every lane of every fourth warp).  Every lane is put on instance 0;
    a lane in seven is a miss and one in eleven a solid entry, and every
    fifth warp is all misses.  Returns (o, d, hit, inst, g_t, g_n)."""
    rng = np.random.default_rng(seed)
    o, d, t_max = scene_rays(seed, 65536, dev)
    hit, inst = tren.march_scene(ts, o, d, t_max)
    surf = (hit.kind == 1).nonzero().ravel()
    rays = 32 * warps + 13
    pick = surf[torch.from_numpy(rng.integers(0, surf.numel(), rays)).to(dev)]
    o, d = o[pick].contiguous(), d[pick].contiguous()
    # what the backward reads: the hit's kind, t and cell
    hit = MarchHit(hit=None, t=hit.t[pick].contiguous(),
                   kind=hit.kind[pick].contiguous(),
                   cell=hit.cell[pick].contiguous(), t_in=None, t_out=None,
                   face_normal=None)
    inst = torch.zeros(rays, dtype=torch.int32, device=dev)
    n = int(ts.volumes.n[int(ts.inst_volume[0])])
    c0 = np.array([n // 2, n // 3, n // 2])
    lane = np.arange(rays) % 32
    if case == "one_cell":
        cells = np.tile(c0, (rays, 1))
    elif case == "split_warp":
        cells = np.where((lane % 3 == 0)[:, None], c0, c0 + (4, 0, 0))
    else:
        cells = c0 + rng.integers(0, 2, (rays, 3))
    hit.cell.copy_(torch.from_numpy(cells.astype(np.int32)))
    kind = np.ones(rays, np.int32)
    kind[np.arange(rays) % 7 == 3] = 0
    kind[np.arange(rays) % 11 == 5] = 2
    kind[(np.arange(rays) // 32) % 5 == 4] = 0
    hit.kind.copy_(torch.from_numpy(kind))
    g_t = torch.from_numpy(rng.normal(size=rays).astype(np.float32)).to(dev)
    g_n = torch.from_numpy(
        rng.normal(size=(rays, 3)).astype(np.float32)).to(dev)
    if case == "zero_cotangents":
        zero = torch.from_numpy((rng.uniform(size=rays) < 0.5)
                                | ((np.arange(rays) // 32) % 4 == 1)).to(dev)
        g_t[zero] = 0.0
        g_n[zero] = 0.0
    return o, d, hit, inst, g_t, g_n


def _bits_equal(a, b):
    """Equal bit for bit (a -0 is not a +0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("rays_grad", [True, False], ids=["rays", "table"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("table", ["f32x8", "f32x9", "bf16x8"])
@pytest.mark.parametrize("case", CONTENTION_HITS)
def test_resolve_backward_designs_on_card(case, table, offset, rays_grad):
    """The fused resolve's redesigned backward (merged row cotangents,
    16-byte reductions) against its first design and against the closed
    form on hit sets built to contend (``_contended_hits``), with tables of
    8 and 9 channels, one based 4 bytes off its storage's alignment: the
    ray gradients bit-equal to the first design's on every lane, both
    tables within 1e-5 * max|sum| of the closed form summed in float64,
    the 9-channel table's view of a 12-float accumulator with nothing in
    its 9th channel."""
    from vrt_torch.kernels import resolve as kr

    dev = _card()
    dtype, ch = RESOLVE_TABLES[table]
    ts = _with_table(_crowd(5, "chebyshev", dtype, 2, dev), ch, offset)
    o, d, hit, inst, g_t, g_n = _contended_hits(ts, case, dev)
    before = kr.LAUNCHES["backward"]
    new = kr.resolve_scene_backward_cuda(ts, o, d, hit, inst, g_t, g_n,
                                         rays_grad=rays_grad)
    old = kr.resolve_scene_backward_cuda(ts, o, d, hit, inst, g_t, g_n,
                                         rays_grad=rays_grad,
                                         _old_design=True)
    torch.cuda.synchronize()
    assert kr.LAUNCHES["backward"] == before + 2
    want = tren.resolve_scene_backward_reference(ts, o, d, hit, inst, g_t,
                                                 g_n, acc_dtype=torch.float64)
    if rays_grad:
        for name, a, b, w in zip(("g_o_w", "g_d_w"), new, old, want):
            assert _bits_equal(a, b), name
            scale = w.abs().max().item()
            assert scale > 0 and (a - w).abs().max().item() <= 1e-5 * scale
    else:
        assert new[:2] == (None, None) and old[:2] == (None, None)
    scale = want[2].abs().max().item()
    assert scale > 0
    for side, acc in (("new", new[2]), ("old", old[2])):
        assert acc.dtype == torch.float32 and acc.shape == want[2].shape
        assert bool(torch.isfinite(acc).all()), side
        err = (acc.double() - want[2]).abs().max().item()
        assert err <= 1e-5 * scale, (side, err, scale)
    buf = new[2]
    assert buf.stride() == ((8, 1) if ch == 8 else (12, 1))
    assert buf.data_ptr() % 16 == 0
    assert not bool(buf[:, 8:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["f32x9", "bf16x8"])
def test_resolve_scene_grads_on_card_match_autograd(table):
    """``resolve_scene`` under a graph on the card (``ResolveScene``: both
    kernels) against autograd through ``resolve_scene_reference`` over K3 on
    the same tensors: gradients in the rays within 1e-5 * max|g|, in the
    table within 1e-5 * max|g| plus one rounding of its dtype."""
    from vrt_torch.kernels import resolve as kr

    dev = _card()
    dtype, ch = RESOLVE_TABLES[table]
    ts = _with_table(_crowd(5, "chebyshev", dtype, 12, dev), ch, 0)
    o, d, t_max = scene_rays(9, 65536, dev)
    hit, inst = tren.march_scene(ts, o, d, t_max)
    gen = torch.Generator().manual_seed(5)
    g_t = torch.randn(o.shape[0], generator=gen).to(dev)
    g_n = torch.randn(o.shape, generator=gen).to(dev)
    grads = []
    for fn in (tren.resolve_scene, tren.resolve_scene_reference):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (o, d, ts.volumes.corners)]
        scene = dataclasses.replace(ts, volumes=dataclasses.replace(
            ts.volumes, corners=leaves[2]))
        before = dict(kr.LAUNCHES)
        t, n, _ = fn(scene, leaves[0], leaves[1], hit, inst)
        grads.append(torch.autograd.grad([t, n], leaves, [g_t, g_n]))
        launched = {k: kr.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"forward": 1, "backward": 1}
                            if fn is tren.resolve_scene
                            else {"forward": 0, "backward": 0})
    torch.cuda.synchronize()
    for name, a, b in zip(("o_w", "d_w", "corners"), *grads):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = b.abs().max().item()
        err = (a.double() - b.double()).abs()
        if name == "corners" and dtype == torch.bfloat16:
            err = err - 2.0 ** -7 * b.double().abs()
        assert scale > 0 and err.max().item() <= 1e-5 * scale, name


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
    halved = dataclasses.replace(ts, volumes=dataclasses.replace(
        ts.volumes, corners=ts.volumes.corners.half()))
    bwd, g_t = kr.resolve_scene_backward_cuda, hit.t
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
        lambda: bwd(ts, o.cpu(), d, hit, inst, g_t, d),             # device
        lambda: bwd(ts, o, d, hit, inst, g_t.double(), d),          # dtype
        lambda: bwd(ts, o, d, hit, inst.long(), g_t, d),            # dtype
        lambda: bwd(ts, o, d, hit, inst, g_t, d.t().contiguous().t()),
        lambda: bwd(ts, o, d, hit, inst, g_t[:-1], d),              # shape
        lambda: bwd(sliced, o, d, hit, inst, g_t, d),               # layout
        lambda: bwd(halved, o, d, hit, inst, g_t, d),               # table
    ]
    before = (k1.LAUNCHES, k1.SCENE_LAUNCHES, dict(kr.LAUNCHES))
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


def _onehot_inputs(table, outside, dev, k=512, rows=1024, seed=6):
    """GP-C's inputs at the p4 / k4 shape (K = 512, 1024 rows): a table of
    normal values with some -0s ("finite"), also with an Inf, a -Inf, a NaN
    and a value that rounds to bf16 Inf in three columns ("nonfinite"),
    rows picked among them; with ``outside`` a tenth of the indices lie
    outside the table."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(k, 8)).astype(np.float32)
    src[rng.integers(0, k, 40), rng.integers(0, 8, 40)] = -0.0
    idx = rng.integers(0, k, rows).astype(np.int32)
    if table == "nonfinite":
        src[3, 2], src[100, 5], src[200, 5] = np.inf, -np.inf, np.nan
        src[7, 0] = 3.4e38
        idx[:4] = (3, 100, 200, 7)
    if outside:
        far = rng.uniform(size=rows) < 0.1
        idx[far] = rng.choice([-1, -7, k, k + 33], far.sum())
    return torch.from_numpy(src).to(dev), torch.from_numpy(idx).to(dev)


def _nan_or_bits_equal(a, b):
    """NaN where the other is NaN, bit-equal elsewhere."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and _bits_equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


@pytest.mark.gpu
@pytest.mark.parametrize("outside", [False, True], ids=["inside", "outside"])
@pytest.mark.parametrize("table", ["finite", "nonfinite"])
@pytest.mark.parametrize("iters", [0, 256], ids=["p4", "k4"])
def test_onehot_gather_designs_on_card(iters, table, outside):
    """GP-C's direct gather against its first design (the tensor cores)
    at p4's shape (no rounds) and k4's (256 rounds, mask 511): NaN where
    the first design gives NaN, bit-equal everywhere else, indices outside
    the table included; and, with the indices inside, equal to
    ``onehot_gather_reference`` (NaN to NaN: a column with another row's Inf
    or NaN is NaN, as the matmul's 0 * Inf makes it)."""
    from vrt_torch.kernels import gather as G

    dev = _card()
    src, idx = _onehot_inputs(table, outside, dev)
    mask = 511 if iters else -1
    before = G.LAUNCHES["GP-C"]
    new = G.onehot_gather_cuda(src, idx, iters, mask)
    old = G.onehot_gather_cuda(src, idx, iters, mask, _old_design=True)
    torch.cuda.synchronize()
    assert G.LAUNCHES["GP-C"] == before + 2
    assert new.shape == (idx.shape[0], 8) and new.dtype == torch.float32
    assert _nan_or_bits_equal(new, old)
    assert bool(torch.isnan(new).any()) == (table == "nonfinite")
    if not outside:
        want = G.onehot_gather_reference(src, idx, iters, mask)
        assert torch.equal(torch.isnan(new), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(new), torch.nan_to_num(want))


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
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", ["f32x8", "f32x9", "f32x24"])
def test_k3_scatter_paths_on_card(case, offset):
    """``scatter_rows_cuda`` on both of its paths against a float64
    ``index_add_``: 16-byte vector reductions where the rows of the
    cotangents and of the accumulator and the cotangents' base are 16-byte
    aligned, one scalar atomic per element otherwise; zero quads and zero
    elements are skipped on either."""
    from vrt_torch.kernels import rows as K3

    dev = _card()
    _, ch, out_ch = K3_CASES[case]
    _, idx, g = _k3_inputs(torch.float32, ch, out_ch, 0, dev)
    g[::3] = 0.0
    g[1::3, :4] = 0.0
    flat = torch.empty(g.numel() + offset, device=dev)
    grad = flat[offset:].view(g.shape)
    grad.copy_(g)
    aligned = offset == 0 and ch % 4 == 0
    assert K3.scatter_path(grad, ch) == ("v4" if aligned else "scalar")
    before = K3.LAUNCHES["K3 scatter"]
    got = K3.scatter_rows_cuda(grad, idx, 4096, ch)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["K3 scatter"] == before + 1
    exact = K3.scatter_rows_reference(grad, idx, 4096, ch, torch.float64)
    scale = exact.abs().max().item()
    assert got.dtype == torch.float32 and got.shape == exact.shape
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale
    assert not bool(got[:, out_ch:].any())


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


# ---- the engine path on the card -------------------------------------------

def _engine_graph():
    """A sphere and a CSG box with a camera and a light, as a host scene."""
    from vrt_torch.core import quat as vq
    from vrt_torch.core.material import Material
    from vrt_torch.scene.scene import (Camera, DirectionalLight, Scene,
                                       VoxelObject)
    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    scene = Scene()
    sphere = VoxelVolume.from_generator(
        S.Sphere(radius=50.0), 5, 100.0,
        material=Material(albedo=(0.9, 0.2, 0.2, 1.0), roughness=0.1,
                          metallic=0.6))
    csg = S.CSG(shape=S.Box(extends=(40.0, 40.0, 40.0)))
    csg.add_child(S.Sphere(radius=50.0), S.SUBTRACT)
    box = VoxelVolume.from_generator(csg, 5, 100.0)
    a = scene.spawn(VoxelObject(
        volume=sphere, position=np.asarray([0.0, -70.0, 0.0], np.float32)))
    scene.spawn(VoxelObject(
        volume=box, position=np.asarray([0.0, 90.0, 10.0], np.float32)))
    scene.spawn(Camera(
        position=np.asarray([320.0, 0.0, 40.0], np.float32),
        rotation=np.asarray(vq.from_euler_degrees(0.0, 180.0, 0.0))))
    scene.spawn(DirectionalLight(
        rotation=np.asarray(vq.from_euler_degrees(0.0, 45.0, -30.0)),
        strength=6.0))
    scene.environment = np.full((6, 4, 4, 3), (0.25, 0.45, 0.85), np.float32)
    return scene, a, sphere


@pytest.mark.gpu
@pytest.mark.parametrize("pipelined", [True, False])
def test_engine_frames_on_card(pipelined):
    """The engine loop on the card: per frame 5 scene marches and 3 fused
    resolves, an incremental sync that uploads no volume again, and 8-bit
    frames equal to the UNORM of ``render_image`` on the synced scene
    (pipelined frames reach the host one call late and never change once
    handed out)."""
    from vrt_torch.engine.engine import Engine, EngineInstance, to_unorm8
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr

    dev = _card()
    scene, obj, sphere = _engine_graph()
    engine = Engine(EngineInstance(), 96, 64, pipelined=pipelined,
                    device=dev)
    engine.set_scene(scene)
    wants, gots, ptrs = [], [], set()
    for i in range(4):
        obj.position = np.asarray([0.0, -70.0 + 15 * i, 0.0], np.float32)
        before = (k1.SCENE_LAUNCHES, kr.LAUNCHES["forward"], k1.LAUNCHES)
        gots.append(engine.render_frame())
        assert k1.SCENE_LAUNCHES == before[0] + 5
        assert kr.LAUNCHES["forward"] == before[1] + 3
        assert k1.LAUNCHES == before[2]
        scene.post_render()
        gpu = engine._gpu_scene
        ptrs.add((gpu.volumes.corners.data_ptr(),
                  gpu.volumes.accel_u8.data_ptr(), gpu.textures.data_ptr(),
                  gpu.env.data_ptr()))
        wants.append(to_unorm8(render_image(gpu, 96, 64,
                                            RenderMode())).cpu().numpy())
    assert len(ptrs) == 1            # nothing but constants went up again
    last = engine.drain()
    assert last.dtype == np.uint8 and last.shape == (64, 96, 4)
    assert np.array_equal(last, wants[-1])
    if pipelined:
        assert gots[0] is None
        for got, want in zip(gots[1:], wants[:-1]):
            assert np.array_equal(got, want)
    else:
        for got, want in zip(gots, wants):
            assert np.array_equal(got, want)
    assert not np.array_equal(wants[0], wants[-1])
    sphere.set_voxel((16, 16, 16), 5.0)
    engine.render_frame()
    rebuilt = engine._gpu_scene.volumes       # a dirty volume: a full sync
    assert rebuilt is not gpu.volumes
    assert rebuilt.sdf[0, 16, 16, 16].item() == 5.0


@pytest.mark.gpu
def test_scene_graph_on_card_matches_cpu():
    """``Scene.to_gpu`` and an incremental ``sync_gpu`` on the card hold the
    tensors the CPU build holds, and the card's engine frame agrees with the
    CPU's under the ``_assert_close`` thresholds in units of 1/255."""
    import dataclasses as dc

    from vrt_torch.engine.engine import Engine, EngineInstance

    dev = _card()
    scene, obj, sphere = _engine_graph()
    sphere.clear_dirty()
    for v in scene.volumes:
        v.clear_dirty()
    card = scene.sync_gpu(None, device=dev)
    obj.position = np.asarray([5.0, -60.0, 3.0], np.float32)
    card2 = scene.sync_gpu(card, device=dev)
    assert card2.volumes is card.volumes and card2.env is card.env
    cpu = scene.to_gpu(device="cpu")
    for f in dc.fields(cpu):
        a, b = getattr(card2, f.name), getattr(cpu, f.name)
        if isinstance(b, torch.Tensor):
            assert a.device.type == "cuda" and a.dtype == b.dtype, f.name
            assert torch.equal(a.cpu(), b), f.name
    frames = []
    for device in (dev, "cpu"):
        e = Engine(EngineInstance(), 64, 48, pipelined=False,
                   render_scale=0.75, device=device)
        e.set_scene(scene)
        frames.append(e.render_frame().astype(np.float32) / 255.0)
    diff = np.abs(frames[0] - frames[1])
    assert np.quantile(diff, 0.98) < 6e-3 and diff.mean() < 2.5e-3
    assert (diff.max(axis=-1) > 0.05).mean() < 0.005


# ---- K4: the two shade kernels on the card ----------------------------------
#
# Built with --fmad=false in the plain stages' operation order; torch's own
# reductions over 3, 4 and 8 elements and its pow round in an order of their
# own, and a comparison that feeds a select may flip, so a float is held to
# SHADE_ATOL + SHADE_RTOL * |plain| on all but SHADE_FLOAT_BUDGET of the lanes
# and a boolean may flip on LANE_BUDGET of them (the budgets ``chip_smoke.py``
# holds them to).

SHADE_RTOL, SHADE_ATOL = 1e-4, 1e-5
SHADE_FLOAT_BUDGET = 0.0
SHADE_MODES = {f"mode{m}": RenderMode.from_enum(m) for m in range(8)}
SHADE_MODES["overlay"] = RenderMode(debug_overlay=True)
LIGHT_SETS = {"no-lights": (0, 0), "point-spot": (1, 1),
              "two-points-spot": (2, 1), "five-five": (5, 5)}


def _lanes_beyond(a, b, lanes=None):
    if lanes is not None:
        a, b = a[lanes], b[lanes]
    if a.numel() == 0:
        return 0.0
    same = (a == b) | ((a != a) & (b != b))
    diff = (a - b).abs().masked_fill(same, 0.0)
    off = ~(diff <= SHADE_ATOL + SHADE_RTOL * b.abs())
    return off.reshape(off.shape[0], -1).any(-1).float().mean().item()


def _held_stages(seen):
    """A stage pair that launches each kernel, holds it against its plain
    stage on the same inputs and hands on the kernel's result."""
    def surface(*args):
        got = tren._shade_surface_kernel(*args)
        want = tren.shade_surface_reference(*args)
        on = args[5].hit
        # a level that spawns no trace leaves a miss lane's origin unwritten
        spawns = args[7].lit and (args[8] or args[9])
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "lights":      # the plain stage's alone
                assert a is None
                continue
            assert (a is None) == (b is None), f.name
            if a is None:
                continue
            if f.name == "gate":
                assert (a != b).float().mean().item() <= LANE_BUDGET
            elif f.name == "shadow_tmax":
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    dead = torch.isinf(x), torch.isinf(y)
                    assert (dead[0] != dead[1]).float().mean().item() \
                        <= LANE_BUDGET
                    assert _lanes_beyond(x, y, ~dead[0] & ~dead[1]) \
                        <= SHADE_FLOAT_BUDGET
            elif f.name == "shadow_dir":
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert _lanes_beyond(x, y, on) <= SHADE_FLOAT_BUDGET
            else:
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                lanes = None if f.name == "shadow_origin" and spawns else on
                assert _lanes_beyond(a, b, lanes) <= SHADE_FLOAT_BUDGET, \
                    f.name
        seen["surface"] += 1
        return got

    def combine(*args):
        got = tren._shade_combine_kernel(*args)
        want = tren.shade_combine_reference(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _lanes_beyond(got, want) <= SHADE_FLOAT_BUDGET
        seen["combine"] += 1
        return got

    return lambda *_: (surface, combine)


def _render_held(scene, width, height, mode):
    from vrt_torch.kernels import shade as k4

    seen = dict(surface=0, combine=0)
    before = dict(k4.LAUNCHES)
    plain = tren.shade_stages
    tren.shade_stages = _held_stages(seen)
    try:
        with torch.no_grad():
            img = render_image(scene, width, height, mode)
    finally:
        tren.shade_stages = plain
    torch.cuda.synchronize()
    levels = 3 if mode.lit and scene.any_reflective else 1
    assert seen == dict(surface=levels, combine=levels)
    assert {k: k4.LAUNCHES[k] - before[k] for k in before} == dict(
        surface=levels, combine=levels, surface_bwd=0, combine_bwd=0)
    assert img.shape == (height, width, 4)
    assert bool(torch.isfinite(img).all()) and bool((img[..., 3] == 1).all())
    return img


@pytest.mark.gpu
@pytest.mark.parametrize("lights", sorted(LIGHT_SETS))
@pytest.mark.parametrize("mode", sorted(SHADE_MODES))
def test_shade_kernels_match_plain_on_card(mode, lights):
    """Every launch of both kernels in a 480x270 frame of the textured scene
    against its plain stage, per render mode and light set."""
    from vrt_torch.scenes import shading_scene

    dev = _card()
    points, spots = LIGHT_SETS[lights]
    scene = shading_scene(5, points, spots, device=dev)
    img = _render_held(scene, 480, 270, SHADE_MODES[mode])
    assert img[..., :3].std().item() > 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["colours-f32", "colours-bf16",
                                  "colours-unpacked", "non-reflective",
                                  "empty", "default-1x1"])
def test_shade_kernels_on_card_cases(case):
    """Per-voxel colours from an f32 and a bf16 table and from the unpacked
    f32 grid (lit and unlit), a scene without reflective material (one
    level, no bounce record), the scene without instances, and the
    flagship's default 1x1 textures."""
    from vrt_torch.scenes import shading_scene

    dev = _card()
    if case.startswith("colours"):
        dtype = torch.bfloat16 if case.endswith("bf16") else None
        scene = shading_scene(5, 2, 1, colors=True, march_dtype=dtype,
                              device=dev)
        assert scene.voxel_color_corners.dtype == (dtype or torch.float32)
        if case.endswith("unpacked"):
            scene = unpacked_colors(scene)
    elif case == "non-reflective":
        scene = shading_scene(5, 1, 1, reflective=False, device=dev)
        assert not scene.any_reflective
    elif case == "empty":
        full = shading_scene(4, 1, 1, device=dev)
        scene = dataclasses.replace(
            full, inst_volume=full.inst_volume[:0],
            inst_pos=full.inst_pos[:0], inst_rot=full.inst_rot[:0],
            inst_scale=full.inst_scale[:0],
            inst_active=full.inst_active[:0])
    else:
        scene = flagship_scene(5, device=dev)
    for mode in (RenderMode(), RenderMode(lit=False),
                 RenderMode(textured=False)):
        _render_held(scene, 480, 270, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("fixture,mode,limits", [
    ("flagship_r7_cheb_bf16_160x90.npy", RenderMode(),
     (0.90, 0.015, 0.01, 0.1, 0.03)),
    ("flagship_r7_cheb_bf16_cube_unlit_160x90.npy",
     RenderMode(interp=False, lit=False), (0.98, 6e-3, 2.5e-3, 0.05, 0.005))],
    ids=["interp-lit", "cube-unlit"])
def test_fixture_frames_through_shade_kernels(fixture, mode, limits):
    """The 160x90 frames ``vrt`` rendered on the CPU, through the kernels on
    the card, under the thresholds ``chip_smoke.py`` holds them to."""
    import os

    from vrt_torch.kernels import shade as k4

    dev = _card()
    want = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                fixture))
    scene = flagship_scene(7, "chebyshev", torch.bfloat16, device=dev)
    before = k4.LAUNCHES["combine"]
    got = render_image(scene, 160, 90, mode)[..., :3].cpu().numpy()
    assert k4.LAUNCHES["combine"] == before + (3 if mode.lit else 1)
    q, q_max, mean_max, off, off_max = limits
    diff = np.abs(got - want)
    assert np.isfinite(got).all()
    assert np.quantile(diff, q) < q_max
    assert diff.mean() < mean_max
    assert (diff.max(axis=-1) > off).mean() < off_max


@pytest.mark.gpu
def test_shade_dispatch_on_card():
    """CUDA tensors take the kernels; a graph through a material constant,
    an instance transform or the corner table takes the Function pair,
    whose frame is the kernels' frame and whose backward launches the
    backward kernels: no graph shades on the plain stages on the card."""
    from vrt_torch.kernels import shade as k4

    dev = _card()
    scene = flagship_scene(4, device=dev)
    before = dict(k4.LAUNCHES)

    def launched(n, n_bwd=0):
        return {k: k4.LAUNCHES[k] - before[k] for k in before} == dict(
            surface=n, combine=n, surface_bwd=n_bwd, combine_bwd=n_bwd)

    base = render_image(scene, 64, 36, RenderMode())
    assert launched(3)
    tint = scene.tint.clone().requires_grad_(True)
    img = render_image(dataclasses.replace(scene, tint=tint), 64, 36,
                       RenderMode())
    assert launched(6)
    assert img.requires_grad and not base.requires_grad
    torch.testing.assert_close(img.detach(), base, rtol=1e-4, atol=2e-5)
    with torch.no_grad():
        render_image(dataclasses.replace(scene, tint=tint), 64, 36,
                     RenderMode())
    assert launched(9)
    # a graph through an instance transform: the Function pair, its
    # backward kernels (the surface's instance variant) launched by the
    # backward
    pos = scene.inst_pos.clone().requires_grad_(True)
    img = render_image(dataclasses.replace(scene, inst_pos=pos), 64, 36,
                       RenderMode())
    assert launched(12)
    torch.testing.assert_close(img.detach(), base, rtol=1e-4, atol=2e-5)
    img.sum().backward()
    assert launched(12, 3) and bool(torch.isfinite(pos.grad).all())
    assert bool(pos.grad.any())
    # a graph through the corner table: the Function pair, its backward
    # kernels launched by the backward
    corners = scene.volumes.corners.clone().requires_grad_(True)
    img = render_image(dataclasses.replace(
        scene, volumes=dataclasses.replace(scene.volumes, corners=corners)),
        64, 36, RenderMode())
    assert launched(15, 3)
    torch.testing.assert_close(img.detach(), base, rtol=1e-4, atol=2e-5)
    img.sum().backward()
    assert launched(15, 6) and bool(torch.isfinite(corners.grad).all())


@pytest.mark.gpu
def test_shade_wrappers_reject_bad_inputs_on_card():
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.camera import camera_rays

    dev = _card()
    scene = flagship_scene(4, device=dev)
    mode = RenderMode()
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, 32, 18)
    o = o.contiguous()
    t_max = torch.full((o.shape[0],), tren.RADIANCE_TMAX, device=dev)
    hit, inst = tren.march_scene(scene, o, d, t_max)
    t, n_obj, unlit = tren.resolve_scene(scene, o, d, hit, inst)
    rec = k4.shade_surface_cuda(scene, o, d, t, n_obj, hit, inst, mode, True,
                                True)
    before = dict(k4.LAUNCHES)
    blocked = [torch.zeros(o.shape[0], dtype=torch.bool, device=dev)]
    bad_surface = [
        lambda: k4.shade_surface_cuda(scene, o.double(), d, t, n_obj, hit,
                                      inst, mode, True, True),
        lambda: k4.shade_surface_cuda(scene, o, d[:-1], t, n_obj, hit, inst,
                                      mode, True, True),
        lambda: k4.shade_surface_cuda(scene, o, d, t, n_obj.cpu(), hit, inst,
                                      mode, True, True),
        lambda: k4.shade_surface_cuda(scene, o, d, t, n_obj, hit,
                                      inst.long(), mode, True, True),
        lambda: k4.shade_surface_cuda(
            scene, o, d, torch.stack([t, t], -1)[:, 0], n_obj, hit, inst,
            mode, True, True)]
    bad_combine = [
        lambda: k4.shade_combine_cuda(scene, rec, d, n_obj, hit.hit.int(),
                                      unlit, None, blocked, mode),
        lambda: k4.shade_combine_cuda(scene, rec, d, n_obj, hit.hit, unlit,
                                      None, blocked * 2, mode),
        lambda: k4.shade_combine_cuda(scene, rec, d, n_obj, hit.hit, unlit,
                                      d.double(), blocked, mode),
        lambda: k4.shade_combine_cuda(
            scene, dataclasses.replace(rec, n_w=rec.n_w[:, :2]), d, n_obj,
            hit.hit, unlit, None, blocked, mode)]
    for call in bad_surface + bad_combine:
        with pytest.raises(ValueError):
            call()
    assert k4.LAUNCHES == before
    out = k4.shade_combine_cuda(scene, rec, d, n_obj, hit.hit, unlit, None,
                                blocked, mode, final=True)
    assert out.shape == (o.shape[0], 4)


@pytest.mark.gpu
def test_colour_layouts_refused_on_card():
    """The surface kernels take the packed view (f32 or bf16) or the f32
    voxel grid of the corner table's side: a bf16 or wrongly sized grid, an
    f16 view, a colour table that is not the one the scene samples and CPU
    tensors raise before any launch."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.scenes import shading_scene

    dev = _card()
    packed = shading_scene(4, 1, 1, colors=True, device=dev)
    scene = unpacked_colors(packed)
    mode = RenderMode()
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, 32, 18)
    o = o.contiguous()
    t_max = torch.full((o.shape[0],), tren.RADIANCE_TMAX, device=dev)
    hit, inst = tren.march_scene(scene, o, d, t_max)
    t, n_obj, _ = tren.resolve_scene(scene, o, d, hit, inst)
    grid = scene.voxel_colors
    bad_scenes = [
        dataclasses.replace(scene, voxel_colors=grid.to(torch.bfloat16)),
        dataclasses.replace(scene, voxel_colors=grid[:, 1:, 1:, 1:]
                            .contiguous()),
        dataclasses.replace(packed, voxel_color_corners=packed
                            .voxel_color_corners.half())]
    before = dict(k4.LAUNCHES)
    for bad in bad_scenes:
        with pytest.raises(ValueError):
            k4.shade_surface_cuda(bad, o, d, t, n_obj, hit, inst, mode, True,
                                  True)
    with pytest.raises(ValueError, match="colour table"):
        k4.ShadeSurface.apply(
            o, d, t, n_obj, packed.voxel_color_corners,
            *(getattr(scene, f) for f in k4.MATERIAL_FIELDS),
            scene.tex_scale, scene.textures,
            *(getattr(scene, f) for f in k4.INSTANCE_FIELDS), scene, hit,
            inst, mode, True, True)
    cpu_hit = dataclasses.replace(hit, hit=hit.hit.cpu(), cell=hit.cell.cpu())
    with pytest.raises(ValueError):
        k4.shade_surface_cuda(scene, o.cpu(), d.cpu(), t.cpu(), n_obj.cpu(),
                              cpu_hit, inst.cpu(), mode, True, True)
    assert k4.LAUNCHES == before
    rec = k4.shade_surface_cuda(scene, o, d, t, n_obj, hit, inst, mode, True,
                                True)
    assert k4.LAUNCHES["surface"] == before["surface"] + 1
    assert bool(torch.isfinite(rec.albedo[hit.hit]).all())


# ---- the corner table's pack and its backward on the card --------------------
#
# The pack is a copy and one cast, so it equals the plain pack bit for bit;
# the backward adds each voxel's at most 8 cotangents in f32 in autograd's
# order, and is held to 1e-6 * max|g| of autograd of the plain pack (bit
# for bit where the orders agree).

PACK_GRAD_RTOL = 1e-6


def _pack_case(table, n, dev, seed=0):
    """A seeded SDF [V,n,n,n] (V = 2 up to n = 65), the accel of a 9-channel
    table (None for 8), the table's dtype and a seeded cotangent."""
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if table.startswith("bf16") else torch.float32
    vols, c = (2 if n <= 65 else 1), n - 1
    sdf = torch.from_numpy(rng.normal(scale=4.0, size=(vols, n, n, n))
                           .astype(np.float32)).to(dev)
    accel = None
    if table.endswith("x9"):
        accel = torch.from_numpy(rng.integers(0, 700, size=(vols, c, c, c))
                                 .astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(vols, c, c, c, 9 if accel is not
                                          None else 8)).astype(np.float32))
    return sdf, accel, dtype, g.to(dtype).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [17, 65, 257, 10])
@pytest.mark.parametrize("table", ["f32x9", "bf16x8", "f32x8", "bf16x9"])
def test_pack_corners_match_plain_on_card(table, n):
    """``pack_cell_corners`` on CUDA tensors (``PackCorners``: one pack and
    one backward launch) against the plain pack and autograd of it, at
    config6's 65^3 and config4's 257^3 sides and at 10^3, whose 729 cells a
    volume are no multiple of a block."""
    from vrt_torch.kernels import pack as kp
    from vrt_torch.march.types import (pack_cell_corners,
                                       pack_cell_corners_reference)

    dev = _card()
    sdf, accel, dtype, g = _pack_case(table, n, dev)
    leaf = sdf.clone().requires_grad_(True)
    want = pack_cell_corners_reference(leaf, accel, dtype)
    (g_want,) = torch.autograd.grad(want, leaf, g)
    before = dict(kp.LAUNCHES)
    leaf = sdf.clone().requires_grad_(True)
    got = pack_cell_corners(leaf, accel, dtype)
    (g_got,) = torch.autograd.grad(got, leaf, g)
    torch.cuda.synchronize()
    assert {k: kp.LAUNCHES[k] - before[k] for k in before} == dict(
        pack=1, pack_bwd=1)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want.detach())
    assert g_got.dtype == torch.float32 and g_got.shape == sdf.shape
    scale = g_want.abs().max().item()
    assert scale > 0
    assert (g_got - g_want).abs().max().item() <= PACK_GRAD_RTOL * scale
    assert torch.equal(kp.pack_corners_backward_reference(g, n), g_want)


@pytest.mark.gpu
def test_pack_wrappers_reject_bad_inputs_on_card():
    from vrt_torch.kernels import pack as kp

    dev = _card()
    sdf, accel, dtype, g = _pack_case("f32x9", 9, dev)
    before = dict(kp.LAUNCHES)
    bad = [
        lambda: kp.pack_corners_cuda(sdf.cpu(), accel.cpu(), dtype),
        lambda: kp.pack_corners_cuda(sdf.double(), accel, dtype),
        lambda: kp.pack_corners_cuda(sdf, accel.long(), dtype),
        lambda: kp.pack_corners_cuda(sdf, accel[:, :-1].contiguous(), dtype),
        lambda: kp.pack_corners_cuda(sdf, accel, torch.float16),
        lambda: kp.pack_corners_cuda(sdf.transpose(1, 3), accel, dtype),
        lambda: kp.pack_corners_cuda(sdf[..., :-1].contiguous(), None,
                                     dtype),
        lambda: kp.pack_corners_backward_cuda(g.cpu()),
        lambda: kp.pack_corners_backward_cuda(g.half()),
        lambda: kp.pack_corners_backward_cuda(g[..., :7].contiguous()),
        lambda: kp.pack_corners_backward_cuda(g.transpose(1, 2))]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert kp.LAUNCHES == before


# ---- the accel rebuild (pyramid, rebuild) and the tiled pack backward ---------
#
# The pyramid and the rebuild compute integers and copy or round the table's
# values once, so they equal their plain versions bit for bit; a NaN in a
# bf16 table is held as a NaN (torch's casts give it payloads of their own).
# The tiled backward adds the same terms in the same order as its first
# design and as autograd of the plain pack.


def _accel_case(v, n, seed, special, dev):
    """A seeded SDF [v,n,n,n] of noisy spheres (surfaces scattered, skips
    of every level), with NaN, -0.0, 0.0 and inf voxels where ``special``
    (one NaN at corner 0 of cell 0)."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    vols = []
    for _ in range(v):
        centre = rng.uniform(0, n - 1, 3)
        s = np.linalg.norm(grid - centre, axis=-1) - rng.uniform(
            0.6, (n - 1) / 3)
        vols.append(s + rng.normal(scale=0.05, size=s.shape))
    sdf = np.stack(vols).astype(np.float32)
    if special:
        for k, val in enumerate([np.nan, -0.0, 0.0, np.inf, -0.0, np.nan]):
            idx = rng.integers(0, n, size=(8, 3))
            for j, (x, y, z) in enumerate(idx):
                sdf[j % v, x, y, z] = val
        sdf[0, :2, :2, :2] = -0.0
        sdf[0, 1, 1, 1] = 0.0
        sdf[0, 0, 0, 0] = np.nan
    return torch.from_numpy(sdf).to(dev)


def _table_equal(got, want):
    """Bit for bit, but a NaN of a bf16 table only as a NaN."""
    if got is None or want is None:
        return got is None and want is None
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = torch.isnan(want.float())
    if not torch.equal(nan, torch.isnan(got.float())):
        return False
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("v,n", [(1, 3), (1, 5), (2, 9), (2, 17), (1, 33),
                                 (2, 65), (1, 129), (1, 257)])
def test_accel_pyramid_matches_plain_on_card(v, n, special):
    """The pyramid kernel's levels against the plain pyramid of the plain
    flags, at every level count, on both designs: one launch (the default)
    and the first design's ceil(levels / 3)."""
    from vrt_torch.kernels import accel as ka
    from vrt_torch.volume.accel import cell_corner_signs_differ

    dev = _card()
    sdf = _accel_case(v, n, n + v, special, dev)
    c = n - 1
    r = c.bit_length() - 1
    flag = cell_corner_signs_differ(sdf)
    for levels in sorted({1, min(3, r), min(4, r), r}):
        want = ka.occupancy_pyramid_reference(flag, levels)
        for old, launches in ((False, 1), (True, -(-levels // 3))):
            before = ka.LAUNCHES["pyramid"]
            got = ka.pyramid_levels(
                ka.accel_pyramid_cuda(sdf, levels, _old_design=old), (v,), c,
                levels)
            torch.cuda.synchronize()
            assert ka.LAUNCHES["pyramid"] - before == launches
            assert len(got) == len(want) == levels
            for lvl, (a, b) in enumerate(zip(got, want), 1):
                assert torch.equal(a, b), (levels, old, lvl)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("v", [1, 3])
def test_accel_pyramid_one_launch_on_card(v, c):
    """The one-launch pyramid over all R levels (the grid's last block
    building levels 4..R) against ``occupancy_pyramid_reference`` and the
    first design, bit for bit, at C = 2..256 over 1 and 3 volumes, run
    three times in a row (the ticket counter left zeroed each time)."""
    from vrt_torch.kernels import accel as ka
    from vrt_torch.volume.accel import cell_corner_signs_differ

    dev = _card()
    sdf = _accel_case(v, c + 1, 5 * c + v, True, dev)
    r = c.bit_length() - 1
    want = ka.occupancy_pyramid_reference(cell_corner_signs_differ(sdf), r)
    first = ka.accel_pyramid_cuda(sdf, r, _old_design=True)
    for _ in range(3):
        before = ka.LAUNCHES["pyramid"]
        flat = ka.accel_pyramid_cuda(sdf, r)
        torch.cuda.synchronize()
        assert ka.LAUNCHES["pyramid"] - before == 1
        assert torch.equal(flat, first)
        got = ka.pyramid_levels(flat, (v,), c, r)
        for lvl, (a, b) in enumerate(zip(got, want), 1):
            assert torch.equal(a, b), lvl
        if r > 3:
            assert int(ka._ticket(dev)) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("table", ["none", "f32x8", "bf16x8", "f32x9",
                                   "bf16x9"])
@pytest.mark.parametrize("v,n", [(1, 3), (2, 5), (2, 17), (2, 65),
                                 (1, 257)])
def test_accel_rebuild_matches_plain_on_card(v, n, table, special):
    """The rebuild (with the pyramid) against ``rebuild_accel_reference``
    on the same CUDA tensors: the accel and its u8 view bit for bit, the
    table bit for bit (NaN as NaN), one rebuild launch; and ``build_accel``
    on a CUDA tensor (accel only) against ``build_accel_reference``."""
    from vrt_torch.kernels import accel as ka
    from vrt_torch.volume.accel import build_accel, build_accel_reference

    dev = _card()
    sdf = _accel_case(v, n, 3 * n + v, special, dev)
    r = (n - 1).bit_length() - 1
    channels = 0 if table == "none" else int(table[-1])
    dtype = torch.bfloat16 if table.startswith("bf16") else torch.float32
    before = dict(ka.LAUNCHES)
    got = ka.rebuild_accel_cuda(sdf, r, dtype, channels)
    torch.cuda.synchronize()
    assert ka.LAUNCHES["rebuild"] - before["rebuild"] == 1
    want = ka.rebuild_accel_reference(sdf, r, dtype, channels)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert _table_equal(got[0], want[0])
    for levels in (0, r // 2, r + 2):
        assert torch.equal(build_accel(sdf, levels),
                           build_accel_reference(sdf, levels))


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["f32x9", "bf16x8", "f32x8", "bf16x9"])
def test_rebuild_function_matches_plain_on_card(table):
    """``RebuildAccel`` forward and backward on the card (one pyramid
    launch, one rebuild, one tiled backward) against the plain rebuild and autograd
    of the plain pack, bit for bit."""
    from vrt_torch.kernels import accel as ka
    from vrt_torch.kernels import pack as kp

    dev = _card()
    sdf = _accel_case(2, 65, 11, False, dev)
    dtype = torch.bfloat16 if table.startswith("bf16") else torch.float32
    channels = int(table[-1])
    g = torch.randn((2, 64, 64, 64, channels), device=dev,
                    generator=torch.Generator(dev).manual_seed(5)).to(dtype)
    leaf = sdf.clone().requires_grad_(True)
    want, _, _ = ka.rebuild_accel_reference(leaf, 6, dtype, channels)
    (g_want,) = torch.autograd.grad(want, leaf, g)
    before = (dict(ka.LAUNCHES), dict(kp.LAUNCHES))
    leaf = sdf.clone().requires_grad_(True)
    got, accel, view = ka.RebuildAccel.apply(leaf, 6, dtype, channels)
    assert got.requires_grad and not accel.requires_grad
    (g_got,) = torch.autograd.grad(got, leaf, g)
    torch.cuda.synchronize()
    assert {k: ka.LAUNCHES[k] - before[0][k] for k in ka.LAUNCHES} == dict(
        pyramid=1, rebuild=1)
    assert {k: kp.LAUNCHES[k] - before[1][k] for k in kp.LAUNCHES} == dict(
        pack=0, pack_bwd=1)
    assert torch.equal(got, want.detach())
    assert torch.equal(g_got, g_want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3, 10, 17, 33, 41, 65, 257])
@pytest.mark.parametrize("table", ["f32x9", "bf16x8", "f32x8", "bf16x9"])
def test_pack_backward_designs_on_card(table, n):
    """The pack backward's designs (the library's choice, the tiled kernel
    where its words align, the first design) against each other and the
    slices' transpose (autograd's order), bit for bit: sides that are no
    multiple of the tiled kernel's 32 x 8 x 16 block or of a 16-byte word's
    cells (9 channels: the first design runs), and config6's and
    config4's."""
    from vrt_torch.kernels import pack as kp

    dev = _card()
    _, _, dtype, g = _pack_case(table, n, dev, seed=n)
    new = kp.pack_corners_backward_cuda(g)
    tiled = kp.pack_corners_backward_cuda(g, _tiled=True)
    old = kp.pack_corners_backward_cuda(g, _old_design=True)
    torch.cuda.synchronize()
    assert torch.equal(new, old)
    assert torch.equal(tiled, old)
    assert torch.equal(new, kp.pack_corners_backward_reference(g, n))


@pytest.mark.gpu
@pytest.mark.parametrize("table,n,design", [("f32x9", 65, "first"),
                                            ("bf16x8", 257, "tiled")])
def test_pack_backward_choice_on_card(table, n, design):
    """The library's choice on each side of its threshold (the tiled
    kernel where its grid is at least one wave of resident blocks): config6's
    two 65^3 volumes (256 blocks, under a wave of an H100's 132
    multiprocessors at the 2 or more blocks each holds) take the first
    design, config4's 257^3 table (2,048 blocks, over a wave at the 8 blocks
    at most) the tiled kernel; ``_tiled`` takes the tiled kernel on both,
    ``_old_design`` the first design."""
    from vrt_torch.kernels import pack as kp

    dev = _card()
    _, _, _, g = _pack_case(table, n, dev, seed=n)
    for kwargs, want in (({}, design), (dict(_tiled=True), "tiled"),
                         (dict(_old_design=True), "first")):
        before = dict(kp.BWD_LAUNCHES)
        kp.pack_corners_backward_cuda(g, **kwargs)
        assert {k: kp.BWD_LAUNCHES[k] - before[k] for k in before} == {
            "first": int(want == "first"), "tiled": int(want == "tiled")}


@pytest.mark.gpu
def test_accel_wrappers_reject_bad_inputs_on_card():
    from vrt_torch.kernels import accel as ka
    from vrt_torch.kernels import pack as kp

    dev = _card()
    sdf = _accel_case(2, 17, 1, False, dev)
    odd = _accel_case(1, 13, 1, False, dev)
    g = torch.zeros((1, 16, 16, 16, 8), device=dev)
    before = (dict(ka.LAUNCHES), dict(kp.LAUNCHES))
    bad = [
        lambda: ka.accel_pyramid_cuda(sdf.cpu(), 4),
        lambda: ka.accel_pyramid_cuda(odd, 2),
        lambda: ka.accel_pyramid_cuda(sdf, 5),
        lambda: ka.accel_pyramid_cuda(sdf.double(), 4),
        lambda: ka.accel_pyramid_cuda(sdf.transpose(1, 3), 4),
        lambda: ka.rebuild_accel_cuda(odd, 2),
        lambda: ka.rebuild_accel_cuda(sdf, -1),
        lambda: ka.rebuild_accel_cuda(sdf, 4, torch.float16, 8),
        lambda: ka.rebuild_accel_cuda(sdf, 4, torch.float32, 7),
        lambda: ka.rebuild_accel_cuda(sdf[..., :-1].contiguous(), 4),
        lambda: ka.rebuild_accel_cuda(sdf, 4, pyramid=torch.zeros(
            3, dtype=torch.uint8, device=dev)),
        lambda: ka.build_accel_cuda(odd, 3),
        lambda: ka.RebuildAccel.apply(sdf, 4, torch.float32, 0),
        lambda: kp.pack_corners_backward_cuda(g[:, :, :, :15]),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert (ka.LAUNCHES, kp.LAUNCHES) == before
    with pytest.raises(ValueError):
        kp.pack_corners_backward_cuda(g, _old_design=True, _tiled=True)
    # a cotangent off a 16-byte boundary: the tiled kernel does not take
    # its words, so even ``_tiled`` runs the first design
    flat = torch.randn(16 ** 3 * 8 + 1, device=dev,
                       generator=torch.Generator(dev).manual_seed(3))
    off = flat[1:].view(1, 16, 16, 16, 8)
    before = dict(kp.BWD_LAUNCHES)
    assert torch.equal(kp.pack_corners_backward_cuda(off, _tiled=True),
                       kp.pack_corners_backward_cuda(off, _old_design=True))
    assert {k: kp.BWD_LAUNCHES[k] - before[k] for k in before} == dict(
        first=2, tiled=0)


# ---- the fit step's Adam update ----------------------------------------------
#
# The kernel rounds each operation of optax's arithmetic once, in the eager
# ops' order, so it equals its plain version on the card bit for bit.


def _adam_case(shapes, dev, seed, offset=0):
    """Seeded leaves (params, grads, mu, nu) of ``shapes``, each leaf a view
    ``offset`` elements into its buffer (off 16 bytes where offset % 4),
    gradients from 1 to 1e-4, and c1, c2 of step 3 of Adam(0.9, 0.999)."""
    rng = np.random.default_rng(seed)

    def leaf(shape, scale, positive=False):
        n = int(np.prod(shape))
        x = rng.normal(size=n + offset) * scale
        x = np.abs(x) if positive else x
        return torch.from_numpy(x.astype(np.float32)).to(dev)[offset:].view(
            shape)

    keys = [f"leaf{i}" for i in range(len(shapes))]
    p = {k: leaf(s, 1.0) for k, s in zip(keys, shapes)}
    g = {k: leaf(s, 10.0 ** -(i % 5)) for i, (k, s) in
         enumerate(zip(keys, shapes))}
    mu = {k: leaf(s, 0.1) for k, s in zip(keys, shapes)}
    nu = {k: leaf(s, 0.01, True) for k, s in zip(keys, shapes)}
    steps = torch.tensor(3.0, device=dev)
    c1, c2 = 1 - torch.pow(0.9, steps), 1 - torch.pow(0.999, steps)
    return p, g, mu, nu, c1, c2


@pytest.mark.gpu
@pytest.mark.parametrize("apply", [True, False], ids=["apply", "update"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 1025, 4097,
                               2 * 65 ** 3, 257 ** 3])
def test_adam_kernel_matches_plain_on_card(n, apply):
    """The Adam kernel (p + u, or the update u) against its plain version
    on the same CUDA tensors, bit for bit, at odd and aligned lengths (a
    leaf's last partial 16-byte word element by element: 257^3 is odd), two
    leaves in one launch; new tensors, the inputs unchanged."""
    from vrt_torch.kernels import optim as ko

    dev = _card()
    p, g, mu, nu, c1, c2 = _adam_case([(n,), (n + 3,)], dev, n)
    keep = [t.clone() for tree in (p, g, mu, nu) for t in tree.values()]
    before = dict(ko.LAUNCHES)
    got = ko.adam_step_cuda(p, g, mu, nu, c1, c2, 0.9, 0.999, 1e-2, 1e-8,
                            apply)
    torch.cuda.synchronize()
    assert ko.LAUNCHES["apply" if apply else "update"] - \
        before["apply" if apply else "update"] == 1
    want = ko.adam_step_reference(p, g, mu, nu, c1, c2, 0.9, 0.999, 1e-2,
                                  1e-8, apply)
    for a, b in zip(got, want):
        for k in g:
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(
        keep, [t for tree in (p, g, mu, nu) for t in tree.values()]))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_adam_kernel_leaf_layouts_on_card(offset):
    """Leaves off a 16-byte boundary (element by element), empty leaves and
    more leaves than a launch takes (17 non-empty: 2 launches), against the
    plain version bit for bit."""
    from vrt_torch.kernels import optim as ko

    dev = _card()
    shapes = [(7 * i + 1, 3) for i in range(17)] + [(0,), (2, 0)]
    p, g, mu, nu, c1, c2 = _adam_case(shapes, dev, 11 + offset, offset)
    before = ko.LAUNCHES["apply"]
    got = ko.adam_step_cuda(p, g, mu, nu, c1, c2, 0.9, 0.999, 1e-3, 1e-8)
    torch.cuda.synchronize()
    assert ko.LAUNCHES["apply"] - before == 2
    want = ko.adam_step_reference(p, g, mu, nu, c1, c2, 0.9, 0.999, 1e-3,
                                  1e-8)
    for a, b in zip(got, want):
        for k in g:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dict", "slab"])
def test_adam_apply_on_card_syncs_nothing(kind):
    """``Adam.apply`` and ``Adam.update`` on CUDA tensors (a fit step's
    dict, a slab step's one tensor): one kernel launch each, no host
    synchronisation (``torch.cuda.set_sync_debug_mode("error")``), and over
    three steps bit-equal to the plain composition (the eager arithmetic,
    then ``apply_updates``) on the card from the same state."""
    from vrt_torch.diff.optim import adam, apply_updates
    from vrt_torch.kernels import optim as ko

    dev = _card()
    p, g, _, _, _, _ = _adam_case([(2, 33, 33, 33), (2, 33, 33, 33, 3)],
                                  dev, 4)
    if kind == "slab":
        p, g = p["leaf0"], g["leaf0"]

    def leaves(t):
        return t if isinstance(t, dict) else {"": t}

    opt = adam(1e-2)
    state = opt.init(p)
    for step in range(3):
        before = dict(ko.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            p1, s1 = opt.apply(p, g, state)
            u, su = opt.update(g, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert {k: ko.LAUNCHES[k] - before[k] for k in before} == dict(
            apply=1, update=1)
        count, c1, c2 = opt.corrections(state.count)
        u_plain, mu, nu = ko.adam_step_reference(
            None, leaves(g), leaves(state.mu), leaves(state.nu), c1, c2,
            0.9, 0.999, 1e-2, 1e-8, apply=False)
        p_plain = apply_updates(leaves(p), u_plain)
        for k in leaves(g):
            assert torch.equal(leaves(u)[k], u_plain[k]), (step, k)
            assert torch.equal(leaves(p1)[k], p_plain[k]), (step, k)
            for st in (s1, su):
                assert torch.equal(leaves(st.mu)[k], mu[k]), (step, k)
                assert torch.equal(leaves(st.nu)[k], nu[k]), (step, k)
        assert int(s1.count) == int(su.count) == int(count) == step + 1
        p, state = p1, s1


@pytest.mark.gpu
def test_adam_wrapper_rejects_bad_inputs_on_card():
    from vrt_torch.diff.optim import adam
    from vrt_torch.kernels import optim as ko

    dev = _card()
    p, g, mu, nu, c1, c2 = _adam_case([(64,), (5, 5)], dev, 1)
    before = dict(ko.LAUNCHES)

    def call(**kw):
        args = dict(params=p, grads=g, mu=mu, nu=nu, c1=c1, c2=c2)
        args.update(kw)
        return ko.adam_step_cuda(args["params"], args["grads"], args["mu"],
                                 args["nu"], args["c1"], args["c2"], 0.9,
                                 0.999, 1e-2, 1e-8)

    bad = [
        dict(grads=dict(g, leaf0=g["leaf0"].double())),
        dict(params=dict(p, leaf1=p["leaf1"].to(torch.bfloat16))),
        dict(mu=dict(mu, leaf0=mu["leaf0"].cpu())),
        dict(nu=dict(nu, leaf1=nu["leaf1"][:4])),
        dict(params=dict(p, leaf1=p["leaf1"].t())),
        dict(nu={"leaf0": nu["leaf0"]}),
        dict(c1=c1.cpu()),
        dict(c2=c2.reshape(1)),
        dict(grads={}),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)
    with pytest.raises(ValueError, match="f32"):
        adam(1e-2).apply(p, dict(g, leaf0=g["leaf0"].double()),
                         adam(1e-2).init(p))
    assert ko.LAUNCHES == before


# ---- K4's backward: the two backward kernels on the card ---------------------
#
# Each recomputes its stage from the stage's inputs and sums in its own
# order; the colour rows are added with f32 atomics in an order that changes
# from run to run.  An element of a per-ray cotangent is held on every lane
# to SHADE_GRAD_RTOL * |g| + SHADE_GRAD_ATOL * (the launch's largest |g|) of
# its plain version (autograd of the plain stage; a cotangent that cancels to
# 0 there keeps a residue of rounding here): the GGX term of a smooth mirror, 1 + (a^2 -
# 1) (n.h)^2 with n.h near 1, cancels to about a^2 and so turns the last bit
# of a dot product into a relative 1e-5 and more, in the forward as in the
# backward.  The colour table's cotangent is held to SCATTER_RTOL * max|sum|
# of the plain version summed in float64.

SHADE_GRAD_RTOL, SHADE_GRAD_ATOL = 1e-4, 1e-5
SCATTER_RTOL = 1e-5
SHADE_GRAD_CASES = {
    "lit-textured-lights": dict(points=2, spots=1),
    "lit-colours-f32": dict(points=2, spots=1, colors=True),
    "lit-colours-bf16": dict(points=1, spots=1, colors=True,
                             march_dtype=torch.bfloat16),
    "untextured": dict(points=1, spots=1, mode=RenderMode(textured=False)),
    "unlit-textured": dict(points=0, spots=0, mode=RenderMode(lit=False)),
    "unlit-colours": dict(points=0, spots=0, colors=True,
                          mode=RenderMode(lit=False)),
    "overlay": dict(points=1, spots=1, mode=RenderMode(debug_overlay=True)),
    "flagship-1x1-textures": dict(flagship=True, colors=True),
    "contention": dict(contention=True),
    "kinks": dict(points=1, spots=1, colors=True, kinks=True),
    # the f32 voxel grid vrt samples above COLOR_CORNER_BUDGET_BYTES
    "lit-colours-unpacked": dict(points=2, spots=1, colors=True,
                                 unpacked=True),
    "unlit-colours-unpacked": dict(points=0, spots=0, colors=True,
                                   unpacked=True, mode=RenderMode(lit=False)),
    "contention-unpacked": dict(contention=True, unpacked=True),
    "kinks-unpacked": dict(points=1, spots=1, colors=True, kinks=True,
                           unpacked=True),
}


def _shade_grad_level(case, dev, width=480, height=270, seed=0,
                      posed=False):
    """A level of the case's scene on ``dev``: its inputs, seeded cotangents
    (zero on miss lanes, as the chain hands them on) and the bounce's
    radiance and shadow booleans.  With ``kinks`` some lanes sit where
    ``vrt``'s derivatives have kinks: hit points on faces of their cells
    (the colour sample's weights), normals with a zero component (the
    triplanar blend) and a black bounce (the mirror term's clamp).
    ``posed``: the scene's first instance posed by
    ``scenes.posed_instances`` (a quaternion of norm 1.05, an uneven
    scale) before the march."""
    from vrt_torch.march.types import RECORD_GRAD_FIELDS
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.scenes import shading_scene

    spec = dict(SHADE_GRAD_CASES[case])
    mode = spec.pop("mode", RenderMode())
    kinks = spec.pop("kinks", False)
    unpacked = spec.pop("unpacked", False)
    if spec.pop("contention", False):
        # every ray on one colour row; the frame at most 64x64
        scene = contention_scene(flagship_scene(4, use_colors=True,
                                                device=dev))
        width, height = min(width, 64), min(height, 64)
    elif spec.pop("flagship", False):
        scene = flagship_scene(5, use_colors=spec["colors"], device=dev)
    else:
        scene = shading_scene(5, device=dev, **spec)
    if unpacked:
        scene = unpacked_colors(scene)
    if posed:
        from vrt_torch.scenes import posed_instances

        scene = posed_instances(scene)
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, width,
                       height)
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.full((o.shape[0],), tren.RADIANCE_TMAX, device=dev)
    hit, inst = tren.march_scene(scene, o, d, t_max, mode.interp,
                                 debug_overlay=mode.debug_overlay)
    t, n_obj, unlit = tren.resolve_scene(scene, o, d, hit, inst)
    if kinks:
        lanes = torch.arange(3, o.shape[0], 7, device=dev)[:1024]
        on_cell_faces(scene, o, d, hit, inst, lanes, seed)
        t[lanes] = hit.t[lanes]
        n_obj[lanes[::2], 1] = 0.0
        n_obj[lanes[1::4], 0] = -0.0
    rng = np.random.default_rng(seed)
    rays = o.shape[0]

    def seeded(*shape, on=None):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        if on is not None:
            x = torch.where(on.reshape(on.shape + (1,) * (x.ndim - 1)), x,
                            0.0)
        return x

    cots = [seeded(*((rays,) if f in ("roughness", "metallic")
                     else (rays, 3)), on=hit.hit) if mode.lit or
            f == "albedo" else None for f in RECORD_GRAD_FIELDS]
    lights = 1 + scene.num_point + scene.num_spot
    blocked = [torch.from_numpy(rng.uniform(size=rays) < 0.3).to(dev)
               for _ in range(lights)] if mode.lit else None
    refl = torch.from_numpy(rng.uniform(size=(rays, 3)).astype(
        np.float32)).to(dev) if mode.lit else None
    if kinks:
        refl[::3] = 0.0
    return dict(scene=scene, mode=mode, o=o, d=d, hit=hit, inst=inst, t=t,
                n_obj=n_obj, unlit=unlit, cots=cots, blocked=blocked,
                refl=refl, g_rgb=seeded(rays, 3))


def unpacked_colors(scene):
    """``scene`` without its corner-packed colour view: the shading samples
    the f32 voxel grid, as where ``vrt`` leaves the colours unpacked."""
    from vrt_torch.kernels import shade as k4

    scene = dataclasses.replace(scene, voxel_color_corners=None)
    assert k4.color_layout(scene) == "voxels f32"
    return scene


def _assert_grads_close(names, got, want):
    """Per-ray cotangents of a backward kernel against its plain version's,
    None where not returned (the plain version's is then zero)."""
    scale = max(b.abs().max().item() for b in want if b is not None)
    assert scale > 0
    for name, a, b in zip(names, got, want):
        if a is None:
            assert b is None or not bool(b.any()), name
        else:
            _assert_grad_close(a, b, name, scale)


def _assert_grad_close(got, want, name, scale):
    assert want is not None and got.shape == want.shape, name
    assert bool(torch.isfinite(got).all()), name
    diff = (got.double() - want.double()).abs()
    bound = SHADE_GRAD_RTOL * want.double().abs() + SHADE_GRAD_ATOL * scale
    assert bool((diff <= bound).all()), (name, diff.max().item(), scale)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SHADE_GRAD_CASES))
def test_shade_backward_kernels_match_plain_on_card(case):
    """Both backward kernels against their plain versions on the inputs of a
    480x270 level, the record's miss lanes filled with NaN before the
    combine backward (no NaN may reach a cotangent)."""
    from vrt_torch.kernels import shade as k4

    dev = _card()
    lv = _shade_grad_level(case, dev)
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit)
    before = dict(k4.LAUNCHES)
    got = k4.shade_surface_backward_cuda(*args, lv["cots"])
    want = tren.shade_surface_backward_reference(*args, lv["cots"],
                                                 acc_dtype=torch.float64)
    torch.cuda.synchronize()
    _assert_grads_close(("o_w", "d_w", "t", "n_obj"), got[:4], want[:4])
    for name, a in zip(("o_w", "d_w", "t", "n_obj"), got):
        assert not bool((a[~hit.hit] != 0).any()), name
    if scene.use_voxel_colors:
        scale = want[4].abs().max().item()
        assert scale > 0
        assert (got[4].double() - want[4]).abs().max().item() \
            <= SCATTER_RTOL * scale
    else:
        assert got[4] is None and want[4] is None

    rec = k4.shade_surface_cuda(*args, mode.lit)
    miss = ~hit.hit
    for f in ("albedo", "shadow_origin", "n_w", "roughness", "metallic",
              "k", "refl_dir"):
        x = getattr(rec, f)
        if x is not None:
            x[miss] = float("nan")
    cargs = (scene, rec, lv["d"], lv["n_obj"], hit.hit, lv["unlit"],
             lv["refl"], lv["blocked"], mode)
    got = k4.shade_combine_backward_cuda(*cargs, lv["g_rgb"])
    want = tren.shade_combine_backward_reference(*cargs, lv["g_rgb"])
    torch.cuda.synchronize()
    names = ("albedo", "shadow_origin", "n_w", "roughness", "metallic",
             "refl_dir", "d_w", "n_obj", "refl_rgb")
    _assert_grads_close(names, got, want)
    for name, a in zip(names, got):
        if a is not None and name != "d_w":
            assert not bool((a[miss] != 0).any()), name
    assert k4.LAUNCHES["surface_bwd"] == before["surface_bwd"] + 1
    assert k4.LAUNCHES["combine_bwd"] == before["combine_bwd"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(480, 270), (63, 37)],
                         ids=["480x270", "63x37"])
@pytest.mark.parametrize("case", ["contention", "lit-colours-f32",
                                  "lit-colours-bf16", "unlit-colours",
                                  "lit-textured-lights",
                                  "flagship-1x1-textures",
                                  "contention-unpacked",
                                  "lit-colours-unpacked",
                                  "unlit-colours-unpacked"])
def test_surface_backward_designs_on_card(case, size):
    """The surface backward's merged kernel with NaN in ``t`` and ``n_obj``
    on every miss lane: finite cotangents, exact zeros on miss lanes, within
    the tolerances of the plain version (the colour table's of a float64
    sum); the first design on the same inputs gives bit-equal per-ray
    cotangents and a colour table within the same tolerance.  At 63x37 the
    last warp holds 27 rays: its lanes past the end merge and store
    nothing."""
    from vrt_torch.kernels import shade as k4

    dev = _card()
    lv = _shade_grad_level(case, dev, *size)
    assert lv["o"].shape[0] % 32 == (27 if size == (63, 37) else 0)
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    miss = ~hit.hit
    t, n_obj = lv["t"].clone(), lv["n_obj"].clone()
    t[miss] = float("nan")
    n_obj[miss] = float("nan")
    args = (scene, lv["o"], lv["d"], t, n_obj, hit, lv["inst"], mode,
            mode.lit)
    before = k4.LAUNCHES["surface_bwd"]
    got = k4.shade_surface_backward_cuda(*args, lv["cots"])
    old = k4.shade_surface_backward_cuda(*args, lv["cots"],
                                         _old_design=True)
    assert k4.LAUNCHES["surface_bwd"] == before + 2
    want = tren.shade_surface_backward_reference(
        scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"], mode,
        mode.lit, lv["cots"], acc_dtype=torch.float64)
    torch.cuda.synchronize()
    names = ("o_w", "d_w", "t", "n_obj")
    _assert_grads_close(names, got[:4], want[:4])
    for name, a, b in zip(names, got, old):
        assert bool(torch.isfinite(a).all()), name
        assert not bool((a[miss] != 0).any()), name
        assert torch.equal(a, b), name
    if scene.use_voxel_colors:
        scale = want[4].abs().max().item()
        assert scale > 0
        for table in (got[4], old[4]):
            assert (table.double() - want[4]).abs().max().item() \
                <= SCATTER_RTOL * scale
    if case.startswith("contention"):
        rows = torch.unique(hit.cell[hit.hit], dim=0)
        assert int(hit.hit.sum()) == hit.hit.numel() and rows.shape[0] == 1
    if case.endswith("unpacked"):
        assert got[4].shape == (scene.voxel_colors.numel() // 3, 3)


# a scene table's entry summed by a variant's blocks is held to SCATTER_RTOL
# times the sum of its own lanes' |terms| (each term rounds on its own, and
# the terms may cancel), plus TABLE_ATOL
TABLE_ATOL = 1e-12


def _assert_table_close(got, want, terms, name):
    """A scene table's cotangent, summed by a variant's blocks, against the
    plain version's (summed over the lanes in float64): each entry within
    ``SCATTER_RTOL`` * the sum of its lanes' |terms| (``terms``) +
    ``TABLE_ATOL``, so zero where no lane adds to it."""
    assert got.shape == want.shape == terms.shape, name
    assert bool(torch.isfinite(got).all()), name
    err = (got.double() - want.double()).abs()
    bound = SCATTER_RTOL * terms.double() + TABLE_ATOL
    assert bool((err <= bound).all()), (name, (err / bound).max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("old_design", [False, True], ids=["new", "old"])
@pytest.mark.parametrize("case", sorted(SHADE_GRAD_CASES))
def test_shade_variants_match_plain_on_card(case, old_design):
    """The surface backward's material variant and the combine backward's
    light variant (the redesign, or the first design) against their plain
    versions on a 480x270 level, the record's miss lanes NaN before the
    combine backward: the per-ray cotangents (the record's k's among them)
    within the per-ray tolerances, each entry of a material constant or
    light table within ``SCATTER_RTOL`` * the sum of its lanes' |terms| of
    the plain version's float64 sum (``_assert_table_close``);
    every per-ray cotangent that the default launch also returns bit-equal
    to the default launch's on the same inputs; one launch of each variant,
    counted as such."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import LIGHT_FIELDS, MATERIAL_FIELDS

    dev = _card()
    lv = _shade_grad_level(case, dev)
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    rays = hit.hit.shape[0]
    g_k = torch.where(hit.hit, lv["g_rgb"][:, 0], 0.0) if mode.lit else None
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit, lv["cots"])
    variants = dict(k4.VARIANT_LAUNCHES)
    got = k4.shade_surface_backward_cuda(*args, _old_design=old_design,
                                         g_k=g_k, material=True)
    base = k4.shade_surface_backward_cuda(*args, _old_design=old_design)
    want = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, g_k=g_k, material=True)
    torch.cuda.synchronize()
    _assert_grads_close(("o_w", "d_w", "t", "n_obj"), got[:4], want[:4])
    for name, a, b in zip(("o_w", "d_w", "t", "n_obj"), got, base):
        assert torch.equal(a, b), name
    if scene.use_voxel_colors:
        scale = want[4].abs().max().item()
        assert (got[4].double() - want[4]).abs().max().item() \
            <= SCATTER_RTOL * scale
    for name, a, b, terms in zip(MATERIAL_FIELDS, got[5:], want[5:9],
                                 want[9]):
        _assert_table_close(a, b.reshape(a.shape), terms.reshape(a.shape),
                            name)
    if mode.lit:
        assert bool(got[6].any()) and bool(got[8].any())

    rec = k4.shade_surface_cuda(*args[:9], mode.lit)
    miss = ~hit.hit
    for f in ("albedo", "shadow_origin", "n_w", "roughness", "metallic",
              "k", "refl_dir"):
        x = getattr(rec, f)
        if x is not None:
            x[miss] = float("nan")
    cargs = (scene, rec, lv["d"], lv["n_obj"], hit.hit, lv["unlit"],
             lv["refl"], lv["blocked"], mode, lv["g_rgb"])
    got = k4.shade_combine_backward_cuda(*cargs, _old_design=old_design,
                                         lights=True)
    base = k4.shade_combine_backward_cuda(*cargs, _old_design=old_design)
    want = tren.shade_combine_backward_reference(*cargs, lights=True)
    torch.cuda.synchronize()
    names = COMBINE_NAMES + ("k",)
    _assert_grads_close(names, got[:10], want[:10])
    for name, a, b in zip(COMBINE_NAMES, got, base):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    if mode.lit:
        assert got[9].shape == (rays,) and not bool((got[9][miss] != 0).any())
    for name, a, b, terms in zip(LIGHT_FIELDS, got[10], want[10], want[11]):
        _assert_table_close(a, b, terms, name)
    if mode.lit:
        assert bool(got[10][0].any()) and bool(got[10][1].any())
    assert {k: k4.VARIANT_LAUNCHES[k] - variants[k] for k in variants} == {
        "surface_bwd material": 1, "combine_bwd lights": 1,
        "surface_bwd instances": 0}


# the levels whose texture and env variants are held: lit and textured,
# lit with per-voxel colours (no albedo texture), unlit and textured, and
# untextured (no texture variant runs: the texture tables' cotangents are
# zeros)
TABLE_VARIANT_CASES = ("lit-textured-lights", "lit-colours-f32",
                       "unlit-textured", "untextured")


@pytest.mark.gpu
@pytest.mark.parametrize("combined", [False, True],
                         ids=["alone", "with-material-and-lights"])
@pytest.mark.parametrize("path", ["shared", "global"])
@pytest.mark.parametrize("case", TABLE_VARIANT_CASES)
def test_texture_and_env_variants_match_plain_on_card(case, path, combined):
    """The surface backward's texture variant and the combine backward's
    env variant (``combined``: in one launch with the material and the
    light variant) against their plain versions on a 480x270 level, on the
    shared-memory path (the shading scene's own tables) and on the global
    path (``scenes.padded_sampled_tables``: the same texels in a
    [3,256,256,3] stack, the env at twice its side), the record's miss
    lanes NaN before the combine backward: the per-ray cotangents within
    the per-ray tolerances and bit-equal to the launch without the
    variant on the same inputs; each entry of ``tex_scale``, ``textures``
    and ``env`` (and with ``combined`` of the material and light tables)
    within ``SCATTER_RTOL`` * its lanes' |terms| (``_assert_table_close``);
    the padding of the stack exactly zero; one launch of each, counted on
    its path."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import LIGHT_FIELDS, MATERIAL_FIELDS
    from vrt_torch.scenes import padded_sampled_tables

    dev = _card()
    lv = _shade_grad_level(case, dev)
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    sizes = scene.tex_sizes.tolist()
    if path == "global":
        scene = padded_sampled_tables(scene)
    assert k4.table_path(scene.textures, k4.TEXTURE_SHARED_BYTES) == path
    assert k4.table_path(scene.env, k4.ENV_SHARED_BYTES) == path
    g_k = torch.where(hit.hit, lv["g_rgb"][:, 1], 0.0) \
        if combined and mode.lit else None
    surf_kw = dict(g_k=g_k, material=True) if combined else {}
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit, lv["cots"])
    tables, variants = dict(k4.TABLE_LAUNCHES), dict(k4.VARIANT_LAUNCHES)
    got = k4.shade_surface_backward_cuda(*args, textures=True, **surf_kw)
    base = k4.shade_surface_backward_cuda(*args, **surf_kw)
    want = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, textures=True, **surf_kw)
    torch.cuda.synchronize()
    _assert_grads_close(("o_w", "d_w", "t", "n_obj"), got[:4], want[:4])
    for name, a, b in zip(("o_w", "d_w", "t", "n_obj"), got, base):
        assert torch.equal(a, b), name
    if scene.use_voxel_colors:
        scale = want[4].abs().max().item()
        assert (got[4].double() - want[4]).abs().max().item() \
            <= SCATTER_RTOL * scale
    if combined:
        for name, a, b, terms in zip(MATERIAL_FIELDS, got[5:9], want[5:9],
                                     want[9]):
            _assert_table_close(a, b.reshape(a.shape),
                                terms.reshape(a.shape), name)
    terms = want[-1]
    _assert_table_close(got[-2], want[-3], terms[0], "tex_scale")
    _assert_table_close(got[-1], want[-2], terms[1], "textures")
    for i, (h, w) in enumerate(sizes):
        assert not bool(got[-1][i, h:].any()), i
        assert not bool(got[-1][i, :, w:].any()), i
    assert bool(got[-1].any()) == mode.textured
    assert bool(got[-2].any()) == mode.textured

    rec = k4.shade_surface_cuda(*args[:9], mode.lit)
    miss = ~hit.hit
    for f in ("albedo", "shadow_origin", "n_w", "roughness", "metallic",
              "k", "refl_dir"):
        x = getattr(rec, f)
        if x is not None:
            x[miss] = float("nan")
    comb_kw = dict(lights=True) if combined else {}
    cargs = (scene, rec, lv["d"], lv["n_obj"], hit.hit, lv["unlit"],
             lv["refl"], lv["blocked"], mode, lv["g_rgb"])
    got = k4.shade_combine_backward_cuda(*cargs, env=True, **comb_kw)
    base = k4.shade_combine_backward_cuda(*cargs, **comb_kw)
    want = tren.shade_combine_backward_reference(*cargs, env=True,
                                                 **comb_kw)
    torch.cuda.synchronize()
    names = COMBINE_NAMES + (("k",) if combined else ())
    _assert_grads_close(names, got[:len(names)], want[:len(names)])
    for name, a, b in zip(names, got, base):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    if combined:
        for name, a, b, t in zip(LIGHT_FIELDS, got[10], want[10], want[11]):
            _assert_table_close(a, b, t, name)
    _assert_table_close(got[-1], want[-2], want[-1], "env")
    assert bool(got[-1].any())
    assert {k: k4.TABLE_LAUNCHES[k] - tables[k] for k in tables} == {
        k: int(k == f"combine_bwd env {path}" or mode.textured
               and k == f"surface_bwd textures {path}") for k in tables}
    assert {k: k4.VARIANT_LAUNCHES[k] - variants[k] for k in variants} == {
        k: 2 * combined * (k != "surface_bwd instances") for k in variants}


@pytest.mark.gpu
def test_texture_and_env_variants_refuse_the_first_design_on_card():
    """The first designs of the two backward kernels have no texture or
    env variant: asking for one raises, and nothing is launched."""
    from vrt_torch.kernels import shade as k4

    dev = _card()
    lv = _shade_grad_level("lit-textured-lights", dev)
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit, lv["cots"])
    rec = k4.shade_surface_cuda(*args[:9], mode.lit)
    before = dict(k4.LAUNCHES)
    with pytest.raises(ValueError, match="first design"):
        k4.shade_surface_backward_cuda(*args, _old_design=True, textures=True)
    with pytest.raises(ValueError, match="first design"):
        k4.shade_combine_backward_cuda(
            scene, rec, lv["d"], lv["n_obj"], hit.hit, lv["unlit"],
            lv["refl"], lv["blocked"], mode, lv["g_rgb"], _old_design=True,
            env=True)
    assert k4.LAUNCHES == before


# the levels on which the texture and env variants' two designs are held
# against each other (``test_texture_and_env_designs_on_card``): the
# shading scene's coherent texture scale (a warp's lanes on a few
# footprints), a scale of 0.5 x 0.5 units with the miss lanes' directions
# scattered (each lane a footprint of its own: the segmented merges), and a
# frame of 479 x 270 rays (a partial last warp: the scalar path) with the
# cotangents zero on whole warps and on every third lane
TABLE_DESIGN_CASES = ("coherent", "divergent", "partial-zeros")


def _table_design_level(case, dev):
    """``_shade_grad_level``'s lit textured level for a case of
    ``TABLE_DESIGN_CASES``."""
    width = 479 if case == "partial-zeros" else 480
    lv = _shade_grad_level("lit-textured-lights", dev, width=width)
    hit = lv["hit"].hit
    rays = hit.shape[0]
    if case == "divergent":
        lv["scene"] = dataclasses.replace(
            lv["scene"], tex_scale=torch.full_like(lv["scene"].tex_scale,
                                                   0.5))
        gen = torch.Generator().manual_seed(4)
        d = torch.randn((rays, 3), generator=gen).to(dev)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        lv["d_miss"] = torch.where(hit[:, None], lv["d"], d).contiguous()
    if case == "partial-zeros":
        lane = torch.arange(rays, device=dev)
        zero = ((lane // 32) % 5 == 0) | (lane % 3 == 0)
        lv["cots"] = [None if g is None else torch.where(
            zero.reshape(zero.shape + (1,) * (g.ndim - 1)), 0.0, g)
            for g in lv["cots"]]
        lv["g_rgb"] = torch.where(zero[:, None], 0.0, lv["g_rgb"])
    return lv


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["shared", "global"])
@pytest.mark.parametrize("case", TABLE_DESIGN_CASES)
def test_texture_and_env_designs_on_card(case, path):
    """The texture and env variants' redesigns (the default) and their first
    designs (``_old_table_design``), each with the material and the light
    variant in the same launch, on the levels of ``TABLE_DESIGN_CASES``, on
    the shared path and on the global path
    (``scenes.padded_sampled_tables``): every per-ray cotangent of both
    bit-equal to the default launch's on the same inputs; each entry of
    ``tex_scale``, ``textures`` and ``env`` of both within ``SCATTER_RTOL``
    * its lanes' |terms| + ``TABLE_ATOL`` of the plain version's float64
    sums (``_assert_table_close``); the padding of the stack exactly zero;
    each launch counted on its path and its design."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.scenes import padded_sampled_tables

    dev = _card()
    lv = _table_design_level(case, dev)
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    sizes = scene.tex_sizes.tolist()
    if path == "global":
        scene = padded_sampled_tables(scene)
    assert k4.table_path(scene.textures, k4.TEXTURE_SHARED_BYTES) == path
    g_k = torch.where(hit.hit, lv["g_rgb"][:, 1], 0.0)
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit, lv["cots"])
    kw = dict(g_k=g_k, material=True)
    designs = dict(k4.TABLE_DESIGN_LAUNCHES)
    base = k4.shade_surface_backward_cuda(*args, **kw)
    want = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, textures=True, **kw)
    for old in (False, True):
        got = k4.shade_surface_backward_cuda(*args, textures=True,
                                             _old_table_design=old, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("o_w", "d_w", "t", "n_obj"), got, base):
            assert torch.equal(a, b), (old, name)
        _assert_table_close(got[-2], want[-3], want[-1][0], "tex_scale")
        _assert_table_close(got[-1], want[-2], want[-1][1], "textures")
        for i, (h, w) in enumerate(sizes):
            assert not bool(got[-1][i, h:].any()), (old, i)
            assert not bool(got[-1][i, :, w:].any()), (old, i)
        assert bool(got[-1].any())

    rec = k4.shade_surface_cuda(*args[:9], mode.lit)
    cargs = (scene, rec, lv.get("d_miss", lv["d"]), lv["n_obj"], hit.hit,
             lv["unlit"], lv["refl"], lv["blocked"], mode, lv["g_rgb"])
    base = k4.shade_combine_backward_cuda(*cargs, lights=True)
    want = tren.shade_combine_backward_reference(*cargs, env=True,
                                                 lights=True)
    for old in (False, True):
        got = k4.shade_combine_backward_cuda(*cargs, env=True, lights=True,
                                             _old_table_design=old)
        torch.cuda.synchronize()
        for name, a, b in zip(COMBINE_NAMES + ("k",), got, base):
            assert (a is None) == (b is None), (old, name)
            if a is not None:
                assert torch.equal(a, b), (old, name)
        _assert_table_close(got[-1], want[-2], want[-1], "env")
        assert bool(got[-1].any())
    assert {k: k4.TABLE_DESIGN_LAUNCHES[k] - designs[k] for k in designs} \
        == dict.fromkeys(designs, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TABLE_DESIGN_CASES)
def test_texture_and_env_redesign_with_the_instance_variant_on_card(case):
    """The surface backward's instance variant with the texture and the
    material variant in one launch (its texture path the redesign's) on the
    levels of ``TABLE_DESIGN_CASES`` with the first instance posed: the
    textures and the texture scale within their entry bounds, the per-ray
    cotangents bit-equal to the default launch's; the first design refused
    there."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.scenes import posed_instances

    dev = _card()
    lv = _table_design_level(case, dev)
    lv["scene"] = posed_instances(lv["scene"])
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    g_k = torch.where(hit.hit, lv["g_rgb"][:, 1], 0.0)
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit, lv["cots"])
    kw = dict(g_k=g_k, material=True, textures=True, instances=True)
    designs = dict(k4.TABLE_DESIGN_LAUNCHES)
    got = k4.shade_surface_backward_cuda(*args, **kw)
    base = k4.shade_surface_backward_cuda(*args)
    want = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("o_w", "d_w", "t", "n_obj"), got, base):
        assert torch.equal(a, b), name
    _assert_table_close(got[9], want[10], want[12][0], "tex_scale")
    _assert_table_close(got[10], want[11], want[12][1], "textures")
    assert {k: k4.TABLE_DESIGN_LAUNCHES[k] - designs[k] for k in designs} \
        == {k: int(k == "surface_bwd textures warp") for k in designs}
    with pytest.raises(ValueError, match="first design"):
        k4.shade_surface_backward_cuda(*args, _old_table_design=True, **kw)


def _instance_variants(lv, surface_kw=None, dev=None):
    """The two backward kernels' instance variants on a level ``lv`` of
    ``_shade_grad_level`` (its g_rgb's first column and g_rgb as the
    resolve's cotangents), each held against its plain version with
    ``instances`` and against the default launch on the same inputs: the
    per-ray cotangents (the table's) within their tolerances of the plain
    version and bit-equal to the default's; each transform entry within
    ``SCATTER_RTOL`` * its lanes' |terms| (``_assert_table_close``), every
    seen instance's nonzero.  ``surface_kw`` adds the material and texture
    variants to the surface launch.  Returns the instance cotangents of
    both launches."""
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import INSTANCE_FIELDS

    surface_kw = dict(surface_kw or {})
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    inst = lv["inst"]
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, inst,
            mode, mode.lit, lv["cots"])
    variants = dict(k4.VARIANT_LAUNCHES), dict(kr.VARIANT_LAUNCHES)
    got = k4.shade_surface_backward_cuda(*args, instances=True, **surface_kw)
    base = k4.shade_surface_backward_cuda(*args, **surface_kw)
    want = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, instances=True, **surface_kw)
    torch.cuda.synchronize()
    _assert_grads_close(("o_w", "d_w", "t", "n_obj"), got[:4], want[:4])
    for name, a, b in zip(("o_w", "d_w", "t", "n_obj"), got, base):
        assert torch.equal(a, b), name
    if scene.use_voxel_colors:
        scale = want[4].abs().max().item()
        assert (got[4].double() - want[4]).abs().max().item() \
            <= SCATTER_RTOL * scale
    seen = torch.unique(inst[hit.hit].clamp_min(0)).long()
    for name, a, b, terms in zip(INSTANCE_FIELDS, got[-3:], want[-4:-1],
                                 want[-1]):
        _assert_table_close(a, b, terms, name)
        # a seen instance's entries nonzero where the plain version's are
        # (a flat texture moves no hit point's sample)
        assert torch.equal((a[seen] != 0).any(-1),
                           (b[seen] != 0).any(-1).to(a.device)), name
        if name != "inst_pos":
            assert bool(a[seen].any(dim=-1).all()), name
    surface = got[-3:]

    g_t = torch.where(hit.hit, lv["g_rgb"][:, 0], 0.0)
    g_n = torch.where(hit.hit[:, None], lv["g_rgb"], 0.0)
    rargs = (scene, lv["o"], lv["d"], hit, inst, g_t, g_n)
    got = kr.resolve_scene_backward_cuda(*rargs, instances=True)
    base = kr.resolve_scene_backward_cuda(*rargs)
    want = tren.resolve_scene_backward_reference(
        *rargs, acc_dtype=torch.float64, instances=True)
    torch.cuda.synchronize()
    for name, a, b, w in zip(("g_o_w", "g_d_w"), got, base, want):
        assert _bits_equal(a, b), name
        scale = w.abs().max().item()
        assert (a - w).abs().max().item() <= 1e-5 * scale, name
    scale = want[2].abs().max().item()
    assert (got[2].double() - want[2]).abs().max().item() <= 1e-5 * scale
    carries = (hit.kind == 1) | (hit.kind == 2)
    seen = torch.unique(inst[carries].clamp_min(0)).long()
    for name, a, b, terms in zip(INSTANCE_FIELDS, got[3:], want[3:6],
                                 want[6]):
        _assert_table_close(a, b, terms, name)
        assert bool(a[seen].any(dim=-1).all()), name
    assert {k: k4.VARIANT_LAUNCHES[k] - variants[0][k]
            for k in variants[0]} == {
        "surface_bwd material": 2 * bool(surface_kw.get("material")),
        "combine_bwd lights": 0, "surface_bwd instances": 1}
    assert {k: kr.VARIANT_LAUNCHES[k] - variants[1][k]
            for k in variants[1]} == {"backward instances": 1}
    return surface, got[3:]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SHADE_GRAD_CASES))
def test_instance_variants_match_plain_on_card(case):
    """The surface backward's and the resolve backward's instance variants
    against their plain versions on a 480x270 level whose first instance is
    posed (``scenes.posed_instances``: a quaternion of norm 1.05, an uneven
    scale), on f32 and bf16 corner tables and both colour layouts
    (``_instance_variants``)."""
    _instance_variants(_shade_grad_level(case, _card(), posed=True))


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_instance_variants_with_twelve_instances_on_card(table):
    """The two instance variants on config7's 12 instances at 128x128
    (``apps/bench.py::config7_scene``, the first posed) and on the
    12-instance crowd of the resolve tests (overlapping, one rotated and
    scaled, one inactive) on a bf16 table: every instance a ray hits gets
    its own cotangents."""
    from vrt_torch.apps.bench import config7_scene
    from vrt_torch.scenes import posed_instances

    dev = _card()
    if table == "f32":
        scene = posed_instances(config7_scene(5, 12, dev))
    else:
        scene = posed_instances(_crowd(5, "chebyshev", torch.bfloat16, 12,
                                       dev))
    lv = _level_of(scene, dev, 128, 128)
    assert scene.num_instances == 12
    assert torch.unique(lv["inst"][lv["hit"].hit]).numel() >= 6
    _instance_variants(lv)


def _level_of(scene, dev, width, height, seed=5):
    """``_shade_grad_level``'s level of a given scene (lit, textured)."""
    from vrt_torch.march.types import RECORD_GRAD_FIELDS

    from vrt_torch.render.camera import camera_rays

    mode = RenderMode()
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, width,
                       height)
    o, d = o.contiguous(), d.contiguous()
    hit, inst = tren.march_scene(scene, o, d, torch.full(
        (o.shape[0],), tren.RADIANCE_TMAX, device=dev))
    t, n_obj, unlit = tren.resolve_scene(scene, o, d, hit, inst)
    gen = torch.Generator().manual_seed(seed)
    rays = o.shape[0]

    def seeded(*shape):
        x = torch.randn(shape, generator=gen).to(dev)
        return torch.where(hit.hit.reshape(hit.hit.shape + (1,)
                                           * (x.ndim - 1)), x, 0.0)

    cots = [seeded(rays) if f in ("roughness", "metallic")
            else seeded(rays, 3) for f in RECORD_GRAD_FIELDS]
    return dict(scene=scene, mode=mode, o=o, d=d, hit=hit, inst=inst, t=t,
                n_obj=n_obj, unlit=unlit, cots=cots,
                g_rgb=torch.randn((rays, 3), generator=gen).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lit-textured-lights", "lit-colours-f32",
                                  "unlit-textured"])
def test_instance_variant_with_material_and_textures_on_card(case):
    """The surface backward's instance variant in one launch with the
    material and the texture variant: every table of the three within its
    entry bounds, the instance cotangents those of the launch of the
    instance variant alone within the same bounds."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import MATERIAL_FIELDS

    dev = _card()
    lv = _shade_grad_level(case, dev, posed=True)
    mode, hit = lv["mode"], lv["hit"]
    g_k = torch.where(hit.hit, lv["g_rgb"][:, 1], 0.0) if mode.lit else None
    kw = dict(g_k=g_k, material=True, textures=True)
    tables = dict(k4.TABLE_LAUNCHES)
    both, _ = _instance_variants(lv, kw)
    args = (lv["scene"], lv["o"], lv["d"], lv["t"], lv["n_obj"], hit,
            lv["inst"], mode, mode.lit, lv["cots"])
    got = k4.shade_surface_backward_cuda(*args, instances=True, **kw)
    want = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, instances=True, **kw)
    alone = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, instances=True)
    torch.cuda.synchronize()
    for name, a, b, terms in zip(MATERIAL_FIELDS, got[5:9], want[5:9],
                                 want[9]):
        _assert_table_close(a, b.reshape(a.shape), terms.reshape(a.shape),
                            name)
    _assert_table_close(got[9], want[10], want[12][0], "tex_scale")
    _assert_table_close(got[10], want[11], want[12][1], "textures")
    for name, a, b, terms in zip(("inst_pos", "inst_rot", "inst_scale"),
                                 both, alone[5:8], alone[8]):
        _assert_table_close(a, b, terms, name)
    # the helper's variant and default launches, and this one
    assert sum(k4.TABLE_LAUNCHES[k] - tables[k] for k in tables) \
        == 3 * bool(mode.textured)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lit-colours-f32", "lit-colours-bf16"])
def test_instance_variants_on_a_side_stream_on_card(case):
    """Both instance variants launched inside ``torch.cuda.stream`` of a new
    stream, behind a sleep queued on that stream, equal the same launches
    on the default stream: the per-ray cotangents bit for bit, the
    transforms' within ``SCATTER_RTOL`` * their lanes' |terms| (their
    atomics add in any order).  A launch on another stream would run before
    the sleep and the wrappers' zero fills, or fail."""
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import INSTANCE_FIELDS

    dev = _card()
    lv = _shade_grad_level(case, dev, posed=True)
    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit, lv["cots"])
    g_t = torch.where(hit.hit, lv["g_rgb"][:, 0], 0.0)
    g_n = torch.where(hit.hit[:, None], lv["g_rgb"], 0.0)
    rargs = (scene, lv["o"], lv["d"], hit, lv["inst"], g_t, g_n)

    def call():
        return (k4.shade_surface_backward_cuda(*args, instances=True),
                kr.resolve_scene_backward_cuda(*rargs, instances=True))

    want = call()
    terms = (tren.shade_surface_backward_reference(*args, instances=True)[-1],
             tren.resolve_scene_backward_reference(*rargs,
                                                   instances=True)[-1])
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    assert side.cuda_stream != 0
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        got = call()
    side.synchronize()
    for a, b in zip(got[0][:4] + got[1][:2], want[0][:4] + want[1][:2]):
        assert _bits_equal(a, b)
    for g, w, t in zip(got, want, terms):
        # two sums of the kernel's, each within its bound of the exact one
        for name, a, b, tt in zip(INSTANCE_FIELDS, g[-3:], w[-3:], t):
            _assert_table_close(a, b, 2 * tt.to(a.device), name)


def _surface_tables(flags, got, want):
    """The scene tables a surface backward launch with the variant
    ``flags`` returned, as (name, the kernel's, the plain version's float64
    sum, its lanes' |terms|), from the wrapper's outputs ``got`` and the
    plain version's ``want`` with the same flags."""
    from vrt_torch.render.gpuscene import INSTANCE_FIELDS, MATERIAL_FIELDS

    out, g, w = [], 5, 5
    for flag, names in (("material", MATERIAL_FIELDS),
                        ("textures", ("tex_scale", "textures")),
                        ("instances", INSTANCE_FIELDS)):
        if flags.get(flag):
            n = len(names)
            out += [(name, a, b.reshape(a.shape), t.reshape(a.shape))
                    for name, a, b, t in zip(names, got[g:g + n],
                                             want[w:w + n], want[w + n])]
            g, w = g + n, w + n + 1
    return out


def _sums_designs(lv, kw):
    """The surface backward's launch with the variant flags ``kw`` (the
    material variant without the texture variant, or the instance variant)
    on a level ``lv`` on its sums' redesign (the default) and on their
    first design (``_old_sums_design``): the per-ray cotangents of both
    bit-equal to the default launch's (no variant) on the same inputs; the
    colour table within ``SCATTER_RTOL`` * its largest |sum| and each
    entry of every scene table within ``SCATTER_RTOL`` * its lanes'
    |terms| + ``TABLE_ATOL`` (``_assert_table_close``) of the plain
    version's float64 sums, in both; each launch counted by its sums'
    design.  Returns both designs' tables {name: (redesign's, first's)}."""
    from vrt_torch.kernels import shade as k4

    scene, mode, hit = lv["scene"], lv["mode"], lv["hit"]
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], hit, lv["inst"],
            mode, mode.lit, lv["cots"])
    kw = dict(kw)
    if kw.get("material") and mode.lit:
        kw["g_k"] = torch.where(hit.hit, lv["g_rgb"][:, 1], 0.0)
    sums = dict(k4.SUMS_DESIGN_LAUNCHES)
    base = k4.shade_surface_backward_cuda(*args)
    want = tren.shade_surface_backward_reference(
        *args, acc_dtype=torch.float64, **kw)
    tables = {}
    for old in (False, True):
        got = k4.shade_surface_backward_cuda(*args, _old_sums_design=old,
                                             **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("o_w", "d_w", "t", "n_obj"), got, base):
            assert torch.equal(a, b), (old, name)
        if scene.use_voxel_colors:
            scale = want[4].abs().max().item()
            assert (got[4].double() - want[4]).abs().max().item() \
                <= SCATTER_RTOL * scale, old
        for name, a, b, terms in _surface_tables(kw, got, want):
            _assert_table_close(a, b, terms.to(a.device), (old, name))
            tables.setdefault(name, []).append(a)
    assert {k: k4.SUMS_DESIGN_LAUNCHES[k] - sums[k] for k in sums} == {
        "surface_bwd sums warp": 1, "surface_bwd sums first": 1}
    return tables


# the variant flags of the sums' designs: the material variant alone, the
# instance variant alone and both in one launch
SUMS_VARIANTS = {"material": dict(material=True),
                 "instances": dict(instances=True),
                 "instances+material": dict(instances=True, material=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(SUMS_VARIANTS))
@pytest.mark.parametrize("case", sorted(SHADE_GRAD_CASES))
def test_sums_designs_on_card(case, variant):
    """The material and instance variants' sums redesign against their
    first design and the plain version (``_sums_designs``) on a 480x270
    level of every ``SHADE_GRAD_CASES`` case, its first instance posed
    (``scenes.posed_instances``): f32 and bf16 tables, both colour layouts,
    every mode; the rotations nonzero, and the material constants
    somewhere but unlit under per-voxel colours (which read none)."""
    lv = _shade_grad_level(case, _card(), posed="instances" in variant)
    tables = _sums_designs(lv, SUMS_VARIANTS[variant])
    for a in tables.get("inst_rot", ()):
        assert bool(a.any())
    if "tint" in tables:
        read = lv["mode"].lit or not lv["scene"].use_voxel_colors
        for j in range(2):
            assert any(bool(tables[f][j].any()) for f in (
                "tint", "roughness", "metallic", "k")) == read


@pytest.mark.gpu
@pytest.mark.parametrize("case", TABLE_DESIGN_CASES)
def test_sums_designs_with_textures_on_card(case):
    """The instance variant with the material and the texture variant in
    one launch on the levels of ``TABLE_DESIGN_CASES`` (the shading scene,
    lit and textured, the first instance posed) on both sums' designs:
    every table of the three within its entry bounds, the per-ray
    cotangents bit-equal; the material variant with the texture variant
    alone has no sums redesign (``_old_sums_design`` refused)."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.scenes import posed_instances

    lv = _table_design_level(case, _card())
    lv["scene"] = posed_instances(lv["scene"])
    _sums_designs(lv, dict(material=True, textures=True, instances=True))
    args = (lv["scene"], lv["o"], lv["d"], lv["t"], lv["n_obj"], lv["hit"],
            lv["inst"], lv["mode"], True, lv["cots"])
    with pytest.raises(ValueError, match="sums' first design"):
        k4.shade_surface_backward_cuda(*args, material=True, textures=True,
                                       _old_sums_design=True)


def _permuted(lv, seed=3):
    """A level ``lv`` of ``_level_of`` with its lanes in a seeded random
    order: a warp's lanes then hit many instances at once."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        lv["o"].shape[0])).to(lv["o"].device)
    out = dict(lv)
    for k in ("o", "d", "inst", "t", "n_obj", "unlit", "g_rgb"):
        out[k] = lv[k][perm].contiguous()
    out["hit"] = MarchHit(**{f.name: getattr(lv["hit"], f.name)[perm]
                             .contiguous()
                             for f in dataclasses.fields(MarchHit)})
    out["cots"] = [None if g is None else g[perm].contiguous()
                   for g in lv["cots"]]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n_inst", [12, 20])
def test_sums_designs_with_many_instances_on_card(n_inst):
    """Both sums' designs on the crowd of ``n_inst`` instances (20 is
    ``gpuscene.MAX_OBJECTS``; overlapping, one rotated and scaled, one
    inactive) at 128x128 with the lanes in a random order: most warps' hit
    lanes name several instances, so the segmented merge runs beside the
    butterfly; the instance and material variants in one launch."""
    dev = _card()
    from vrt_torch.scenes import posed_instances

    scene = posed_instances(_crowd(5, "chebyshev", torch.float32, n_inst,
                                   dev))
    lv = _permuted(_level_of(scene, dev, 128, 128))
    hit, inst = lv["hit"].hit, lv["inst"]
    keys = torch.where(hit, inst, -1).reshape(-1, 32)
    mixed = sum(torch.unique(w[w >= 0]).numel() > 1 for w in keys)
    assert mixed > keys.shape[0] // 4
    assert torch.unique(inst[hit]).numel() >= 6
    _sums_designs(lv, dict(instances=True, material=True))


@pytest.mark.gpu
def test_sums_designs_without_instances_on_card():
    """A scene without instances: every lane a miss; the instance variant
    returns empty transforms and launches the material variant alone, on
    either sums' design, its tables zero and its per-ray cotangents
    zero."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.scenes import shading_scene

    dev = _card()
    full = shading_scene(4, 1, 1, device=dev)
    scene = dataclasses.replace(
        full, inst_volume=full.inst_volume[:0], inst_pos=full.inst_pos[:0],
        inst_rot=full.inst_rot[:0], inst_scale=full.inst_scale[:0],
        inst_active=full.inst_active[:0])
    lv = _level_of(scene, dev, 64, 48)
    assert not bool(lv["hit"].hit.any())
    sums = dict(k4.SUMS_DESIGN_LAUNCHES)
    args = (scene, lv["o"], lv["d"], lv["t"], lv["n_obj"], lv["hit"],
            lv["inst"], lv["mode"], True, lv["cots"])
    for old in (False, True):
        got = k4.shade_surface_backward_cuda(*args, material=True,
                                             instances=True,
                                             _old_sums_design=old)
        torch.cuda.synchronize()
        assert all(not bool(g.any()) for g in got[:4] + got[5:9])
        assert [tuple(g.shape) for g in got[-3:]] == [(0, 3), (0, 4), (0, 3)]
    assert {k: k4.SUMS_DESIGN_LAUNCHES[k] - sums[k] for k in sums} == {
        "surface_bwd sums warp": 1, "surface_bwd sums first": 1}


def _many_volumes(scene, n):
    """``scene`` with its volumes and their material tables repeated to
    ``n`` volumes (the instances still name the first ones)."""
    def rows(x):
        return x[torch.arange(n, device=x.device) % x.shape[0]]

    vols = scene.volumes
    vols = dataclasses.replace(vols, **{
        f.name: rows(getattr(vols, f.name))
        for f in dataclasses.fields(vols)
        if isinstance(getattr(vols, f.name), torch.Tensor)})
    return dataclasses.replace(scene, volumes=vols, **{
        name: rows(getattr(scene, name))
        for name in ("tint", "roughness", "metallic", "k", "tex_scale",
                     "albedo_tex", "normal_tex", "rm_tex")})


@pytest.mark.gpu
def test_sums_designs_with_many_volumes_on_card():
    """The material variant on a scene of 100 volumes (the lights scene's
    repeated; the hit lanes name the first ones) on both sums' designs
    (``_sums_designs``); on one of 1,000, whose sums outgrow the redesign's
    shared memory, the entry point refuses the launch."""
    lv = _shade_grad_level("lit-textured-lights", _card(), 64, 48)
    lv["scene"] = _many_volumes(lv["scene"], 100)
    _sums_designs(lv, dict(material=True))
    from vrt_torch.kernels import shade as k4

    args = (_many_volumes(lv["scene"], 1000), lv["o"], lv["d"], lv["t"],
            lv["n_obj"], lv["hit"], lv["inst"], lv["mode"], True, lv["cots"])
    with pytest.raises(RuntimeError, match="launch failed"):
        k4.shade_surface_backward_cuda(*args, material=True)


@pytest.mark.gpu
def test_fit_through_materials_and_lights_on_card():
    """The 64x36 fit of ``tests/fixtures/fit_flagship_r4_colors_64x36.npz``
    with the material constants and the lights among the parameters, on the
    card: every level through the shade Functions and the backward kernels'
    variants (3 + 3 forward and 3 + 3 backward launches, each backward a
    variant), the loss and the SDF and colour gradients the fixture's, and
    every material and light gradient within a cosine of 1 - 1e-6 and
    1e-4 * max|g| of the same step on the plain stages under autograd."""
    import os

    from vrt_torch.diff.fit import (_value_and_grad, graft_and_rebuild,
                                    render_views)
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import LIGHT_FIELDS, MATERIAL_FIELDS

    dev = _card()
    scene = flagship_scene(4, use_colors=True, device=dev)
    fixture = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                   "fit_flagship_r4_colors_64x36.npz"))
    cams = [dict(position=(320.0, 0.0, 40.0), rotation=(0.0, 0.0, 1.0, 0.0),
                 fov=60.0)]
    keys = ("sdf", "voxel_colors") + MATERIAL_FIELDS + LIGHT_FIELDS

    def loss(p):
        s = graft_and_rebuild(scene, p)
        return torch.mean((render_views(s, cams, 64, 36, RenderMode())
                           - 0.25) ** 2)

    params = {k: scene.volumes.sdf if k == "sdf" else getattr(scene, k)
              for k in keys}
    before, variants = dict(k4.LAUNCHES), dict(k4.VARIANT_LAUNCHES)
    got, grads = _value_and_grad(loss, params)
    torch.cuda.synchronize()
    assert {k: k4.LAUNCHES[k] - before[k] for k in before} == dict(
        surface=3, combine=3, surface_bwd=3, combine_bwd=3)
    assert {k: k4.VARIANT_LAUNCHES[k] - variants[k] for k in variants} == {
        "surface_bwd material": 3, "combine_bwd lights": 3,
        "surface_bwd instances": 0}
    assert float(got) == pytest.approx(float(fixture["loss"]), rel=1e-5)
    for k in ("sdf", "voxel_colors"):
        a = fixture[f"grad_{k}"].astype(np.float64).ravel()
        b = grads[k].double().cpu().numpy().ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert 1.0 - cos < 1e-8, (k, 1.0 - cos)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), k
    plain = tren.shade_stages
    tren.shade_stages = lambda *_: (tren.shade_surface_reference,
                                    tren.shade_combine_reference)
    try:
        _, eager = _value_and_grad(loss, params)
    finally:
        tren.shade_stages = plain
    for k in MATERIAL_FIELDS + LIGHT_FIELDS:
        a = eager[k].double().cpu().numpy().ravel()
        b = grads[k].double().cpu().numpy().ravel()
        assert np.isfinite(b).all(), k
        if not a.any():
            assert not b.any(), k
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert 1.0 - cos < 1e-6, (k, 1.0 - cos)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), k


@pytest.mark.gpu
def test_fit_fixture_through_shade_backward_on_card():
    """The 64x36 fit of ``tests/fixtures/fit_flagship_r4_colors_64x36.npz``
    (vrt's loss and gradients on the CPU) on the card: every level through
    the shade Functions (3 + 3 forward and 3 + 3 backward launches, no K3
    launch), the loss to rtol 1e-5, each gradient to a cosine of 1 - 1e-8
    and 1e-4 * max|g|."""
    import os

    from vrt_torch.diff.fit import (_value_and_grad, graft_and_rebuild,
                                    render_views)
    from vrt_torch.kernels import rows as k3
    from vrt_torch.kernels import shade as k4

    dev = _card()
    scene = flagship_scene(4, use_colors=True, device=dev)
    fixture = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                   "fit_flagship_r4_colors_64x36.npz"))
    cams = [dict(position=(320.0, 0.0, 40.0), rotation=(0.0, 0.0, 1.0, 0.0),
                 fov=60.0)]

    def loss(p):
        s = graft_and_rebuild(scene, p)
        return torch.mean((render_views(s, cams, 64, 36, RenderMode())
                           - 0.25) ** 2)

    before, k3_before = dict(k4.LAUNCHES), dict(k3.LAUNCHES)
    got, grads = _value_and_grad(loss, {"sdf": scene.volumes.sdf,
                                        "voxel_colors": scene.voxel_colors})
    torch.cuda.synchronize()
    assert {k: k4.LAUNCHES[k] - before[k] for k in before} == dict(
        surface=3, combine=3, surface_bwd=3, combine_bwd=3)
    assert k3.LAUNCHES == k3_before
    assert float(got) == pytest.approx(float(fixture["loss"]), rel=1e-5)
    for k, g in grads.items():
        a = fixture[f"grad_{k}"].astype(np.float64).ravel()
        b = g.double().cpu().numpy().ravel()
        assert np.isfinite(b).all(), k
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert 1.0 - cos < 1e-8, (k, 1.0 - cos)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), k


# ---- K4's forward redesign against its first design on the card --------------
#
COMBINE_MODES = {"lit": RenderMode(),
                 "unlit-lanes": RenderMode(debug_overlay=True),
                 "unlit-mode": RenderMode(lit=False)}
COMBINE_LIGHTS = {"sun": (0, 0), "points-spot": (2, 1)}
COMBINE_NAMES = ("albedo", "shadow_origin", "n_w", "roughness", "metallic",
                 "refl_dir", "d_w", "n_obj", "refl_rgb")


def _combine_case(mode, lights, mirror, rays, dev, seed=0):
    """The combine stage's inputs on ``rays`` camera rays of the textured
    scene with ``lights`` (the sun alone, or two point lights and a spot
    light) in ``mode``: the surface kernel's record (its miss lanes as the
    kernel leaves them), seeded roughness on the hit lanes around the
    mirror's gate (some at 0.3 and some just under), the bounce's radiance
    where ``mirror``, seeded shadow booleans and the radiance's
    cotangent.  Returns the combine backward's arguments before
    ``g_rgb``, and ``g_rgb``."""
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.scenes import shading_scene

    points, spots = COMBINE_LIGHTS[lights]
    scene = shading_scene(5, points, spots, device=dev)
    m = COMBINE_MODES[mode]
    width = 256 if rays % 256 == 0 else 63
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, width,
                       rays // width)
    o, d = o.contiguous(), d.contiguous()
    assert o.shape[0] == rays
    t_max = torch.full((rays,), tren.RADIANCE_TMAX, device=dev)
    hit, inst = tren.march_scene(scene, o, d, t_max, m.interp,
                                 debug_overlay=m.debug_overlay)
    t, n_obj, unlit = tren.resolve_scene(scene, o, d, hit, inst)
    bounce = mirror and m.lit
    rec = k4.shade_surface_cuda(scene, o, d, t, n_obj, hit, inst, m, bounce,
                                m.lit)
    rng = np.random.default_rng(seed)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(size=shape).astype(
            np.float32)).to(dev)

    refl = blocked = None
    if m.lit:
        rough = uniform(rays) * 0.6
        rough[::7] = 0.3
        rough[3::7] = float(np.nextafter(np.float32(0.3), np.float32(0.0)))
        rec.roughness = torch.where(hit.hit, rough, rec.roughness)
        blocked = [uniform(rays) < 0.3
                   for _ in range(1 + scene.num_point + scene.num_spot)]
        refl = uniform(rays, 3) if bounce else None
    g_rgb = torch.from_numpy(rng.normal(size=(rays, 3)).astype(
        np.float32)).to(dev)
    assert 0 < int(hit.hit.sum()) < rays
    return (scene, rec, d, n_obj, hit.hit, unlit, refl, blocked, m), g_rgb


@pytest.mark.gpu
@pytest.mark.parametrize("rays", [65536, 4095])
@pytest.mark.parametrize("path", ["v4", "scalar"])
@pytest.mark.parametrize("mirror", [True, False], ids=["mirror", "no-mirror"])
@pytest.mark.parametrize("lights", sorted(COMBINE_LIGHTS))
@pytest.mark.parametrize("mode", sorted(COMBINE_MODES))
def test_combine_backward_designs_on_card(mode, lights, mirror, path, rays):
    """The combine backward's redesign (resident blocks, the lights staged
    once a block, 16-byte spans, a warp without a hit on the env lookup's
    backward alone) against its first design and against
    ``shade_combine_backward_reference`` on the same inputs, lit, with
    unlit-attribute lanes and in unlit mode, with the sun alone and with
    two point lights and a spot light, with and without the mirror term, on
    the vector path and on the scalar path (the direction based off a
    16-byte boundary), at 65,536 rays and at an odd 4,095 (a partial last
    warp): outputs filled with NaN first, all nine cotangents bit-equal to
    the first design's, both within tolerance of the plain version."""
    from vrt_torch.kernels import shade as k4

    dev = _card()
    args, g_rgb = _combine_case(mode, lights, mirror, rays, dev)
    if path == "scalar":
        args = args[:2] + (_off_boundary(args[2]),) + args[3:]
    saved = k4._empty
    k4._empty = _nan_outputs(k4)
    try:
        paths = dict(k4.PATH_LAUNCHES)
        new = k4.shade_combine_backward_cuda(*args, g_rgb)
        moved = {k: k4.PATH_LAUNCHES[k] - paths[k] for k in paths}
        old = k4.shade_combine_backward_cuda(*args, g_rgb, _old_design=True)
    finally:
        k4._empty = saved
    torch.cuda.synchronize()
    assert moved == {**{k: 0 for k in paths}, f"combine_bwd {path}": 1}
    want = tren.shade_combine_backward_reference(*args, g_rgb)
    for name, a, b in zip(COMBINE_NAMES, new, old):
        assert (a is None) == (b is None), name
        if a is not None:
            assert _bits_equal(a, b), name
    _assert_grads_close(COMBINE_NAMES, new, want)
    _assert_grads_close(COMBINE_NAMES, old, want)


# The redesign (resident blocks, a warp's [32,3] spans in 16-byte words) and
# the first design (one thread a ray) compute each lane's values with the
# same device functions in the same order: every lane either writes must be
# bit-equal, and each leaves the same lanes unwritten (outputs filled with
# NaN, or True for the gate, before the launch).

def _nan_outputs(k4):
    """``k4._empty`` filling every output: floats with NaN, bools with
    True."""
    def empty(shape, dtype, dev):
        return torch.full(shape, True if dtype == torch.bool
                          else float("nan"), dtype=dtype, device=dev)
    return empty


def _bit_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()
        if a.is_floating_point() else torch.equal(a, b))


def _want_path(scene, rays, lit, shadows, n_shadow):
    """The path of a surface launch: "voxels" on the unpacked colour grid,
    else the resident kernel's, where the stacked shadow directions' row 1
    starts off a 16-byte boundary where R is not a multiple of 4."""
    from vrt_torch.kernels import shade as k4

    if k4.color_layout(scene) == "voxels f32":
        return "voxels"
    return "scalar" if lit and shadows and n_shadow >= 2 and rays % 4 \
        else "v4"


def _on_design(old, call, resident=False):
    """``call()`` with every output of the forward kernels filled (NaN, or
    True), on the first design where ``old``, on the resident surface
    kernel whatever the colour layout where ``resident``."""
    import functools

    from vrt_torch.kernels import shade as k4

    saved = (k4.shade_surface_cuda, k4.shade_combine_cuda, k4._empty)
    k4._empty = _nan_outputs(k4)
    if old:
        k4.shade_surface_cuda = functools.partial(saved[0], _old_design=True)
        k4.shade_combine_cuda = functools.partial(saved[1], _old_design=True)
    elif resident:
        k4.shade_surface_cuda = functools.partial(saved[0], _resident=True)
    try:
        return call()
    finally:
        k4.shade_surface_cuda, k4.shade_combine_cuda, k4._empty = saved


def _designs_held(seen):
    """A stage pair that runs each launch on both designs with filled
    outputs, holds them bit-equal where either writes, the redesign's
    material unwritten on miss lanes, its path counted as expected, and the
    redesign against the plain stage (``_held_stages``); on the unpacked
    colour grid the surface's default (``surface_voxels_kernel``) is also
    held bit-equal to the resident kernel."""
    from vrt_torch.kernels import shade as k4

    held = _held_stages(seen)(None)

    def surface(*args):
        scene, rays, hit = args[0], args[1].shape[0], args[5].hit
        mode, bounce, shadows = args[7], args[8], args[9]
        paths = dict(k4.PATH_LAUNCHES)
        got = held[0](*args)
        path = _want_path(scene, rays, mode.lit, shadows,
                          scene.num_point + scene.num_spot)
        assert {k: k4.PATH_LAUNCHES[k] - paths[k] for k in paths} == {
            **{k: 0 for k in paths}, f"surface {path}": 1}
        new = _on_design(False, lambda: tren._shade_surface_kernel(*args))
        olds = [_on_design(True, lambda: tren._shade_surface_kernel(*args))]
        if path == "voxels":
            olds.append(_on_design(False, lambda: tren._shade_surface_kernel(
                *args), resident=True))
        torch.cuda.synchronize()
        spawns = mode.lit and (bounce or shadows)
        for f, old in ((f, old) for old in olds
                       for f in dataclasses.fields(new)):
            a, b = getattr(new, f.name), getattr(old, f.name)
            assert (a is None) == (b is None), f.name
            if a is None:
                continue
            if f.name in ("shadow_tmax", "shadow_dir"):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert _bit_equal(x, y), f.name
                    assert not bool(torch.isnan(x).any()), f.name
                continue
            assert _bit_equal(a, b), f.name
            if f.name in ("albedo", "n_w", "roughness", "metallic", "k") or \
                    f.name == "shadow_origin" and not spawns:
                assert bool(torch.isnan(a[~hit]).all()), f.name
            if f.name == "gate":
                assert not bool(a[~hit].any())
            elif f.name == "refl_dir" or f.name == "shadow_origin" and spawns:
                assert not bool(torch.isnan(a).any()), f.name
        return got

    def combine(*args):
        paths = dict(k4.PATH_LAUNCHES)
        got = held[1](*args)
        assert {k: k4.PATH_LAUNCHES[k] - paths[k] for k in paths} == {
            **{k: 0 for k in paths}, "combine v4": 1}
        old = _on_design(True, lambda: tren._shade_combine_kernel(*args))
        torch.cuda.synchronize()
        assert _bit_equal(got, old)
        assert not bool(torch.isnan(got).any())
        return got

    return lambda *_: (surface, combine)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(480, 270), (63, 37)],
                         ids=["480x270", "63x37"])
@pytest.mark.parametrize("lights", sorted(LIGHT_SETS))
@pytest.mark.parametrize("mode", sorted(SHADE_MODES))
def test_shade_forward_designs_on_card(mode, lights, size):
    """Every surface and combine launch of a frame of the textured scene on
    the redesign and on the first design: bit-equal on every lane either
    writes, the same lanes unwritten, the material of miss lanes unwritten,
    the redesign on the path its tensors give (the scalar one at 63x37 with
    two or more point and spot lights: a partial last warp and stacked
    shadow rows off 16-byte boundaries) and within tolerance of the plain
    stages on every lane."""
    from vrt_torch.scenes import shading_scene

    points, spots = LIGHT_SETS[lights]
    _frame_designs(shading_scene(5, points, spots, device=_card()),
                   SHADE_MODES[mode], size)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(480, 270), (63, 37), (256, 256),
                                  (255, 257)],
                         ids=["480x270", "63x37", "256x256", "255x257"])
@pytest.mark.parametrize("mode", ["mode0", "mode1", "mode2", "mode4"])
def test_shade_forward_designs_unpacked_on_card(mode, size):
    """``test_shade_forward_designs_on_card`` on the scene's seeded colours
    unpacked (the f32 voxel grid, 8 voxel rows a hit), lit and unlit,
    textured and not, interpolated and cube: the default there
    (``surface_voxels_kernel``) bit-equal to the first design and to the
    resident kernel with NaN-filled outputs and within tolerance of the
    plain stage, at 256x256 (config4's launch, under one wave of the card)
    and at 255x257 (R = 65,535: a partial last warp) too."""
    from vrt_torch.scenes import shading_scene

    scene = shading_scene(5, 2, 1, colors=True, device=_card())
    _frame_designs(unpacked_colors(scene), SHADE_MODES[mode], size)


def _frame_designs(scene, mode, size):
    """A frame of ``scene`` whose every surface and combine launch runs on
    the redesign and on the first design, held by ``_designs_held``."""
    from vrt_torch.kernels import shade as k4

    width, height = size
    seen = dict(surface=0, combine=0)
    before = dict(k4.LAUNCHES)
    plain = tren.shade_stages
    tren.shade_stages = _designs_held(seen)
    try:
        with torch.no_grad():
            img = render_image(scene, width, height, mode)
    finally:
        tren.shade_stages = plain
    torch.cuda.synchronize()
    levels = 3 if mode.lit and scene.any_reflective else 1
    assert seen == dict(surface=levels, combine=levels)
    # the held stage, the redesign again and the first design per level (and
    # on the unpacked grid the resident kernel)
    surfaces = 4 if k4.color_layout(scene) == "voxels f32" else 3
    assert {k: k4.LAUNCHES[k] - before[k] for k in before} == dict(
        surface=surfaces * levels, combine=2 * levels, surface_bwd=0,
        combine_bwd=0)
    assert img.shape == (height, width, 4)
    assert bool(torch.isfinite(img).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rays", [2331, 2304])
def test_shade_forward_designs_packed_record_on_card(rays):
    """The fit step's record, ``ShadeSurface.apply``'s packed tuple, from
    the redesign and from the first design (outputs filled first):
    bit-equal tensors, the stacked shadow rows included, on the scalar path
    where R = 2331 puts row 1 of the directions off a 16-byte boundary and
    on the vector path at R = 2304."""
    from vrt_torch.kernels import shade as k4

    dev = _card()
    lv = _shade_grad_level("lit-colours-f32", dev, 63, 37)
    scene, hit = lv["scene"], lv["hit"]
    args = tuple(lv[k][:rays].contiguous() for k in ("o", "d", "t", "n_obj"))
    hit = dataclasses.replace(hit, hit=hit.hit[:rays].contiguous(),
                              cell=hit.cell[:rays].contiguous())
    args += (scene.voxel_color_corners,
             *(getattr(scene, f) for f in k4.MATERIAL_FIELDS),
             scene.tex_scale, scene.textures,
             *(getattr(scene, f) for f in k4.INSTANCE_FIELDS), scene, hit,
             lv["inst"][:rays].contiguous(), RenderMode(), True, True)
    paths = dict(k4.PATH_LAUNCHES)
    new = _on_design(False, lambda: k4.ShadeSurface.apply(*args))
    path = "scalar" if rays % 4 else "v4"
    assert {k: k4.PATH_LAUNCHES[k] - paths[k] for k in paths} == {
        **{k: 0 for k in paths}, f"surface {path}": 1}
    old = _on_design(True, lambda: k4.ShadeSurface.apply(*args))
    torch.cuda.synchronize()
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert (a is None) == (b is None)
        if a is not None:
            assert _bit_equal(a, b)
    assert bool(torch.isnan(new[0][~hit.hit]).all())
    tmax, sdir = new[-2:]
    assert tmax.shape == (1 + 3, rays) and sdir.shape == (3, rays, 3)
    assert (sdir[1].data_ptr() % 16 == 0) == (rays % 4 == 0)


# ---- K7, the slab march, and the fused resolve over a slab's table --------

def _slab_volume(resolution=5):
    """tests/test_brick.py's CSG volume (a sphere plus a box) and config5's
    light, as host data."""
    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    csg = S.CSG(shape=S.Sphere(radius=55.0))
    csg.add_child(S.Box(extends=(70.0, 25.0, 25.0),
                        position=np.array([0.0, 0.0, 40.0], np.float32)),
                  S.ADD)
    return VoxelVolume.from_generator(csg, resolution, 100.0)


def _slab_rays(dev, n=64 * 64, seed=9):
    """64^2 rays from outside the volume toward it, some with a zero
    direction component, a third with a finite t_max."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-d * rng.uniform(150.0, 320.0, size=(n, 1))
         + rng.normal(scale=30.0, size=(n, 3))).astype(np.float32)
    d[::29, 0] = 0.0
    t_max = np.where(rng.uniform(size=n) < 0.3, 220.0, 1e4
                     ).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (o, d, t_max)]


def test_slab_wrappers_refuse_cpu_tensors():
    """K7's wrapper and the slab resolve's take CUDA tensors only: no
    fallback to the plain versions."""
    from vrt_torch.dist import brick
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr

    slab = brick.shard_volume(_slab_volume(4), 2).local(0, "cpu")
    o, d, t_max = _slab_rays("cpu", n=8)
    with pytest.raises(ValueError, match="CUDA"):
        k1.march_slab_cuda(slab, o, d, t_max)
    hit = MarchHit.none(8)
    with pytest.raises(ValueError, match="CUDA"):
        kr.resolve_slab_cuda(None, slab, o, d, hit,
                             torch.zeros(8, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("s_count", [2, 4])
@pytest.mark.parametrize("accel_mode", ["octree", "chebyshev"])
@pytest.mark.parametrize("interp,debug", [(True, False), (False, False),
                                          (True, True)],
                         ids=["interp", "cube", "overlay"])
def test_k7_matches_twin_on_card(s_count, accel_mode, interp, debug):
    """K7 against ``march_volume_slab_reference`` on every shard, field by
    field: hit, kind, t, cell, t_in, t_out, face normal (NaN equal to NaN)
    and steps, bit for bit."""
    from vrt_torch.dist import brick
    from vrt_torch.kernels import march as k1

    dev = _card()
    slabs = brick.shard_volume(_slab_volume(), s_count, accel_mode)
    o, d, t_max = _slab_rays(dev)
    before, hits = k1.SLAB_LAUNCHES, 0
    for s in range(s_count):
        slab = slabs.local(s, dev)
        got = brick.march_volume_slab(slab, o, d, t_max, interp, debug)
        want = brick.march_volume_slab_reference(slab, o, d, t_max, interp,
                                                 debug)
        torch.cuda.synchronize()
        for f in ("hit", "t", "kind", "cell", "t_in", "t_out",
                  "face_normal", "steps"):
            a, b = getattr(got, f), getattr(want, f)
            same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                if a.is_floating_point() else a == b
            assert bool(same.all()), (s, f, int((~same).sum()))
        hits += int(got.hit.sum())
    assert k1.SLAB_LAUNCHES - before == s_count
    assert hits > 100


def _hits_same(a, b):
    """Fields of two MarchHits that differ (NaN equal to NaN)."""
    bad = []
    for f in ("hit", "t", "kind", "cell", "t_in", "t_out", "face_normal",
              "steps"):
        x, y = getattr(a, f), getattr(b, f)
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) \
            if x.is_floating_point() else x == y
        if not bool(same.all()):
            bad.append((f, int((~same).sum())))
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("s_count", [2, 4])
@pytest.mark.parametrize("accel_mode", ["octree", "chebyshev"])
@pytest.mark.parametrize("interp,debug", [(True, False), (False, False),
                                          (True, True)],
                         ids=["interp", "cube", "overlay"])
def test_k7_designs_on_card(s_count, accel_mode, interp, debug):
    """K7's redesign (the slab's planes, the capped kernel) against its
    first design (the packed table, ``table="packed"``) and the twin on
    every shard, field by field; one launch of each counted."""
    from vrt_torch.dist import brick
    from vrt_torch.kernels import march as k1

    dev = _card()
    slabs = brick.shard_volume(_slab_volume(), s_count, accel_mode)
    o, d, t_max = _slab_rays(dev)
    before = k1.SLAB_LAUNCHES
    for s in range(s_count):
        slab = slabs.local(s, dev)
        assert slab.table == "planes" and "corners" not in slab.march_tables
        new = brick.march_volume_slab(slab, o, d, t_max, interp, debug)
        old = brick.march_volume_slab(
            dataclasses.replace(slab, table="packed"), o, d, t_max, interp,
            debug)
        want = brick.march_volume_slab_reference(slab, o, d, t_max, interp,
                                                 debug)
        torch.cuda.synchronize()
        assert _hits_same(new, old) == [], s
        assert _hits_same(new, want) == [], s
    assert k1.SLAB_LAUNCHES - before == 2 * s_count


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["planes", "packed"])
@pytest.mark.parametrize("s_count", [2, 4])
def test_slab_resolve_matches_plain_on_card(s_count, table):
    """The fused resolve over each shard's slab (its planes, or the first
    design's slab-local table; a non-zero x origin but on shard 0) against
    ``resolve_slab_hits`` on the lanes whose hit the shard owns: t, the
    normal and unlit equal (NaN equal to NaN); and the planes' forward
    bit-equal to the first design's on every lane but the surface hits the
    shard does not own (whose cells may lie outside its planes, where the
    two designs read zeros by voxel and by row)."""
    from vrt_torch.core import quat as vq
    from vrt_torch.dist import brick
    from vrt_torch.dist.slab_render import SlabTracer, default_fit_scene
    from vrt_torch.kernels import resolve as kr

    dev = _card()
    vol = _slab_volume()
    slabs = brick.shard_volume(vol, s_count)
    light = np.asarray(vq.forward_vector(vq.from_euler_degrees(0, 45, -30)),
                       np.float32)
    scene = default_fit_scene(vol.n_voxels, vol.cell_size, vol.extends,
                              light, device=dev)
    o_w, d_w, t_max = _slab_rays(dev)
    owned_lanes = 0
    for s in range(s_count):
        slab = dataclasses.replace(slabs.local(s, dev), table=table)
        o, d = SlabTracer(slab, None)._object_rays(scene, o_w, d_w)
        hit = brick.march_volume_slab(slab, o, d, t_max)
        inst = torch.where(hit.hit, 0, -1).to(torch.int32)
        got = kr.resolve_slab_cuda(scene, slab, o_w, d_w, hit, inst)
        want = brick.resolve_slab_hits(slab, o, d, hit)
        owned = (hit.hit & (hit.cell[:, 0] >= slab.cell_lo)
                 & (hit.cell[:, 0] < slab.cell_hi))
        for a, b in zip(got, want):
            a, b = a[owned], b[owned]
            assert bool(((a == b) | ((a != a) & (b != b))).all())
        if table == "planes":
            old = kr.resolve_slab_cuda(
                scene, dataclasses.replace(slab, table="packed"), o_w, d_w,
                hit, inst)
            lanes = owned | (hit.kind != 1)
            for a, b in zip(got, old):
                assert _bit_equal(a[lanes], b[lanes])
        owned_lanes += int(owned.sum())
    assert owned_lanes > 100


def _slab_backward_case(dev, slab, scene, o_w, d_w, seed):
    """The slab march's hits on ``slab``, and random cotangents of t and the
    normal on the lanes the slab owns (zeros elsewhere, as the tracer's
    owner sum gives them)."""
    from vrt_torch.dist import brick
    from vrt_torch.dist.slab_render import SlabTracer

    o, d = SlabTracer(slab, None)._object_rays(scene, o_w, d_w)
    hit = brick.march_volume_slab(slab, o, d,
                                  torch.full((o.shape[0],), 1e4, device=dev))
    inst = torch.where(hit.hit, 0, -1).to(torch.int32)
    owned = (hit.hit & (hit.cell[:, 0] >= slab.cell_lo)
             & (hit.cell[:, 0] < slab.cell_hi))
    gen = torch.Generator().manual_seed(seed)
    g_t = torch.randn(o.shape[0], generator=gen).to(dev) * owned
    g_n = torch.randn(o.shape, generator=gen).to(dev) * owned[:, None]
    return hit, inst, owned, g_t.contiguous(), g_n.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["planes", "packed"])
@pytest.mark.parametrize("s_count", [2, 4])
def test_slab_resolve_backward_matches_autograd_on_card(s_count, table):
    """``ResolveSlab`` on the card over each shard's ``resolve_table`` (the
    planes: the fused resolve and the planes variant of its merged
    backward, which adds into the planes' gradient; the first design's
    packed table: the slab variant over the table, its gradient carried to
    the planes through the pack) against autograd of ``resolve_slab_hits``
    on the card for the same cotangents: plane gradients within 1e-5 *
    max|sum| of autograd's and of the closed form
    ``resolve_slab_backward_reference`` summed in float64, ray gradients
    within 1e-5 * max|g| of the closed form's and bit-equal to the packed
    table's two designs; one backward launch a shard, counted as a slab
    launch."""
    import dataclasses

    from vrt_torch.core import quat as vq
    from vrt_torch.dist import brick
    from vrt_torch.dist.slab_render import SlabTracer, default_fit_scene
    from vrt_torch.kernels import resolve as kr

    dev = _card()
    vol = _slab_volume()
    slabs = brick.shard_volume(vol, s_count)
    light = np.asarray(vq.forward_vector(vq.from_euler_degrees(0, 45, -30)),
                       np.float32)
    scene = default_fit_scene(vol.n_voxels, vol.cell_size, vol.extends,
                              light, device=dev)
    o_np, d_np, _ = (x.cpu() for x in _slab_rays("cpu"))
    owned_lanes = 0
    for s in range(s_count):
        slab = dataclasses.replace(slabs.local(s, dev), table=table)
        hit, inst, owned, g_t, g_n = _slab_backward_case(
            dev, slab, scene, o_np.to(dev), d_np.to(dev), s)
        grads = {}
        for path in ("kernels", "autograd"):
            planes = slab.sdf.clone().requires_grad_(True)
            sl = dataclasses.replace(slab, sdf=planes)
            o_w = o_np.to(dev).requires_grad_(True)
            d_w = d_np.to(dev).requires_grad_(True)
            before = dict(kr.SLAB_LAUNCHES)
            if path == "kernels":
                t, normal, _ = kr.ResolveSlab.apply(
                    o_w, d_w, sl.resolve_table, scene, sl, hit, inst)
            else:
                o, d = SlabTracer(sl, None)._object_rays(scene, o_w, d_w)
                t, normal, _ = brick.resolve_slab_hits(sl, o, d, hit)
            ((t * g_t).sum() + (normal * g_n).sum()).backward()
            torch.cuda.synchronize()
            launched = {k: kr.SLAB_LAUNCHES[k] - before[k] for k in before}
            assert launched == ({"forward": 1, "backward": 1}
                                if path == "kernels" else
                                {"forward": 0, "backward": 0}), path
            grads[path] = (planes.grad, o_w.grad, d_w.grad)
        w_o, w_d, w_acc = brick.resolve_slab_backward_reference(
            scene, slab, o_np.to(dev), d_np.to(dev), hit, g_t, g_n,
            acc_dtype=torch.float64)
        if table == "packed":
            planes64 = slab.sdf.double().requires_grad_(True)
            corners64 = brick._pack_slab_corners(planes64)
            corners64.backward(w_acc.reshape(corners64.shape))
            w_acc = planes64.grad
        got_planes, got_o, got_d = grads["kernels"]
        for name, want in (("autograd", grads["autograd"][0]),
                           ("closed form", w_acc)):
            scale = want.abs().max().item()
            assert scale > 0, name
            assert (got_planes.double() - want.double()).abs().max().item() \
                <= 1e-5 * scale, (s, name)
        for name, a, b in (("g_o_w", got_o, w_o), ("g_d_w", got_d, w_d)):
            scale = b.abs().max().item()
            assert scale > 0 and bool(torch.isfinite(a).all()), name
            assert (a - b).abs().max().item() <= 1e-5 * scale, (s, name)
        packed = dataclasses.replace(slab, table="packed")
        for old_design in (False, True):
            old_o, old_d, _ = kr.resolve_slab_backward_cuda(
                scene, packed, o_np.to(dev), d_np.to(dev), hit, inst, g_t,
                g_n, _old_design=old_design)
            assert torch.equal(old_o, got_o) and torch.equal(old_d, got_d)
        owned_lanes += int(owned.sum())
    assert owned_lanes > 100


@pytest.mark.gpu
def test_slab_backward_over_one_slab_equals_the_scene_backward_on_card():
    """The slab variant of the resolve backward over the first design's
    packed table of one slab that holds the whole volume (x origin -2: two
    halo rows a side) against the scene variant (x origin 0, the rows of the
    scene's own f32 table) on the same hits and cotangents, both designs:
    ray gradients bit-equal, the table's rows equal to rounding once
    shifted by the origin, the halo rows untouched."""
    from vrt_torch.dist import brick
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.scenes import config5_scene

    dev = _card()
    vol = _slab_volume()
    slab = dataclasses.replace(brick.shard_volume(vol, 1).local(0, dev),
                               table="packed")
    scene = config5_scene(vol, dev, stub=False)
    corners = scene.volumes.corners
    assert corners.dtype == torch.float32 and slab.march_tables["x0"] == -2
    o_w, d_w, _ = _slab_rays(dev)
    hit, inst, owned, g_t, g_n = _slab_backward_case(dev, slab, scene, o_w,
                                                     d_w, 0)
    assert int(owned.sum()) > 100
    cc = corners.shape[1]
    for old in (False, True):
        s_o, s_d, s_acc = kr.resolve_slab_backward_cuda(
            scene, slab, o_w, d_w, hit, inst, g_t, g_n, _old_design=old)
        c_o, c_d, c_acc = kr.resolve_scene_backward_cuda(
            scene, o_w, d_w, hit, inst, g_t, g_n, _old_design=old)
        torch.cuda.synchronize()
        assert torch.equal(s_o, c_o) and torch.equal(s_d, c_d), old
        s_acc = s_acc.reshape(-1, cc, cc, 8)
        c_acc = c_acc.reshape(cc, cc, cc, -1)[..., :8]
        scale = c_acc.abs().max().item()
        assert scale > 0
        assert (s_acc[2:2 + cc] - c_acc).abs().max().item() <= 1e-6 * scale
        assert not bool(s_acc[:2].any()) and not bool(s_acc[2 + cc:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("old_design", [False, True], ids=["new", "old"])
@pytest.mark.parametrize("wrapper", ["scene", "slab"])
def test_resolve_backward_on_a_side_stream_on_card(wrapper, old_design):
    """The resolve backward launched inside ``torch.cuda.stream`` of a new
    stream, behind a sleep queued on that stream, equals the same launch on
    the default stream: ray gradients bit for bit, the table's gradient
    within 1e-5 * max|sum| (its reductions add in any order).  A launch on
    any other stream than the side stream would run before the sleep and
    the wrapper's zero fill of the accumulator, or fail."""
    from vrt_torch.dist import brick
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.scenes import config5_scene

    dev = _card()
    if wrapper == "scene":
        ts = _with_table(_crowd(5, "chebyshev", None, 2, dev), 8, 0)
        o, d, hit, inst, g_t, g_n = _contended_hits(ts, "neighbours", dev)

        def call():
            return kr.resolve_scene_backward_cuda(
                ts, o, d, hit, inst, g_t, g_n, _old_design=old_design)
    else:
        vol = _slab_volume()
        slab = dataclasses.replace(brick.shard_volume(vol, 1).local(0, dev),
                                   table="packed")
        scene = config5_scene(vol, dev, stub=False)
        o, d, _ = _slab_rays(dev)
        hit, inst, _, g_t, g_n = _slab_backward_case(dev, slab, scene, o, d,
                                                     0)

        def call():
            return kr.resolve_slab_backward_cuda(
                scene, slab, o, d, hit, inst, g_t, g_n,
                _old_design=old_design)
    want = call()
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    assert side.cuda_stream != 0
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        got = call()
    side.synchronize()
    for name, a, b in zip(("g_o_w", "g_d_w"), got[:2], want[:2]):
        assert _bits_equal(a, b), name
    scale = want[2].abs().max().item()
    assert scale > 0
    assert (got[2] - want[2]).abs().max().item() <= 1e-5 * scale


@pytest.mark.gpu
def test_sharded_frame_on_card_equals_render_image():
    """The flagship at resolution 5, 64x36, over 2 data ranks sharing the
    card (gloo): equal to ``render_image`` bit for bit."""
    from vrt_torch.dist import mesh

    dev = _card()
    scene = flagship_scene(5, "chebyshev", torch.bfloat16, device=dev)
    want = render_image(scene, 64, 36, RenderMode()).cpu().numpy()
    out = mesh.spawn_world(_sharded_card_rank, 2, args=(64, 36),
                           timeout=300)
    for img in out:
        assert np.array_equal(img, want)


def _sharded_card_rank(rank, world, width, height):
    """A rank of ``test_sharded_frame_on_card_equals_render_image``:
    ``render_image_sharded`` of the flagship at resolution 5 (chebyshev,
    bf16) over a (world, 1) mesh of ranks sharing the card."""
    from vrt_torch.dist import mesh
    from vrt_torch.dist.sharding import render_image_sharded

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    scene = flagship_scene(5, "chebyshev", torch.bfloat16, device=dev)
    m = mesh.make_render_mesh(world, 1, "cuda")
    return render_image_sharded(scene, width, height, RenderMode(),
                                m).cpu().numpy()
