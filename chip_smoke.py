"""Smoke run of the PyTorch/CUDA port (``vrt_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device  -- needs a CUDA card; prints its name and power limit,
2. build   -- compiles the march K1 (per-lane and scene kernels), the
             gather library (GP-A, GP-B, GP-C), the row gather K3 and the
             fused resolve from ``vrt_torch/csrc/``, one nvcc each, all in
             parallel, and prints ptxas' register and spill lines,
3. kernels -- every kernel against its plain version on the inputs the
             flagship scene (resolution 7, chebyshev, bf16) and config6 give
             it, both timed, with the least time the card could take for the
             same bytes and operations (the bound):
             K1 per lane, reached through ``march_scene(..., lane_marcher=)``:
             480x270 primary and shadow rays, every launch of one 1920x1080
             frame, and of a 480x270 cube frame, overlay frame and config6
             fit step, against the twin;
             the scene march: every launch of one 1080p frame in interp mode,
             in cube mode and with the overlay and of one 1080p config6 fit
             step against ``march_scene_reference`` over the twin (hit, kind,
             t, cell, brackets, face normal, steps, winning instance), the
             any-hit launches against its ``hit``;
             the fused resolve: the three launches of a 1080p frame against
             ``resolve_scene_reference`` with a plain gather (equal, NaN
             equal to NaN);
             K3: every launch of one 1080p frame on the candidate-loop path
             and of one config6 fit step against the plain versions (gathers
             equal, scatters within 1e-5 * max|sum| of a float64
             ``index_add_``), and against the library calls ``src[idx]`` and
             ``index_add_``,
4. frame   -- the 1920x1080 flagship frame three times after a warm-up, in
             interp mode, in cube mode and with the overlay, with the launch
             counts of those frames (per frame 5 scene marches, 3 fused
             resolves, no per-lane K1 launch, no K3 gather); then the frame
             on the candidate-loop path (per-lane K1 launches between eager
             glue, resolve through K3) against the default path in one call,
             in the order old, new, new, old, medians of 5,
5. anchor  -- the 160x90 frame against the image ``vrt`` renders on the CPU
             (``tests/fixtures/flagship_r7_cheb_bf16_160x90.npy``), and the
             160x90 cube-mode unlit frame against its own ``vrt`` fixture,
6. profile -- one 1080p frame under ``torch.profiler``: device busy time,
             the kernels' shares of it, the operators that take the most
             time, and no ``aten::sort`` among them,
7. gather  -- the gather probe (``vrt_torch.apps.probe_gather``): every
             case once through its kernel on every load path, with the
             launches counted, then each output against its plain version
             (equal, or the run fails), both timed, with the library call
             and the bound,
8. fit     -- config6 of ``vrt/apps/bench.py``: the 1920x1080 fit step of
             the flagship at resolution 6 with per-voxel colours, SDF and
             colours optimized by Adam (lr 1e-2) towards zero targets; one
             warm-up step, then three timed, with the launches per step (5
             scene marches, 6 K3 gathers, 6 K3 scatters), peak device memory
             and the losses; the step on the candidate-loop path against the
             default path (old, new, new, old, medians of 3); a profile of
             one step; the card's loss and gradients at 64x36 against
             ``vrt``'s (``tests/fixtures/fit_flagship_r4_colors_64x36.npz``);
             then ``python -m vrt_torch.apps.fit`` at its defaults, whose
             last loss must be under a quarter of its first.

The line before the last is a JSON object with every kernel's launches on
its path, its largest disagreement with its plain version, its time, the
plain version's, the library call's where there is one, and its bound; the
last line is ``{"ok": true, "device": {...}}``.  There is no CPU path.
"""

import contextlib
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "flagship_r7_cheb_bf16_160x90.npy")
CUBE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "flagship_r7_cheb_bf16_cube_unlit_160x90.npy")
FIT_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                           "fit_flagship_r4_colors_64x36.npz")
LANE_BUDGET = 1e-3    # share of lanes whose hit or kind may differ
T_RTOL = 1e-4         # t on lanes where both agree on the hit
FRAME_W, FRAME_H = 1920, 1080
SMALL_W, SMALL_H = 480, 270
# the card's published peaks, for the bounds: device memory bytes/s, and f32
# operations/s outside the tensor cores
HBM_RATE, F32_RATE = 3.35e12, 67e12
# f32 operations of the march, counted from csrc/march.cu: per lane (slab
# entry, entry cell), per node step (node box, exit t, next cell), per
# surface cell (cubic coefficients and the bracketed root), and per instance
# of a scene march (world -> object, slab test)
LANE_FLOPS, STEP_FLOPS, SURFACE_FLOPS, INSTANCE_FLOPS = 60, 32, 380, 90
# the fused resolve, from csrc/resolve.cu: six trilinear samples and the
# normal on a surface lane
RESOLVE_FLOPS = 420
# K3's f32 atomics add in another order on every run: its scatter is held
# to SCATTER_RTOL * max|sum| of an exact (float64) sum
SCATTER_RTOL = 1e-5
# config6's camera (vrt/apps/bench.py bench_fit)
FIT_CAMS = [dict(position=(320.0, 0.0, 40.0), rotation=(0.0, 0.0, 1.0, 0.0),
                 fov=60.0)]
# the card against vrt's CPU fit gradient (fixture): the loss to FIT_LOSS_RTOL,
# each gradient to a cosine of 1 - FIT_COS_TOL and a largest difference of
# FIT_DIFF_TOL * max|g| (atomics and the card's own rounding of the
# shading math move the gradients in their last bits)
FIT_LOSS_RTOL, FIT_COS_TOL, FIT_DIFF_TOL = 1e-5, 1e-8, 1e-4


def _compare(tag, a, b, who="K1 vs twin"):
    """March hits ``a`` of a kernel against hits ``b`` of its plain
    version; returns max |dt| on lanes where both hit with the same kind.
    On lanes where hit and kind agree, the steps, t_in, t_out and face
    normal (NaN equal to NaN) must be equal, and on hit lanes the cell
    too."""
    import torch

    agree = (a.hit == b.hit) & (a.kind == b.kind)
    flips = 1.0 - agree.float().mean().item()
    both = agree & a.hit
    dt = (a.t - b.t)[both].abs()
    rel = (dt / b.t[both].abs().clamp_min(1e-30)).max().item() \
        if both.any() else 0.0
    cells = bool(torch.equal(a.cell[both], b.cell[both]))
    steps = bool(torch.equal(a.steps[agree], b.steps[agree]))
    brackets = bool(torch.equal(a.t_in[agree], b.t_in[agree])
                    and torch.equal(a.t_out[agree], b.t_out[agree]))
    fa, fb = a.face_normal[agree], b.face_normal[agree]
    faces = bool(((fa == fb) | (torch.isnan(fa) & torch.isnan(fb))).all())
    err = dt.max().item() if both.any() else 0.0
    print(f"{who} [{tag}]: lanes={a.hit.numel()} hits={int(a.hit.sum())}"
          f" hit/kind flips={flips:.2e} max|dt|={err:.3e} max rel dt={rel:.3e}"
          f" cells equal={cells} steps equal={steps} (sum "
          f"{int(b.steps.sum())}) t_in/t_out equal={brackets} face normals "
          f"equal={faces}", flush=True)
    if flips > LANE_BUDGET:
        raise AssertionError(f"{tag}: {flips:.2e} of lanes flip hit/kind")
    if rel > T_RTOL:
        raise AssertionError(f"{tag}: t differs by rel {rel:.3e}")
    if not cells:
        raise AssertionError(f"{tag}: hit cells differ")
    if not steps:
        raise AssertionError(f"{tag}: step counts differ")
    if not brackets:
        raise AssertionError(f"{tag}: t_in or t_out differ")
    if not faces:
        raise AssertionError(f"{tag}: face normals differ")
    return err


@contextlib.contextmanager
def _recording(module, name):
    """Keep every call of ``module.name`` as (args, kwargs, result)."""
    calls = []
    fn = getattr(module, name)

    def recorder(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _candidate_loop_path():
    """The renderer on its candidate-loop path: ``march_scene`` with
    ``lane_marcher=march_lanes`` (one per-lane K1 launch per candidate
    instance between eager transforms, a stable sort and per-pass gathers),
    shadow traces reading ``hit`` off a full trace, and resolve in plain
    PyTorch over K3's gather."""
    from vrt_torch.march.march import march_lanes
    from vrt_torch.render import renderer as tren

    saved = (tren.march_scene, tren.march_scene_any_hit, tren.resolve_scene)

    def scene_march(scene, o_w, d_w, t_max, interp=True, debug_overlay=False,
                    lane_marcher=None):
        return saved[0](scene, o_w, d_w, t_max, interp, debug_overlay,
                        lane_marcher=lane_marcher or march_lanes)

    def any_hit(scene, o_w, d_w, t_max, interp=True):
        return scene_march(scene, o_w, d_w, t_max, interp)[0].hit

    tren.march_scene, tren.march_scene_any_hit = scene_march, any_hit
    tren.resolve_scene = tren.resolve_scene_reference
    try:
        yield
    finally:
        (tren.march_scene, tren.march_scene_any_hit,
         tren.resolve_scene) = saved


@contextlib.contextmanager
def _plain_gather():
    """Resolve's row gather as plain ``table[idx]`` on any device."""
    from vrt_torch.kernels import rows as k3
    from vrt_torch.march import isosurface as iso

    saved = iso.gather_rows
    iso.gather_rows = k3.gather_rows_reference
    try:
        yield
    finally:
        iso.gather_rows = saved


def _bound(nbytes, flops):
    """The least time in ms the card could take: the larger of the bytes
    over its memory rate and the f32 operations over its peak rate."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_RATE, 1e3 * flops / F32_RATE
    return dict(bound_ms=max(by_bytes, by_ops), bytes=int(nbytes),
                flops=int(flops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _march_bound(vols, hit, interp, in_bytes, out_bytes, instances=0):
    """The bound of one march launch from its plain version's result
    ``hit``: per ray ``in_bytes`` read and ``out_bytes`` written, and of the
    tables what these rays need at least: one accel byte per node step and,
    in interp mode, one corner row per surface or solid-entry hit (rows of
    surface cells crossed without a root are not counted), in cube mode one
    density per step; no table counted beyond its size."""
    rays = hit.hit.numel()
    steps = int(hit.steps.sum())
    corners = vols.corners
    rows = int(((hit.kind == 1) | (hit.kind == 2)).sum())
    table = min(steps, vols.accel_u8.numel())
    if interp:
        table += min(rows * corners.shape[-1] * corners.element_size(),
                     corners.numel() * corners.element_size())
    else:
        table += min(4 * steps, 4 * vols.sdf.numel())
    flops = (rays * (LANE_FLOPS + instances * INSTANCE_FLOPS)
             + steps * STEP_FLOPS + rows * SURFACE_FLOPS)
    return _bound(rays * (in_bytes + out_bytes) + table, flops)


def _sum_bounds(bounds):
    """Bounds of several launches as one: times and counts summed, bounded
    by what bounds most of the time."""
    by = {}
    for b in bounds:
        by[b["bound_by"]] = by.get(b["bound_by"], 0.0) + b["bound_ms"]
    return dict(bound_ms=sum(b["bound_ms"] for b in bounds),
                bytes=sum(b["bytes"] for b in bounds),
                flops=sum(b["flops"] for b in bounds),
                bound_by=max(by, key=by.get) if by else "bytes")


def _k1_passes(run, expected, tag):
    """Every per-lane K1 launch of ``run()`` (a frame or a fit step on the
    candidate-loop path), kept with its inputs and the output ``run`` used,
    then held against the twin on the same inputs; both timed.  Fails
    unless K1 launched ``expected`` times.  Returns dict(max_abs_err, ms,
    plain_ms (lists, per launch), bound)."""
    import torch

    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.march import march_lanes_reference

    with _recording(k1, "march_lanes_cuda") as passes, \
            _candidate_loop_path():
        run()
    torch.cuda.synchronize()
    if len(passes) != expected:
        raise AssertionError(f"the {tag} launched K1 {len(passes)} times, "
                             f"expected {expected}")
    err, k1_ms, tw_ms, bounds = 0.0, [], [], []
    for i, (args, _, h_k1) in enumerate(passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            start.record()
            h_tw = march_lanes_reference(*args)
            end.record()
        end.synchronize()
        tw_ms.append(start.elapsed_time(end))
        err = max(err, _compare(f"{tag} pass {i}", h_k1, h_tw))
        k1_ms.append(device_ms(lambda: k1.march_lanes_cuda(*args), 20))
        bounds.append(_march_bound(args[0], h_tw, args[5], 32, 45))
        del h_tw
    return dict(max_abs_err=err, ms=k1_ms, plain_ms=tw_ms,
                bound=_sum_bounds(bounds))


def _scene_calls(run, expected, tag):
    """Every scene-march launch of ``run()`` (a frame or a fit step), kept
    with its inputs and the output ``run`` used, then held against its
    plain version, ``march_scene_reference`` over the twin, on the same
    inputs: a full trace field by field as ``_compare`` does, with the
    winning instance; an any-hit trace against the plain version's ``hit``.
    Both timed.  Fails unless the scene march launched ``expected`` times.
    Returns dict(max_abs_err, ms, plain_ms (lists, per launch), bound)."""
    import torch

    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.march import march_lanes_reference
    from vrt_torch.render.renderer import march_scene_reference

    with _recording(k1, "march_scene_cuda") as calls:
        run()
    torch.cuda.synchronize()
    if len(calls) != expected:
        raise AssertionError(f"the {tag} launched the scene march "
                             f"{len(calls)} times, expected {expected}")
    err, ms, plain_ms, bounds = 0.0, [], [], []
    for i, (args, kwargs, got) in enumerate(calls):
        scene, o_w, d_w, t_max, interp = args[:5]
        overlay = args[5] if len(args) > 5 else False
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want, want_inst = march_scene_reference(
            scene, o_w, d_w, t_max, interp, overlay,
            lane_marcher=march_lanes_reference)
        end.record()
        end.synchronize()
        plain_ms.append(start.elapsed_time(end))
        if kwargs.get("any_hit"):
            flips = (got != want.hit).float().mean().item()
            print(f"scene march vs plain [{tag} trace {i}, any-hit]: rays="
                  f"{got.numel()} blocked={int(got.sum())} flips={flips:.2e}",
                  flush=True)
            if got.dtype != torch.bool or flips > LANE_BUDGET:
                raise AssertionError(f"{tag} trace {i}: the any-hit march "
                                     f"differs on {flips:.2e} of rays")
            out_bytes = 1
        else:
            hit, inst = got
            err = max(err, _compare(f"{tag} trace {i}", hit, want,
                                    who="scene march vs plain"))
            agree = (hit.hit == want.hit) & (hit.kind == want.kind)
            if not torch.equal(inst[agree], want_inst[agree]):
                raise AssertionError(f"{tag} trace {i}: winning instances "
                                     f"differ")
            out_bytes = 49
        ms.append(device_ms(
            lambda: k1.march_scene_cuda(*args, **kwargs), 20))
        bounds.append(_march_bound(scene.volumes, want, interp, 28,
                                   out_bytes, scene.num_instances))
        del want, want_inst
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound=_sum_bounds(bounds))


def _resolve_bound(scene, hit, inst):
    """The fused resolve's bound, from what these hits need: per ray kind
    and t read (8 B) and t, normal, unlit written (17 B); the face normal
    (12 B) where it is passed through (every kind but surface and debug);
    the ray and its instance (28 B) on surface and solid-entry hits; the
    cell (12 B) on surface hits, and each distinct corner row that their
    six neighbours name, once."""
    import torch

    from vrt_torch.march.resolve import _OFFS7

    vols = scene.volumes
    rays = hit.kind.numel()
    surf = hit.kind == 1
    n_surf = int(surf.sum())
    n_solid = int((hit.kind == 2).sum())
    n_debug = int((hit.kind == 5).sum())
    vol = scene.inst_volume[inst[surf].clamp_min(0).long()].long()
    cells = hit.cell[surf][:, None, :].long() + torch.as_tensor(
        _OFFS7[1:], device=surf.device).long()
    n = vols.n[vol].long()[:, None, None]
    valid = ((cells >= 0) & (cells + 1 < n)).all(-1)
    cc = vols.corners.shape[1]
    flat = ((vol[:, None] * cc + cells[..., 0]) * cc + cells[..., 1]) * cc \
        + cells[..., 2]
    rows = int(torch.unique(flat[valid]).numel())
    row_bytes = vols.corners.shape[-1] * vols.corners.element_size()
    nbytes = (rays * (8 + 17) + (rays - n_surf - n_debug) * 12
              + (n_surf + n_solid) * 28 + n_surf * 12 + rows * row_bytes)
    return _bound(nbytes, n_surf * RESOLVE_FLOPS)


def _resolve_calls(run, expected, tag):
    """Every fused-resolve launch of ``run()``, kept with its inputs and
    the output ``run`` used, then held against its plain version
    (``resolve_scene_reference`` with a plain gather, no graph) on the same
    inputs: unlit equal, t and the normal equal with NaN equal to NaN.  Both
    timed, and the plain version over K3's gather (resolve as the
    candidate-loop path runs it).  Returns dict(launches, max_abs_err, ms,
    plain_ms, over_k3_ms, bound)."""
    import torch

    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.render.renderer import resolve_scene_reference

    with _recording(kr, "resolve_scene_cuda") as calls:
        run()
    torch.cuda.synchronize()
    if len(calls) != expected:
        raise AssertionError(f"the {tag} launched the fused resolve "
                             f"{len(calls)} times, expected {expected}")

    def plain(*args):
        with _plain_gather(), torch.no_grad():
            return resolve_scene_reference(*args)

    def over_k3(*args):
        with torch.no_grad():
            return resolve_scene_reference(*args)

    ms, plain_ms, k3_ms, bounds = [], [], [], []
    for i, (args, _, got) in enumerate(calls):
        want = plain(*args)
        for name, a, b in zip(("t", "normal", "unlit"), got, want):
            same = (a == b) | ((a != a) & (b != b))
            if a.dtype != b.dtype or a.shape != b.shape or \
                    not bool(same.all()):
                worst = (a.float() - b.float())[~same].abs().max().item()
                raise AssertionError(
                    f"{tag} resolve {i}: {name} differs from the plain "
                    f"version on {int((~same).sum())} rays, by at most "
                    f"{worst:.3e}")
        del want
        ms.append(device_ms(lambda: kr.resolve_scene_cuda(*args), 20))
        plain_ms.append(device_ms(lambda: plain(*args), 3))
        k3_ms.append(device_ms(lambda: over_k3(*args), 3))
        bounds.append(_resolve_bound(args[0], args[3], args[4]))
        kinds = torch.bincount(args[3].kind, minlength=6).tolist()
        print(f"fused resolve vs plain [{tag} {i}]: rays "
              f"{args[1].shape[0]} kinds {kinds} equal; kernel "
              f"{ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f} ms, plain over "
              f"K3's gather {k3_ms[-1]:.4f} ms, bound "
              f"{bounds[-1]['bound_ms']:.4f} ms ({bounds[-1]['bytes']} B)",
              flush=True)
    return dict(launches=len(calls), max_abs_err=0.0, ms=sum(ms),
                plain_ms=sum(plain_ms), over_k3_ms=sum(k3_ms),
                bound=_sum_bounds(bounds))


def _k3_calls(run, tag):
    """Every K3 launch of ``run()``, kept with its inputs and the output
    ``run`` used, then held against the plain version on the same inputs:
    each gather equal to ``gather_rows_reference``, each scatter within
    ``SCATTER_RTOL * max|sum|`` of ``scatter_rows_reference`` in float64;
    kernel, plain version (f32) and library call (``table[idx]`` with its
    cast, ``index_add_``; int64 indices made beforehand) timed.  Returns
    {"gather" | "scatter": dict(launches, max_abs_err, ms, plain_ms,
    library_ms, bound)}, the times summed over the launches."""
    import torch

    from vrt_torch.kernels import rows as k3
    from vrt_torch.kernels._timing import device_ms

    calls = {"gather": [], "scatter": []}
    gather, scatter = k3.gather_rows_cuda, k3.scatter_rows_cuda

    def rec_gather(table, idx, out_ch):
        out = gather(table, idx, out_ch)
        calls["gather"].append(((table.detach(), idx, out_ch), out))
        return out

    def rec_scatter(grad, idx, rows, ch):
        out = scatter(grad, idx, rows, ch)
        calls["scatter"].append(((grad.clone(), idx, rows, ch), out))
        return out

    k3.gather_rows_cuda, k3.scatter_rows_cuda = rec_gather, rec_scatter
    try:
        run()
    finally:
        k3.gather_rows_cuda, k3.scatter_rows_cuda = gather, scatter
    torch.cuda.synchronize()
    out = {}
    for op, launch, plain in (
            ("gather", gather, k3.gather_rows_reference),
            ("scatter", scatter, k3.scatter_rows_reference)):
        err, ms, plain_ms, lib_ms, bounds = 0.0, [], [], [], []
        for i, (args, got) in enumerate(calls[op]):
            idx = args[1]
            idx64 = idx.clamp_min(0).long()
            touched = int(torch.unique(idx[idx >= 0]).numel())
            if op == "gather":
                table, _, out_ch = args
                want = plain(*args)
                if not torch.equal(got, want):
                    raise AssertionError(f"{tag}: K3 gather {i} differs from "
                                         f"its plain version")
                path = k3.load_path(table, out_ch)
                shape = f"{tuple(table.shape)} {table.dtype} {path}"
                library = lambda: table[idx64, :out_ch].float()  # noqa: E731
                nbytes = (idx.numel() * (4 + 4 * out_ch)
                          + touched * out_ch * table.element_size())
            else:
                grad, _, rows, ch = args
                want = plain(*args, dtype=torch.float64)
                scale = want.abs().max().item()
                e = (got.double() - want).abs().max().item()
                if not e <= SCATTER_RTOL * scale:
                    raise AssertionError(f"{tag}: K3 scatter {i} off by "
                                         f"{e:.3e} > {SCATTER_RTOL} * "
                                         f"{scale:.3e}")
                err = max(err, e)
                shape = f"{tuple(grad.shape)} -> ({rows}, {ch})"
                # times the call only: it adds masked lanes into row 0
                acc = torch.zeros((rows, grad.shape[1]), device=grad.device)
                library = lambda: acc.index_add_(0, idx64, grad)  # noqa: E731
                nbytes = idx.numel() * 4 + grad.numel() * 4 + rows * ch * 4
            del want
            ms.append(device_ms(lambda: launch(*args), 10))
            plain_ms.append(device_ms(lambda: plain(*args), 10))
            lib_ms.append(device_ms(library, 10))
            bounds.append(_bound(nbytes, 0))
            print(f"K3 {op} [{tag} {i}]: lanes {idx.numel()} "
                  f"{shape}: kernel {ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f}"
                  f" ms, library {lib_ms[-1]:.4f} ms, bound "
                  f"{bounds[-1]['bound_ms']:.4f} ms ({nbytes} B, {touched} "
                  f"rows touched)", flush=True)
        out[op] = dict(launches=len(calls[op]), max_abs_err=err,
                       ms=sum(ms), plain_ms=sum(plain_ms),
                       library_ms=sum(lib_ms), bound=_sum_bounds(bounds))
    return out


def _reset(counts):
    for name in counts:
        counts[name] = 0


def _traces(scene):
    """``march_scene`` calls one frame makes: one radiance trace per level
    of the inline recursion, and one shadow trace per light at the levels
    whose shadows are traced."""
    from vrt_torch.render.renderer import MAX_RAY_RECURSION_DEPTH as cap

    levels = cap if scene.any_reflective else 1
    lights = 1 + scene.num_point + scene.num_spot
    shadowed = sum(1 for depth in range(levels) if depth + 1 < cap)
    return levels + shadowed * lights


def _resolves(scene):
    """Resolves one frame makes: one per radiance level."""
    from vrt_torch.render.renderer import MAX_RAY_RECURSION_DEPTH as cap

    return cap if scene.any_reflective else 1


def _expected_k3(scene):
    """K3 gathers a fit step (or a frame on the candidate-loop path)
    makes: one resolve per radiance level, and one colour sample per lit
    level with per-voxel colours."""
    return _resolves(scene) * (2 if scene.use_voxel_colors else 1)


def _expected_passes(scene):
    """Per-lane K1 launches of a frame on the candidate-loop path: one per
    instance for every ``march_scene`` call."""
    return scene.num_instances * _traces(scene)


def _config6(dev, w=FRAME_W, h=FRAME_H):
    """config6 (``vrt/apps/bench.py``: ``bench_fit(6, ..., 1920, 1080)``):
    the flagship at resolution 6 with per-voxel colours 0.5, one camera,
    zero targets, Adam at 1e-2 on the SDF and the colours, at ``w`` x
    ``h``.  Returns (scene, step, params, opt_state, targets)."""
    import torch

    from vrt_torch.diff.fit import make_fit_step
    from vrt_torch.diff.optim import adam
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    scene = flagship_scene(6, use_colors=True, device=dev)
    params = {"sdf": scene.volumes.sdf, "voxel_colors": scene.voxel_colors}
    opt = adam(1e-2)
    step = make_fit_step(scene, FIT_CAMS, w, h, RenderMode(), opt)
    targets = torch.zeros((len(FIT_CAMS), w * h, 3), device=dev)
    return scene, step, params, opt.init(params), targets


def _profile(render, sync, frame_ms, top=8, what="one 1080p frame"):
    """Device time of one ``render()`` by kernel and by the torch operator
    that launched it, from torch.profiler.  Returns the operators that
    took device time, or None where the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        sync()
        render()
        sync()
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0.0:
        print("profile: torch.profiler saw no device time (not measured)",
              flush=True)
        return None

    def share(*names):
        ms = sum(r[0] for r in rows if any(n in r[2] for n in names))
        return f"{ms:.1f} ms = {100 * ms / busy:.0f}% of busy"

    print(f"profile of {what}: device busy {busy:.1f} ms = "
          f"{100 * busy / frame_ms:.0f}% of its {frame_ms:.1f} ms; "
          f"K1 {share('march_kernel', 'march_scene_kernel')}; "
          f"K3 {share('rows_kernel')}; "
          f"fused resolve {share('resolve_kernel')}; "
          f"{sum(r[1] for r in rows)} device ops", flush=True)
    for ms, count, key in rows[:top]:
        print(f"  kernel {ms:8.2f} ms {count:5d}x {key[:80]}", flush=True)
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key,
                   str(e.input_shapes)[:60])
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), reverse=True)
    for ms, count, key, shapes in ops[:top]:
        print(f"  op {ms:8.2f} ms {count:5d}x {key} {shapes}", flush=True)
    return {op[2] for op in ops}


def _list(ms):
    return ", ".join(f"{t:.4f}" for t in ms)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from vrt_torch.apps import probe_gather as probe
    from vrt_torch.kernels import gather as gk
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import rows as k3
    from vrt_torch.march.march import march_lanes, march_lanes_reference
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import (DIR_SHADOW_TMAX, RADIANCE_TMAX,
                                           march_scene, march_scene_any_hit,
                                           render_image, resolve_scene)
    from vrt_torch.scenes import flagship_scene

    # ---- 1. device ---------------------------------------------------------
    card = probe.card()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build: one nvcc per source, all started together ---------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        logs = {"K1 (march.cu)": pool.submit(k1.build),
                "gather (gather.cu)": pool.submit(gk.build),
                "K3 (rows.cu)": pool.submit(k3.build),
                "fused resolve (resolve.cu)": pool.submit(kr.build)}
        logs = {name: f.result() for name, f in logs.items()}
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {name}: {line}", flush=True)

    # ---- 3. every kernel against its plain version --------------------------
    t0 = time.perf_counter()
    scene = flagship_scene(7, "chebyshev", torch.bfloat16, device=dev)
    corners = scene.volumes.corners
    print(f"scene build: {time.perf_counter() - t0:.1f}s, corners "
          f"{tuple(corners.shape)} {corners.dtype}", flush=True)
    mode = RenderMode()
    cube = RenderMode(interp=False)
    overlay = RenderMode(debug_overlay=True)

    def rays(w, h):
        return camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, w, h)

    # 480x270 primary and shadow rays: per-lane K1 (the candidate loop) and
    # the scene march, both against the candidate loop over the twin
    o, d = rays(SMALL_W, SMALL_H)
    t_max = torch.full((o.shape[0],), RADIANCE_TMAX, device=dev)
    h_tw, i_tw = march_scene(scene, o, d, t_max,
                             lane_marcher=march_lanes_reference)
    h_k1, _ = march_scene(scene, o, d, t_max, lane_marcher=march_lanes)
    h_sc, inst = march_scene(scene, o, d, t_max)
    sync()
    err = _compare("primary 480x270", h_k1, h_tw)
    scene_err = _compare("primary 480x270", h_sc, h_tw,
                         who="scene march vs plain")
    if not torch.equal(inst, i_tw):
        raise AssertionError("primary 480x270: winning instances differ")
    t, _, _ = resolve_scene(scene, o, d, h_sc, inst)
    so = o + torch.where(h_sc.hit, t, 0.0)[:, None] * d - d * 0.1
    sd = scene.dir_light_dir.expand(so.shape).contiguous()
    s_max = torch.where(h_sc.hit, DIR_SHADOW_TMAX, -float("inf"))
    s_tw, _ = march_scene(scene, so, sd, s_max,
                          lane_marcher=march_lanes_reference)
    s_k1, _ = march_scene(scene, so, sd, s_max, lane_marcher=march_lanes)
    s_sc, _ = march_scene(scene, so, sd, s_max)
    s_any = march_scene_any_hit(scene, so, sd, s_max)
    sync()
    err = max(err, _compare("dir shadow 480x270", s_k1, s_tw))
    scene_err = max(scene_err, _compare("dir shadow 480x270", s_sc, s_tw,
                                        who="scene march vs plain"))
    if not torch.equal(s_any, s_tw.hit):
        raise AssertionError("dir shadow 480x270: the any-hit march differs "
                             "from the plain version's hit")
    del o, d, t_max, so, sd, s_max

    def frame(m, w=FRAME_W, h=FRAME_H):
        return lambda: render_image(scene, w, h, m)

    # per-lane K1: every launch of a 1080p frame on the candidate-loop path,
    # and of a 480x270 cube frame, overlay frame and config6 fit step
    k1_frame = _k1_passes(frame(mode), _expected_passes(scene), "1080p frame")
    err = max(err, k1_frame["max_abs_err"])
    prim = scene.num_instances
    print(f"K1 device time per pass of the 1080p frame on {card}: "
          f"{_list(k1_frame['ms'])} ms = {sum(k1_frame['ms']):.4f} ms per "
          f"frame, the {prim} primary passes "
          f"{sum(k1_frame['ms'][:prim]):.4f} ms; twin on the same lanes "
          f"{', '.join(f'{t:.2f}' for t in k1_frame['plain_ms'])} ms = "
          f"{sum(k1_frame['plain_ms']):.2f} ms; bound "
          f"{k1_frame['bound']['bound_ms']:.4f} ms "
          f"({k1_frame['bound']['bytes']} B, by "
          f"{k1_frame['bound']['bound_by']})", flush=True)
    k1_small = {}
    for tag, m in (("cube", cube), ("overlay", overlay)):
        got = _k1_passes(frame(m, SMALL_W, SMALL_H), _expected_passes(scene),
                         f"480x270 {tag} frame")
        err = max(err, got["max_abs_err"])
        k1_small[tag] = got
    small_fit = _config6(dev, SMALL_W, SMALL_H)
    got = _k1_passes(lambda: small_fit[1](*small_fit[2:]),
                     _expected_passes(small_fit[0]),
                     "480x270 config6 fit step")
    err = max(err, got["max_abs_err"])
    k1_small["fit"] = got
    del small_fit
    for tag, got in k1_small.items():
        print(f"K1 device time over the passes of the 480x270 {tag} path on "
              f"{card}: {sum(got['ms']):.4f} ms; twin "
              f"{sum(got['plain_ms']):.2f} ms", flush=True)

    # the scene march: every launch of the three 1080p frames and of one
    # 1080p config6 fit step
    scene_runs = {}
    for tag, m in (("interp", mode), ("cube", cube), ("overlay", overlay)):
        got = _scene_calls(frame(m), _traces(scene), f"1080p {tag} frame")
        scene_err = max(scene_err, got["max_abs_err"])
        scene_runs[tag] = got
    fit = _config6(dev)
    got = _scene_calls(lambda: fit[1](*fit[2:]), _traces(fit[0]),
                       "config6 fit step")
    scene_err = max(scene_err, got["max_abs_err"])
    scene_runs["fit"] = got
    for tag, got in scene_runs.items():
        print(f"scene march device time per launch of the 1080p {tag} path "
              f"on {card}: {_list(got['ms'])} ms = {sum(got['ms']):.4f} ms; "
              f"plain {', '.join(f'{t:.2f}' for t in got['plain_ms'])} ms = "
              f"{sum(got['plain_ms']):.2f} ms; bound "
              f"{got['bound']['bound_ms']:.4f} ms ({got['bound']['bytes']} "
              f"B, by {got['bound']['bound_by']})", flush=True)

    # the fused resolve: the three launches of a 1080p frame
    fused = _resolve_calls(frame(mode), _resolves(scene), "1080p frame")

    # K3: every launch of one 1080p frame on the candidate-loop path and of
    # one config6 fit step
    def old_frame():
        with _candidate_loop_path():
            render_image(scene, FRAME_W, FRAME_H, mode)

    k3_frame = _k3_calls(old_frame, "1080p frame, candidate-loop path")
    if k3_frame["gather"]["launches"] != _expected_k3(scene):
        raise AssertionError(f"the 1080p frame launched K3 "
                             f"{k3_frame['gather']['launches']} times, "
                             f"expected {_expected_k3(scene)}")
    k3_fit = _k3_calls(lambda: fit[1](*fit[2:]), "config6 fit step")
    for op in ("gather", "scatter"):
        if k3_fit[op]["launches"] != _expected_k3(fit[0]):
            raise AssertionError(f"the config6 fit step launched K3 {op} "
                                 f"{k3_fit[op]['launches']} times, "
                                 f"expected {_expected_k3(fit[0])}")
    del fit
    print(f"K3 device time on {card}: 1080p frame gathers "
          f"{k3_frame['gather']['ms']:.4f} ms (plain "
          f"{k3_frame['gather']['plain_ms']:.4f}, library "
          f"{k3_frame['gather']['library_ms']:.4f}, bound "
          f"{k3_frame['gather']['bound']['bound_ms']:.4f} ms); config6 fit "
          f"step gathers {k3_fit['gather']['ms']:.4f} ms (plain "
          f"{k3_fit['gather']['plain_ms']:.4f}, library "
          f"{k3_fit['gather']['library_ms']:.4f}, bound "
          f"{k3_fit['gather']['bound']['bound_ms']:.4f} ms), scatters "
          f"{k3_fit['scatter']['ms']:.4f} ms (plain "
          f"{k3_fit['scatter']['plain_ms']:.4f}, library "
          f"{k3_fit['scatter']['library_ms']:.4f}, bound "
          f"{k3_fit['scatter']['bound']['bound_ms']:.4f} ms), max scatter "
          f"error {k3_fit['scatter']['max_abs_err']:.3e}", flush=True)

    # ---- 4. the frames -----------------------------------------------------
    def zero_counts():
        k1.LAUNCHES = k1.SCENE_LAUNCHES = kr.LAUNCHES = 0
        _reset(k3.LAUNCHES)

    def counts():
        return dict(k1=k1.LAUNCHES, scene=k1.SCENE_LAUNCHES,
                    resolve=kr.LAUNCHES, gather=k3.LAUNCHES["K3 gather"],
                    scatter=k3.LAUNCHES["K3 scatter"])

    def timed(run, n):
        run()                                              # warm-up
        runs = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            out = run()
            sync()
            runs.append(time.perf_counter() - t0)
        return runs, out

    def frames(m, tag):
        render_image(scene, FRAME_W, FRAME_H, m)           # warm-up
        sync()
        zero_counts()
        runs = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            img = render_image(scene, FRAME_W, FRAME_H, m)
            sync()
            runs.append(time.perf_counter() - t0)
        got = counts()
        want = dict(k1=0, scene=3 * _traces(scene),
                    resolve=3 * _resolves(scene), gather=0, scatter=0)
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"1080p {tag} frame has non-finite pixels")
        if tuple(img.shape) != (FRAME_H, FRAME_W, 4):
            raise AssertionError(f"{tag} frame shape {tuple(img.shape)}")
        if got != want:
            raise AssertionError(f"launches in 3 {tag} frames {got}, "
                                 f"expected {want}")
        median = statistics.median(runs)
        print(f"1080p {tag} frame on {card}: median {median * 1e3:.1f} ms "
              f"(runs {', '.join(f'{f * 1e3:.1f}' for f in runs)} ms), "
              f"{FRAME_W * FRAME_H / median:.0f} rays/s; launches in 3 "
              f"frames: scene march {got['scene']}, fused resolve "
              f"{got['resolve']}, per-lane K1 {got['k1']}, K3 gathers "
              f"{got['gather']}", flush=True)
        return median, got

    frame_s, frame_counts = frames(mode, "interp")
    _, cube_counts = frames(cube, "cube")
    _, overlay_counts = frames(overlay, "overlay")

    # the candidate-loop path against the default path, in one call
    def old(run):
        def go():
            with _candidate_loop_path():
                return run()
        return go

    zero_counts()
    paired = {}
    for tag, m in (("interp", mode), ("cube", cube)):
        meds = []
        for run in (old(frame(m)), frame(m), frame(m), old(frame(m))):
            meds.append(statistics.median(timed(run, 5)[0]) * 1e3)
        paired[tag] = meds
        print(f"1080p {tag} frame on {card}, candidate-loop path against "
              f"the scene march and fused resolve, medians of 5 in the order "
              f"old, new, new, old: {', '.join(f'{t:.2f}' for t in meds)} ms",
              flush=True)
    old_counts = counts()
    if old_counts["k1"] != 2 * 2 * 6 * _expected_passes(scene) or \
            old_counts["gather"] != 2 * 2 * 6 * _expected_k3(scene):
        raise AssertionError(f"launches of the paired frames {old_counts}")

    # ---- 5. anchored to the JAX reference ----------------------------------
    want = np.load(FIXTURE)
    got = render_image(scene, 160, 90, mode)[..., :3].cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("160x90 frame has non-finite pixels")
    diff = np.abs(got - want)
    q90 = float(np.quantile(diff, 0.90))
    mean = float(diff.mean())
    outl = float((diff.max(axis=-1) > 0.1).mean())
    print(f"160x90 vs vrt fixture: q90 {q90:.2e} (< 0.015), mean {mean:.2e}"
          f" (< 0.01), pixels off > 0.1 {outl:.2e} (< 0.03)", flush=True)
    if not (q90 < 0.015 and mean < 0.01 and outl < 0.03):
        raise AssertionError("160x90 frame disagrees with the vrt fixture")
    want = np.load(CUBE_FIXTURE)
    got = render_image(scene, 160, 90, RenderMode(interp=False, lit=False))
    got = got[..., :3].cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("160x90 cube frame has non-finite pixels")
    diff = np.abs(got - want)
    q98 = float(np.quantile(diff, 0.98))
    mean = float(diff.mean())
    outl = float((diff.max(axis=-1) > 0.05).mean())
    print(f"160x90 cube unlit vs vrt fixture: q98 {q98:.2e} (< 6e-3), mean "
          f"{mean:.2e} (< 2.5e-3), pixels off > 0.05 {outl:.2e} (< 0.005)",
          flush=True)
    if not (q98 < 6e-3 and mean < 2.5e-3 and outl < 0.005):
        raise AssertionError("160x90 cube frame disagrees with the vrt "
                             "fixture")

    # ---- 6. where the time goes ---------------------------------------------
    ops = _profile(frame(mode), sync, frame_s * 1e3)
    if ops is not None and "aten::sort" in ops:
        raise AssertionError("the 1080p frame still sorts on the device")
    del scene

    # ---- 7. the gather probe ------------------------------------------------
    t0 = time.perf_counter()
    cases = [(c, probe.to_device(c, dev)) for c in probe.CASES]
    sync()
    print(f"gather probe data: {len(cases)} cases, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    _reset(gk.LAUNCHES)
    outs = [probe.launch_all(c, gathers) for c, gathers in cases]
    sync()
    gp_launches = dict(gk.LAUNCHES)
    for name, n in gp_launches.items():
        if n == 0:
            raise AssertionError(f"the gather probe never launched {name}")
    results = []
    for (c, gathers), out in zip(cases, outs):
        results += probe.check_and_time(
            c, gathers, out, log=lambda s: print(s, flush=True))
    del cases, outs
    print(f"gather probe on {card}: {len(results)} case-paths, every kernel "
          f"equal to its plain version; launches {gp_launches}", flush=True)

    # ---- 8. the fit: config6 ----------------------------------------------
    fit_scene, step, params, state, targets = _config6(dev)
    start = {k: v.clone() for k, v in params.items()}
    params, state, loss = step(params, state, targets)         # warm-up
    sync()
    losses = [float(loss)]
    del loss
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    runs = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, targets)
        sync()
        runs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    fit_counts = counts()
    step_s = statistics.median(runs)
    n_rays = len(FIT_CAMS) * FRAME_W * FRAME_H
    print(f"config6 fit step 1920x1080 on {card}: median "
          f"{step_s * 1e3:.1f} ms/step (runs "
          f"{', '.join(f'{r * 1e3:.1f}' for r in runs)} ms), "
          f"{n_rays / step_s:.0f} rays/s forward+backward; peak "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; losses "
          f"{', '.join(f'{v:.6f}' for v in losses)} (warm-up first); per "
          f"step scene march {fit_counts['scene'] / 3:g}, K3 gathers "
          f"{fit_counts['gather'] / 3:g}, K3 scatters "
          f"{fit_counts['scatter'] / 3:g}, per-lane K1 "
          f"{fit_counts['k1'] / 3:g}, fused resolve "
          f"{fit_counts['resolve'] / 3:g}", flush=True)
    want = dict(k1=0, scene=3 * _traces(fit_scene), resolve=0,
                gather=3 * _expected_k3(fit_scene),
                scatter=3 * _expected_k3(fit_scene))
    if fit_counts != want:
        raise AssertionError(f"launches in 3 fit steps {fit_counts}, "
                             f"expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite fit losses {losses}")
    for k, v in params.items():
        moved = (v != start[k]).float().mean().item()
        print(f"  {k}: {moved:.4%} of entries moved", flush=True)
        if moved == 0.0:
            raise AssertionError(f"the fit did not move {k}")
    del start

    # the step on the candidate-loop path against the default path; every
    # run starts from the same parameters and optimizer state
    def one_step():
        return step(params, state, targets)[2]

    meds = []
    for run in (old(one_step), one_step, one_step, old(one_step)):
        meds.append(statistics.median(timed(run, 3)[0]) * 1e3)
    print(f"config6 fit step on {card}, candidate-loop path against the "
          f"scene march, medians of 3 in the order old, new, new, old: "
          f"{', '.join(f'{t:.2f}' for t in meds)} ms", flush=True)
    paired["fit"] = meds
    _profile(lambda: step(params, state, targets), sync, step_s * 1e3,
             what="one config6 fit step")
    del fit_scene, step, params, state, targets

    # the card's fit loss and gradients against vrt's (CPU) on the fixture
    from vrt_torch.diff.fit import (_value_and_grad, graft_and_rebuild,
                                    render_views)
    small = flagship_scene(4, use_colors=True, device=dev)
    fixture = np.load(FIT_FIXTURE)

    def small_loss(p):
        s = graft_and_rebuild(small, p)
        return torch.mean((render_views(s, FIT_CAMS, 64, 36, RenderMode())
                           - 0.25) ** 2)

    got_loss, grads = _value_and_grad(
        small_loss, {"sdf": small.volumes.sdf,
                     "voxel_colors": small.voxel_colors})
    want_loss = float(fixture["loss"])
    rel = abs(float(got_loss) - want_loss) / abs(want_loss)
    print(f"fit loss at 64x36 vs vrt fixture: {float(got_loss):.8f} vs "
          f"{want_loss:.8f}, rel {rel:.2e} (< {FIT_LOSS_RTOL})", flush=True)
    if not rel < FIT_LOSS_RTOL:
        raise AssertionError("the card's fit loss disagrees with vrt's")
    for k, g in grads.items():
        a = fixture[f"grad_{k}"].astype(np.float64).ravel()
        b = g.double().cpu().numpy().ravel()
        scale = np.abs(a).max()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        diff = float(np.abs(a - b).max() / scale)
        print(f"  grad {k} vs vrt fixture: 1 - cosine {1 - cos:.2e} "
              f"(< {FIT_COS_TOL}), max diff / max|g| {diff:.2e} "
              f"(< {FIT_DIFF_TOL})", flush=True)
        if not (np.isfinite(b).all() and 1 - cos < FIT_COS_TOL
                and diff < FIT_DIFF_TOL):
            raise AssertionError(f"the card's {k} gradient disagrees with "
                                 f"vrt's")
    del small, grads

    # the fit CLI at its defaults, on the card
    from vrt_torch.apps import fit as fit_app

    t0 = time.perf_counter()
    cli = fit_app.main([])
    print(f"python -m vrt_torch.apps.fit (defaults) on {card}: loss "
          f"{cli[0]:.5f} -> {cli[-1]:.5f} = {cli[-1] / cli[0]:.2%} of the "
          f"first (< 25%) in {len(cli)} steps, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not cli[-1] < 0.25 * cli[0]:
        raise AssertionError("the fit CLI did not bring its loss under a "
                             "quarter of the first")

    def bound_keys(b):
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "bound_bytes": b["bytes"], "bound_operations": b["flops"]}

    gp = []
    for name, first in (("GP-A", "scripts/probe_gather.py:47"),
                        ("GP-B", "scripts/probe_gather.py:79"),
                        ("GP-C", "scripts/probe_gather4.py:158")):
        rows = [r for r in results if r["kernel"] == name
                and r["path"] in ("-", "ldg")]
        with_lib = [r for r in rows if r["library_ms"] is not None]
        gp.append({
            "name": name, "route": "cuda",
            "source": "vrt_torch/csrc/gather.cu", "replaces": first,
            "also_replaces": sorted({r["replaces"] for r in results
                                     if r["kernel"] == name and r["pallas"]}
                                    - {first}),
            "launches": gp_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results
                               if r["kernel"] == name),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes",
            # the cases without rounds have a library call; the kernel's
            # time over the same cases stands beside it
            "library_ms": sum(r["library_ms"] for r in with_lib),
            "library_cases_ms": sum(r["ms"] for r in with_lib)})
    scene_all = {tag: c["scene"] for tag, c in
                 (("interp", frame_counts), ("cube", cube_counts),
                  ("debug_overlay", overlay_counts),
                  ("fit_steps", fit_counts))}
    print(json.dumps({"kernels": [{
        "name": "K1 march", "route": "cuda",
        "source": "vrt_torch/csrc/march.cu",
        "replaces": "scripts/pallas_march.py:85",
        "modes": ["interp", "cube", "debug_overlay"],
        "path": "render_image with march_scene(lane_marcher=march_lanes): "
                "0 launches on the default frame and fit step",
        "launches": old_counts["k1"],
        "max_abs_err": err, "ms": sum(k1_frame["ms"]),
        "plain_ms": sum(k1_frame["plain_ms"]),
        **bound_keys(k1_frame["bound"]), "library_ms": None,
        "small_ms": {t: sum(g["ms"]) for t, g in k1_small.items()},
        "small_plain_ms": {t: sum(g["plain_ms"])
                           for t, g in k1_small.items()}},
        {"name": "K1 scene march", "route": "cuda",
         "source": "vrt_torch/csrc/march.cu",
         "replaces": "vrt/render/renderer.py:78 (march_scene, an XLA loop: "
                     "no Pallas kernel)",
         "modes": ["interp", "cube", "debug_overlay", "any_hit"],
         "launches": sum(scene_all.values()),
         "launches_by_path": scene_all,
         "max_abs_err": scene_err, "ms": sum(scene_runs["interp"]["ms"]),
         "plain_ms": sum(scene_runs["interp"]["plain_ms"]),
         **bound_keys(scene_runs["interp"]["bound"]), "library_ms": None,
         "by_path": {t: {"ms": sum(g["ms"]), "plain_ms": sum(g["plain_ms"]),
                         **bound_keys(g["bound"])}
                     for t, g in scene_runs.items()}},
        {"name": "fused resolve", "route": "cuda",
         "source": "vrt_torch/csrc/resolve.cu",
         "replaces": "vrt/march/resolve.py:61 (resolve_hits under "
                     "vrt/render/renderer.py:210, XLA ops: no Pallas "
                     "kernel)",
         "launches": frame_counts["resolve"] + cube_counts["resolve"]
         + overlay_counts["resolve"],
         "max_abs_err": fused["max_abs_err"], "ms": fused["ms"],
         "plain_ms": fused["plain_ms"],
         "plain_over_k3_ms": fused["over_k3_ms"],
         **bound_keys(fused["bound"]), "library_ms": None},
        {"name": "K3 gather", "route": "cuda",
         "source": "vrt_torch/csrc/rows.cu",
         "replaces": "vrt/march/isosurface.py:181 (take_rows, an XLA "
                     "gather: no Pallas kernel)",
         "launches": fit_counts["gather"],
         "launches_by_path": {"fit_steps": fit_counts["gather"],
                              "candidate_loop_frames":
                              old_counts["gather"]},
         "max_abs_err": 0.0, "ms": k3_fit["gather"]["ms"],
         "plain_ms": k3_fit["gather"]["plain_ms"],
         **bound_keys(k3_fit["gather"]["bound"]),
         "library_ms": k3_fit["gather"]["library_ms"],
         "frame": {"ms": k3_frame["gather"]["ms"],
                   "plain_ms": k3_frame["gather"]["plain_ms"],
                   "library_ms": k3_frame["gather"]["library_ms"],
                   **bound_keys(k3_frame["gather"]["bound"])}},
        {"name": "K3 scatter", "route": "cuda",
         "source": "vrt_torch/csrc/rows.cu",
         "replaces": "vrt/march/isosurface.py:204 (_take_rows_bwd, an XLA "
                     "scatter-add: no Pallas kernel)",
         "launches": fit_counts["scatter"],
         "max_abs_err": k3_fit["scatter"]["max_abs_err"],
         "ms": k3_fit["scatter"]["ms"],
         "plain_ms": k3_fit["scatter"]["plain_ms"],
         **bound_keys(k3_fit["scatter"]["bound"]),
         "library_ms": k3_fit["scatter"]["library_ms"]}] + gp,
        "paired_ms_old_new_new_old": paired}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
