"""Smoke run of the PyTorch/CUDA port (``vrt_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device  — needs a CUDA card; prints its name and power limit,
2. build   — compiles the march kernel K1 and the gather library (GP-A,
             GP-B, GP-C) from ``vrt_torch/csrc/``, one nvcc each, in
             parallel, and prints ptxas' register and spill lines,
3. K1      — K1 against its plain-torch twin on the flagship scene
             (resolution 7, chebyshev, bf16): 480x270 primary rays and the
             directional shadow rays cast from their hits; then every K1
             launch of one 1920x1080 frame (primary, shadow and bounce
             passes) against the twin on the same inputs, both timed;
             then the same for one 1080p frame in cube mode and one with
             the debug overlay,
4. frame   — the 1920x1080 flagship frame three times after a warm-up,
             with K1's launch count over those frames; then the same in
             cube mode and with the debug overlay,
5. anchor  — the 160x90 frame against the image ``vrt`` renders on the CPU
             (``tests/fixtures/flagship_r7_cheb_bf16_160x90.npy``), and the
             160x90 cube-mode unlit frame against its own ``vrt`` fixture,
6. profile — one 1080p frame under ``torch.profiler``: device busy time,
             K1's share of it, and the kernels that take the most time,
7. gather  — the gather probe (``vrt_torch.apps.probe_gather``): every
             case once through its kernel on every load path, with the
             launches counted, then each output against its plain version
             (equal, or the run fails) and both timed.

The line before the last is a JSON object with every kernel's launches on
its main path, its largest disagreement with its plain version, and both
times; the last line is ``{"ok": true, "device": {...}}``.  There is no
CPU path.
"""

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
LANE_BUDGET = 1e-3    # share of lanes whose hit or kind may differ
T_RTOL = 1e-4         # t on lanes where both agree on the hit
FRAME_W, FRAME_H = 1920, 1080
TWIN_BUDGET_S = 60.0  # twin time over a frame's passes before 960x540


def _compare(tag, a, b):
    """K1 hits ``a`` against twin hits ``b``; returns max |dt| on lanes
    where both hit with the same kind.  On lanes where hit and kind agree,
    the steps, t_in, t_out and face normal (NaN equal to NaN) must be
    equal, and on hit lanes the cell too."""
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
    print(f"K1 vs twin [{tag}]: lanes={a.hit.numel()} hits={int(a.hit.sum())}"
          f" hit/kind flips={flips:.2e} max|dt|={err:.3e} max rel dt={rel:.3e}"
          f" cells equal={cells} steps equal={steps} t_in/t_out equal="
          f"{brackets} face normals equal={faces}", flush=True)
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


def _frame_passes(scene, mode, w, h, tag, twin_budget_s=None):
    """Every K1 launch of one ``w`` x ``h`` frame in ``mode``, kept with
    its inputs and the output the frame used, then held against the twin
    on the same inputs; both timed.  Returns (max |dt|, K1 ms per pass,
    twin ms per pass), or None once the twin's total passes
    ``twin_budget_s``."""
    import torch

    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.march import march_lanes_reference
    from vrt_torch.render.renderer import render_image

    frame_passes = []
    launch = k1.march_lanes_cuda

    def recording(*args):
        h = launch(*args)
        frame_passes.append((args, h))
        return h

    k1.march_lanes_cuda = recording
    try:
        render_image(scene, w, h, mode)
    finally:
        k1.march_lanes_cuda = launch
    torch.cuda.synchronize()
    if len(frame_passes) != _expected_passes(scene):
        raise AssertionError(f"the {tag} frame launched K1 "
                             f"{len(frame_passes)} times, expected "
                             f"{_expected_passes(scene)}")
    err, k1_ms, tw_ms = 0.0, [], []
    for i, (args, h_k1) in enumerate(frame_passes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h_tw = march_lanes_reference(*args)
        end.record()
        end.synchronize()
        tw_ms.append(start.elapsed_time(end))
        err = max(err, _compare(f"{tag} pass {i}", h_k1, h_tw))
        k1_ms.append(device_ms(lambda: launch(*args), 20))
        del h_tw
        if twin_budget_s is not None and sum(tw_ms) > 1e3 * twin_budget_s:
            return None
    return err, k1_ms, tw_ms


def _profile(render, sync, frame_ms, top=8):
    """Device time of one ``render()`` by kernel and by the torch operator
    that launched it, from torch.profiler."""
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
        return
    k1_ms = sum(r[0] for r in rows if "march_kernel" in r[2])
    print(f"profile of one 1080p frame: device busy {busy:.1f} ms = "
          f"{100 * busy / frame_ms:.0f}% of the {frame_ms:.1f} ms frame; "
          f"K1 {k1_ms:.1f} ms = {100 * k1_ms / busy:.0f}% of busy; "
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


def _expected_passes(scene):
    """K1 launches one frame issues: one per instance for every
    ``march_scene`` call of the inline recursion (radiance at each depth,
    one shadow trace per light at depths whose shadows are traced)."""
    from vrt_torch.render.renderer import MAX_RAY_RECURSION_DEPTH as cap

    levels = cap if scene.any_reflective else 1
    lights = 1 + scene.num_point + scene.num_spot
    shadowed = sum(1 for depth in range(levels) if depth + 1 < cap)
    return scene.num_instances * (levels + shadowed * lights)


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
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.march import march_lanes_reference
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import (DIR_SHADOW_TMAX, RADIANCE_TMAX,
                                           march_scene, render_image,
                                           resolve_scene)
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
    with ThreadPoolExecutor(2) as pool:
        logs = {"K1 (march.cu)": pool.submit(k1.build),
                "gather (gather.cu)": pool.submit(gk.build)}
        logs = {name: f.result() for name, f in logs.items()}
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {name}: {line}", flush=True)

    # ---- 3. K1 against the twin -------------------------------------------
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

    o, d = rays(480, 270)
    t_max = torch.full((o.shape[0],), RADIANCE_TMAX, device=dev)
    h_k1, inst = march_scene(scene, o, d, t_max)
    h_tw, _ = march_scene(scene, o, d, t_max,
                          lane_marcher=march_lanes_reference)
    sync()
    err = _compare("primary 480x270", h_k1, h_tw)
    t, _, _ = resolve_scene(scene, o, d, h_k1, inst)
    so = o + torch.where(h_k1.hit, t, 0.0)[:, None] * d - d * 0.1
    sd = scene.dir_light_dir.expand(so.shape)
    s_max = torch.where(h_k1.hit, DIR_SHADOW_TMAX, -float("inf"))
    s_k1, _ = march_scene(scene, so, sd, s_max)
    s_tw, _ = march_scene(scene, so, sd, s_max,
                          lane_marcher=march_lanes_reference)
    sync()
    err = max(err, _compare("dir shadow 480x270", s_k1, s_tw))

    e, k1_ms, tw_ms = _frame_passes(scene, mode, FRAME_W, FRAME_H,
                                    "1080p frame")
    err = max(err, e)
    ms, plain_ms = sum(k1_ms), sum(tw_ms)
    prim = scene.num_instances
    o, d = rays(FRAME_W, FRAME_H)
    t_max = torch.full((o.shape[0],), RADIANCE_TMAX, device=dev)
    scene_ms = device_ms(lambda: march_scene(scene, o, d, t_max), 5,
                         hold=False)
    print(f"K1 device time per pass of the 1080p frame on {card}: "
          f"{', '.join(f'{t:.4f}' for t in k1_ms)} ms = {ms:.4f} ms per "
          f"frame, the {prim} primary passes {sum(k1_ms[:prim]):.4f} ms; "
          f"twin on the same lanes {', '.join(f'{t:.2f}' for t in tw_ms)} "
          f"ms = {plain_ms:.2f} ms; primary march_scene with K1 "
          f"{scene_ms:.2f} ms", flush=True)
    del o, d, t_max

    # the cube-mode and overlay frames, every launch against the twin
    mode_ms = {}
    for tag, m in (("cube", cube), ("overlay", overlay)):
        got = _frame_passes(scene, m, FRAME_W, FRAME_H, f"1080p {tag}",
                            twin_budget_s=TWIN_BUDGET_S)
        size = "1920x1080"
        if got is None:
            print(f"the twin passed {TWIN_BUDGET_S:.0f} s on the 1080p "
                  f"{tag} frame: comparing its passes at 960x540 instead",
                  flush=True)
            got = _frame_passes(scene, m, 960, 540, f"960x540 {tag}")
            size = "960x540"
        e, m_ms, m_tw = got
        err = max(err, e)
        mode_ms[tag] = (sum(m_ms), sum(m_tw))
        print(f"K1 device time per pass of the {size} {tag} frame on "
              f"{card}: {', '.join(f'{t:.4f}' for t in m_ms)} ms = "
              f"{sum(m_ms):.4f} ms per frame; twin "
              f"{', '.join(f'{t:.2f}' for t in m_tw)} ms = "
              f"{sum(m_tw):.2f} ms", flush=True)

    # ---- 4. the frames -----------------------------------------------------
    def frames(m, tag):
        img = render_image(scene, FRAME_W, FRAME_H, m)     # warm-up
        sync()
        k1.LAUNCHES = 0
        runs = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            img = render_image(scene, FRAME_W, FRAME_H, m)
            sync()
            runs.append(time.perf_counter() - t0)
        launches = k1.LAUNCHES
        expected = 3 * _expected_passes(scene)
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"1080p {tag} frame has non-finite pixels")
        if tuple(img.shape) != (FRAME_H, FRAME_W, 4):
            raise AssertionError(f"{tag} frame shape {tuple(img.shape)}")
        if launches < expected:
            raise AssertionError(f"K1 launched {launches} times in 3 {tag} "
                                 f"frames, expected >= {expected}")
        median = statistics.median(runs)
        print(f"1080p {tag} frame on {card}: median {median * 1e3:.1f} ms "
              f"(runs {', '.join(f'{f * 1e3:.1f}' for f in runs)} ms), "
              f"{FRAME_W * FRAME_H / median:.0f} rays/s; K1 launches "
              f"{launches} in 3 frames (>= {expected})", flush=True)
        return median, launches

    frame_s, launches = frames(mode, "interp")
    _, cube_launches = frames(cube, "cube")
    _, overlay_launches = frames(overlay, "overlay")

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
    _profile(lambda: render_image(scene, FRAME_W, FRAME_H, mode), sync,
             frame_s * 1e3)
    del scene

    # ---- 7. the gather probe ------------------------------------------------
    t0 = time.perf_counter()
    cases = [(c, probe.to_device(c, dev)) for c in probe.CASES]
    sync()
    print(f"gather probe data: {len(cases)} cases, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name in gk.LAUNCHES:
        gk.LAUNCHES[name] = 0
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

    gp = []
    for name, first in (("GP-A", "scripts/probe_gather.py:47"),
                        ("GP-B", "scripts/probe_gather.py:79"),
                        ("GP-C", "scripts/probe_gather4.py:158")):
        rows = [r for r in results if r["kernel"] == name
                and r["path"] in ("-", "ldg")]
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
            "plain_ms": sum(r["plain_ms"] for r in rows)})
    print(json.dumps({"kernels": [{
        "name": "K1 march", "route": "cuda",
        "source": "vrt_torch/csrc/march.cu",
        "replaces": "scripts/pallas_march.py:85",
        "modes": ["interp", "cube", "debug_overlay"],
        "launches": launches + cube_launches + overlay_launches,
        "launches_by_mode": {"interp": launches, "cube": cube_launches,
                             "debug_overlay": overlay_launches},
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "cube_ms": mode_ms["cube"][0], "cube_plain_ms": mode_ms["cube"][1],
        "overlay_ms": mode_ms["overlay"][0],
        "overlay_plain_ms": mode_ms["overlay"][1]}] + gp}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
