"""The fit steps of config4 and config6 on one CUDA card, timed for the
``vrt_torch`` package of a given checkout, so that one call can time two
checkouts in turns on the same card.

    python3 vrt_torch/apps/probe_step.py [--root DIR] [--configs 4 6]
                                         [--steps N] [--out FILE]

``--root`` (default: the checkout this file is in) is put first on the
module path before anything of ``vrt_torch`` is imported: run the file by
its path, not with ``-m``, so that the package under ``--root`` is the one
timed (another checkout unpacked into an ignored directory, say the parent
commit's).  Its kernels build into that checkout's own ``build/``.  Only
the public API is called: ``apps.bench.config4_scene`` (config4,
``vrt/apps/bench.py``'s ``bench_fit_257``: the 257^3 sphere with per-voxel
colours and a bf16 corner table, 2 views of 256x256) and
``scenes.flagship_scene(6, use_colors=True)`` (config6, ``bench_fit(6,
..., 1920, 1080)``), each through ``diff.fit.make_fit_step`` with Adam at
1e-2 on the SDF and the colours and zero targets.

For each config: a warm-up step, then ``--steps`` steps on the host clock
(each ended by a synchronize: the median and every run), the peak
``max_memory_allocated`` over them, then one step under ``torch.profiler``:
the device's busy time (the sum of its kernels), its device operations (the
host's launch calls, ``kernels._timing.LAUNCH_CALLS``, or the device records
where they are more, as ``chip_smoke.py`` counts them), its largest kernels,
and the launches a step of each of the checkout's kernel wrappers it finds.
Every result is a JSON line on stdout (and appended to ``--out``) with the
card's name and power limit as ``nvidia-smi`` gives them.  There is no CPU
path.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
# config6's camera (vrt/apps/bench.py bench_fit)
CONFIG6_CAMS = [dict(position=(320.0, 0.0, 40.0),
                     rotation=(0.0, 0.0, 1.0, 0.0), fov=60.0)]
# the kernel modules a checkout may hold, and the counters of each
WRAPPERS = {"march": ("SCENE_LAUNCHES", "LAUNCHES"),
            "resolve": ("LAUNCHES",), "rows": ("LAUNCHES",),
            "shade": ("LAUNCHES",), "pack": ("LAUNCHES", "BWD_LAUNCHES"),
            "accel": ("LAUNCHES",), "optim": ("LAUNCHES",)}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _kernel_modules():
    """The checkout's kernel modules, by name (those it has)."""
    mods = {}
    for name in WRAPPERS:
        try:
            mods[name] = importlib.import_module(f"vrt_torch.kernels.{name}")
        except ModuleNotFoundError:
            continue
    return mods


def _counts(mods) -> dict:
    """Every wrapper counter of ``mods`` as flat {name: launches}."""
    out = {}
    for name, mod in mods.items():
        for attr in WRAPPERS[name]:
            value = getattr(mod, attr, None)
            if isinstance(value, dict):
                out.update({f"{name} {k}": v for k, v in value.items()})
            elif isinstance(value, int):
                out[f"{name} {attr}"] = value
    return out


def _step(config: int, dev):
    """(step, params, opt_state, targets, rays) of a config."""
    import torch

    from vrt_torch.diff.fit import make_fit_step
    from vrt_torch.diff.optim import adam
    from vrt_torch.render.gpuscene import RenderMode

    if config == 4:
        from vrt_torch.apps import bench

        scene, cams = bench.config4_scene(8, 2, device=dev)
        w = h = 256
    elif config == 6:
        from vrt_torch.scenes import flagship_scene

        scene, cams = flagship_scene(6, use_colors=True, device=dev), \
            CONFIG6_CAMS
        w, h = 1920, 1080
    else:
        raise SystemExit(f"probe_step: no config{config} (4 or 6)")
    params = {"sdf": scene.volumes.sdf, "voxel_colors": scene.voxel_colors}
    opt = adam(1e-2)
    step = make_fit_step(scene, cams, w, h, RenderMode(), opt)
    targets = torch.zeros((len(cams), w * h, 3), device=dev)
    return step, params, opt.init(params), targets, len(cams) * w * h


def _profile(run):
    """(busy ms, device ops, device records, the 8 largest kernels as
    (ms, count, name)) of one ``run()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vrt_torch.kernels._timing import LAUNCH_CALLS

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:90])
                   for e in events if e.device_type == DeviceType.CUDA),
                  reverse=True)
    records = sum(r[1] for r in rows)
    ops = max(records, sum(e.count for e in events if e.key in LAUNCH_CALLS))
    return sum(r[0] for r in rows) or None, ops, records, rows[:8]


def measure(config: int, steps: int, card: str, root: str) -> dict:
    import torch

    dev = torch.device("cuda", 0)
    mods = _kernel_modules()
    t0 = time.perf_counter()
    step, params, state, targets, rays = _step(config, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params, state, loss = step(params, state, targets)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _counts(mods)
    runs, losses = [], [float(loss)]
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, targets)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = _counts(mods)
    launches = {k: (after[k] - before.get(k, 0)) / steps for k in after
                if after[k] != before.get(k, 0)}
    busy, ops, records, top = _profile(
        lambda: step(params, state, targets))
    return dict(config=config, root=root, card=card, rays=rays,
                step_ms=statistics.median(runs), runs_ms=runs,
                busy_ms=busy, device_ops=ops, device_records=records,
                peak_gib=peak, launches_per_step=launches, losses=losses,
                scene_s=build_s, top_kernels=top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--configs", type=int, nargs="+", default=[4, 6])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_step needs a CUDA card")
    import vrt_torch

    if not os.path.abspath(vrt_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"probe_step: vrt_torch came from "
                         f"{vrt_torch.__file__}, not from {root}")
    card = _card()
    mods = _kernel_modules()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        for f in [pool.submit(m.build) for m in mods.values()
                  if hasattr(m, "build")]:
            f.result()
    print(f"probe_step: {root} on {card}: built {sorted(mods)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for config in args.configs:
        got = measure(config, args.steps, card, root)
        line = json.dumps(got)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
