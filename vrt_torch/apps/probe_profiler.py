"""How steady torch.profiler's count of device operations is, on one config6
fit step (``vrt/apps/bench.py``: ``bench_fit(6, ..., 1920, 1080)``) on one
CUDA card.

    python3 -m vrt_torch.apps.probe_profiler [--profiles N]

``chip_smoke.py`` holds a config6 step to a count of device operations
(kernels, copies and fills) read from ``torch.profiler``: the host's launch
calls (``vrt_torch.kernels._timing.LAUNCH_CALLS``), since this probe found
the device records short at the start of some traces.  This probe
profiles the same step ``N`` times in each of two ways, back to back:

- ``cold``: a profiler started just before the step (a sync, the step, a
  sync), as ``chip_smoke.py`` profiles it;
- ``warm``: the profiler's schedule with one warm-up cycle, the step run in
  it and again in the active cycle that is counted.

For every profile it counts the device records and, beside them, the host's
launch calls that CUPTI saw (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
``cudaMemsetAsync`` and their driver-API kin), and the wrappers' own launch
counts.  Where a profile holds fewer device records than the most seen, it
names the records it lacks and where they lie in the step's order of
device records (from the fullest profile, by start time): at its start, at
its end, or between.  It prints every profile's numbers and a summary
beside the card's name and power limit.  There is no CPU path.
"""

from __future__ import annotations

import argparse
import difflib
import subprocess
from collections import Counter

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from vrt_torch.kernels._timing import LAUNCH_CALLS

# config6's camera (vrt/apps/bench.py bench_fit)
CAMS = [dict(position=(320.0, 0.0, 40.0), rotation=(0.0, 0.0, 1.0, 0.0),
             fov=60.0)]
W, H = 1920, 1080


def _config6():
    from vrt_torch.diff.fit import make_fit_step
    from vrt_torch.diff.optim import adam
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    scene = flagship_scene(6, use_colors=True, device="cuda")
    params = {"sdf": scene.volumes.sdf, "voxel_colors": scene.voxel_colors}
    opt = adam(1e-2)
    step = make_fit_step(scene, CAMS, W, H, RenderMode(), opt)
    targets = torch.zeros((len(CAMS), W * H, 3), device="cuda")
    return step, params, opt.init(params), targets


def _read(prof):
    """(device records in order of start time as names, host launch calls
    by name) of a finished profile."""
    device, calls = [], Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name != "ProfilerStep*":
            device.append((e.time_range.start, e.name))
        elif e.name in LAUNCH_CALLS:
            calls[e.name] += 1
    return [n for _, n in sorted(device)], calls


def _cold(run):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    return _read(prof)


def _warm(run):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for cycle in range(2):
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            if cycle == 0:
                prof.step()
    return _read(prof)


def _where(full, got):
    """The records of ``full`` that ``got`` lacks, as (first, last index in
    ``full``, count, names)."""
    gaps = []
    ops = difflib.SequenceMatcher(a=full, b=got, autojunk=False).get_opcodes()
    for tag, i0, i1, j0, j1 in ops:
        if tag in ("delete", "replace"):
            names = Counter(n[:60] for n in full[i0:i1])
            gaps.append((i0, i1 - 1, (i1 - i0) - (j1 - j0), dict(names)))
    return gaps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profiles", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_profiler needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from vrt_torch.kernels import march, resolve, shade

    step, params, state, targets = _config6()

    def run():
        return step(params, state, targets)[2]

    for _ in range(3):
        run()
    torch.cuda.synchronize()

    def launches():
        return (march.SCENE_LAUNCHES + sum(resolve.LAUNCHES.values())
                + sum(shade.LAUNCHES.values()))

    results = {"cold": [], "warm": []}
    for i in range(args.profiles):
        for way, fn in (("cold", _cold), ("warm", _warm)):
            before = launches()
            device, calls = fn(run)
            wrappers = launches() - before
            if way == "warm":
                wrappers //= 2
            results[way].append((device, calls))
            print(f"{way} profile {i}: {len(device)} device records, "
                  f"{sum(calls.values())} host launch calls "
                  f"{dict(sorted(calls.items()))}, {wrappers} launches of "
                  f"the repo's kernels", flush=True)
    full = max((d for r in results.values() for d, _ in r), key=len)
    for way, rows in results.items():
        counts = [len(d) for d, _ in rows]
        host = [sum(c.values()) for _, c in rows]
        short = [i for i, n in enumerate(counts) if n < len(full)]
        print(f"{way}: device records {min(counts)}..{max(counts)} "
              f"({len(short)} of {len(rows)} profiles short of "
              f"{len(full)}), host launch calls {min(host)}..{max(host)}, "
              f"on {card}", flush=True)
        for i in short:
            print(f"  {way} profile {i} lacks {len(full) - counts[i]} of "
                  f"{len(full)} records:", flush=True)
            for first, last, n, names in _where(full, rows[i][0]):
                print(f"    {n} at {first}..{last}: {names}", flush=True)


if __name__ == "__main__":
    main()
