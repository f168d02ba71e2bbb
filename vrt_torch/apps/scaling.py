"""Scaling of the model-parallel slab fit (port of ``vrt.apps.scaling``):
BASELINE config 5, a 512^3-class slab-sharded SDF, rays sharded over the
ranks, halo exchange and the gradient's sums over the ranks.

Times one ``make_slab_fit_step`` at S = 1, 2, 4, ... model ranks, each rank
a process (``vrt_torch.dist.mesh.spawn_world``, gloo), and reports

    efficiency          = t(1) / (S * t(S))   # wall-clock speedup retained
    efficiency_work     = t(1) / t(S)         # total-work growth bound

with ``vrt``'s rays (4096 from ``default_rng(0)``), targets of 0.4 and Adam
at 1e-2.  ``--device cuda`` (the default) puts every rank on ``cuda:0``:
S ranks then share one card, and the summary says ``oversubscribed``
wherever there are more ranks than cards, so the efficiencies are one
card's, not a multi-card scaling.  ``--device cpu`` runs the ranks on the
CPU (oversubscribed where the host has fewer cores than ranks).  Prints one
JSON line per S and a summary line.

    python -m vrt_torch.apps.scaling [--res 9] [--rays 4096] [--steps 3]
        [--shards 1 2 4] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

ADAM_LR = 1e-2
TARGET = 0.4
RANK_TIMEOUT = 1200.0


def build_volume(resolution: int):
    """config5's CSG volume at n = 2^resolution + 1
    (``vrt_torch.scenes.config5_slab_volume``, ``vrt``'s ``build_volume``
    bit for bit)."""
    from vrt_torch.scenes import config5_slab_volume

    return config5_slab_volume(resolution)


def scaling_rays(n_rays: int):
    """``vrt``'s rays: directions and origins from ``default_rng(0)``, f32
    numpy [n, 3] each."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = (-dirs * rng.uniform(250.0, 400.0, size=(n_rays, 1))
         ).astype(np.float32)
    o += rng.normal(scale=40.0, size=(n_rays, 3)).astype(np.float32)
    return o, dirs


def _device(device: str):
    import torch

    if device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        return dev
    return torch.device(device)


def _build_kernels():
    """The kernels of the slab fit step: K7 with K1, the fused resolve, K4
    (one nvcc each, in parallel; a rank then loads them)."""
    from concurrent.futures import ThreadPoolExecutor

    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4

    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(k.build) for k in (k1, kr, k4)]:
            f.result()


def _rank(rank, world, td, device, steps, geometry):
    """One model rank: its slab from ``td``, a warm-up step, then ``steps``
    timed steps from a barrier to the card's end; its primary march steps
    over every ray (``vrt``'s ``march_steps_per_shard``)."""
    import torch
    import torch.distributed as dist

    from vrt_torch.diff.optim import adam
    from vrt_torch.dist import brick, mesh
    from vrt_torch.dist.slab_render import default_fit_scene, make_slab_fit_step

    dev = _device(device)
    cuda = dev.type == "cuda"
    if cuda:
        _build_kernels()
    with np.load(os.path.join(td, f"slab{rank}.npz")) as f:
        slab = brick.SlabVolume(**{k: torch.from_numpy(f[k]).to(dev)
                                   for k in brick._FIELDS})
    with np.load(os.path.join(td, "rays.npz")) as f:
        o, d = (torch.from_numpy(f[k]).to(dev) for k in ("o", "d"))
    n, h, ext, light = geometry
    scene = default_fit_scene(n, h, ext, light, device=dev)
    m = mesh.make_render_mesh(1, world, dev.type)
    local = o.shape[0] // world
    mine = slice(rank * local, (rank + 1) * local)
    targets = torch.full((local, 3), TARGET, dtype=torch.float32, device=dev)
    optimizer = adam(ADAM_LR)
    step = make_slab_fit_step(m, optimizer, scene)
    params = slab.sdf.clone()
    state = optimizer.init(params)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    params, state, loss = step(params, state, slab, o[mine], d[mine],
                               targets)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mesh.reset_stats()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, slab, o[mine], d[mine],
                                   targets)
    sync()
    dt = (time.perf_counter() - t0) / steps
    out = dict(step_s=dt, loss=float(loss),
               collective_s=mesh.STATS["seconds"] / steps)
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        t_max = torch.full((o.shape[0],), 1e4, dtype=torch.float32,
                           device=dev)
        out["march_steps"] = int(brick.march_volume_slab(
            slab, o, d, t_max).steps.sum())
    return out


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover
        return os.cpu_count() or 1


def run(resolution: int, n_rays: int, steps: int, shard_counts=None,
        device: str = "cuda"):
    """-> (rows, summary), each row and the summary also printed as a JSON
    line; ``vrt``'s keys, with each rank's step time (and, on the card,
    peak device memory) beside them."""
    from vrt_torch.core import quat as vq
    from vrt_torch.dist import brick, mesh
    from vrt_torch.scenes import CONFIG5_LIGHT_EULER

    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA card")
        cards, kind = torch.cuda.device_count(), torch.cuda.get_device_name(0)
        _build_kernels()
    else:
        cards, kind = 0, "cpu"
    if shard_counts is None:
        shard_counts = [1, 2, 4]
    vol = build_volume(resolution)
    n = vol.n_voxels
    print(f"# volume {n}^3 ({n ** 3 * 4 / 1e9:.2f} GB f32), {n_rays} rays, "
          f"device {kind}", flush=True)
    o, d = scaling_rays(n_rays)
    light = np.asarray(vq.forward_vector(vq.from_euler_degrees(
        *CONFIG5_LIGHT_EULER)), np.float32)
    geometry = (n, vol.cell_size, vol.extends, light)

    results, t1 = [], None
    for s_count in shard_counts:
        if n_rays % s_count:
            raise ValueError(f"{n_rays} rays do not split over {s_count} "
                             f"ranks")
        slabs = brick.shard_volume(vol, s_count)
        with tempfile.TemporaryDirectory() as td:
            for s in range(s_count):
                local = slabs.local(s, "cpu")
                np.savez(os.path.join(td, f"slab{s}.npz"),
                         **{f: getattr(local, f).numpy()
                            for f in brick._FIELDS})
            np.savez(os.path.join(td, "rays.npz"), o=o, d=d)
            del slabs, local
            ranks = mesh.spawn_world(_rank, s_count,
                                     args=(td, device, steps, geometry),
                                     timeout=RANK_TIMEOUT)
        dt = max(r["step_s"] for r in ranks)
        if t1 is None:
            t1 = dt
        row = {"model_shards": s_count, "step_s": round(dt, 4),
               "loss": round(ranks[0]["loss"], 6),
               "efficiency": round(t1 / (s_count * dt), 3),
               "efficiency_work": round(t1 / dt, 3),
               "march_steps_per_shard": [r["march_steps"] for r in ranks],
               "step_s_by_rank": [r["step_s"] for r in ranks],
               "collective_s_by_rank": [r["collective_s"] for r in ranks]}
        if device == "cuda":
            row["peak_gb_by_rank"] = [r["peak_gb"] for r in ranks]
        results.append(row)
        print(json.dumps(row), flush=True)

    cores = _cores()
    top = results[-1]["model_shards"]
    oversub = top > cards if device == "cuda" else cores < top
    summary = {
        "metric": f"slab-fit scaling efficiency ({n}^3 SDF, {n_rays} rays)",
        "best_shards": top, "efficiency": results[-1]["efficiency"],
        "efficiency_work": results[-1]["efficiency_work"],
        "oversubscribed": oversub, "host_cores": cores, "device": kind,
        "cards": cards}
    print(json.dumps(summary), flush=True)
    return results, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=9,
                    help="volume resolution r (n = 2^r + 1; 9 -> 513^3)")
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--shards", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None,
                    help="write rows + summary as JSON lines")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    results, summary = run(args.res, args.rays, args.steps, args.shards,
                           args.device)
    if args.out:
        with open(args.out, "w") as f:
            for row in results:
                f.write(json.dumps(row) + "\n")
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
