"""Benchmark suite CLI (port of ``vrt.apps.bench``): ``vrt``'s eight
cells, end to end on the card.

``python -m vrt_torch.apps.bench [--configs 1 2 ...] [--out BENCH.md]
 [--device cuda]``

The cells, run in ``vrt``'s order (1, 2, 3, 8, 4, 6, 7, 5) whatever the
order of ``--configs`` (default 1 2), under ``vrt``'s labels:
 1. the flagship at resolution 5 (65^3), chebyshev accel, 256x256 (fwd)
 2. the flagship at resolution 6 (129^3-class), 512x512 (fwd)
 3. a 9,216-triangle torus voxelized at 257^3 (resolution 8), bf16 table,
    1080p (fwd); the import's host seconds are printed beside the row
 8. the flagship at resolution 7 (129^3), chebyshev accel, 1080p (fwd)
 4. the fit step of a 257^3 sphere SDF with per-voxel colours and a bf16
    corner table from 2 views at 256x256, Adam 1e-2 (fwd+bwd)
 6. the flagship's fit step at resolution 6 with colours, 1920x1080
    (fwd+bwd)
 7. 12 instances of a sphere and a box minus a sphere at resolution 6,
    512x512 (fwd)
 5. ray-DP scaling of the flagship at resolution 5, 256x256, over
    ``torch.cuda.device_count()`` cards

Each row is ms per frame (or step) and rays/s.  ``_time`` makes one warm-up
call, then times three and synchronises the card once after them (it runs
them in order).  ``--out`` writes ``vrt``'s table under a title line that
names the card and its power limit (``nvidia-smi``).  The cells run on the
card unless ``--device cpu`` is given; the device is never changed on its
own.

Deliberate deviations from ``vrt``:
- no ``--chunk``, and no chunked, sorted or compacted frame: the port
  renders a frame as one batch of rays (``render_image``, ``make_fit_step``);
- no fov jitter ``i*1e-6`` between timed calls: it lies below the f32 ulp
  of the fov, and torch memoises no dispatch for it to defeat;
- config5 on a host with one card is, by ``vrt``'s own rule, the
  single-device time at an efficiency of 1.0; ranks that shared one card
  over gloo would time gloo, not the port.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

ORDER = (1, 2, 3, 8, 4, 6, 7, 5)
LABELS = {
    1: "config1 64^3-class 256x256 fwd",
    2: "config2 128^3-class 512x512 fwd",
    8: "flagship 129^3 analytic 1080p fwd",
    6: "config6 fit step 1080p fwd+bwd",
    7: "config7 12-instance scene 512x512 fwd",
    5: "config5 ray-DP scaling 256x256",
}
ADAM_LR = 1e-2


def config3_label(n_voxels: int, width: int = 1920, height: int = 1080):
    return f"config3 voxelized glTF {n_voxels}^3 {width}x{height} fwd"


def config4_label(views: int = 2, size: int = 256):
    return f"config4 fit 257^3 ({views} views {size}x{size}) fwd+bwd"


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, iters: int = 3) -> float:
    """Seconds per call of ``fn()``: a warm-up call, then ``iters`` calls
    with one synchronisation after the last."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _row(results, label, dt, rays, unit="frame", note=""):
    results.append((label, dt * 1e3, rays / dt))
    print(f"{label}: {dt * 1e3:.1f} ms/{unit}, {rays / dt / 1e6:.2f} Mrays/s"
          f"{note}", file=sys.stderr, flush=True)


def bench_forward(resolution, width, height, label, results,
                  device: torch.device):
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scenes import flagship_scene

    scene = flagship_scene(resolution, "chebyshev", device=device)
    dt = _time(lambda: render_image(scene, width, height, RenderMode()),
               device)
    _row(results, label, dt, width * height)


def bench_voxelized_mesh(results, device: torch.device, resolution=8,
                         width=1920, height=1080):
    """config3: the glTF torus voxelized natively at ``resolution`` (257^3
    at 8, the reference voxelizer's cap) and rendered at 1080p; the
    import's host seconds are printed beside the row (a one-off, not a
    frame cost)."""
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scenes import TORUS_MESH, voxelized_torus_scene

    scene, seconds = voxelized_torus_scene(resolution, device=device)
    n = scene.volumes.sdf.shape[-1]
    print(f"voxelized {2 * TORUS_MESH['nu'] * TORUS_MESH['nv']} tris at res "
          f"{resolution} ({n}^3): {seconds['convert']:.1f}s (native path); "
          f"mesh {seconds['mesh']:.2f}s, .vox read {seconds['load']:.2f}s, "
          f"build_scene {seconds['build']:.2f}s", file=sys.stderr,
          flush=True)
    dt = _time(lambda: render_image(scene, width, height, RenderMode()),
               device)
    _row(results, config3_label(n, width, height), dt, width * height)
    return seconds


def _fit_params(scene):
    return {"sdf": scene.volumes.sdf, "voxel_colors": scene.voxel_colors}


def bench_fit(resolution, size, label, results, device: torch.device,
              width=None, height=None, scene=None, cams=None):
    from vrt_torch.diff.fit import make_fit_step
    from vrt_torch.diff.optim import adam
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    width = width or size
    height = height or size
    if scene is None:
        scene = flagship_scene(resolution, use_colors=True, device=device)
    # vrt's bench_fit camera: at (320, 0, 40) looking down -x
    cams = cams or [dict(position=(320.0, 0.0, 40.0),
                         rotation=np.asarray([0.0, 0.0, 1.0, 0.0],
                                             np.float32), fov=60.0)]
    targets = torch.zeros((len(cams), width * height, 3), device=device)
    opt = adam(ADAM_LR)
    state = {"params": _fit_params(scene)}
    state["opt"] = opt.init(state["params"])
    step = make_fit_step(scene, cams, width, height, RenderMode(), opt)

    def run():
        state["params"], state["opt"], _ = step(state["params"], state["opt"],
                                                targets)

    dt = _time(run, device)
    _row(results, label, dt, len(cams) * width * height, "step",
         " (fwd+bwd)")


def config4_scene(resolution: int = 8, views: int = 2,
                  device: torch.device | str = "cuda"):
    """config4 (``vrt/apps/bench.py``'s ``bench_fit_257``): a sphere of
    radius 70 at 2^resolution + 1 voxels (257^3 at 8) with roughness 0.8,
    per-voxel colours of 0.5 and a bf16 corner table, lit along Euler (0,
    45, -30) at strength 6 under an 8x8 sky; and ``views`` cameras on a
    circle of radius 300 at height 60, pitched -11.3 degrees.  Returns
    (scene, cameras)."""
    from vrt_torch.core import quat as vq
    from vrt_torch.core.material import Material
    from vrt_torch.render.gpuscene import build_scene
    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    vol = VoxelVolume.from_generator(
        S.Sphere(radius=70.0), resolution, 100.0,
        material=Material(albedo=(0.8, 0.8, 0.8, 1.0), roughness=0.8))
    n = vol.n_voxels
    colors = np.full((1, n, n, n, 3), 0.5, np.float32)
    scene = build_scene(
        [vol], [{"volume": 0}],
        camera={"position": (300.0, 0.0, 0.0),
                "rotation": np.asarray(vq.from_euler_degrees(0.0, 180.0,
                                                             0.0))},
        dir_light={"direction": np.asarray(vq.forward_vector(
            vq.from_euler_degrees(0.0, 45.0, -30.0))), "strength": 6.0},
        env=np.full((6, 8, 8, 3), (0.25, 0.45, 0.85), np.float32),
        voxel_colors=colors, march_dtype=torch.bfloat16, device=device)
    cams = []
    for i in range(views):
        yaw = 360.0 * i / views
        a = np.radians(yaw)
        cams.append(dict(
            position=(300.0 * np.cos(a), 300.0 * np.sin(a), 60.0),
            rotation=np.asarray(vq.from_euler_degrees(
                0.0, 180.0 + yaw, -11.3)), fov=60.0))
    return scene, cams


def bench_fit_257(results, device: torch.device, resolution=8, size=256,
                  views=2):
    """config4: the steady-state fit step of the 257^3 SDF and colours."""
    scene, cams = config4_scene(resolution, views, device)
    bench_fit(resolution, size, config4_label(views, size), results, device,
              scene=scene, cams=cams)


def config7_scene(resolution: int = 6, n_inst: int = 12,
                  device: torch.device | str = "cuda"):
    """config7 (``vrt``'s ``bench_many_instances``): ``n_inst`` instances,
    alternately a sphere of radius 45 (roughness 0.6) and a 40-unit box
    minus a sphere of radius 50 (roughness 0.8), at 2^resolution + 1
    voxels, on a grid of 4 per row 160 units apart in -x and 170 in y,
    staggered by 60 in z; chebyshev accel, f32 table; a camera at (430, 0,
    60) looking down -x through 70 degrees, a light along Euler (0, 45,
    -30) at strength 5 and a flat 4x4 sky."""
    from vrt_torch.core import quat as vq
    from vrt_torch.core.material import Material
    from vrt_torch.render.gpuscene import build_scene
    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    sphere = VoxelVolume.from_generator(
        S.Sphere(radius=45.0), resolution, 100.0,
        material=Material(albedo=(0.9, 0.3, 0.2, 1.0), roughness=0.6))
    csg = S.CSG(shape=S.Box(extends=(40.0, 40.0, 40.0)))
    csg.add_child(S.Sphere(radius=50.0), S.SUBTRACT)
    box = VoxelVolume.from_generator(
        csg, resolution, 100.0,
        material=Material(albedo=(0.2, 0.5, 0.9, 1.0), roughness=0.8))
    insts = []
    for i in range(n_inst):
        gx, gy = divmod(i, 4)
        insts.append({"volume": i % 2,
                      "position": (-160.0 * gx, 170.0 * (gy - 1.5),
                                   60.0 * ((i % 3) - 1))})
    return build_scene(
        [sphere, box], insts, accel_mode="chebyshev",
        camera={"position": (430.0, 0.0, 60.0),
                "rotation": np.asarray(vq.from_euler_degrees(0.0, 180.0,
                                                             0.0)),
                "fov": 70.0},
        dir_light={"direction": np.asarray(vq.forward_vector(
            vq.from_euler_degrees(0.0, 45.0, -30.0))), "strength": 5.0},
        env=np.full((6, 4, 4, 3), (0.3, 0.4, 0.6), np.float32),
        device=device)


def bench_many_instances(resolution, size, label, results,
                         device: torch.device, n_inst=12):
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image

    scene = config7_scene(resolution, n_inst, device)
    dt = _time(lambda: render_image(scene, size, size, RenderMode()), device)
    _row(results, label, dt, size * size)


def _scaling_rank(rank, world, resolution, size, device_type):
    """One rank of config5's sharded frame: its seconds per frame."""
    from vrt_torch.dist.mesh import make_render_mesh
    from vrt_torch.dist.sharding import render_image_sharded
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    dev = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    scene = flagship_scene(resolution, device=dev)
    mesh = make_render_mesh(world, 1, device_type=device_type)
    return _time(lambda: render_image_sharded(scene, size, size,
                                              RenderMode(), mesh), dev)


def bench_scaling(resolution, size, label, results, device: torch.device,
                  n_dev: int | None = None):
    """config5: the flagship's frame on one device, and with ``n_dev``
    devices (default: the host's cards) ``render_image_sharded`` over an
    (n_dev, 1) mesh, a process per card; the row is the sharded frame's
    time, or the single device's where there is one card."""
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scenes import flagship_scene

    if n_dev is None:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    scene = flagship_scene(resolution, device=device)
    dt1 = _time(lambda: render_image(scene, size, size, RenderMode()),
                device)
    if n_dev > 1:
        from vrt_torch.dist.mesh import spawn_world

        backend = "nccl" if device.type == "cuda" else "gloo"
        dtn = max(spawn_world(_scaling_rank, n_dev,
                              args=(resolution, size, device.type),
                              backend=backend))
        eff = dt1 / (dtn * n_dev)
    else:
        dtn, eff = dt1, 1.0
    results.append((label, dtn * 1e3, size * size / dtn))
    print(f"{label}: 1 dev {dt1 * 1e3:.1f} ms, {n_dev} dev "
          f"{dtn * 1e3:.1f} ms, scaling efficiency {eff:.1%}",
          file=sys.stderr, flush=True)
    return eff


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    from vrt_torch.apps.probe_gather import card

    return card()


def run(configs, device: torch.device):
    """The cells of ``configs`` in ``vrt``'s order: [(label, ms, rays/s)]."""
    results = []
    if 1 in configs:
        bench_forward(5, 256, 256, LABELS[1], results, device)
    if 2 in configs:
        bench_forward(6, 512, 512, LABELS[2], results, device)
    if 3 in configs:
        bench_voxelized_mesh(results, device)
    if 8 in configs:
        bench_forward(7, 1920, 1080, LABELS[8], results, device)
    if 4 in configs:
        bench_fit_257(results, device)
    if 6 in configs:
        bench_fit(6, 0, LABELS[6], results, device, width=1920, height=1080)
    if 7 in configs:
        bench_many_instances(6, 512, LABELS[7], results, device)
    if 5 in configs:
        bench_scaling(5, 256, LABELS[5], results, device)
    return results


def write_table(path, results, card: str):
    with open(path, "w") as f:
        f.write(f"# vrt_torch benchmarks on {card}\n\n")
        f.write("| config | ms/frame | rays/s |\n|---|---|---|\n")
        for label, ms, rps in results:
            f.write(f"| {label} | {ms:.1f} | {rps:,.0f} |\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="vrt_torch benchmarks")
    ap.add_argument("--configs", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from vrt_torch.core.platform import apply_platform_env
    apply_platform_env()

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a CUDA card "
                             "(--device cpu runs the cells on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    results = run(set(args.configs), device)
    if args.out:
        write_table(args.out, results, card_line(device))
        print(f"wrote {args.out}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
