"""The register-cap probe of the kernels redesigned for the H100: K1's
scene march (``march_scene_capped_kernel``), K4's surface backward
(``surface_bwd_merged_kernel``), K4's forward pair
(``surface_resident_kernel``, ``combine_resident_kernel``) and its surface
on the unpacked colour grid (``surface_voxels_kernel``), the fused
resolve's backward (``resolve_bwd_merged_kernel``) and K7, the slab march
(``march_slab_capped_kernel``), with the slab resolve's backward into the
planes, and the one-launch accel pyramid (``pyramid_one_kernel``), on one
CUDA card.

    python3 -m vrt_torch.apps.probe_caps [march] [surface_bwd] [shade_fwd]
                                         [resolve_bwd] [slab] [pyramid]
                                         [combine_bwd] [resolve_fwd]
                                         [surface_voxels [--parent DIR]]
                                         [shade_bwd --parent DIR] [tex_env]

Each kernel's block and register cap are constants of its source
(``kSceneThreads``, ``kSceneMinBlocks`` and ``kAnyHitMinBlocks`` in
``march.cu``; ``kSurfaceBwdMinBlocks``, ``kFwdThreads``,
``kSurfaceMinBlocks``, ``kCombineMinBlocks``, ``kFetchDepth`` and
``kFlagRounds`` in ``shade.cu``, where ``kFwdResident`` and ``kFwdHitPath`` also switch the
forward pair to one thread a ray over the whole grid and compile its hit
lanes' work out, and ``kFwdColorSample`` compiles the surface kernels'
colour sample out; ``kVoxelThreads`` and ``kVoxelMinBlocks`` there set
``surface_voxels_kernel``'s block and register cap; ``kMergeRows`` and ``kVecReduce`` in ``resolve.cu``
switch the backward's merge of a warp's row cotangents by hit cell and its
16-byte reductions, and ``kBwdMinBlocks`` sets its register cap;
``kSlabThreads`` and ``kSlabMinBlocks`` in ``march.cu`` set K7's block
and its register cap; ``kCombineBwdThreads``, ``kCombineBwdMinBlocks`` and
``kCombineBwdFetchDepth`` in ``shade.cu`` the combine backward's, and its
rounds fetched ahead; ``kResolveThreads`` and ``kResolveMinBlocks`` in
``resolve.cu`` the fused resolve forward's; ``kPyramidMinBlocks`` and ``kTailBytes`` in
``accel.cu`` the one-launch pyramid's register cap and persistent grid,
and the shared memory in which its last block keeps the levels it
reduces).  For
``pyramid`` it runs the pyramid of config4's 257^3 SDF over its 8 levels
and over 3 (no ticket and no last block: the difference is their cost)
and of config6's two 65^3 SDFs over 6 and 3 through each build, each
bit-equal to the default build's, the first design beside them.  The
probe builds a copy of the source for each of ``MARCH``, ``SURFACE_BWD``,
``SHADE_FWD`` and ``RESOLVE_BWD`` with those constants set as the variant
says (all builds in parallel, under ``build/vrt_torch_kernels/probe/``),
then runs the launches of the path that chose them through each build in
turn: the five scene marches of the flagship's 1080p interp frame, the
three surface backwards of one 1080p config6 fit step, the three surface
and three combine launches of the 1080p interp and cube frames, of a
480x270 frame with two point lights and a spot light and of config4's fit
step (its surface launches also on the packed bf16 view of its colours,
built for the probe), and the three
resolve backwards of one 1080p config6 fit step (the last on the primary
rays); for ``slab``, config5 (the 513^3 volume of ``vrt/apps/scaling.py``
in 4 x-slabs) with every slab in this one process (``_Slabs``: each slab
marched by K7 and resolved in turn, the closest hit taken as
``combine_hits`` takes it): the primary and shadow K7 launches of each
slab in a 1080p frame, with each launch's live lanes (those that take a
node step), the SIMT efficiency of its warps in launch order and of dense
warps of its live lanes (from the kernel's step counts), and the first
design (the packed table) beside the builds; and each slab's resolve
backward into its planes on ``vrt/apps/scaling.py``'s 4,096 rays with
random cotangents on the lanes it owns; for ``combine_bwd``, the three
combine backwards of one 1080p config6 fit step and the two of one config4
fit step (65,536 rays each); for ``resolve_fwd``, the three fused resolves
of the flagship's 1080p interp frame, the one of config7's 512x512 frame
and the two of one config4 fit step; for ``surface_voxels``, the surface
launches on the unpacked grid of one config4 fit step and of a 512x512 and
a 1080p frame of its scene (one wave of the card and more), the resident
kernel forced beside them, and with ``--parent DIR`` the surface launches
of the flagship's 1080p frame, a config6 fit step, config3's and config7's
frames and a config4 fit step on this checkout's kernels and on the
``shade.cu`` of the checkout under DIR in turns; for ``shade_bwd --parent
DIR`` the four shade kernels' launches (forward and backward) and the
fused resolve backward's of the 1080p flagship frame, the config6 and
config4 fit steps, the material-and-light step (the backward's material
and light variants), the pose step (the instance variants) and the
texture-and-env step (the texture and env variants) on this checkout's
``shade.cu`` and ``resolve.cu`` and on the parent's, parent, this, this,
parent, bit-equal, with the host's median time a launch; for
``tex_env`` the surface backward's texture variant and the combine
backward's env variant (``_tex_env_probe``): every launch of the 1080p
texture-and-env step and of the 480x270 lights frame's loss in the sampled
tables, the first design against the redesign, old, new, new, old, as
built and with the tap sums switched by ``kTapSink`` in ``shade.cu`` (the
taps computed but nothing added, each lane's own atomics, no block's
flush, the merges without atomics, the taps' keys and values alone), the
default instantiation and the global path beside them, a
census of the distinct keys each merge sees (a build with ``kTapCensus``)
and ptxas of both designs.  Each build must give the default
build's result (the marches
field by field, the per-ray cotangents bit for bit (every output of the
combine backward and of the fused resolve), the forward pair on
every lane both write; the miss-only build on the miss lanes; the resolve
backward's table within ``SCATTER_RTOL`` of the default build's largest
entry); each launch is timed as device time (``device_ms``), the default
build first and last, with the first design (``_old_design``) beside them.
It prints ptxas' registers, stack frame and spills of each build's
variants, and the warp slots the registers leave filled, beside the card's
name and power limit.  Without arguments it runs all of them.  There is no
CPU path.
"""

from __future__ import annotations

import re
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels import march as k1
from vrt_torch.kernels import shade as k4
from vrt_torch.kernels._timing import device_ms
from vrt_torch.render.renderer import SceneTracer

# (label, the source's constants set otherwise, threads a block)
SLAB = (
    ("default: 64 threads, 12 blocks an SM", {}, 64),
    ("64 threads uncapped", {"kSlabMinBlocks": 1}, 64),
    ("64 threads, 10 blocks an SM", {"kSlabMinBlocks": 10}, 64),
    ("64 threads, 16 blocks an SM", {"kSlabMinBlocks": 16}, 64),
    ("128 threads, 5 blocks an SM",
     {"kSlabThreads": 128, "kSlabMinBlocks": 5}, 128),
    ("256 threads uncapped (the first design's block) on the planes",
     {"kSlabThreads": 256, "kSlabMinBlocks": 1}, 256))
MARCH = (
    ("default: 64 threads, full traces 10 and any-hit 12 blocks an SM", {},
     64),
    ("full traces uncapped", {"kSceneMinBlocks": 1}, 64),
    ("any-hit uncapped", {"kAnyHitMinBlocks": 1}, 64),
    ("all 12 blocks an SM", {"kSceneMinBlocks": 12}, 64),
    ("all 16 blocks an SM", {"kSceneMinBlocks": 16, "kAnyHitMinBlocks": 16},
     64),
    ("128 threads, full traces 5 and any-hit 6 blocks an SM",
     {"kSceneThreads": 128, "kSceneMinBlocks": 5, "kAnyHitMinBlocks": 6},
     128))
SURFACE_BWD = (
    ("default: 3 blocks an SM", {}, 256),
    ("uncapped", {"kSurfaceBwdMinBlocks": 1}, 256),
    ("4 blocks an SM", {"kSurfaceBwdMinBlocks": 4}, 256))
SHADE_FWD = (
    ("default: 256 threads, surface 3 and combine 4 blocks an SM, surface "
     "fetches 1 round ahead", {}, 256),
    ("uncapped", {"kSurfaceMinBlocks": 1, "kCombineMinBlocks": 1}, 256),
    ("surface 2 blocks an SM", {"kSurfaceMinBlocks": 2}, 256),
    ("surface 4 blocks an SM", {"kSurfaceMinBlocks": 4}, 256),
    ("combine 6 blocks an SM", {"kCombineMinBlocks": 6}, 256),
    ("128 threads, surface 4 and combine 8 blocks an SM",
     {"kFwdThreads": 128, "kSurfaceMinBlocks": 4, "kCombineMinBlocks": 8},
     128),
    ("512 threads, surface 1 and combine 2 blocks an SM",
     {"kFwdThreads": 512, "kSurfaceMinBlocks": 1, "kCombineMinBlocks": 2},
     512),
    ("surface fetches 2 rounds ahead", {"kFetchDepth": 3}, 256),
    ("surface fetches flags a round at a time at a level without traces",
     {"kFlagRounds": 1}, 256),
    ("one thread a ray over the whole grid", {"kFwdResident": "false"}, 256),
    ("miss lanes only: the hit path compiled out",
     {"kFwdHitPath": "false"}, 256),
    ("colour sample compiled out", {"kFwdColorSample": "false"}, 256))
RESOLVE_BWD = (
    ("default: merged by hit cell, 16-byte reductions, 2 blocks an SM",
     {}, 256),
    ("not merged", {"kMergeRows": "false"}, 256),
    ("merged by hit cell, scalar atomics", {"kVecReduce": "false"}, 256),
    ("not merged, scalar atomics",
     {"kMergeRows": "false", "kVecReduce": "false"}, 256),
    ("uncapped", {"kBwdMinBlocks": 1}, 256),
    ("3 blocks an SM", {"kBwdMinBlocks": 3}, 256))
PYRAMID = (
    ("default: 4 blocks an SM, the last block's level 3 in shared memory",
     {}, 256),
    ("2 blocks an SM", {"kPyramidMinBlocks": 2}, 256),
    ("3 blocks an SM", {"kPyramidMinBlocks": 3}, 256),
    ("5 blocks an SM", {"kPyramidMinBlocks": 5}, 256),
    ("the last block reads level 3 from device memory",
     {"kTailBytes": 16}, 256),
    ("6 blocks an SM, 8 KB of levels in the last block (level 3 from "
     "device memory at 257^3)", {"kPyramidMinBlocks": 6, "kTailBytes": 8192},
     256),
    ("8 blocks an SM, 8 KB of levels in the last block",
     {"kPyramidMinBlocks": 8, "kTailBytes": 8192}, 256))
COMBINE_BWD = (
    ("default: resident, 256 threads, 2 blocks an SM, 1 round fetched ahead",
     {}, 256),
    ("none fetched ahead", {"kCombineBwdFetchDepth": 1}, 256),
    ("64 threads, 8 blocks an SM",
     {"kCombineBwdThreads": 64, "kCombineBwdMinBlocks": 8}, 64),
    ("128 threads, 4 blocks an SM",
     {"kCombineBwdThreads": 128, "kCombineBwdMinBlocks": 4}, 128),
    ("256 threads, 3 blocks an SM", {"kCombineBwdMinBlocks": 3}, 256))
RESOLVE_FWD = (
    ("default: 256 threads, 5 blocks an SM", {}, 256),
    ("uncapped", {"kResolveMinBlocks": 1}, 256),
    ("4 blocks an SM", {"kResolveMinBlocks": 4}, 256),
    ("6 blocks an SM", {"kResolveMinBlocks": 6}, 256),
    ("128 threads, 10 blocks an SM",
     {"kResolveThreads": 128, "kResolveMinBlocks": 10}, 128))
SURFACE_VOXELS = (
    ("default: 256 threads, uncapped", {}, 256),
    ("2 blocks an SM", {"kVoxelMinBlocks": 2}, 256),
    ("3 blocks an SM", {"kVoxelMinBlocks": 3}, 256),
    ("128 threads", {"kVoxelThreads": 128}, 128),
    ("a lane's loads gated on its flag", {"kVoxelGated": "true"}, 256),
    ("colour sample compiled out", {"kFwdColorSample": "false"}, 256),
    ("miss lanes only: the hit path compiled out",
     {"kFwdHitPath": "false"}, 256))
# the texture and env variants' table sums (tex_env), each build timing both
# designs: as built, then with the sink switched by kTapSink
TEX_ENV = (
    ("as built", {}, 256),
    ("the taps computed, nothing added", {"kTapSink": 1}, 256),
    ("each lane's own atomics, no merge", {"kTapSink": 2}, 256),
    ("merges and atomics, no block's flush", {"kTapSink": 3}, 256),
    ("merges, no atomic", {"kTapSink": 4}, 256),
    ("the taps' keys and values alone, no merge", {"kTapSink": 5}, 256))
TEX_ENV_KERNELS = ("surface_bwd_textures_kernel",
                   "surface_bwd_textures_warp_kernel",
                   "combine_bwd_env_kernel", "combine_bwd_env_warp_kernel")
SHADE_KERNELS = ("surface_resident_kernel", "combine_resident_kernel")
# the resolve backward's table against the default build's: its sums add in
# another order (chip_smoke.py's SCATTER_RTOL)
SCATTER_RTOL = 1e-5
FIELDS = ("hit", "t", "kind", "cell", "t_in", "t_out", "face_normal", "steps")
REPS = 20
# calls a launch's host time is the median of (_host_us)
HOST_LAUNCHES = 50


def _variant(source, consts, tag):
    """``csrc/<source>`` with ``consts`` set, and ``scene.cuh`` beside it,
    copied under the build directory: (path of the source, of the header)."""
    text = (_build.CSRC / source).read_text()
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr (int|bool) {name} = \w+;",
                          rf"constexpr \1 {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{source} defines {name} {n} times")
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{source.split('.')[0]}_{tag}.cu"
    path.write_text(text)
    header = out / "scene.cuh"
    shutil.copyfile(_build.CSRC / "scene.cuh", header)
    return path, header


def _builds(module, source, variants, kernels, entries):
    """Every variant of ``source`` built (in parallel), its ``entries``
    typed as ``module``'s own library types them: [(label, library,
    {kernel: ptxas usage} of ``kernels``, threads)]."""
    module.build()
    paths = [_variant(source, consts, i)
             for i, (_, consts, _) in enumerate(variants)]
    with ThreadPoolExecutor(len(paths)) as pool:
        built = list(pool.map(
            lambda ph: _build.build(str(ph[0]),
                                    getattr(module, "NVCC_FLAGS", ()),
                                    headers=[str(ph[1])]), paths))
    out = []
    for (label, _, threads), (lib, log) in zip(variants, built):
        for name in entries:
            ref, fn = getattr(module._lib, name), getattr(lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        out.append((label, lib, {k: _build.ptxas_usage(log, k)
                                 for k in kernels}, threads))
    return out


def _recorded(module, name, run):
    """Every call of ``module.name`` during ``run()``: (args, kwargs,
    result)."""
    calls, fn = [], getattr(module, name)

    def recorder(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, recorder)
    try:
        run()
    finally:
        setattr(module, name, fn)
    torch.cuda.synchronize()
    return calls


def _same_march(got, want, args, label):
    if isinstance(got, torch.Tensor):
        return torch.equal(got, want)
    return torch.equal(got[1], want[1]) and all(
        bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        if a.is_floating_point() else torch.equal(a, b)
        for a, b in ((getattr(got[0], f), getattr(want[0], f))
                     for f in FIELDS))


def _same_cotangents(got, want, args, label):
    return all(torch.equal(a, b) for a, b in zip(got[:4], want[:4])
               if a is not None)


def _same_resolve_bwd(got, want, args, label):
    """The ray gradients bit for bit, the table within ``SCATTER_RTOL`` of
    the largest entry of the default build's."""
    rays = all(torch.equal(a, b) for a, b in zip(got[:2], want[:2])
               if a is not None)
    if want[2] is None:
        return rays and got[2] is None
    scale = want[2].abs().max().item()
    return rays and (got[2] - want[2]).abs().max().item() <= \
        SCATTER_RTOL * scale


def _same_bits(got, want, args, label):
    """Every output bit for bit (NaN to NaN), None where the default
    build's is None."""
    return len(got) == len(want) and all(
        (a is None and b is None) or (
            a is not None and b is not None and _equal_where(a, b, None))
        for a, b in zip(got, want))


def _equal_where(a, b, lanes):
    """``a`` equal to ``b`` (NaN to NaN) on the rays ``lanes`` marks."""
    if lanes is not None:
        a, b = a[lanes], b[lanes]
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()) \
        if a.is_floating_point() else torch.equal(a, b)


def _same_record(got, want, args, label):
    """A surface record against the default build's on every lane both
    write: the material on hit lanes, the traces' rays on every lane of a
    level that spawns them; the miss-only build on the miss lanes."""
    mode, bounce, shadows = args[7], args[8], args[9]
    hit = args[5].hit
    miss_only = label.startswith("miss lanes only")
    mat = None if miss_only else hit
    spawns = mode.lit and (bounce or shadows)
    every = ~hit if miss_only else None
    # without the colour sample, or from another table, the albedo differs
    other_albedo = label.startswith(("colour sample compiled out",
                                     "the packed bf16 view"))
    pairs = [("n_w", mat), ("roughness", mat),
             ("metallic", mat), ("k", mat),
             ("shadow_origin", every if spawns else mat),
             ("refl_dir", every), ("gate", every)]
    if not other_albedo:
        pairs.append(("albedo", mat))
    for name, lanes in pairs:
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None):
            return False
        if a is None or (miss_only and lanes is None):
            continue
        if not _equal_where(a, b, lanes):
            return False
    for name in ("shadow_tmax", "shadow_dir"):
        for a, b in zip(getattr(got, name) or (), getattr(want, name) or ()):
            if not _equal_where(a, b, every):
                return False
    return True


def _same_rgb(got, want, args, label):
    """Combine outputs on every lane; the miss-only build's on miss
    lanes."""
    lanes = ~args[4] if label.startswith("miss lanes only") else None
    return _equal_where(got, want, lanes)


def _probe(module, fn_name, builds, calls, same):
    """Each build's launches of ``calls`` (checked with ``same`` against the
    recorded result) timed, the default build first and last, the first
    design after it: [(label, ms per launch, usage, threads)]."""
    fn = getattr(module, fn_name)
    default = module._lib

    def timed(old_design=False):
        per_launch = []
        for args, kwargs, want in calls:
            kw = dict(kwargs, _old_design=True) if old_design else kwargs
            if not same(fn(*args, **kw), want, args, label):
                raise AssertionError(f"{fn_name}: {label} changed the "
                                     f"result")
            per_launch.append(device_ms(lambda: fn(*args, **kw), REPS))
        return per_launch

    rows = []
    order = builds + [builds[0]]
    label = builds[0][0]
    try:
        for i, (label, lib, usage, threads) in enumerate(order):
            module._lib = lib
            rows.append((label + (", again" if i == len(builds) else ""),
                         timed(), usage, threads))
            if i == 0:
                module._lib = default
                label = "first design"
                rows.append((label, timed(old_design=True), None, 256))
    finally:
        module._lib = default
    return rows


def _packed_view(calls):
    """The surface launches ``calls`` on the unpacked f32 colour grid, and
    again on the packed bf16 view of the same colours (the layout of a
    scene under ``COLOR_CORNER_BUDGET_BYTES``, built here only), on the
    default build, each held against the recorded record (the albedo
    apart), in turns: [(label, ms per launch, None, threads)]."""
    import dataclasses

    from vrt_torch.render.gpuscene import pack_voxel_color_corners

    views = {}
    packed = []
    for args, kwargs, want in calls:
        scene = args[0]
        if id(scene) not in views:
            with torch.no_grad():
                views[id(scene)] = dataclasses.replace(
                    scene, voxel_color_corners=pack_voxel_color_corners(
                        scene.voxel_colors.detach(), torch.bfloat16))
        packed.append(((views[id(scene)],) + tuple(args[1:]), kwargs, want))
    rows = []
    for label, launches in (("unpacked f32 grid (default build)", calls),
                            ("the packed bf16 view (default build)", packed),
                            ("unpacked f32 grid, again", calls)):
        per = []
        for args, kwargs, want in launches:
            if not _same_record(k4.shade_surface_cuda(*args, **kwargs), want,
                                args, label):
                raise AssertionError(f"shade surface: {label} changed the "
                                     f"record")
            per.append(device_ms(lambda: k4.shade_surface_cuda(*args,
                                                               **kwargs),
                                 REPS))
        rows.append((label, per, None, 256))
    return rows


def _against_parent(parent, card, dev, config4_step):
    """The surface launches of the flagship's 1080p frame, a 1080p config6
    fit step, config3's and config7's frames (the resident kernel on packed
    colours or none) and a config4 fit step (the unpacked grid), each on
    this checkout's kernels (the default path) and on the parent checkout
    ``parent``'s ``shade.cu`` (the resident kernel on every layout, as its
    wrapper launched it) in the order parent, this, this, parent, every
    record bit-equal on the lanes both write, outputs filled with NaN
    first (``_same_record``)."""
    from pathlib import Path

    from vrt_torch.apps import bench
    from vrt_torch.diff.fit import make_fit_step
    from vrt_torch.diff.optim import adam
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scenes import flagship_scene, voxelized_torus_scene

    k4.build()
    csrc = Path(parent).resolve() / "vrt_torch" / "csrc"
    old, _ = _build.build(str(csrc / "shade.cu"), k4.NVCC_FLAGS,
                          headers=[str(csrc / "scene.cuh")])
    fn, ref = old.vrt_shade_surface, k4._lib.vrt_shade_surface
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    new, empty = k4._lib, k4._empty

    def filled(shape, dtype, device):
        return torch.full(shape, True if dtype == torch.bool
                          else float("nan"), dtype=dtype, device=device)

    def config6_step():
        scene = flagship_scene(6, use_colors=True, device=dev)
        params = bench._fit_params(scene)
        opt = adam(bench.ADAM_LR)
        step = make_fit_step(scene, [dict(position=(320.0, 0.0, 40.0),
                                          rotation=(0.0, 0.0, 1.0, 0.0),
                                          fov=60.0)], 1920, 1080,
                             RenderMode(), opt)
        targets = torch.zeros((1, 1920 * 1080, 3), device=dev)
        state = opt.init(params)
        return lambda: step(params, state, targets)

    def frame(make, w, h):
        scene = make()
        return lambda: render_image(scene, w, h, RenderMode())

    for what, make in (
            ("the flagship's 1080p frame", lambda: frame(
                lambda: flagship_scene(7, "chebyshev", torch.bfloat16,
                                       device=dev), 1920, 1080)),
            ("the config6 fit step", config6_step),
            ("config3's 1080p frame", lambda: frame(
                lambda: voxelized_torus_scene(8, device=dev)[0], 1920,
                1080)),
            ("config7's 512x512 frame", lambda: frame(
                lambda: bench.config7_scene(6, 12, device=dev), 512, 512)),
            ("the config4 fit step", config4_step)):
        calls = _recorded(k4, "shade_surface_cuda", make())
        per = []
        try:
            for args, kwargs, _ in calls:
                outs = []
                k4._empty = filled
                for lib in (old, new):
                    k4._lib = lib
                    outs.append(k4.shade_surface_cuda(
                        *args, _resident=lib is old, **kwargs))
                k4._empty = empty
                torch.cuda.synchronize()
                if not _same_record(outs[1], outs[0], args, "parent"):
                    raise AssertionError(f"{what}: this checkout's surface "
                                         f"differs from the parent's")

                def on(lib):
                    def run():
                        k4._lib = lib
                        return k4.shade_surface_cuda(
                            *args, _resident=lib is old, **kwargs)
                    return run

                per.append([device_ms(on(lib), REPS)
                            for lib in (old, new, new, old)])
        finally:
            k4._lib, k4._empty = new, empty
        olds = sum(t[0] + t[3] for t in per) / 2
        news = sum(t[1] + t[2] for t in per) / 2
        print(f"{what}'s shade surface launches on {card}: the parent "
              f"checkout's kernel, this checkout's, this, the parent's "
              f"{'; '.join(', '.join(f'{x:.4f}' for x in t) for t in per)} "
              f"ms; sums {olds:.4f} against {news:.4f} ms "
              f"({news / olds - 1:+.1%}); every record bit-equal",
              flush=True)
        del calls


def _parent_library(module, parent, source, entries):
    """``module``'s source as the parent checkout ``parent`` has it, built,
    its ``entries`` typed as ``module``'s own library types them (an entry
    that takes a new parameter last passes it on, and the parent's ignores
    it): (the parent's library, this checkout's)."""
    from pathlib import Path

    module.build()
    csrc = Path(parent).resolve() / "vrt_torch" / "csrc"
    old, _ = _build.build(str(csrc / source), module.NVCC_FLAGS,
                          headers=[str(csrc / "scene.cuh")])
    for name in entries:
        fn, ref = getattr(old, name), getattr(module._lib, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return old, module._lib


def _host_us(launch, n=HOST_LAUNCHES):
    """The host's median microseconds of one call of ``launch`` over ``n``
    calls queued on the stream (synchronized before and after; the
    wrapper's checks and allocation, the entry point and the launch)."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        launch()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def _shade_against_parent(parent, card, steps):
    """Every launch of the four shade kernels (the surface's and the
    combine's, forward and backward) and of the fused resolve's backward in
    each run of ``steps`` ((what, run): the 1080p flagship frame, config6's
    and config4's fit steps and config6's step with the materials and the
    lights), each on this checkout's ``shade.cu`` / ``resolve.cu`` and on
    the parent checkout ``parent``'s in the order parent, this, this,
    parent, with the same arguments: every launch must give the parent's
    outputs bit for bit (a surface record on the lanes it writes, the
    combine's rgb, the surface backward's per-ray cotangents, every per-ray
    cotangent of the combine backward, the resolve backward's ray
    gradients; the tables' atomics add in an order of their own: the
    corner table's within ``SCATTER_RTOL`` of its largest entry), and the
    host's median microseconds a launch (``_host_us``) in the same order.
    The material variant alone and the instance variant run this
    checkout's sums redesign against the parent's first designs, whose
    per-ray cotangents it gives bit for bit; the rest are the parent's
    kernels, the texture and env variants on a cached occupancy."""
    from vrt_torch.kernels import resolve as kr

    libs = {k4: _parent_library(k4, parent, "shade.cu", (
        "vrt_shade_surface", "vrt_shade_combine", "vrt_shade_surface_bwd",
        "vrt_shade_combine_bwd")),
            kr: _parent_library(kr, parent, "resolve.cu",
                                ("vrt_resolve_scene_bwd",))}

    def per_ray(got, want, args, label):
        # the combine backward's nine cotangents and the light variant's k
        return _same_bits(got[:10], want[:10], args, label)

    for what, run in steps:
        for module, name, same in (
                (k4, "shade_surface_cuda", _same_record),
                (k4, "shade_combine_cuda", _same_rgb),
                (k4, "shade_surface_backward_cuda", _same_cotangents),
                (k4, "shade_combine_backward_cuda", per_ray),
                (kr, "resolve_scene_backward_cuda", _same_resolve_bwd)):
            old, new = libs[module]
            calls = _recorded(module, name, run)
            if not calls:
                continue
            per, host = [], []
            try:
                for args, kwargs, got in calls:
                    def on(lib):
                        def launch():
                            module._lib = lib
                            return getattr(module, name)(*args, **kwargs)
                        return launch

                    outs = [on(lib)() for lib in (old, new)]
                    torch.cuda.synchronize()
                    if not same(outs[1], outs[0], args, "parent"):
                        raise AssertionError(
                            f"{what} {name}: this checkout's launch "
                            f"{kwargs} differs from the parent's")
                    del outs
                    per.append([device_ms(on(lib), REPS)
                                for lib in (old, new, new, old)])
                    host.append([_host_us(on(lib))
                                 for lib in (old, new, new, old)])
            finally:
                module._lib = new
            olds = sum(t[0] + t[3] for t in per) / 2
            news = sum(t[1] + t[2] for t in per) / 2
            flags = sorted({k for _, kw, _ in calls for k, v in kw.items()
                            if v is True})
            print(f"{what} {name} launches {flags or 'default'} on {card}: "
                  f"the parent checkout's, this checkout's, this, the "
                  f"parent's "
                  f"{'; '.join(', '.join(f'{x:.4f}' for x in t) for t in per)}"
                  f" ms; sums {olds:.4f} against {news:.4f} ms "
                  f"({news / olds - 1:+.1%}); every output bit-equal; the "
                  f"host's median µs a launch in the same order "
                  f"{'; '.join(', '.join(f'{x:.1f}' for x in t) for t in host)}",
                  flush=True)
            del calls


class _Slabs(SceneTracer):
    """A slab tracer over every slab of a slab-sharded volume in one
    process (``vrt_torch.render.renderer.SceneTracer``'s seam): each slab
    marched by K7 in turn, the closest hit taken as
    ``brick.combine_hits`` takes it (the first slab on a tie), and each hit
    resolved by the slab that owns its cell."""

    def __init__(self, slabs):
        self.slabs = slabs

    def march(self, scene, o_w, d_w, t_max, interp, debug_overlay=False):
        import dataclasses

        from vrt_torch.dist import brick
        from vrt_torch.march.types import MarchHit
        from vrt_torch.render.renderer import _world_to_object

        with torch.no_grad():
            o, d = _world_to_object(scene.inst_pos[0], scene.inst_rot[0],
                                    scene.inst_scale[0], o_w, d_w)
            hits = [brick.march_volume_slab(sl, o, d, t_max, interp,
                                            debug_overlay)
                    for sl in self.slabs]
            win = torch.argmin(torch.stack(
                [torch.where(h.hit, h.t, float("inf")) for h in hits]), 0)

            def pick(name):
                xs = torch.stack([getattr(h, name) for h in hits])
                idx = win.reshape((1,) + win.shape + (1,) * (xs.dim() - 2))
                return torch.gather(xs, 0, idx.expand((1,) + xs.shape[1:]))[0]

            hit = MarchHit(**{f.name: pick(f.name)
                              for f in dataclasses.fields(MarchHit)})
        return hit, torch.where(hit.hit, 0, -1).to(torch.int32)

    def resolve(self, scene, o_w, d_w, hit, inst):
        import dataclasses

        from vrt_torch.kernels import resolve as kr

        hit = dataclasses.replace(hit, cell=hit.cell.contiguous(),
                                  face_normal=hit.face_normal.contiguous())
        out = None
        for sl in self.slabs:
            got = kr.resolve_slab_cuda(scene, sl, o_w.contiguous(),
                                       d_w.contiguous(), hit,
                                       inst.contiguous())
            owned = (hit.hit & (hit.cell[:, 0] >= sl.cell_lo)
                     & (hit.cell[:, 0] < sl.cell_hi))
            mine = [owned if x.dim() == 1 else owned[:, None] for x in got]
            got = [torch.where(m, x, torch.zeros_like(x))
                   for m, x in zip(mine, got)]
            out = got if out is None else [a + b if a.dtype != torch.bool
                                           else a | b
                                           for a, b in zip(out, got)]
        return tuple(out)


def _tex_env_builds(card):
    """``TEX_ENV``'s builds of ``shade.cu`` and the census build
    (``kTapCensus``), in parallel, their entries typed as ``k4``'s: [(label,
    library)] and the census library; prints ptxas' registers and spills of
    the texture and env variants' kernels in each build, the kMat / kGrad
    instantiations apart."""
    k4.build()
    variants = TEX_ENV + (("census", {"kTapCensus": "true"}, 256),)
    paths = [_variant("shade.cu", consts, f"tex_env_{i}")
             for i, (_, consts, _) in enumerate(variants)]
    with ThreadPoolExecutor(len(paths)) as pool:
        built = list(pool.map(lambda ph: _build.build(
            str(ph[0]), k4.NVCC_FLAGS, headers=[str(ph[1])]), paths))
    out = []
    for (label, _, threads), (lib, log) in zip(variants, built):
        for name in ("vrt_shade_surface", "vrt_shade_combine",
                     "vrt_shade_surface_bwd", "vrt_shade_combine_bwd",
                     "vrt_shade_tap_census"):
            ref, fn = getattr(k4._lib, name), getattr(lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        for kernel in TEX_ENV_KERNELS:
            for last in (False, True):
                usage = _build.ptxas_usage(log, kernel, last)
                if usage is None:
                    print(f"ptxas, {label}: {kernel} (kMat / kGrad {last}): "
                          f"not in this run's log", flush=True)
                    continue
                slots = [_build.warp_slots(r, threads)
                         for r in usage["registers"][::-1]]
                print(f"ptxas, {label}: {kernel} (kMat / kGrad {last}): "
                      f"{usage['variants']} variants, registers "
                      f"{usage['registers']}, stack {usage['stack_bytes']}, "
                      f"spills {usage['spill_bytes']} bytes, warp slots "
                      f"filled {slots[0]:.0%}-{slots[1]:.0%}", flush=True)
        out.append((label, lib))
    return out[:-1], out[-1][1]


def _tex_env_probe(card, dev, runs):
    """The ``tex_env`` section: every launch of the surface backward's
    texture variant and of the combine backward's env variant in each run
    of ``runs`` ((what, run, padded): the 1080p texture-and-env step, the
    480x270 lights frame's loss in the sampled tables on the scene's own
    tables and on ``scenes.padded_sampled_tables``), each through the first
    design (``_old_table_design``) and the redesign, old, new, new, old, on
    each build of ``TEX_ENV`` (as built; the taps computed but nothing
    added; each lane's own atomics; no flush), then on the default build the
    default instantiation on the same inputs and, where ``padded``, both
    designs on the padded tables (the global path); every launch's per-ray
    cotangents bit-equal to the recorded launch's, the tables of the two
    designs reported against each other; and each launch's census on the
    census build: how many merges saw how many distinct keys among the
    lanes that add (the first design a tap at a time, the redesign a
    sample's footprint at a time)."""
    import dataclasses

    from vrt_torch.scenes import padded_sampled_tables

    builds, census_lib = _tex_env_builds(card)
    default = k4._lib
    for what, run, padded in runs:
        for name, flag in (("shade_surface_backward_cuda", "textures"),
                           ("shade_combine_backward_cuda", "env")):
            fn = getattr(k4, name)
            calls = [c for c in _recorded(k4, name, run) if c[1].get(flag)]
            n = 4 if flag == "textures" else 9 + bool(
                calls and calls[0][1].get("lights"))
            rows = {}
            try:
                for j, (args, kwargs, want) in enumerate(calls):
                    def on(lib, old, a=args, kw=kwargs):
                        def launch():
                            k4._lib = lib
                            return fn(*a, **kw, _old_table_design=old)
                        return launch

                    for label, lib in builds:
                        outs = [on(lib, old)() for old in (True, False)]
                        torch.cuda.synchronize()
                        for o in outs:
                            if not _same_bits(o[:n], want[:n], args, label):
                                raise AssertionError(
                                    f"{what} {name} {j} ({label}): the "
                                    f"per-ray cotangents differ from the "
                                    f"recorded launch's")
                        if label == builds[0][0]:
                            old_t, new_t = outs[0][-1], outs[1][-1]
                            top = old_t.abs().max().item()
                            diff = (old_t - new_t).abs().max().item()
                            print(f"{what} {name} {j}: the two designs' "
                                  f"{flag} table differ by {diff:.3e} "
                                  f"(largest entry {top:.3e})", flush=True)
                        del outs
                        rows.setdefault(label, []).append(
                            [device_ms(on(lib, old), REPS)
                             for old in (True, False, False, True)])
                    k4._lib = default
                    plain_kw = {k: v for k, v in kwargs.items() if k != flag}
                    rows.setdefault("the default instantiation", []).append(
                        [device_ms(lambda: fn(*args, **plain_kw), REPS)] * 4)
                    if padded:
                        with torch.no_grad():
                            wide = padded_sampled_tables(args[0])
                        big = (dataclasses.replace(
                            args[0], textures=wide.textures, env=wide.env),
                            ) + tuple(args[1:])
                        rows.setdefault("the padded tables (global path)",
                                        []).append(
                            [device_ms(on(default, old, big), REPS)
                             for old in (True, False, False, True)])
                    for design, old in (("first design", True),
                                        ("redesign", False)):
                        k4._lib = census_lib
                        k4.tap_census(reset=True)
                        on(census_lib, old)()
                        hist = k4.tap_census(reset=True)
                        merges = sum(hist)
                        print(f"{what} {name} {j}, {design}: {merges} merges "
                              f"by distinct keys "
                              + ", ".join(f"{k}: {c}" for k, c in
                                          enumerate(hist) if c), flush=True)
            finally:
                k4._lib = default
            for label, per in rows.items():
                olds = sum(t[0] + t[3] for t in per) / 2
                news = sum(t[1] + t[2] for t in per) / 2
                print(f"{what} {name} ({flag}) on {card}, {label}: first "
                      f"design, redesign, redesign, first design "
                      f"{'; '.join(', '.join(f'{x:.4f}' for x in t) for t in per)}"
                      f" ms; sums {olds:.4f} against {news:.4f} ms",
                      flush=True)
            del calls


def _simt_of(steps):
    """SIMT efficiency of warps of 32 consecutive lanes: the lane-steps
    taken over 32 times each warp's largest."""
    steps = steps.long()
    per = torch.nn.functional.pad(steps, (0, -steps.numel() % 32))
    issued = 32 * per.reshape(-1, 32).amax(1).sum().item()
    return steps.sum().item() / issued if issued else 1.0


def _slab_probe(card, dev):
    """The ``slab`` section (see the module's docstring)."""
    import dataclasses

    from vrt_torch.apps.scaling import scaling_rays
    from vrt_torch.dist import brick
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_rays, trace_radiance
    from vrt_torch.scenes import config5_scene, config5_slab_volume

    builds = _builds(k1, "march.cu", SLAB, ("march_slab_capped_kernel",),
                     ("vrt_march_lanes", "vrt_march_scene", "vrt_march_slab"))
    vol = config5_slab_volume(9)
    scene = config5_scene(vol, dev)
    stacked = brick.shard_volume(vol, 4)
    slabs = [stacked.local(s, dev) for s in range(4)]
    del vol, stacked
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, 1920,
                       1080)
    calls = _recorded(k1, "march_slab_cuda", lambda: render_rays(
        scene, o, d, RenderMode(), _Slabs(slabs)))
    packed = {id(sl): dataclasses.replace(sl, table="packed")
              for sl in slabs}
    for i, (args, _, got) in enumerate(calls):
        live = got.steps > 0
        print(f"config5 1080p K7 launch {i} (slab {i % 4}, "
              f"{'primary' if i < 4 else 'shadow'}) on {card}: live lanes "
              f"{int(live.sum())} of {live.numel()}; SIMT efficiency in "
              f"launch order {_simt_of(got.steps):.3f}, of dense warps of "
              f"the live lanes {_simt_of(got.steps[live]):.3f}; steps "
              f"{int(got.steps.sum())}", flush=True)
    default = k1._lib
    rows = []
    order = builds + [builds[0]]
    try:
        for j, (label, lib, usage, threads) in enumerate(order):
            k1._lib = lib
            per = []
            for args, kw, want in calls:
                if any(_hits_differ(k1.march_slab_cuda(*args, **kw), want)):
                    raise AssertionError(f"K7: {label} changed the result")
                per.append(device_ms(lambda: k1.march_slab_cuda(*args, **kw),
                                     REPS))
            rows.append((label + (", again" if j == len(builds) else ""),
                         per, usage, threads))
            if j == 0:
                k1._lib = default
                per = []
                for args, kw, want in calls:
                    old = (packed[id(args[0])],) + tuple(args[1:])
                    if any(_hits_differ(k1.march_slab_cuda(*old, **kw),
                                        want)):
                        raise AssertionError("K7's first design differs")
                    per.append(device_ms(
                        lambda: k1.march_slab_cuda(*old, **kw), REPS))
                rows.append(("first design: the packed table, 256 threads "
                             "uncapped", per, None, 256))
    finally:
        k1._lib = default
    _report("config5's 1080p K7 launches (slabs 0-3 primary, then shadow)",
            card, rows)
    del calls, packed

    # the resolve backward into each slab's planes, on scaling.py's rays,
    # the default design first and last, the first design between
    kr.build()
    o_np, d_np = scaling_rays(4096)
    ro, rd = (torch.from_numpy(x).to(dev) for x in (o_np, d_np))
    fwds = _recorded(kr, "resolve_slab_cuda", lambda: trace_radiance(
        scene, ro, rd, 0, RenderMode(), tracer=_Slabs(slabs)))
    calls = []
    gen = torch.Generator().manual_seed(0)
    for args, _, _ in fwds:
        sc, sl, o_w, d_w, hit, inst = args
        owned = (hit.hit & (hit.cell[:, 0] >= sl.cell_lo)
                 & (hit.cell[:, 0] < sl.cell_hi))
        g_t = (torch.randn(o_w.shape[0], generator=gen).to(dev) * owned)
        g_n = (torch.randn(o_w.shape, generator=gen).to(dev)
               * owned[:, None])
        calls.append((sc, sl, o_w, d_w, hit, inst, g_t.contiguous(),
                      g_n.contiguous()))

    def timed(table):
        per = []
        for args in calls:
            run = (args[0], dataclasses.replace(args[1], table=table),
                   *args[2:])
            per.append(device_ms(
                lambda: kr.resolve_slab_backward_cuda(*run), REPS))
        return per

    rows = [("default: scalar atomics into the planes", timed("planes"),
             None, 256),
            ("first design: the packed table's 1.1 GB accumulator",
             timed("packed"), None, 256),
            ("default, again", timed("planes"), None, 256)]
    _report("config5's slab resolve backwards on 4,096 rays (slabs 0-3)",
            card, rows)


def _hits_differ(a, b):
    """The fields of two MarchHits that differ (NaN equal to NaN)."""
    return [f for f in FIELDS if not _equal_where(getattr(a, f),
                                                  getattr(b, f), None)]


def _report(what, card, rows):
    for label, ms, usages, threads in rows:
        regs = []
        for kernel, usage in (usages or {None: None}).items():
            if usage is None:
                regs.append("ptxas: not in this run's log")
                continue
            slots = [_build.warp_slots(r, threads)
                     for r in usage["registers"][::-1]]
            regs.append(
                f"{kernel}: {usage['variants']} variants, registers "
                f"{usage['registers']}, stack {usage['stack_bytes']}, spills "
                f"{usage['spill_bytes']} bytes, warp slots filled "
                f"{slots[0]:.0%}-{slots[1]:.0%}")
        print(f"{what} on {card}: {label}: "
              f"{', '.join(f'{t:.4f}' for t in ms)} ms = {sum(ms):.4f} ms; "
              f"{'; '.join(regs)}", flush=True)


def main(argv=None) -> int:
    from vrt_torch.apps.probe_gather import card as card_name
    from vrt_torch.diff.fit import make_fit_step
    from vrt_torch.diff.optim import adam
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scenes import flagship_scene, shading_scene

    if not torch.cuda.is_available():
        print("probe_caps needs a CUDA card", file=sys.stderr)
        return 1
    from vrt_torch.kernels import resolve as kr

    args = list(sys.argv[1:] if argv is None else argv)
    parent = None
    if "--parent" in args:
        at = args.index("--parent")
        parent = args[at + 1]
        del args[at:at + 2]
    probes = set(args) or {
        "march", "surface_bwd", "shade_fwd", "resolve_bwd", "slab", "pyramid",
        "combine_bwd", "resolve_fwd", "surface_voxels", "tex_env"}
    dev = torch.device("cuda", 0)
    card = card_name()
    entries = ("vrt_shade_surface", "vrt_shade_combine",
               "vrt_shade_surface_bwd", "vrt_shade_combine_bwd")
    if "march" in probes:
        builds = _builds(k1, "march.cu", MARCH,
                         ("march_scene_capped_kernel",),
                         ("vrt_march_lanes", "vrt_march_scene"))
        scene = flagship_scene(7, "chebyshev", torch.bfloat16, device=dev)
        calls = _recorded(k1, "march_scene_cuda", lambda: render_image(
            scene, 1920, 1080, RenderMode()))
        _report("the 1080p interp frame's scene marches", card,
                _probe(k1, "march_scene_cuda", builds, calls, _same_march))
        del scene, calls

    def config6_step():
        # config6 (vrt/apps/bench.py bench_fit): the flagship at resolution
        # 6 with per-voxel colours, one camera, zero targets, Adam at 1e-2
        scene = flagship_scene(6, use_colors=True, device=dev)
        params = {"sdf": scene.volumes.sdf,
                  "voxel_colors": scene.voxel_colors}
        opt = adam(1e-2)
        cams = [dict(position=(320.0, 0.0, 40.0),
                     rotation=(0.0, 0.0, 1.0, 0.0), fov=60.0)]
        step = make_fit_step(scene, cams, 1920, 1080, RenderMode(), opt)
        targets = torch.zeros((1, 1920 * 1080, 3), device=dev)
        state = opt.init(params)
        return lambda: step(params, state, targets)

    def config4_step():
        # config4 (vrt/apps/bench.py bench_fit_257): the 257^3 sphere and
        # its f32 colours, 2 views of 256x256, zero targets, Adam at 1e-2
        from vrt_torch.apps import bench

        scene, cams = bench.config4_scene(8, 2, device=dev)
        params = bench._fit_params(scene)
        opt = adam(bench.ADAM_LR)
        step = make_fit_step(scene, cams, 256, 256, RenderMode(), opt)
        targets = torch.zeros((len(cams), 256 * 256, 3), device=dev)
        state = opt.init(params)
        return lambda: step(params, state, targets)

    if "combine_bwd" in probes:
        builds = _builds(k4, "shade.cu", COMBINE_BWD,
                         ("combine_bwd_resident_kernel",), entries)
        for what, make in (("the config6 fit step's", config6_step),
                           ("the config4 fit step's", config4_step)):
            calls = _recorded(k4, "shade_combine_backward_cuda", make())
            _report(f"{what} combine backwards", card,
                    _probe(k4, "shade_combine_backward_cuda", builds, calls,
                           _same_bits))
            del calls

    if "resolve_fwd" in probes:
        from vrt_torch.apps import bench

        builds = _builds(kr, "resolve.cu", RESOLVE_FWD,
                         ("resolve_lean_kernel",),
                         ("vrt_resolve_scene", "vrt_resolve_scene_bwd"))
        flagship = flagship_scene(7, "chebyshev", torch.bfloat16, device=dev)
        for what, run in (
                ("the 1080p interp frame's", lambda: render_image(
                    flagship, 1920, 1080, RenderMode())),
                ("config7's 512x512 frame's", lambda: render_image(
                    bench.config7_scene(6, 12, device=dev), 512, 512,
                    RenderMode())),
                ("the config4 fit step's", config4_step())):
            calls = _recorded(kr, "resolve_scene_cuda", run)
            _report(f"{what} fused resolves", card,
                    _probe(kr, "resolve_scene_cuda", builds, calls,
                           _same_bits))
            del calls
        del flagship

    if "surface_bwd" in probes:
        builds = _builds(k4, "shade.cu", SURFACE_BWD,
                         ("surface_bwd_merged_kernel",), entries)
        calls = _recorded(k4, "shade_surface_backward_cuda", config6_step())
        _report("the config6 fit step's surface backwards", card,
                _probe(k4, "shade_surface_backward_cuda", builds, calls,
                       _same_cotangents))
        del calls

    if "pyramid" in probes:
        from vrt_torch.apps import bench
        from vrt_torch.kernels import accel as ka

        builds = _builds(ka, "accel.cu", PYRAMID, ("pyramid_one_kernel",),
                         ("vrt_accel_pyramid", "vrt_accel_rebuild"))
        for name, make, r in (
                ("config4's 257^3 SDF", lambda: bench.config4_scene(
                    8, 2, device=dev)[0].volumes.sdf, 8),
                ("config6's two 65^3 SDFs", lambda: flagship_scene(
                    6, use_colors=True, device=dev).volumes.sdf, 6)):
            sdf = make()
            calls = [((sdf, levels), {}, ka.accel_pyramid_cuda(sdf, levels))
                     for levels in (r, 3)]
            _report(f"the accel pyramid of {name} ({r} levels, then 3)",
                    card, _probe(ka, "accel_pyramid_cuda", builds, calls,
                                 lambda got, want, args, label:
                                 torch.equal(got, want)))
            del sdf, calls

    if "resolve_bwd" in probes:
        builds = _builds(kr, "resolve.cu", RESOLVE_BWD,
                         ("resolve_bwd_merged_kernel",),
                         ("vrt_resolve_scene", "vrt_resolve_scene_bwd"))
        calls = _recorded(kr, "resolve_scene_backward_cuda", config6_step())
        _report("the config6 fit step's resolve backwards (the primary "
                "rays last)", card,
                _probe(kr, "resolve_scene_backward_cuda", builds, calls,
                       _same_resolve_bwd))
        # what the default build's launches spend apart from the table:
        # each without the table's cotangent, and the accumulator's fill
        no_table, fill = [], []
        for args, _, got in calls:
            no_table.append(device_ms(lambda: kr.resolve_scene_backward_cuda(
                *args[:7], rays_grad=got[0] is not None, table_grad=False),
                REPS))
            rows, ch = got[2].shape
            fill.append(device_ms(lambda: kr.accumulator(rows, ch, dev),
                                  REPS))
        print(f"the config6 fit step's resolve backwards on {card}: without "
              f"the table's cotangent {', '.join(f'{t:.4f}' for t in no_table)}"
              f" ms; the accumulator's fill alone "
              f"{', '.join(f'{t:.4f}' for t in fill)} ms", flush=True)
        del calls

    def material_step():
        # config6's step with the material constants and the directional
        # light among the parameters (chip_smoke.py's phase 8)
        scene = flagship_scene(6, use_colors=True, device=dev)
        keys = ("sdf", "voxel_colors", "tint", "roughness", "metallic", "k",
                "dir_light_dir", "dir_light_strength")
        params = {k: scene.volumes.sdf if k == "sdf" else getattr(scene, k)
                  for k in keys}
        opt = adam(1e-2)
        cams = [dict(position=(320.0, 0.0, 40.0),
                     rotation=(0.0, 0.0, 1.0, 0.0), fov=60.0)]
        step = make_fit_step(scene, cams, 1920, 1080, RenderMode(), opt)
        targets = torch.zeros((1, 1920 * 1080, 3), device=dev)
        state = opt.init(params)
        return lambda: step(params, state, targets)

    def pose_step():
        # chip_smoke.py's phase 8: config6's SDF, colours and instance
        # transforms among the parameters
        scene = flagship_scene(6, use_colors=True, device=dev)
        keys = ("sdf", "voxel_colors", "inst_pos", "inst_rot", "inst_scale")
        params = {k: scene.volumes.sdf if k == "sdf" else getattr(scene, k)
                  for k in keys}
        opt = adam(1e-2)
        cams = [dict(position=(320.0, 0.0, 40.0),
                     rotation=(0.0, 0.0, 1.0, 0.0), fov=60.0)]
        step = make_fit_step(scene, cams, 1920, 1080, RenderMode(), opt)
        targets = torch.zeros((1, 1920 * 1080, 3), device=dev)
        state = opt.init(params)
        return lambda: step(params, state, targets)

    def texture_step():
        # chip_smoke.py's phase 8: the shading scene at 1080p from its own
        # camera, the texture scale, the textures and the env among the
        # parameters beside the material constants and the sun
        scene = shading_scene(6, 2, 1, colors=False, accel_mode="chebyshev",
                              march_dtype=torch.bfloat16, device=dev)
        keys = ("sdf", "tint", "roughness", "metallic", "tex_scale",
                "textures", "env", "dir_light_strength")
        params = {k: scene.volumes.sdf if k == "sdf" else getattr(scene, k)
                  for k in keys}
        opt = adam(1e-2)
        cams = [dict(position=scene.cam_pos, rotation=scene.cam_rot,
                     fov=scene.cam_fov)]
        step = make_fit_step(scene, cams, 1920, 1080, RenderMode(), opt)
        targets = torch.zeros((1, 1920 * 1080, 3), device=dev)
        state = opt.init(params)
        return lambda: step(params, state, targets)

    if "tex_env" in probes:
        from vrt_torch.scenes import padded_sampled_tables

        def table_loss(scene):
            # chip_smoke.py's phase 3: a seeded weighting of the 480x270
            # frame differentiated in the texture scale, the textures and
            # the env
            import dataclasses

            import numpy as np

            from vrt_torch.render.gpuscene import TEXTURE_FIELDS

            weights = torch.from_numpy(np.random.default_rng(0).normal(
                size=(270, 480, 3)).astype(np.float32)).to(dev)

            def run():
                leaves = {f: getattr(scene, f).detach().clone()
                          .requires_grad_(True) for f in TEXTURE_FIELDS}
                rgb = render_image(dataclasses.replace(scene, **leaves),
                                   480, 270, RenderMode())
                return torch.autograd.grad((rgb[..., :3] * weights).sum(),
                                           list(leaves.values()))
            return run

        lights = shading_scene(6, 2, 1, device=dev)
        _tex_env_probe(card, dev, (
            ("the 1080p texture-and-env step's", texture_step(), True),
            ("the 480x270 lights frame's (own tables)", table_loss(lights),
             True),
            ("the 480x270 lights frame's (padded tables)",
             table_loss(padded_sampled_tables(lights)), False)))
        del lights

    if "shade_bwd" in probes and parent is not None:
        flagship = flagship_scene(7, "chebyshev", torch.bfloat16, device=dev)
        _shade_against_parent(parent, card, (
            ("the 1080p interp frame's", lambda: render_image(
                flagship, 1920, 1080, RenderMode())),
            ("the config6 fit step's", config6_step()),
            ("the config4 fit step's", config4_step()),
            ("the config6 material-and-light step's", material_step()),
            ("the config6 pose step's", pose_step()),
            ("the 1080p texture-and-env step's", texture_step())))
        del flagship

    if "surface_voxels" in probes:
        from vrt_torch.apps import bench

        builds = _builds(k4, "shade.cu", SURFACE_VOXELS,
                         ("surface_voxels_kernel",), entries)
        c4, _ = bench.config4_scene(8, 2, device=dev)
        for what, run in (
                ("the config4 fit step's", config4_step()),
                ("the 512x512 frame of config4's scene:", lambda:
                 render_image(c4, 512, 512, RenderMode())),
                ("the 1080p frame of config4's scene:", lambda:
                 render_image(c4, 1920, 1080, RenderMode()))):
            calls = _recorded(k4, "shade_surface_cuda", run)
            rows = _probe(k4, "shade_surface_cuda", builds, calls,
                          _same_record)
            rows.insert(2, ("the resident kernel (forced)", [
                device_ms(lambda: k4.shade_surface_cuda(
                    *args, _resident=True, **kwargs), REPS)
                for args, kwargs, _ in calls], None, 256))
            _report(f"{what} shade surface launches", card, rows)
            del calls
        del c4
        if parent is not None:
            _against_parent(parent, card, dev, config4_step)

    if "shade_fwd" in probes:
        builds = _builds(k4, "shade.cu", SHADE_FWD, SHADE_KERNELS, entries)
        for what, scene, w, h, mode in (
                ("the 1080p interp frame's",
                 flagship_scene(7, "chebyshev", torch.bfloat16, device=dev),
                 1920, 1080, RenderMode()),
                ("the 1080p cube frame's",
                 flagship_scene(7, "chebyshev", torch.bfloat16, device=dev),
                 1920, 1080, RenderMode(interp=False)),
                ("the 480x270 frame with 2 point lights and a spot light:",
                 shading_scene(6, 2, 1, device=dev), 480, 270,
                 RenderMode())):
            for stage, same in (("surface", _same_record),
                                ("combine", _same_rgb)):
                name = f"shade_{stage}_cuda"
                calls = _recorded(k4, name, lambda: render_image(
                    scene, w, h, mode))
                _report(f"{what} shade {stage} launches", card,
                        _probe(k4, name, builds, calls, same))
                del calls
            del scene
        # config4's two views: the surface on the unpacked f32 grid, then on
        # the packed bf16 view of the same colours
        step = config4_step()
        for stage, same in (("surface", _same_record),
                            ("combine", _same_rgb)):
            name = f"shade_{stage}_cuda"
            calls = _recorded(k4, name, step)
            _report(f"the config4 fit step's shade {stage} launches", card,
                    _probe(k4, name, builds, calls, same))
            if stage == "surface":
                _report("the config4 fit step's shade surface launches",
                        card, _packed_view(calls))
            del calls
        del step
    if "slab" in probes:
        _slab_probe(card, dev)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
