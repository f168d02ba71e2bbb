"""Smoke run of the PyTorch/CUDA port (``vrt_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device  -- needs a CUDA card; prints its name and power limit,
2. build   -- compiles the march K1 (per-lane and scene kernels) with K7
             (the slab march, the same source), the
             gather library (GP-A, GP-B, GP-C), the row gather K3, the fused
             resolve (forward and backward), the four shade kernels K4
             (surface and combine, forward and backward), the corner
             table's pack and its backward (both designs), the accel
             rebuild (the occupancy pyramid, both designs, and the
             rebuild) and the fit step's Adam update from
             ``vrt_torch/csrc/``, one nvcc each, and the import's native
             library (``vrt_torch/native/vrtnative.cpp``) with g++, all in
             parallel, and prints
             ptxas' register and spill lines, K1's per-lane kernel and K7
             side by side, and for the redesigned
             kernels (the capped scene march, the merged surface backward,
             the resident surface and combine kernels, the merged resolve
             backward, the tiled pack backward, the one-launch pyramid,
             the texture and env variants of the shade backward kernels)
             and their first designs and the accel and Adam kernels the
             registers, stack
             frames, spills and the warp slots the registers leave filled,
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
             any-hit launches against its ``hit``, and against its first
             design on the same inputs (equal field by field), the two
             designs timed old, new, new, old, with each launch's SIMT
             efficiency in launch order and in 8x4 pixel tiles (from the
             plain version's steps);
             the fused resolve: the three launches of a 1080p frame, and the
             three of a 1080p config6 fit step (a graph is recorded), against
             ``resolve_scene_reference`` with a plain gather (equal, NaN
             equal to NaN), and against its first design with both
             designs' outputs filled with NaN first (bit-equal on every
             lane), the two timed old, new, new, old; so are config3's,
             the engine frames', config7's and config4's launches, and in
             phase 11 the slab resolve over the planes;
             the two shade kernels K4 (surface, then combine): every launch
             of the three 1080p frames, of an unlit 1080p frame and of 480x270
             frames of a textured scene with two point lights and a spot
             light, without and with per-voxel colours, against the plain
             stages ``shade_surface_reference`` / ``shade_combine_reference``
             on the same inputs (floats within 1e-5 + 1e-4 * |plain| on every
             lane, the gate and the ``t_max = -inf`` masks as lane flips
             under 0.1% of lanes; the outputs that are bit-equal are named),
             and each launch again on the first design with both designs'
             outputs filled with NaN first: bit-equal on every lane (the
             same lanes written), the redesign's material unwritten on miss
             lanes, the two timed old, new, new, old, the redesign's
             launches counted by path (``shade_path``);
             the fused resolve's backward: the three launches of that fit
             step against ``resolve_scene_backward_reference`` on the same
             saved inputs and cotangents (ray gradients within 1e-5 * max|g|,
             the table's within 1e-5 * max|sum| of the closed form summed in
             float64), and against its first design on the same inputs (ray
             gradients bit-equal, its table held as the redesign's, the two
             timed old, new, new, old, with the row reductions each issues
             as counted on the host and the bound's share);
             the shade kernels of that fit step (through the Functions
             ``ShadeSurface`` / ``ShadeCombine``): its 3 + 3 forward launches
             as the frames' above, and its 3 + 3 backward launches against
             ``shade_surface_backward_reference`` /
             ``shade_combine_backward_reference`` (autograd of the plain
             stages) on the same inputs and cotangents (every per-ray
             cotangent within 1e-4 * |plain| + 1e-5 * the launch's largest
             |plain| on every lane, the colour table's within 1e-5 * max|sum|
             of the plain version summed in float64), timed with their bound,
             the surface backward also against its first design on the same
             inputs (per-ray cotangents bit-equal or not, said; its colour
             table within the same tolerance; old, new, new, old) with the
             colour rows' contention (distinct rows, most hits on a row,
             rows a warp), the combine backward against its first design
             with both designs' outputs filled with NaN first (all nine
             cotangents bit-equal; old, new, new, old) and its launches
             counted by path;
             the backward kernels' variants: every launch of the material
             and light variants in a loss on the 480x270 frames above
             differentiated in the materials and the lights, and of the
             texture and env variants in one differentiated in the texture
             scale, the textures and the env, on the scene's own tables
             (their sums in shared memory) and on the same texels in a
             [3,256,256,3] stack with the env at twice its side (f32
             atomics into the tables), against their plain versions (the
             per-ray cotangents as above, each table entry within 1e-5 of
             its lanes' sum of |terms|, the stack's padding zero) and the
             default instantiation on the same inputs (per-ray cotangents
             bit-equal; default, variant, variant, default), each texture
             and env launch also on its first design
             (``_old_table_design``: per-ray cotangents bit-equal, tables
             held the same way; first design, redesign, redesign, first
             design); and every
             launch of the surface and the resolve backward's instance
             variants in a loss differentiated in the instance transforms
             on the 480x270 lights frame and on config7's 12 instances at
             512x512, each with its first instance posed
             (``scenes.posed_instances``: a quaternion of norm 1.05, an
             uneven scale), held the same way (``_instance_calls``);
             K3: every launch of one 1080p frame on the candidate-loop path,
             of one config6 fit step with eager shading (the colour rows:
             the default step launches no K3), and of one with resolve on the
             plain path (the 9-channel corner rows) against the plain
             versions (gathers equal, scatters within 1e-5 * max|sum| of a
             float64 ``index_add_``), each scatter on its own path and, where
             that is the 16-byte one, on the scalar path too, and against the
             library calls ``src[idx]`` and ``index_add_``,
4. frame   -- the 1920x1080 flagship frame three times after a warm-up, in
             interp mode, in cube mode and with the overlay, with the launch
             counts of those frames (per frame 5 scene marches, 3 fused
             resolves, 3 + 3 shade launches, no per-lane K1 launch, no K3
             gather); then the frame on the candidate-loop path (per-lane K1
             launches between eager glue, resolve through K3) against the
             default path, the frame with eager shading (the plain stages)
             against the two shade kernels, and the frames (interp, cube,
             overlay) on the first designs of the scene march and the shade
             forward pair against the redesigns (launches and paths
             asserted), each in one call in the order old, new, new, old,
             medians of 5,
5. anchor  -- the 160x90 frame against the image ``vrt`` renders on the CPU
             (``tests/fixtures/flagship_r7_cheb_bf16_160x90.npy``), and the
             160x90 cube-mode unlit frame against its own ``vrt`` fixture,
             both through the shade kernels,
6. profile -- one 1080p frame under ``torch.profiler``: device busy time,
             the kernels' shares of it, the operators that take the most
             time; at most 400 device operations, no ``aten::sort``, no
             ``aten::index`` and no ``aten::cat`` of ray-sized tensors among
             them,
7. gather  -- the gather probe (``vrt_torch.apps.probe_gather``): every
             case once through its kernel on every load path, with the
             launches counted, then each output against its plain version
             (equal, or the run fails), both timed, with the library call
             and the bound; GP-C also against its first design (the tensor
             cores: the same bits), the two timed old, new, new, old,
8. fit     -- config6 of ``vrt/apps/bench.py``: the 1920x1080 fit step of
             the flagship at resolution 6 with per-voxel colours, SDF and
             colours optimized by Adam (lr 1e-2) towards zero targets; one
             warm-up step, then three timed, with the launches per step (5
             scene marches, 3 fused resolves forward and 3 backward, 3 + 3
             shade kernels forward and 3 + 3 backward, the accel rebuild
             (``RebuildAccel``: 1 pyramid launch and 1 rebuild, f32 with
             the accel folded in), 1 pack backward and 1 Adam launch
             (``Adam.apply`` over both leaves), no first-design pack, no
             K3, no per-lane K1), peak device memory and the losses; the
             rebuild and the pack backward of one step against their plain
             versions and first designs (``_rebuild_calls``: the pyramid
             against the plain pyramid and its first design in 2 launches,
             the accel, its u8 view and the table bit for bit,
             the SDF's gradient bit-equal to the first design and within
             ``PACK_GRAD_RTOL`` of the plain version), each timed old, new,
             new, old with its bound, the rebuild also against the eager
             ``build_accel`` + ``_accel_u8`` + the first design's pack;
             ``rebuild_accel`` dispatching no eager op (``REBUILD_OPS``)
             and launching the pyramid once and the rebuild once; the
             step's Adam launch against its plain version (``_adam_held``:
             bit for bit on every leaf, timed plain, new, new, plain beside
             ``torch.optim.Adam(fused=True)`` and the bound); the
             step with resolve on
             the plain path over K3, the step with eager shading (the plain
             stages under autograd) and the step on the first designs of the
             scene march, the shade forward pair, the surface backward and
             the resolve backward (launches and paths asserted), each
             against the default
             path (old, new, new, old, medians of 3), with the device ops
             (launch calls; the default step's held to ``FIT_STEP_OPS`` on
             one profile) and device records, busy time and
             peak memory of a step on each; the card's loss and gradients at 64x36
             (through the backward kernels, launches asserted) against
             ``vrt``'s (``tests/fixtures/fit_flagship_r4_colors_64x36.npz``);
             config6's step with the material constants and the sun among
             its parameters, and the shading scene's 1080p step (three
             textures, an 8x8 env, 2 point lights and a spot light;
             chebyshev, bf16) with the texture scale, the textures, the
             env, the material constants and the sun's strength, each on
             the backward kernels' variants (one launch of the texture and
             material, one of the env and light variant a level) against
             the plain pair under autograd (old, new, new, old: the
             kernels' medians of 3, one plain step a side), with their
             launches, losses and gradients against the plain route's
             float64 sums, device ops, busy time and peak memory, the
             texture-and-env step also with the texture and env variants on
             their first designs (old, new, new, old, medians of 3, its own
             profile), and every
             variant launch of one step held as in phase 3; and config6's
             pose step (``POSE_STEP_KEYS``: the SDF, the colours and the
             instance transforms) on the surface and the resolve backward's
             instance variants (3 of each, no K3, no plain stage) against
             the plain route (eager shading, resolve on the plain path
             over K3), its transforms held entry by entry against the same
             step with the backward on the plain versions;
             then ``python -m vrt_torch.apps.fit`` at its defaults, whose
             last loss must be under a quarter of its first,
9. engine  -- the engine path.  A host ``Scene`` of the flagship's two 129^3
             volumes, camera and light -> ``Scene.to_gpu`` (chebyshev, an f32
             corner table), whose 1080p frame must equal the frame of the
             same scene built by ``build_scene`` directly, bit for bit.
             ``Engine(instance, 1920, 1080)`` over it, the objects moving
             every frame: 12 frames pipelined and 12 synchronous, each with 5
             scene marches, 3 fused resolves, 3 + 3 shade launches, no per-lane
             K1 and no K3 launch;
             after every incremental ``sync_gpu`` the volume, accel, texture
             and env tensors are the ones before it, and a ``set_voxel``
             forces a rebuild; every scene-march, fused-resolve and shade
             launch of the loop's first and last frame against its plain
             version, as in phase 3; ``last_frame`` is uint8 [1080, 1920, 4] and equals the
             UNORM of ``render_image`` on the same synced scene; ms per
             frame, per incremental and full sync, per resize + UNORM +
             readback, the upload of the per-frame constants as one pinned
             block against one pageable copy per array (with a frame in
             flight), and the device-busy share of a frame.
             ``render_scale=0.71`` at 1080p (within 1 LSB of
             ``F.interpolate`` on the CPU of the same low-resolution frame).
             The CLIs at 1080p: ``vrt_torch.apps.demo`` (its last PNG read
             back equal to ``engine.last_frame``) and
             ``vrt_torch.apps.render`` on ``assets/torus.vox`` with
             ``assets/skybox.dds``,
10. import -- the import chain and config3 of ``vrt/apps/bench.py``: the
             native library of phase 2 loads, with g++'s time; a
             9,216-triangle torus, written as a glTF mesh, is voxelized
             through it at 257^3 (the numpy voxelizer refused), written to
             and read from its ``.vox`` file and built with the chebyshev
             accel and a bf16 corner table, no colour table
             (``vrt_torch.scenes.voxelized_torus_scene``), each step timed on
             the host; its 1920x1080 frame three times after a warm-up, with
             the launches of those frames asserted (2 scene marches, 1 fused
             resolve, 1 + 1 shade launches a frame), a profile of one (at
             most 400 device ops; taken again where CUPTI dropped records at
             the start of the trace); every scene-march, fused-resolve and
             shade launch of one frame against its plain version at phase 3's
             gates, with the lanes on the iteration cap, each kernel's time
             and its bound at 257^3; the 160x90 frame against ``vrt``'s CPU
             render (``tests/fixtures/config3_r8_cheb_bf16_160x90.npy``) at
             phase 5's tolerance; ``python -m vrt_torch.apps.voxelize`` (the
             same grid) and ``python -m vrt_torch.apps.render`` at 1080p
             (the PNG read back) in processes of their own.
11. config5 -- config5 of ``vrt/apps/scaling.py``: its 513^3 CSG volume
             (``vrt_torch.scenes.config5_slab_volume``, baked on the host in
             threads) split by ``shard_volume`` into 4 x-slabs, one a model
             rank; the 4 ranks are processes (``spawn``) on this one card,
             joined over gloo through a ``FileStore`` (NCCL needs a card a
             rank), each loading the kernels built in phase 2.  Each rank
             renders ``render_slab_image`` of the stub scene at 1920x1080
             three times after a warm-up (launches asserted: 2 K7, 1 slab
             resolve, 1 + 1 shade a frame, no scene march; host clock from
             a barrier, and the collectives' host seconds), and at 160x90;
             a 1080p frame's peak memory on the slab's planes and on the
             first design's packed table (``SlabVolume(table="packed")``);
             every K7 launch of a 480x270 and a 1080p frame against
             ``march_volume_slab_reference`` and against its first design
             field by field (no lane on the step cap), every slab-resolve
             launch against ``resolve_slab_hits`` on the lanes whose hit
             the rank owns (equal, NaN equal to NaN) and against its first
             design bit for bit but on surface hits the rank does not own,
             the 1080p launches of both designs timed old, new, new, old
             while the other ranks wait at a barrier, with K7's bound, live
             lanes, SIMT efficiency and registers (K7's redesign no slower
             than its first design over the 4 ranks) and each rank's
             primary march steps; then rank 2 edits a plane that rank 1
             holds as a halo, and after ``exchange_halos`` every slab equals
             a fresh ``shard_volume`` of the edited volume.  The 1080p frame
             must lie within ``tests/test_slab_render.py``'s gates of the
             replicated ``render_image`` of the same volume (f32 table,
             octree accel), and the 160x90 frame within phase 5's tolerance
             of ``vrt``'s CPU render
             (``tests/fixtures/config5_r9_slab4_160x90.npy``).  Last, the
             flagship frame at 1080p split over 2 data ranks
             (``render_image_sharded``), equal to ``render_image`` bit for
             bit, with its launches asserted (5 scene marches, 3 resolves,
             3 + 3 shade a frame on each rank).
12. slabfit -- the training half of the distribution layer.  config5's
             fit step (``make_slab_fit_step``) on phase 11's 513^3 slabs
             over the same 4 model ranks, with ``vrt/apps/scaling.py``'s
             traffic (4096 rays from ``default_rng(0)``, targets of 0.4,
             Adam at 1e-2) on the first design's packed table and on the
             planes, old, new, new, old: each a warm-up, then 3 steps timed
             on the host from a barrier, with each rank's collectives' host
             seconds, peak ``max_memory_allocated``, the table packs counted
             and a profile's busy time and top kernels, and its launches
             asserted (per step 2 K7, 1 slab resolve forward and 1
             backward, 1 + 1 shade forward and 1 + 1 backward; no scene
             march, no K3); on the planes no pack (and under
             ``PACK_KERNEL_MS`` of cat kernels), a pack a step on the table,
             and a peak at least ``SLABFIT_PEAK_GAIN_GB`` below the table's;
             the slab resolve backward's launch of one step on every rank
             against autograd of ``resolve_slab_hits`` and the closed form
             summed in float64 (the planes' gradient within
             ``SCATTER_RTOL``, the ray gradients within ``RAY_GRAD_RTOL``
             and bit-equal to both designs of the packed table, whose
             gradient carried through the pack agrees too), timed with the
             first design (old, new, new, old), its table's pack and pack
             backward, the closed form and its bound while the other ranks
             wait; the step's plane gradients against the same
             step on the plain slab resolve (``FIT_*`` gates); the 12x12
             step on tests/test_brick.py's 33^3 volume against ``vrt``'s
             (``tests/fixtures/slab_fit_r5_slab4_12x12.npz``: loss and
             gradient at the ``FIT_*`` gates); over a 2x2 mesh the crossed
             step (``make_slab_fit_step_crossed``) at 129^3 against the 1x2
             step on the same rays.  config6's DP step
             (``make_fit_step_dp``, 1920x1080 over 2 data ranks, Adam at
             1e-2: launches, host median, collectives, busy time, peak
             memory) and one SGD step of it against ``make_fit_step`` on
             one rank (loss and gradient at the ``FIT_*`` gates, the
             replicas bit-equal).  One Adam launch a step on every rank of
             the slab, crossed and DP steps, the slab step's on each
             rank's planes and the crossed step's (with Adam once) held
             bit for bit against its plain version and timed while the
             other ranks wait.  Last ``python -m vrt_torch.apps.scaling
             --res 9 --rays 4096 --steps 3 --shards 1 2 4`` in a process of
             its own, its rows and summary printed (S ranks share this one
             card: the efficiencies are one card's).
13. bench  -- ``python -m vrt_torch.apps.bench --configs 1 2 3 8 4 6 7 5``
             (``vrt/apps/bench.py``'s eight cells) in a process of its own:
             eight rows with ``vrt``'s labels in ``vrt``'s order under a
             title naming the card, printed.  config7 (12 instances of two
             resolution-6 volumes, 512x512): three frames with their
             launches asserted; every scene-march launch of one frame
             against its plain version (the 0.1% gate) and its first design
             (old, new, new, old), with SIMT efficiency and the lanes on the
             step cap; every fused-resolve and shade launch against its
             plain version; the 64x64 frame against ``vrt``'s CPU render
             (``tests/fixtures/config7_r6_64x64.npy``) at the f32 golden
             tolerances.  config4 (the 257^3 sphere with per-voxel colours
             and a bf16 corner table, 2 views of 256x256, Adam at 1e-2):
             its colours above ``COLOR_CORNER_BUDGET_BYTES``, so the f32
             [1,257,257,257,3] grid with no packed view, sampled by the
             surface kernels' unpacked layout; three steps with their
             launches (the pyramid, the rebuild, the pack backward and
             Adam once a step, the first design's pack and the colour
             repack never) and peak memory; every kernel launch of one
             step, forward and backward, the rebuild's, the pack
             backward's (``_rebuild_calls``) and Adam's (``_adam_held``)
             among them, against its plain version; one step whose
             ``Adam.apply`` runs under ``set_sync_debug_mode("error")``
             (no synchronising call); the step's gradients against the
             same step on the plain stages (``FIT_COS_TOL``; the f32 colour
             grid's at ``FIT_DIFF_TOL``, the SDF's at ``BF16_DIFF_TOL`` for
             the bf16 table's rounding); a profile (busy time) and peak
             memory, ``rebuild_accel``, ``build_accel`` on the kernels and
             eager, and the eager ``_accel_u8`` each timed alone.
Last, two yardsticks that the port uses nowhere: the 1080p frame with eager
shading captured into one CUDA graph and replayed (the run fails unless the
capture succeeds and the replay gives the eager frame), and ``torch.compile``
of the two plain stages on that frame's inputs (reported as not measured
where it does not compile).

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
CONFIG3_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "config3_r8_cheb_bf16_160x90.npy")
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
# the backward, from csrc/resolve.cu: the weights and their derivatives,
# three fields with nine derivatives, F'(t0), the normal's and the hit
# point's pull-back and the 56 products of the row cotangents
RESOLVE_BWD_FLOPS = 900
# the two shade kernels, from csrc/shade.cu, per hit lane: the surface
# kernel's frame (hit point, transforms, world normal, mirror ray), one
# triplanar sample of 12 taps, the colour sample, one point or spot light;
# the combine kernel's Cook-Torrance term per light, the env lookup per miss
# lane, Reinhard and gamma per pixel
SHADE_FLOPS = dict(surface=170, tri_sample=190, colors=260, light=45,
                   radiance=115, env=60, tonemap=30)
# the two backward kernels, from csrc/shade.cu, per hit lane: the surface
# backward's frame recomputed and pulled back (world normal, mirror ray,
# quaternions), one triplanar sample recomputed with its 12 taps' uv
# derivatives, the colour sample and its 24 row cotangents; the combine
# backward's Cook-Torrance term recomputed and transposed per light, a point
# or spot light's direction and intensity pulled back, the env lookup's
# derivative per miss lane
SHADE_BWD_FLOPS = dict(surface=450, tri_sample=420, colors=560,
                       radiance=330, light=110, env=110)
# a float of a shade kernel against its plain stage: torch's reductions over
# 3, 4 and 8 elements and its pow round in an order of their own, and a
# comparison that feeds a select (a texel's floor, the cube face, a light's
# floor) may flip, so a float is held to SHADE_ATOL + SHADE_RTOL * |plain| on
# all but SHADE_FLOAT_BUDGET of the lanes; the record's booleans (the gate,
# the t_max = -inf masks) may flip on LANE_BUDGET of them
SHADE_RTOL, SHADE_ATOL = 1e-4, 1e-5
SHADE_FLOAT_BUDGET = 0.0
# an element of a backward kernel's per-ray cotangent against its plain
# version (autograd of the plain stage): within SHADE_GRAD_RTOL * |plain| +
# SHADE_GRAD_ATOL * the launch's largest |plain| cotangent, on all but
# SHADE_GRAD_LANE_BUDGET of the lanes (a cotangent that cancels to 0 in the
# plain version keeps a residue of rounding in the kernel).
# The GGX term of a smooth mirror, 1 + (a^2 - 1) (n.h)^2 with n.h near 1,
# cancels to about a^2 and so turns the last bit of a dot product into a
# relative 1e-5 and more, in the forward as in the backward
SHADE_GRAD_RTOL, SHADE_GRAD_ATOL = 1e-4, 1e-5
SHADE_GRAD_LANE_BUDGET = 0.0
# device operations of a 1080p frame (3,111 before the shade kernels), and
# of a config6 fit step: 6,676 with eager shading under autograd; through
# the shade Functions what is left is the scene marches and resolves, the
# twelve shade launches, rebuild_accel, the corner and colour repacks,
# Adam, the camera rays, the tonemap and the loss: 451 on the first run on
# the card (NVIDIA H100 80GB HBM3, 700 W); with the corner table's eager
# pack and its autograd backward (slices, casts, a stack; zeroed buffers
# and adds) replaced by the pack kernel pair, 389 in every profile on that
# card (452 with the eager pack); with the eager build_accel (sign, seven
# compares and ORs, per level an amax, a compare, three repeat_interleaves
# and a masked_fill) and _accel_u8 (in graft_params' and rebuild_accel's
# replace of the volume) replaced by the accel kernels (2 pyramid launches
# and 1 rebuild in place of the pack), 318 (vrt_torch/apps/probe_step.py,
# parent and change in turns: 389 and 318 in every profile); with Adam's
# eager passes, its host-to-device copies and 2 pyramid launches replaced
# by one Adam launch and one pyramid launch, 290 (probe_step.py, parent
# and change in turns: 318 and 290 in every profile).  The count follows
# the
# code, not the data, but for the few ops of a level whose shadows are not
# traced: a step back on eager shading, or a stage that falls back to eager
# ops, leaves the range.  Counted by the host's launch calls (``_profile``):
# the device records of one profile in twenty came up short, by 1 to 79 at
# the start of the trace, while the launch calls held at 452 in 80 profiles
# (``vrt_torch/apps/probe_profiler.py``)
FRAME_OPS_MAX = 400
FIT_STEP_OPS = range(290 - 10, 290 + 10 + 1)
# f32 operations of the Adam kernel an element (csrc/optim.cu): the two
# moments (7), the bias corrections, root and quotient (6), p + u (1)
ADAM_FLOPS = 14
# the corner pack's backward adds a voxel's at most 8 cotangents in
# autograd's order: held to PACK_GRAD_RTOL * max|g| of the plain version
# (the slices' transpose), bit-equality reported
PACK_GRAD_RTOL = 1e-6
# what rebuild_accel may dispatch on CUDA tensors: RebuildAccel's
# allocations and views; an eager op of build_accel or _accel_u8 (sign,
# compares, amax, repeat_interleave, masked_fill, shifts, casts) fails
REBUILD_OPS = ("empty", "empty_strided", "detach", "alias", "view",
               "_unsafe_view", "as_strided")
# K3's f32 atomics add in another order on every run: its scatter is held
# to SCATTER_RTOL * max|sum| of an exact (float64) sum; so are the table
# gradients of the fused resolve's backward, and its ray gradients to
# RAY_GRAD_RTOL * max|g| of the plain closed form (another order of sums)
SCATTER_RTOL = 1e-5
RAY_GRAD_RTOL = 1e-5
# an entry of a material or light table, summed by a backward variant's
# blocks, is held to SCATTER_RTOL times the sum of its own lanes' |terms|
# (each term rounds on its own, and the terms may cancel) plus TABLE_ATOL
TABLE_ATOL = 1e-12
# config6's camera (vrt/apps/bench.py bench_fit)
FIT_CAMS = [dict(position=(320.0, 0.0, 40.0), rotation=(0.0, 0.0, 1.0, 0.0),
                 fov=60.0)]
# the card against vrt's CPU fit gradient (fixture): the loss to FIT_LOSS_RTOL,
# each gradient to a cosine of 1 - FIT_COS_TOL and a largest difference of
# FIT_DIFF_TOL * max|g| (atomics and the card's own rounding of the
# shading math move the gradients in their last bits)
FIT_LOSS_RTOL, FIT_COS_TOL, FIT_DIFF_TOL = 1e-5, 1e-8, 1e-4
# config4's bf16 tables: each table cotangent is an f32 sum rounded once
# to bf16, and the plain path (K3's scatter, autograd) adds in another order
# than the kernels, so an entry may land one bf16 step (2^-8 of itself)
# from the other's: the SDF and colour gradients of the two are held to
# FIT_COS_TOL and to a largest difference of one bf16 step of the largest
# |g| (the kernel step against itself gives the same bits)
BF16_DIFF_TOL = 2.0 ** -8
# the threads a block of the two kernels redesigned last, as csrc/shade.cu
# (kCombineBwdThreads) and csrc/resolve.cu (kResolveThreads) set them: the
# warp slots their registers leave filled are counted for blocks of these
RESOLVE_THREADS = 256
COMBINE_BWD_THREADS = 256


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
def _counting(module, name):
    """Count the calls of ``module.name`` in a one-element list, keeping
    nothing of them."""
    count = [0]
    fn = getattr(module, name)

    def counter(*args, **kwargs):
        count[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counter)
    try:
        yield count
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
def _plain_resolve_path():
    """The renderer with resolve in plain PyTorch under autograd, over K3's
    gather and scatter: the path a fit step took before the fused resolve
    had a backward."""
    from vrt_torch.render import renderer as tren

    saved = tren.resolve_scene
    tren.resolve_scene = tren.resolve_scene_reference
    try:
        yield
    finally:
        tren.resolve_scene = saved


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


def _nan_equal(a, b):
    """Tensors equal element by element, NaN equal to NaN."""
    import torch

    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()
        if a.is_floating_point() else torch.equal(a, b))


@contextlib.contextmanager
def _old_designs():
    """The scene march, the fused resolve forward and backward, the shade
    forward pair and the shade backward pair on their first designs (the
    comparators of the redesigned kernels), through the wrappers' private
    ``_old_design``; everything else as it is."""
    import functools

    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4

    names = ((k1, "march_scene_cuda"), (k4, "shade_surface_cuda"),
             (k4, "shade_combine_cuda"), (k4, "shade_surface_backward_cuda"),
             (k4, "shade_combine_backward_cuda"),
             (kr, "resolve_scene_backward_cuda"), (kr, "resolve_scene_cuda"),
             (kr, "resolve_slab_cuda"))
    saved = [getattr(m, n) for m, n in names]
    for (m, n), fn in zip(names, saved):
        setattr(m, n, functools.partial(fn, _old_design=True))
    try:
        yield
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)


@contextlib.contextmanager
def _filled_outputs():
    """Every output of the shade forward kernels, of the combine backward
    and of the fused resolve forward filled before the launch (floats with
    NaN, bools with True), so that a lane a kernel leaves unwritten
    shows."""
    import torch

    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4

    saved = (k4._empty, kr._empty)
    k4._empty = kr._empty = lambda shape, dtype, dev: torch.full(
        shape, True if dtype == torch.bool else float("nan"), dtype=dtype,
        device=dev)
    try:
        yield
    finally:
        k4._empty, kr._empty = saved


def _design_pair(new, old, hit, spawns):
    """The surface records (or the combine outputs) of the two designs on
    the same inputs, outputs filled first: equal on every lane (NaN to
    NaN: the same lanes unwritten), the redesign's material unwritten on
    miss lanes, and at a level that spawns no trace its shadow origin too.
    Returns the names of the outputs that differ."""
    import torch

    if isinstance(new, torch.Tensor):
        return [] if _nan_equal(new, old) else ["rgb"]
    bad = []
    for name in ("albedo", "shadow_origin", "n_w", "roughness", "metallic",
                 "k", "refl_dir", "gate", "shadow_tmax", "shadow_dir"):
        a, b = getattr(new, name), getattr(old, name)
        if (a is None) != (b is None):
            bad.append(name)
            continue
        if a is None:
            continue
        if isinstance(a, tuple):
            if len(a) != len(b) or not all(map(_nan_equal, a, b)):
                bad.append(name)
            continue
        if not _nan_equal(a, b):
            bad.append(name)
        unwritten = name in ("albedo", "n_w", "roughness", "metallic",
                             "k") or name == "shadow_origin" and not spawns
        if unwritten and not bool(torch.isnan(a[~hit]).all()):
            bad.append(f"{name} written on miss lanes")
    return bad


def _paired_ms(old, new, reps, hold=True):
    """Device time of ``old()`` and ``new()`` in the order old, new, new,
    old (``device_ms`` each): (old's two, new's two)."""
    from vrt_torch.kernels._timing import device_ms

    t = [device_ms(f, reps, hold) for f in (old, new, new, old)]
    return [t[0], t[3]], [t[1], t[2]]


def _simt(steps, width=None):
    """The SIMT efficiency of a march launch, from its plain version's
    per-ray step counts: the steps of all rays over 32 times the sum over
    warps of the warp's largest count (the lane-steps a warp issues while
    its slowest lane marches).  Threads take rays in launch order, or with
    ``width`` (the rays are the pixels of rows of that many) warp w takes
    the 8x4 pixel tile w of the row-major grid of tiles."""
    import torch

    rays = steps.numel()
    steps = steps.long()
    if width:
        rows = -(-rays // width)
        tiles_x = -(-width // 8)
        tid = torch.arange(tiles_x * -(-rows // 4) * 32, device=steps.device)
        warp, lane = tid // 32, tid % 32
        x = warp % tiles_x * 8 + lane % 8
        ray = (warp // tiles_x * 4 + lane // 8) * width + x
        ray = torch.where((x < width) & (ray < rays), ray, -1)
        per_thread = torch.where(ray >= 0, steps[ray.clamp_min(0)], 0)
    else:
        per_thread = torch.nn.functional.pad(steps, (0, -rays % 32))
    issued = 32 * per_thread.reshape(-1, 32).amax(1).sum().item()
    return steps.sum().item() / issued if issued else 1.0


def _row_contention(scene, hit, inst):
    """How the colour-row cotangents of a surface backward launch collide:
    dict(hits, rows (distinct rows hit: packed rows, or the cells whose 8
    voxel rows the unpacked grid takes), max_hits_on_a_row, rows_per_warp
    (distinct rows over the warps of 32 rays in launch order that hold a
    hit, on average), hits_per_warp (likewise))."""
    import torch

    from vrt_torch.render.gpuscene import color_table

    cn = color_table(scene).shape[1] + 1
    mask = hit.hit
    cell = (hit.cell + 1).clamp(0, cn - 1).long()
    vol = scene.inst_volume.long()[inst.clamp_min(0).long()]
    row = ((vol * cn + cell[:, 0]) * cn + cell[:, 1]) * cn + cell[:, 2]
    rows = row[mask]
    if rows.numel() == 0:
        return dict(hits=0, rows=0, max_hits_on_a_row=0, rows_per_warp=0.0,
                    hits_per_warp=0.0)
    _, counts = torch.unique(rows, return_counts=True)
    warp = torch.arange(row.numel(), device=row.device)[mask] // 32
    pairs = torch.unique(torch.stack([warp, rows]), dim=1)
    warps = torch.unique(warp).numel()
    return dict(hits=int(rows.numel()), rows=int(counts.numel()),
                max_hits_on_a_row=int(counts.max()),
                rows_per_warp=pairs.shape[1] / warps,
                hits_per_warp=rows.numel() / warps)


def _scene_calls(run, expected, tag, width=FRAME_W):
    """Every scene-march launch of ``run()`` (a frame or a fit step), kept
    with its inputs and the output ``run`` used, then held against its
    plain version, ``march_scene_reference`` over the twin, on the same
    inputs: a full trace field by field as ``_compare`` does, with the
    winning instance; an any-hit trace against the plain version's ``hit``.
    The first design (``_old_design``) on the same inputs must give the
    same result field by field; the two designs are timed in the order
    old, new, new, old, the plain version once.  From the plain version's
    step counts, the SIMT efficiency of the launch with threads in launch
    order and in 8x4 tiles of an image ``width`` pixels wide (``_simt``).
    The lanes that end on the iteration cap (``MAX_ITERATIONS`` steps) are
    counted in the kernel's result (full traces) and the plain version's.
    Fails unless the scene march
    launched ``expected`` times.  Returns dict(max_abs_err, ms, old_ms,
    plain_ms, simt_flat, simt_tiled, capped ((kernel or None, plain) lanes
    on the cap) (lists, per launch), bound)."""
    import torch

    from vrt_torch.kernels import march as k1
    from vrt_torch.march.march import MAX_ITERATIONS, march_lanes_reference
    from vrt_torch.render.renderer import march_scene_reference

    with _recording(k1, "march_scene_cuda") as calls:
        run()
    torch.cuda.synchronize()
    if len(calls) != expected:
        raise AssertionError(f"the {tag} launched the scene march "
                             f"{len(calls)} times, expected {expected}")
    err, ms, old_ms, plain_ms, bounds = 0.0, [], [], [], []
    simt_flat, simt_tiled, capped = [], [], []
    for i, (args, kwargs, got) in enumerate(calls):
        scene, o_w, d_w, t_max, interp = args[:5]
        overlay = args[5] if len(args) > 5 else False
        old = k1.march_scene_cuda(*args, **kwargs, _old_design=True)
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
            if not torch.equal(old, got):
                raise AssertionError(f"{tag} trace {i}: the two designs' "
                                     f"any-hit marches differ")
            out_bytes = 1
            capped.append((None, int((want.steps >= MAX_ITERATIONS).sum())))
        else:
            hit, inst = got
            err = max(err, _compare(f"{tag} trace {i}", hit, want,
                                    who="scene march vs plain"))
            agree = (hit.hit == want.hit) & (hit.kind == want.kind)
            if not torch.equal(inst[agree], want_inst[agree]):
                raise AssertionError(f"{tag} trace {i}: winning instances "
                                     f"differ")
            same = torch.equal(old[1], inst) and all(
                _nan_equal(getattr(old[0], f), getattr(hit, f))
                for f in ("hit", "t", "kind", "cell", "t_in", "t_out",
                          "face_normal", "steps"))
            if not same:
                raise AssertionError(f"{tag} trace {i}: the two designs' "
                                     f"marches differ")
            out_bytes = 49
            capped.append((int((hit.steps >= MAX_ITERATIONS).sum()),
                           int((want.steps >= MAX_ITERATIONS).sum())))
        del old
        olds, news = _paired_ms(
            lambda: k1.march_scene_cuda(*args, **kwargs, _old_design=True),
            lambda: k1.march_scene_cuda(*args, **kwargs), 20)
        ms.append(sum(news) / 2)
        old_ms.append(sum(olds) / 2)
        simt_flat.append(_simt(want.steps))
        simt_tiled.append(_simt(want.steps, width))
        bounds.append(_march_bound(scene.volumes, want, interp, 28,
                                   out_bytes, scene.num_instances))
        print(f"scene march [{tag} trace {i}{', any-hit' if out_bytes == 1 else ''}]"
              f": old, new, new, old {', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
              f" ms; bound {bounds[-1]['bound_ms']:.4f} ms = "
              f"{bounds[-1]['bound_ms'] / ms[-1]:.0%} of new, "
              f"{bounds[-1]['bound_ms'] / old_ms[-1]:.0%} of old; SIMT "
              f"efficiency in launch order {simt_flat[-1]:.3f}, in 8x4 tiles "
              f"{simt_tiled[-1]:.3f} (width {width}); steps "
              f"{int(want.steps.sum())}; lanes on the {MAX_ITERATIONS}-step "
              f"cap: kernel {'-' if capped[-1][0] is None else capped[-1][0]}"
              f", plain {capped[-1][1]}", flush=True)
        del want, want_inst
    return dict(max_abs_err=err, ms=ms, old_ms=old_ms, plain_ms=plain_ms,
                simt_flat=simt_flat, simt_tiled=simt_tiled, capped=capped,
                bound=_sum_bounds(bounds))


def _resolve_bound(scene, hit, inst):
    """The fused resolve's bound, from what these hits need: per ray kind
    and t read (8 B) and t, normal, unlit written (17 B); the face normal
    (12 B) where it is passed through (every kind but surface and debug);
    the ray and its instance (28 B) on surface and solid-entry hits; the
    cell (12 B) on surface hits, and each distinct corner row that their
    six neighbours name, once."""
    from vrt_torch.march.resolve import _OFFS7

    vols = scene.volumes
    rays = hit.kind.numel()
    n_surf = int((hit.kind == 1).sum())
    n_solid = int((hit.kind == 2).sum())
    n_debug = int((hit.kind == 5).sum())
    rows = _surface_rows(scene, hit, inst, _OFFS7[1:])
    row_bytes = vols.corners.shape[-1] * vols.corners.element_size()
    nbytes = (rays * (8 + 17) + (rays - n_surf - n_debug) * 12
              + (n_surf + n_solid) * 28 + n_surf * 12 + rows * row_bytes)
    return _bound(nbytes, n_surf * RESOLVE_FLOPS)


def _resolve_calls(run, expected, tag):
    """Every fused-resolve launch of ``run()``, kept with its inputs and
    the output ``run`` used, then held against its plain version
    (``resolve_scene_reference`` with a plain gather, no graph) on the same
    inputs: unlit equal, t and the normal equal with NaN equal to NaN; and
    against its first design (``_old_design``), both with their outputs
    filled with NaN first (``_filled_outputs``): bit-equal on every lane.
    The two designs timed old, new, new, old, the plain version beside them
    and over K3's gather (resolve as the candidate-loop path runs it).
    Returns dict(launches, max_abs_err, ms (the sum over the launches),
    per_launch_ms, old_ms (per launch), plain_ms, over_k3_ms, bound)."""
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

    ms, old_ms, plain_ms, k3_ms, bounds = [], [], [], [], []
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
        with _filled_outputs():
            new = kr.resolve_scene_cuda(*args)
            old = kr.resolve_scene_cuda(*args, _old_design=True)
        bad = [name for name, a, b in zip(("t", "normal", "unlit"), new, old)
               if not _nan_equal(a, b)]
        if bad:
            raise AssertionError(f"{tag} resolve {i}: the redesign's {bad} "
                                 f"differ from the first design's")
        del new, old
        olds, news = _paired_ms(
            lambda: kr.resolve_scene_cuda(*args, _old_design=True),
            lambda: kr.resolve_scene_cuda(*args), 20)
        ms.append(sum(news) / 2)
        old_ms.append(sum(olds) / 2)
        plain_ms.append(device_ms(lambda: plain(*args), 3))
        k3_ms.append(device_ms(lambda: over_k3(*args), 3))
        bounds.append(_resolve_bound(args[0], args[3], args[4]))
        kinds = torch.bincount(args[3].kind, minlength=6).tolist()
        print(f"fused resolve vs plain [{tag} {i}]: rays "
              f"{args[1].shape[0]} kinds {kinds} equal, bit-equal to the "
              f"first design; old, new, new, old "
              f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
              f" ms, plain {plain_ms[-1]:.4f} ms, plain over K3's gather "
              f"{k3_ms[-1]:.4f} ms, bound {bounds[-1]['bound_ms']:.4f} ms "
              f"({bounds[-1]['bytes']} B) = {bounds[-1]['bound_ms'] / ms[-1]:.0%}"
              f" of new, {bounds[-1]['bound_ms'] / old_ms[-1]:.0%} of old",
              flush=True)
    print(f"fused resolve on the {tag}: {len(calls)} launches, new "
          f"{sum(ms):.4f} ms, first design {sum(old_ms):.4f} ms", flush=True)
    return dict(launches=len(calls), max_abs_err=0.0, ms=sum(ms),
                per_launch_ms=ms, old_ms=old_ms,
                plain_ms=sum(plain_ms), over_k3_ms=sum(k3_ms),
                bound=_sum_bounds(bounds))


def _surface_rows(scene, hit, inst, offsets):
    """How many distinct corner rows the surface hits name through
    ``offsets`` (cells relative to the hit cell), out-of-range ones left
    out."""
    import torch

    vols = scene.volumes
    surf = hit.kind == 1
    vol = scene.inst_volume[inst[surf].clamp_min(0).long()].long()
    cells = hit.cell[surf][:, None, :].long() + torch.as_tensor(
        offsets, device=surf.device).long()
    n = vols.n[vol].long()[:, None, None]
    valid = ((cells >= 0) & (cells + 1 < n)).all(-1)
    cc = vols.corners.shape[1]
    flat = ((vol[:, None] * cc + cells[..., 0]) * cc + cells[..., 1]) * cc \
        + cells[..., 2]
    return int(torch.unique(flat[valid]).numel())


def _resolve_bwd_bound(scene, hit, inst, rays_grad, table_grad):
    """The backward's bound, from what these hits need: per ray the kind
    read (4 B) and, with ``rays_grad``, the two ray gradients written
    (24 B); the ray, its instance and g_t (32 B) on surface and solid-entry
    hits; t, the cell and g_normal (28 B) on surface hits, and each distinct
    corner row that the hit cell and its six neighbours name, once; with
    ``table_grad`` the f32 accumulator written once."""
    from vrt_torch.march.resolve import _OFFS7

    corners = scene.volumes.corners
    rays = hit.kind.numel()
    n_surf = int((hit.kind == 1).sum())
    n_solid = int((hit.kind == 2).sum())
    rows = _surface_rows(scene, hit, inst, _OFFS7)
    row_bytes = corners.shape[-1] * corners.element_size()
    nbytes = (rays * (4 + 24 * int(rays_grad)) + (n_surf + n_solid) * 32
              + n_surf * 28 + rows * row_bytes
              + corners.numel() * 4 * int(table_grad))
    return _bound(nbytes, n_surf * RESOLVE_BWD_FLOPS)


def _resolve_bwd_reductions(scene, o_w, d_w, hit, inst, g_t, g_n):
    """The row reductions a backward launch issues, from the closed form's
    row cotangents (``resolve_hits_backward``) and the warp layout (32 rays
    a warp in launch order): dict(scalar (the first design: one atomic a
    non-zero channel of an in-range row), merged (the redesign: one 16-byte
    reduction a half-row with a non-zero channel, once per warp and hit
    cell, at most: a sum that cancels to 0 is skipped), groups (the warp and
    hit-cell groups with a surface lane))."""
    import torch

    from vrt_torch.march import isosurface as iso
    from vrt_torch.march.resolve import _OFFS7, resolve_hits_backward
    from vrt_torch.render.renderer import (_per_ray_instance,
                                           _world_to_object,
                                           gather_rows_reference)

    pr = _per_ray_instance(scene, inst)
    o, d = _world_to_object(pr["pos"], pr["rot"], pr["scale"], o_w, d_w)
    corners = scene.volumes.corners
    cc, ch = corners.shape[1], corners.shape[-1]
    offs = torch.as_tensor(_OFFS7, device=o_w.device)
    idx = iso.stacked_corner_index(hit.cell[:, None, :] + offs, pr["n"],
                                   pr["vol"], cc)
    rows7 = gather_rows_reference(corners.reshape(-1, ch), idx.reshape(-1),
                                  8).reshape(-1, 7, 8)
    _, _, g_rows7 = resolve_hits_backward(rows7, pr["cell_size"],
                                          pr["extends"], o, d, hit, g_t, g_n)
    del rows7
    rays = g_rows7.shape[0]
    valid = idx.long() >= 0
    nz = g_rows7 != 0
    del g_rows7
    scalar = int((nz & valid[..., None]).sum())
    half = nz.reshape(rays, 7, 2, 4).any(-1) & valid[..., None]
    ray = torch.arange(rays, device=idx.device)
    key = torch.where(valid[:, 0], idx[:, 0].long(), -1 - ray)
    lane, r, q = half.nonzero().unbind(1)
    merged = torch.unique(torch.stack([lane // 32, key[lane], r, q]),
                          dim=1).shape[1]
    surf = hit.kind == 1
    groups = torch.unique(torch.stack([ray[surf] // 32, key[surf]]),
                          dim=1).shape[1]
    return dict(scalar=scalar, merged=merged, groups=groups)


def _resolve_bwd_calls(run, expected, tag):
    """Every launch of the fused resolve's backward in ``run()`` (a fit
    step), kept with its saved inputs, its cotangents and the output ``run``
    used, then held against its plain version
    (``resolve_scene_backward_reference``, the closed form) on the same
    inputs: the ray gradients (where the launch was asked for them: the
    primary rays of a fixed camera need none) within ``RAY_GRAD_RTOL * max|g|``, the table's
    within ``SCATTER_RTOL * max|sum|`` of the closed form summed in float64,
    all finite.  Both timed.  The first design (``_old_design``) runs on the
    same inputs: its ray gradients must equal the redesign's bit for bit,
    its table is held as the redesign's, and the two are timed in the order
    old, new, new, old, and printed with the row reductions each would
    issue (``_resolve_bwd_reductions``, a count on the host, not read from
    the kernels).  Returns dict(launches, max_abs_err (of the table),
    ray_err, ms, plain_ms, old_ms, table_diff (the largest difference
    between the two designs' tables), bound)."""
    import torch

    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.render.renderer import resolve_scene_backward_reference

    with _recording(kr, "resolve_scene_backward_cuda") as calls:
        run()
    torch.cuda.synchronize()
    if len(calls) != expected:
        raise AssertionError(f"the {tag} launched the fused resolve's "
                             f"backward {len(calls)} times, expected "
                             f"{expected}")
    err, ray_err, ms, plain_ms, bounds = 0.0, 0.0, [], [], []
    old_ms, table_diff = [], []
    for i, (args, kwargs, got) in enumerate(calls):
        scene, o_w, d_w, hit, inst, g_t, g_n = args[:7]
        rays_grad, table_grad = args[7:] + tuple(kwargs.values())
        if not table_grad or (got[0] is None) == rays_grad:
            raise AssertionError(f"{tag} backward {i}: outputs do not "
                                 f"follow ({rays_grad}, {table_grad})")
        old = kr.resolve_scene_backward_cuda(*args, **kwargs,
                                             _old_design=True)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got[:2], old[:2]) if a is not None):
            raise AssertionError(f"{tag} backward {i}: the ray gradients "
                                 f"differ from the first design's")
        want = resolve_scene_backward_reference(*args[:7],
                                                acc_dtype=torch.float64)
        rel = [0.0]
        for name, a, b in zip(("g_o_w", "g_d_w"), got, want):
            if not rays_grad:
                break
            scale = b.abs().max().item()
            e = (a - b).abs().max().item()
            rel.append(e / scale if scale > 0 else e)
            if not (bool(torch.isfinite(a).all())
                    and e <= RAY_GRAD_RTOL * scale):
                raise AssertionError(f"{tag} backward {i}: {name} off by "
                                     f"{e:.3e} > {RAY_GRAD_RTOL} * "
                                     f"{scale:.3e}")
        scale = want[2].abs().max().item()
        for side, table in (("", got[2]), ("first design's ", old[2])):
            e = (table.double() - want[2]).abs().max().item()
            if not (bool(torch.isfinite(table).all())
                    and e <= SCATTER_RTOL * scale and scale > 0):
                raise AssertionError(f"{tag} backward {i}: the {side}table "
                                     f"gradient is off by {e:.3e} > "
                                     f"{SCATTER_RTOL} * {scale:.3e}")
            if not side:
                this_err = e
                err, ray_err = max(err, e), max(ray_err, *rel)
        table_diff.append((got[2] - old[2]).abs().max().item())
        del want, old
        olds, news = _paired_ms(
            lambda: kr.resolve_scene_backward_cuda(*args, **kwargs,
                                                   _old_design=True),
            lambda: kr.resolve_scene_backward_cuda(*args, **kwargs), 20)
        ms.append(sum(news) / 2)
        old_ms.append(sum(olds) / 2)
        plain_ms.append(device_ms(
            lambda: resolve_scene_backward_reference(*args[:7]), 3))
        bounds.append(_resolve_bwd_bound(scene, hit, inst, rays_grad,
                                         table_grad))
        red = _resolve_bwd_reductions(*args[:7])
        kinds = torch.bincount(hit.kind, minlength=6).tolist()
        bound_ms = bounds[-1]["bound_ms"]
        print(f"fused resolve backward vs plain [{tag} {i}]: rays "
              f"{o_w.shape[0]} kinds {kinds} cotangents non-zero on "
              f"{int(((g_t != 0) | (g_n != 0).any(-1)).sum())} rays; ray "
              f"gradients "
              + (f"within {max(rel):.2e} * max|g|" if rays_grad
                 else "not asked for")
              + f", table within "
              f"{this_err / scale:.2e} * max|sum|; kernel {ms[-1]:.4f} ms, plain "
              f"{plain_ms[-1]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bounds[-1]['bytes']} B)", flush=True)
        print(f"fused resolve backward [{tag} {i}]: old, new, new, old "
              f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
              f" ms; bound {bound_ms:.4f} ms = {bound_ms / ms[-1]:.0%} of "
              f"new, {bound_ms / old_ms[-1]:.0%} of old; row reductions "
              f"counted on the host: first design {red['scalar']} scalar "
              f"atomics, redesign at most {red['merged']} 16-byte "
              f"reductions over {red['groups']} warp and hit-cell groups; "
              f"ray gradients bit-equal to the first "
              f"design's" + ("" if rays_grad else " (none asked for)")
              + f"; tables differ by at most {table_diff[-1]:.3e} "
              f"(max|sum| {scale:.3e})", flush=True)
    return dict(launches=len(calls), max_abs_err=err, ray_err=ray_err, ms=ms,
                plain_ms=plain_ms, old_ms=old_ms, table_diff=table_diff,
                bound=_sum_bounds(bounds))


def _k3_calls(run, tag):
    """Every K3 launch of ``run()``, kept with its inputs and the output
    ``run`` used, then held against the plain version on the same inputs:
    each gather equal to ``gather_rows_reference``, each scatter within
    ``SCATTER_RTOL * max|sum|`` of ``scatter_rows_reference`` in float64;
    kernel, plain version (f32) and library call (``table[idx]`` with its
    cast, ``index_add_``; int64 indices made beforehand) timed.  A scatter
    that took the 16-byte path ("v4") is launched on the scalar path too, on
    a copy of its cotangents based 4 bytes off alignment, held to the same
    float64 sum and timed.  Returns {"gather" | "scatter" | "scatter_scalar":
    dict(launches, max_abs_err, ms, plain_ms, library_ms, bound)}, the times
    summed over the launches; "scatter" holds the launches as ``run`` made
    them (with ``paths``, the path of each), "scatter_scalar" the scalar
    launches, those of ``run`` and the repeats."""
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
    scalar = dict(launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                  library_ms=0.0, bounds=[])
    for op, launch, plain in (
            ("gather", gather, k3.gather_rows_reference),
            ("scatter", scatter, k3.scatter_rows_reference)):
        err, ms, plain_ms, lib_ms, bounds, paths = 0.0, [], [], [], [], []
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
                paths.append(k3.scatter_path(grad, ch))
                shape = f"{tuple(grad.shape)} -> ({rows}, {ch}) {paths[-1]}"
                # times the call only: it adds masked lanes into row 0
                acc = torch.zeros((rows, grad.shape[1]), device=grad.device)
                library = lambda: acc.index_add_(0, idx64, grad)  # noqa: E731
                nbytes = idx.numel() * 4 + grad.numel() * 4 + rows * ch * 4
            ms.append(device_ms(lambda: launch(*args), 10))
            plain_ms.append(device_ms(lambda: plain(*args), 10))
            lib_ms.append(device_ms(library, 10))
            bounds.append(_bound(nbytes, 0))
            print(f"K3 {op} [{tag} {i}]: lanes {idx.numel()} "
                  f"{shape}: kernel {ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f}"
                  f" ms, library {lib_ms[-1]:.4f} ms, bound "
                  f"{bounds[-1]['bound_ms']:.4f} ms ({nbytes} B, {touched} "
                  f"rows touched)", flush=True)
            if op == "scatter":
                scalar_ms = ms[-1]
                if paths[-1] == "v4":
                    # the same cotangents, 4 bytes off 16-byte alignment
                    off = torch.empty(grad.numel() + 1, device=grad.device)
                    off = off[1:].view(grad.shape).copy_(grad)
                    if k3.scatter_path(off, ch) != "scalar":
                        raise AssertionError("no scalar path for an "
                                             "unaligned cotangent")
                    e = (launch(off, idx, rows, ch).double()
                         - want).abs().max().item()
                    if not e <= SCATTER_RTOL * scale:
                        raise AssertionError(
                            f"{tag}: K3 scatter {i} on the scalar path off "
                            f"by {e:.3e} > {SCATTER_RTOL} * {scale:.3e}")
                    scalar_ms = device_ms(
                        lambda: launch(off, idx, rows, ch), 10)
                    print(f"K3 scatter [{tag} {i}] on the scalar path: "
                          f"kernel {scalar_ms:.4f} ms against {ms[-1]:.4f} "
                          f"ms on v4, within {e / scale:.2e} * max|sum|",
                          flush=True)
                scalar["launches"] += 1
                scalar["max_abs_err"] = max(scalar["max_abs_err"], e)
                scalar["ms"] += scalar_ms
                scalar["plain_ms"] += plain_ms[-1]
                scalar["library_ms"] += lib_ms[-1]
                scalar["bounds"].append(bounds[-1])
            del want
        out[op] = dict(launches=len(calls[op]), max_abs_err=err,
                       ms=sum(ms), plain_ms=sum(plain_ms),
                       library_ms=sum(lib_ms), bound=_sum_bounds(bounds))
        if op == "scatter":
            out[op]["paths"] = paths
    scalar["bound"] = _sum_bounds(scalar.pop("bounds"))
    out["scatter_scalar"] = scalar
    return out


def _beyond(a, b, lanes=None):
    """A float output ``a`` of a shade kernel against its plain version's
    ``b``, over ``lanes`` (a bool mask over the rays; default all): the share
    of lanes where an element differs by more than ``SHADE_ATOL +
    SHADE_RTOL * |b|`` (NaN equal to NaN), the largest difference on the
    other lanes, and whether every element is bit-equal."""
    if lanes is not None:
        a, b = a[lanes], b[lanes]
    if a.numel() == 0:
        return 0.0, 0.0, True
    same = (a == b) | ((a != a) & (b != b))
    diff = (a - b).abs().masked_fill(same, 0.0)
    off = ~(diff <= SHADE_ATOL + SHADE_RTOL * b.abs())
    bad = off.reshape(off.shape[0], -1).any(-1)
    worst = diff.masked_fill(off, 0.0).max().item()
    return bad.float().mean().item(), worst, bool(same.all())


def _color_bytes(scene, hits):
    """What the colour sample of ``hits`` hit lanes reads: the cell (12 B)
    and a packed row of 24 channels, or the unpacked grid's 8 voxel rows of
    3 f32, no more than the table."""
    from vrt_torch.render.gpuscene import color_table

    table = color_table(scene)
    row = 24 * table.element_size() if scene.voxel_color_corners is not None \
        else 8 * 12
    return hits * 12 + min(hits * row, table.numel() * table.element_size())


def _surface_bound(scene, args):
    """The surface kernel's bound from what this launch's data needs, per
    lane kind.  A hit lane reads its flag and instance (5 B), the ray and t
    (28 B) where the mode places the hit point, the normal (12 B) where it
    is lit or textured, with per-voxel colours the cell and a colour row (no
    more than the table), and writes the whole record.  A miss lane reads
    its flag, and where the level spawns traces the ray (24 B), and writes
    only what those traces read: the shadow origin, the mirror ray and its
    gate, a t_max per light and a direction per point and spot light.  The
    textures once."""
    _, o_w, _, _, _, hit, _, mode, bounce, shadows = args
    rays = o_w.shape[0]
    hits = int(hit.hit.sum())
    lit = mode.lit
    bounce, shadows = bool(bounce) and lit, bool(shadows) and lit
    colors = scene.use_voxel_colors
    sampled = mode.textured and (lit or not colors)
    n_shadow = scene.num_point + scene.num_spot
    traced = (13 if bounce else 0) \
        + (4 * (1 + n_shadow) + 12 * n_shadow if shadows else 0)
    hit_in = 5 + (28 if lit or sampled or colors else 0) \
        + (12 if lit or sampled else 0)
    hit_out = 12 + (36 + traced if lit else 0)
    miss_in, miss_out = (25, 12 + traced) if traced else (1, 0)
    nbytes = hits * (hit_in + hit_out) + (rays - hits) * (miss_in + miss_out)
    flops = SHADE_FLOPS["surface"]
    if sampled:
        nbytes += scene.textures.numel() * 4
        samples = (0 if colors else 1) + (2 if lit else 0)
        flops += samples * SHADE_FLOPS["tri_sample"]
    if colors:
        nbytes += _color_bytes(scene, hits)
        flops += SHADE_FLOPS["colors"]
    if lit and shadows:
        flops += n_shadow * SHADE_FLOPS["light"]
    return _bound(nbytes, hits * flops)


def _combine_bound(scene, args):
    """The combine kernel's bound: per ray the direction and the two flags
    read (14 B) and the pixel written; on hit lanes the record it needs
    (the albedo; in lit mode the other 36 B, with a bounce the mirror ray
    and its radiance, one flag per shadow traced); the normal on
    unlit-attribute lanes; four env texels per miss lane (no more than the
    cube)."""
    _, rec, d_w, _, hit_mask, unlit_attr, refl_rgb, blocked, mode, final = \
        args
    rays = d_w.shape[0]
    hits = int(hit_mask.sum())
    lit_hits = hits - int((hit_mask & unlit_attr).sum())
    per_hit = 12
    lights = 0
    if mode.lit:
        lights = 1 + scene.num_point + scene.num_spot
        per_hit += 36 + (24 if refl_rgb is not None else 0) \
            + (len(blocked) if blocked is not None else 0)
        lights += 1 if refl_rgb is not None else 0
    nbytes = (rays * (14 + (16 if final else 12)) + lit_hits * per_hit
              + (hits - lit_hits) * 12
              + min((rays - hits) * 48, scene.env.numel() * 4))
    flops = (lit_hits * lights * SHADE_FLOPS["radiance"]
             + (rays - hits) * SHADE_FLOPS["env"]
             + (rays * SHADE_FLOPS["tonemap"] if final else 0))
    return _bound(nbytes, flops)


def _shade_calls(run, expected, tag):
    """Every launch of the two shade kernels in ``run()`` (a frame), kept
    with its inputs and the output ``run`` used, then held against its plain
    stage (``shade_surface_reference``, ``shade_combine_reference``) on the
    same inputs; both timed with the stream held, with the bound.  The
    surface record's floats are held on hit lanes (the shadow origin on
    all lanes of a level that spawns traces), its gate and its ``t_max =
    -inf`` masks as lane flips on all lanes; the combine stage's radiance or
    pixels on all lanes, against the plain stage on the kernel's own record.
    A float may be off by more than ``SHADE_ATOL + SHADE_RTOL * |plain|`` on
    at most ``SHADE_FLOAT_BUDGET`` of the lanes, a boolean may flip on
    ``LANE_BUDGET`` of them.  The first design (``_old_design``) runs on the
    same inputs, both with their outputs filled first (``_filled_outputs``):
    every output must be bit-equal on every lane (the same lanes written,
    NaN equal to NaN), and the redesign's material unwritten on miss lanes
    (``_design_pair``); the two are timed in the order old, new, new, old.
    Fails unless each kernel launched ``expected`` times.  Returns
    {"surface" | "combine": dict(launches, max_abs_err, lanes_beyond (the
    largest share of lanes on which a float was beyond the tolerance),
    bit_equal (outputs equal to the plain stage's on every lane), ms,
    old_ms, plain_ms (lists, per launch), paths (the redesign's launches of
    the recorded run by path), bound)}."""
    import torch

    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.render.renderer import (shade_combine_reference,
                                           shade_surface_reference)

    _reset(k4.PATH_LAUNCHES)
    with _recording(k4, "shade_surface_cuda") as surf, \
            _recording(k4, "shade_combine_cuda") as comb:
        run()
    torch.cuda.synchronize()
    paths = dict(k4.PATH_LAUNCHES)
    if (len(surf), len(comb)) != (expected, expected):
        raise AssertionError(f"the {tag} launched the shade kernels "
                             f"{len(surf)} + {len(comb)} times, expected "
                             f"{expected} + {expected}")
    out = {}

    def hold(what, i, name, share, worst, state, boolean=False):
        if share > (LANE_BUDGET if boolean else SHADE_FLOAT_BUDGET):
            raise AssertionError(f"{tag} {what} {i}: {name} differs from the "
                                 f"plain stage on {share:.2e} of lanes")
        state["err"] = max(state["err"], worst)
        if not boolean:
            state["share"] = max(state["share"], share)

    def designs(stage, i, kernel, args, hit, spawns):
        """The two designs on ``args``: held equal, timed old, new, new,
        old.  On the unpacked colour grid the surface's default
        (``surface_voxels_kernel``) is also held equal to the resident
        kernel (``_resident``, the kernel this layout took before),
        and timed against it old, new, new, old, the first design once
        beside them.  Returns (new's mean, old's mean, the first design's
        or None) ms."""
        unpacked = stage == "surface" and \
            k4.color_layout(args[0]) == "voxels f32"
        with _filled_outputs():
            new = kernel(*args)
            olds = [kernel(*args, _old_design=True)]
            if unpacked:
                olds.append(kernel(*args, _resident=True))
        torch.cuda.synchronize()
        for name, old in zip(("the first design", "the resident kernel"),
                             olds):
            bad = _design_pair(new, old, hit, spawns)
            if bad:
                raise AssertionError(f"{tag} {stage} {i}: the default "
                                     f"differs from {name} in {bad}")
        del new, olds
        old_kw = dict(_resident=True) if unpacked else dict(_old_design=True)
        olds, news = _paired_ms(lambda: kernel(*args, **old_kw),
                                lambda: kernel(*args), 20)
        first = device_ms(lambda: kernel(*args, _old_design=True), 20) \
            if unpacked else None
        print(f"shade {stage} [{tag} {i}]: "
              + ("the resident kernel against the voxels design"
                 if unpacked else "first design against the redesign")
              + f", old, new, new, old "
              f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
              f" ms"
              + (f"; first design {first:.4f} ms" if unpacked else "")
              + "; bit-equal on every lane", flush=True)
        return sum(news) / 2, sum(olds) / 2, first

    state = dict(err=0.0, share=0.0)
    ms, old_ms, plain_ms, bounds, first = [], [], [], [], []
    equal, differ = set(), set()
    for i, (args, _, got) in enumerate(surf):
        scene, hit = args[0], args[5]
        with torch.no_grad():
            want = shade_surface_reference(*args)
        on = hit.hit
        # a level that spawns no trace leaves a miss lane's origin unwritten
        spawns = args[7].lit and (args[8] or args[9])
        fields = [("albedo", on), ("shadow_origin", None if spawns else on),
                  ("n_w", on), ("roughness", on), ("metallic", on),
                  ("k", on), ("refl_dir", on)]
        pairs = [(f, getattr(got, f), getattr(want, f), m)
                 for f, m in fields]
        for j, (a, b) in enumerate(zip(got.shadow_dir or (),
                                       want.shadow_dir or ())):
            pairs.append((f"shadow_dir[{j}]", a, b, on))
        for j, (a, b) in enumerate(zip(got.shadow_tmax or (),
                                       want.shadow_tmax or ())):
            dead = (torch.isinf(a), torch.isinf(b))
            flips = (dead[0] != dead[1]).float().mean().item()
            hold("surface", i, f"shadow_tmax[{j}] = -inf", flips, 0.0, state,
                 boolean=True)
            pairs.append((f"shadow_tmax[{j}]", a, b, ~dead[0] & ~dead[1]))
        if (got.gate is None) != (want.gate is None) or \
                (got.shadow_tmax is None) != (want.shadow_tmax is None):
            raise AssertionError(f"{tag} surface {i}: the record's optional "
                                 f"fields differ from the plain stage's")
        if got.gate is not None:
            flips = (got.gate != want.gate).float().mean().item()
            hold("surface", i, "gate", flips, 0.0, state, boolean=True)
        for name, a, b, lanes in pairs:
            if (a is None) != (b is None):
                raise AssertionError(f"{tag} surface {i}: {name} is set on "
                                     f"one side only")
            if a is None:
                continue
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{tag} surface {i}: {name} is "
                                     f"{a.dtype} {tuple(a.shape)}")
            share, worst, same = _beyond(a, b, lanes)
            hold("surface", i, name, share, worst, state)
            (equal if same else differ).add(name.split("[")[0])
        del want
        new_ms, before_ms, first_ms = designs(
            "surface", i, k4.shade_surface_cuda, args, on, spawns)
        ms.append(new_ms)
        old_ms.append(before_ms)
        if first_ms is not None:
            first.append(first_ms)
        with torch.no_grad():
            plain_ms.append(device_ms(
                lambda: shade_surface_reference(*args), 2))
        bounds.append(_surface_bound(scene, args))
        print(f"shade surface vs plain [{tag} {i}]: rays {on.numel()} hits "
              f"{int(on.sum())} lit={args[7].lit} bounce={args[8]} shadows="
              f"{args[9]}; kernel {ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f} "
              f"ms, bound {bounds[-1]['bound_ms']:.4f} ms "
              f"({bounds[-1]['bytes']} B, by {bounds[-1]['bound_by']})",
              flush=True)
    out["surface"] = dict(launches=len(surf), max_abs_err=state["err"],
                          lanes_beyond=state["share"], bit_equal=sorted(equal - differ),
                          rounded=sorted(differ), ms=ms, old_ms=old_ms,
                          first_ms=first, plain_ms=plain_ms,
                          bound=_sum_bounds(bounds),
                          paths={k.split()[1]: n for k, n in paths.items()
                                 if k.split()[0] == "surface"})

    state = dict(err=0.0, share=0.0)
    ms, old_ms, plain_ms, bounds, all_same = [], [], [], [], True
    for i, (args, _, got) in enumerate(comb):
        with torch.no_grad():
            want = shade_combine_reference(*args)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{tag} combine {i}: the output is "
                                 f"{got.dtype} {tuple(got.shape)}")
        share, worst, same = _beyond(got, want)
        hold("combine", i, "the radiance", share, worst, state)
        all_same = all_same and same
        del want
        new_ms, first_ms, _ = designs("combine", i, k4.shade_combine_cuda,
                                      args, args[4], True)
        ms.append(new_ms)
        old_ms.append(first_ms)
        with torch.no_grad():
            plain_ms.append(device_ms(
                lambda: shade_combine_reference(*args), 2))
        bounds.append(_combine_bound(args[0], args))
        print(f"shade combine vs plain [{tag} {i}]: rays {got.shape[0]} "
              f"final={args[9]} bounce={args[6] is not None} shadows="
              f"{0 if args[7] is None else len(args[7])}; kernel "
              f"{ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f} ms, bound "
              f"{bounds[-1]['bound_ms']:.4f} ms ({bounds[-1]['bytes']} B, by "
              f"{bounds[-1]['bound_by']})", flush=True)
    out["combine"] = dict(launches=len(comb), max_abs_err=state["err"],
                          lanes_beyond=state["share"], bit_equal=["rgb"] if all_same else [],
                          rounded=[] if all_same else ["rgb"], ms=ms,
                          old_ms=old_ms, plain_ms=plain_ms,
                          bound=_sum_bounds(bounds),
                          paths={k.split()[1]: n for k, n in paths.items()
                                 if k.split()[0] == "combine"})
    for name, got in out.items():
        if sum(got["paths"].values()) != got["launches"]:
            raise AssertionError(f"{tag}: the {name} launches took the "
                                 f"paths {got['paths']}")
        before = "the resident kernel" if got.get("first_ms") \
            else "first design"
        print(f"shade {name} on the {tag}: {got['launches']} launches, "
              f"paths {got['paths']}, {_list(got['ms'])} ms = "
              f"{sum(got['ms']):.4f} ms [{before} "
              f"{_list(got['old_ms'])} ms = {sum(got['old_ms']):.4f} ms"
              + (f"; first design {_list(got['first_ms'])} ms = "
                 f"{sum(got['first_ms']):.4f} ms" if got.get("first_ms")
                 else "") + "]; "
              f"plain "
              f"{sum(got['plain_ms']):.2f} ms; bound "
              f"{got['bound']['bound_ms']:.4f} ms ({got['bound']['bytes']} "
              f"B, by {got['bound']['bound_by']}); largest difference on the "
              f"lanes within tolerance {got['max_abs_err']:.3e}, floats beyond "
              f"it on at most {got['lanes_beyond']:.2e} of lanes; bit-equal "
              f"outputs {got['bit_equal']}, rounded {got['rounded']}",
              flush=True)
    return out


def _grad_beyond(a, b, scale):
    """A per-ray cotangent ``a`` of a backward kernel against its plain
    version's ``b``: the share of lanes where an element differs by more
    than ``SHADE_GRAD_RTOL * |b| + SHADE_GRAD_ATOL * scale`` (or is not
    finite), ``scale`` being the launch's largest |plain| cotangent, and
    the largest difference over ``scale``."""
    diff = (a.double() - b.double()).abs()
    off = ~(diff <= SHADE_GRAD_RTOL * b.double().abs()
            + SHADE_GRAD_ATOL * scale)
    bad = off.reshape(off.shape[0], -1).any(-1)
    worst = diff.max().item()
    return bad.float().mean().item(), worst / scale if scale > 0 else worst


def _surface_bwd_bound(scene, args, rays_grad, table_grad):
    """The surface backward's bound from what this launch's data needs, per
    lane kind.  Every lane reads its flag and writes the cotangents of t and
    n_obj (16 B) and, where asked, of the ray (24 B).  A hit lane reads its
    instance, the ray and t (32 B), the normal (12 B) where the mode reads
    it, the record's cotangents that were passed, with per-voxel colours the
    cell and a colour row or 8 voxel rows (no more than the table).  The
    textures once; the f32 accumulator of the colour table written once."""
    from vrt_torch.render.gpuscene import color_table

    _, o_w, _, _, _, hit, _, mode, _, cots = args[:10]
    rays = o_w.shape[0]
    hits = int(hit.hit.sum())
    lit, colors = mode.lit, scene.use_voxel_colors
    sampled = mode.textured and (lit or not colors)
    cot_bytes = sum(g.numel() * 4 for g in cots
                    if g is not None) // max(rays, 1)
    per_hit = 36 + (12 if lit or sampled else 0) + cot_bytes
    nbytes = rays * (1 + 16 + (24 if rays_grad else 0)) + hits * per_hit
    flops = SHADE_BWD_FLOPS["surface"]
    if sampled:
        nbytes += scene.textures.numel() * 4
        flops += ((0 if colors else 1) + (2 if lit else 0)) \
            * SHADE_BWD_FLOPS["tri_sample"]
    if colors:
        nbytes += _color_bytes(scene, hits)
        nbytes += color_table(scene).numel() * 4 if table_grad else 0
        flops += SHADE_BWD_FLOPS["colors"]
    return _bound(nbytes, hits * flops)


def _combine_bwd_bound(scene, args, outs):
    """The combine backward's bound: per ray the direction, the two flags
    and the radiance's cotangent read (26 B) and every cotangent it returns
    written; on lit hit lanes the record (48 B; with a bounce the mirror ray
    and its radiance, 24 B more; one flag per shadow traced); four env
    texels per miss lane (no more than the cube)."""
    _, rec, d_w, _, hit_mask, unlit_attr, refl_rgb, blocked, mode = args[:9]
    rays = d_w.shape[0]
    hits = int(hit_mask.sum())
    lit_hits = hits - int((hit_mask & unlit_attr).sum()) if mode.lit else 0
    written = sum(x.numel() * 4 for x in outs if x is not None)
    per_hit = 48 + (24 if refl_rgb is not None else 0) \
        + (len(blocked) if blocked is not None else 0)
    lights = 1 + scene.num_point + scene.num_spot \
        + (1 if refl_rgb is not None else 0)
    nbytes = (rays * 26 + written + lit_hits * per_hit
              + min((rays - hits) * 48, scene.env.numel() * 4))
    flops = (lit_hits * (lights * SHADE_BWD_FLOPS["radiance"]
                         + (scene.num_point + scene.num_spot)
                         * SHADE_BWD_FLOPS["light"])
             + (rays - hits) * SHADE_BWD_FLOPS["env"])
    return _bound(nbytes, flops)


COMBINE_GRADS = ("g_albedo", "g_shadow_origin", "g_n_w", "g_roughness",
                 "g_metallic", "g_refl_dir", "g_d_w", "g_n_obj", "g_refl_rgb")


def _shade_bwd_calls(run, expected, tag):
    """Every launch of the two backward kernels in ``run()`` (a fit step),
    kept with its inputs (the forward's inputs, the cotangents) and the
    outputs ``run`` used, then held against its plain version
    (``shade_surface_backward_reference`` /
    ``shade_combine_backward_reference``: autograd of the plain stage) on
    the same inputs: each per-ray cotangent on every lane under
    ``_grad_beyond``'s tolerance on all but ``SHADE_GRAD_LANE_BUDGET`` of the
    lanes, all finite; the colour table's within ``SCATTER_RTOL * max|sum|``
    of the plain version summed in float64.  Both timed, with the bound.
    The surface backward's first design (``_old_design``) runs on the same
    inputs, its colour table held as the new one's, and the two are timed
    in the order old, new, new, old; whether their per-ray cotangents are
    bit-equal is reported, and how the colour rows collide
    (``_row_contention``).  The combine backward's first design runs on
    the same inputs too, both with their outputs filled with NaN first: all
    nine cotangents must be bit-equal; the two are timed old, new, new, old.
    Fails unless each kernel launched ``expected`` times.  Returns
    {"surface_bwd" | "combine_bwd": dict(launches, max_abs_err (the largest
    difference over max|plain|, per-ray outputs and the table), by_output
    (the same per output), lanes_beyond, ms, old_ms, plain_ms (lists),
    bound; for the surface backward also bit_equal_to_old, contention (a
    list); for the combine backward paths (its launches in ``run()`` by
    path))}."""
    import torch

    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.render.renderer import (shade_combine_backward_reference,
                                           shade_surface_backward_reference)

    paths = dict(k4.PATH_LAUNCHES)
    with _recording(k4, "shade_surface_backward_cuda") as surf, \
            _recording(k4, "shade_combine_backward_cuda") as comb:
        run()
    torch.cuda.synchronize()
    paths = {p: k4.PATH_LAUNCHES[f"combine_bwd {p}"]
             - paths[f"combine_bwd {p}"] for p in ("v4", "scalar")}
    if (len(surf), len(comb)) != (expected, expected) or \
            sum(paths.values()) != expected:
        raise AssertionError(f"the {tag} launched the shade backward kernels "
                             f"{len(surf)} + {len(comb)} times (the combine "
                             f"backward {paths} by path), expected "
                             f"{expected} + {expected}")
    out = {}
    for stage, calls in (("surface_bwd", surf), ("combine_bwd", comb)):
        by_output, share_max = {}, 0.0
        ms, plain_ms, bounds = [], [], []
        old_ms, no_table_ms, contention, bit_equal = [], [], [], True
        for i, (args, kwargs, got) in enumerate(calls):
            flags = tuple(args[10:]) + tuple(kwargs.values())
            if stage == "surface_bwd":
                rays_grad, table_grad = (flags + (True, True))[:2]
                want = shade_surface_backward_reference(
                    *args[:10], acc_dtype=torch.float64)
                names = ("g_o_w", "g_d_w", "g_t", "g_n_obj")
                pairs = list(zip(names, got[:4], want[:4]))
                kernel = k4.shade_surface_backward_cuda
                plain = shade_surface_backward_reference
                bounds.append(_surface_bwd_bound(args[0], args, rays_grad,
                                                 table_grad))
                if (got[4] is None) != (want[4] is None or not table_grad):
                    raise AssertionError(f"{tag} {stage} {i}: the colour "
                                         f"table's cotangent is set on one "
                                         f"side only")
                old = kernel(*args, **kwargs, _old_design=True)
                bit_equal = bit_equal and all(
                    torch.equal(a, b) for a, b in zip(old[:4], got[:4])
                    if a is not None)
                for side, table in (("", got[4]), ("first design's ", old[4])):
                    if table is None:
                        continue
                    scale = want[4].abs().max().item()
                    e = (table.double() - want[4]).abs().max().item()
                    if not (bool(torch.isfinite(table).all()) and scale > 0
                            and e <= SCATTER_RTOL * scale):
                        raise AssertionError(
                            f"{tag} {stage} {i}: the {side}colour table's "
                            f"cotangent is off by {e:.3e} > {SCATTER_RTOL} "
                            f"* {scale:.3e}")
                    key = "g_colors_old" if side else "g_colors"
                    by_output[key] = max(by_output.get(key, 0.0), e / scale)
                del old
                if args[0].use_voxel_colors:
                    contention.append(_row_contention(args[0], args[5],
                                                      args[6]))
            else:
                want = shade_combine_backward_reference(*args[:10])
                pairs = list(zip(COMBINE_GRADS, got, want))
                kernel = k4.shade_combine_backward_cuda
                plain = shade_combine_backward_reference
                bounds.append(_combine_bwd_bound(args[0], args, got))
                # both designs with their outputs filled first: every
                # cotangent bit-equal
                with _filled_outputs():
                    new = kernel(*args, **kwargs)
                    old = kernel(*args, **kwargs, _old_design=True)
                bad = [n for n, a, b in zip(COMBINE_GRADS, new, old)
                       if (a is None) != (b is None)
                       or a is not None and not _nan_equal(a, b)]
                if bad:
                    raise AssertionError(f"{tag} {stage} {i}: the "
                                         f"redesign's {bad} differ from the "
                                         f"first design's")
                del new, old
            pairs = [(n, a, b) for n, a, b in pairs
                     if a is not None]  # not asked for, or no such input
            scale = max(b.abs().max().item() for _, _, b in pairs
                        if b is not None)
            for name, a, b in pairs:
                if b is None or a.shape != b.shape:
                    raise AssertionError(f"{tag} {stage} {i}: {name} has no "
                                         f"plain counterpart of its shape")
                share, worst = _grad_beyond(a, b, scale)
                if share > SHADE_GRAD_LANE_BUDGET:
                    raise AssertionError(
                        f"{tag} {stage} {i}: {name} differs from the plain "
                        f"version beyond {SHADE_GRAD_RTOL} * |g| + "
                        f"{SHADE_GRAD_ATOL} * {scale:.3e} on {share:.2e} of "
                        f"lanes (largest difference {worst:.3e} * "
                        f"{scale:.3e})")
                by_output[name] = max(by_output.get(name, 0.0), worst)
                share_max = max(share_max, share)
            del want
            if stage == "surface_bwd":
                olds, news = _paired_ms(
                    lambda: kernel(*args, **kwargs, _old_design=True),
                    lambda: kernel(*args, **kwargs), 20)
                ms.append(sum(news) / 2)
                old_ms.append(sum(olds) / 2)
                # what the colour table's cotangent costs: the launch
                # without it
                no_table_ms.append(device_ms(
                    lambda: kernel(*args[:10], rays_grad=rays_grad,
                                   table_grad=False), 20))
                print(f"shade surface_bwd [{tag} {i}]: without the colour "
                      f"table's cotangent {no_table_ms[-1]:.4f} ms",
                      flush=True)
                print(f"shade surface_bwd [{tag} {i}]: old, new, new, old "
                      f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
                      f" ms; bound {bounds[-1]['bound_ms']:.4f} ms = "
                      f"{bounds[-1]['bound_ms'] / ms[-1]:.0%} of new, "
                      f"{bounds[-1]['bound_ms'] / old_ms[-1]:.0%} of old; "
                      f"per-ray cotangents bit-equal to the first design's "
                      f"{bit_equal}; colour rows "
                      f"{contention[-1] if contention else None}",
                      flush=True)
            else:
                olds, news = _paired_ms(
                    lambda: kernel(*args, **kwargs, _old_design=True),
                    lambda: kernel(*args, **kwargs), 20)
                ms.append(sum(news) / 2)
                old_ms.append(sum(olds) / 2)
                print(f"shade combine_bwd [{tag} {i}]: old, new, new, old "
                      f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
                      f" ms; bound {bounds[-1]['bound_ms']:.4f} ms = "
                      f"{bounds[-1]['bound_ms'] / ms[-1]:.0%} of new, "
                      f"{bounds[-1]['bound_ms'] / old_ms[-1]:.0%} of old; "
                      f"every cotangent bit-equal to the first design's",
                      flush=True)
            plain_ms.append(device_ms(lambda: plain(*args[:10]), 2))
            hit = args[5].hit if stage == "surface_bwd" else args[4]
            print(f"shade {stage} vs plain [{tag} {i}]: rays {hit.numel()} "
                  f"hits {int(hit.sum())}; largest difference per output over"
                  f" the largest |g| "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in by_output.items())};"
                  f" kernel {ms[-1]:.4f} ms, plain {plain_ms[-1]:.4f} ms, "
                  f"bound {bounds[-1]['bound_ms']:.4f} ms "
                  f"({bounds[-1]['bytes']} B, by {bounds[-1]['bound_by']})",
                  flush=True)
        out[stage] = dict(launches=len(calls),
                          max_abs_err=max(by_output.values(), default=0.0),
                          by_output=by_output, lanes_beyond=share_max, ms=ms,
                          plain_ms=plain_ms, bound=_sum_bounds(bounds))
        out[stage]["old_ms"] = old_ms
        if stage == "surface_bwd":
            out[stage].update(no_table_ms=no_table_ms,
                              bit_equal_to_old=bit_equal,
                              contention=contention)
        else:
            out[stage].update(paths=paths, bit_equal_to_old=True)
        got = out[stage]
        print(f"shade {stage} on the {tag}: {got['launches']} launches, "
              f"{_list(ms)} ms = {sum(ms):.4f} ms; plain {sum(plain_ms):.2f} "
              f"ms; bound {got['bound']['bound_ms']:.4f} ms "
              f"({got['bound']['bytes']} B, by {got['bound']['bound_by']}); "
              f"lanes beyond tolerance {share_max:.2e}", flush=True)
    return out


# the flags of each backward kernel's variants (its wrapper's keywords)
SURFACE_FLAGS, COMBINE_FLAGS = ("material", "textures"), ("lights", "env")


def _table_loss(scene, w, h, mode, fields, seed=0):
    """A fit's loss on ``scene``'s w x h frame differentiated in the scene
    tables ``fields`` (leaves of their own): a callable that renders the
    frame, weighs its radiance with seeded weights and runs the
    backward."""
    import dataclasses

    import numpy as np
    import torch

    from vrt_torch.render.renderer import render_image

    weights = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(h, w, 3)).astype(np.float32)).to(scene.cam_pos.device)

    def run():
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_(True)
                  for f in fields}
        rgb = render_image(dataclasses.replace(scene, **leaves), w, h, mode)
        return torch.autograd.grad((rgb[..., :3] * weights).sum(),
                                   list(leaves.values()), allow_unused=True)

    return run


def _variant_tables(surface, flags, got, want):
    """The scene tables a variant launch returned, as (name, the kernel's,
    the plain version's float64 sum, its lanes' |terms|, or None for the
    colour table), from the wrapper's outputs ``got`` and the plain
    version's ``want`` with the same ``flags``."""
    from vrt_torch.render.gpuscene import LIGHT_FIELDS, MATERIAL_FIELDS

    if surface:
        out = [("g_colors", got[4], want[4], None)]
        g, w = list(got[5:]), list(want[5:])
        if "material" in flags:
            out += [(f"g_{f}", a, b, t) for f, a, b, t in zip(
                MATERIAL_FIELDS, g[:4], w[:4], w[4])]
            g, w = g[4:], w[5:]
        if "textures" in flags:
            out += [(f"g_{f}", a, b, t) for f, a, b, t in zip(
                ("tex_scale", "textures"), g[:2], w[:2], w[2])]
        return out
    out = []
    if "lights" in flags:
        out += [(f"g_{f}", a, b, t) for f, a, b, t in zip(
            LIGHT_FIELDS, got[10], want[10], want[11])]
    if "env" in flags:
        out.append(("g_env", got[-1], want[-2], want[-1]))
    return out


def _variant_calls(run, expected, tag, surface=("material",),
                   combine=("lights",)):
    """Every launch of the surface backward with the variant flags
    ``surface`` (``shade_surface_backward_cuda(..., material=True)``, the
    material variant; ``textures=True``, the texture variant; both, one
    launch of both) and of the combine backward with the flags ``combine``
    (``lights=True``, the light variant; ``env=True``, the env variant) in
    ``run()``, kept with its inputs and outputs, then held against its
    plain version on the same inputs (the reference with the same flags:
    autograd of the plain stage with the tables' reads as leaves, summed
    over the lanes in float64): every per-ray cotangent (the record's k's
    among them) under ``_grad_beyond``'s tolerance on every lane, the
    colour table within ``SCATTER_RTOL`` * its largest |sum|, each entry of
    a material constant, light table, the texture scale, the stacked
    textures or the env cube within ``SCATTER_RTOL`` * the sum of its own
    lanes' |terms| + ``TABLE_ATOL`` (an entry's terms may cancel, and each
    lane's term rounds on its own; the largest error over the table's
    largest |sum| is reported too), the padding of the stacked textures
    exactly zero; and against the default instantiation on the same
    inputs: every per-ray cotangent the default launch returns bit-equal,
    the two timed default, variant, variant, default; a texture or env
    variant also against its first design (``_old_table_design``), the
    material variant without the texture variant against its sums' first
    design (``_old_sums_design``), on the same inputs: its per-ray
    cotangents bit-equal, its tables held as the redesign's, the two timed
    first design, redesign, redesign, first design.  Fails unless each
    launched ``expected`` times (and the texture and env variants on one
    path, ``kernels.shade.table_path``, and on their redesigns, the
    material variant alone on its sums' redesign).  Returns {"surface_bwd " +
    "+".join(surface) | "combine_bwd " + "+".join(combine): dict(launches,
    max_abs_err (the largest difference over its scale, per-ray outputs and
    tables), by_output, ms, default_ms, plain_ms (lists), bound, paths
    (the texture or env variant's launches by path), first_design_ms,
    redesign_beside_first_ms (the texture or env variant's pairs, the
    material variant's alone, else empty))}."""
    import torch

    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.render.renderer import (shade_combine_backward_reference,
                                           shade_surface_backward_reference)

    before = dict(k4.VARIANT_LAUNCHES)
    tables_before = dict(k4.TABLE_LAUNCHES)
    designs_before = dict(k4.TABLE_DESIGN_LAUNCHES)
    sums_before = dict(k4.SUMS_DESIGN_LAUNCHES)
    with _recording(k4, "shade_surface_backward_cuda") as surf, \
            _recording(k4, "shade_combine_backward_cuda") as comb:
        run()
    torch.cuda.synchronize()
    sums_designs = {k: k4.SUMS_DESIGN_LAUNCHES[k] - sums_before[k]
                    for k in sums_before}
    # the material variant without the texture variant: its sums' redesign
    summed = "material" in surface and "textures" not in surface
    launched = {k: k4.VARIANT_LAUNCHES[k] - before[k] for k in before}
    paths = {k: k4.TABLE_LAUNCHES[k] - tables_before[k]
             for k in tables_before}
    designs = {k: k4.TABLE_DESIGN_LAUNCHES[k] - designs_before[k]
               for k in designs_before}
    surf = [c for c in surf
            if tuple(f for f in SURFACE_FLAGS if c[1].get(f)) == surface]
    comb = [c for c in comb
            if tuple(f for f in COMBINE_FLAGS if c[1].get(f)) == combine]
    want_launched = {"surface_bwd material": expected * ("material"
                                                         in surface),
                     "combine_bwd lights": expected * ("lights" in combine),
                     "surface_bwd instances": 0}
    keys = ("surface_bwd " + "+".join(surface),
            "combine_bwd " + "+".join(combine))
    table_paths = {
        keys[0]: {p: paths[f"surface_bwd textures {p}"]
                  for p in ("shared", "global")},
        keys[1]: {p: paths[f"combine_bwd env {p}"]
                  for p in ("shared", "global")}}
    tabled = {keys[0]: "textures" in surface, keys[1]: "env" in combine}
    # the texture and env launches of the run all on the redesigns
    want_designs = {"surface_bwd textures warp": expected * tabled[keys[0]],
                    "surface_bwd textures first": 0,
                    "combine_bwd env warp": expected * tabled[keys[1]],
                    "combine_bwd env first": 0}
    if (len(surf), len(comb)) != (expected, expected) or \
            launched != want_launched or designs != want_designs or \
            sums_designs != {"surface_bwd sums warp": expected * summed,
                             "surface_bwd sums first": 0} or any(
                sorted(table_paths[k].values()) != ([0, expected]
                                                    if tabled[k] else [0, 0])
                for k in keys):
        raise AssertionError(f"the {tag} called the surface backward with "
                             f"{surface} {len(surf)} times and the combine "
                             f"backward with {combine} {len(comb)} times "
                             f"(variant launches {launched}, by path "
                             f"{paths}, by design {designs}, {sums_designs}),"
                             f" expected {expected} each")
    out = {}
    for key, calls, flags in zip(keys, (surf, comb), (surface, combine)):
        by_output, ms, default_ms, plain_ms, bounds = {}, [], [], [], []
        first_ms, beside_ms = [], []
        is_surface = key.startswith("surface")
        kernel = k4.shade_surface_backward_cuda if is_surface \
            else k4.shade_combine_backward_cuda
        for i, (args, kwargs, got) in enumerate(calls):
            scene = args[0]
            if is_surface:
                rays_grad, table_grad = (tuple(args[10:]) + (True, True))[:2]

                def plain():
                    return shade_surface_backward_reference(
                        *args[:10], acc_dtype=torch.float64,
                        g_k=kwargs.get("g_k"),
                        **{f: True for f in flags})

                want = plain()
                per_ray = zip(("g_o_w", "g_d_w", "g_t", "g_n_obj"), got[:4],
                              want[:4])
                shared, hits = 4, int(args[5].hit.sum())
                base = _surface_bwd_bound(scene, args, rays_grad,
                                          table_grad)
                # the record's k read on the hit lanes, the [V,8]
                # accumulator written once; the texture scale's and the
                # textures' accumulators written once
                extra = (hits * 4 + scene.tint.shape[0] * 32
                         if "material" in flags else 0) \
                    + ((scene.tex_scale.numel() + scene.textures.numel()) * 4
                       if "textures" in flags else 0)
            else:
                def plain():
                    return shade_combine_backward_reference(
                        *args[:10], **{f: True for f in flags})

                want = plain()
                n = len(COMBINE_GRADS) + ("lights" in flags)
                per_ray = zip(COMBINE_GRADS + ("g_k",), got[:n], want[:n])
                shared = 9
                base = _combine_bwd_bound(scene, args, got[:n])
                # the light tables' and the env cube's accumulators written
                # once
                extra = (sum(g.numel() * 4 for g in got[10])
                         if "lights" in flags else 0) \
                    + (scene.env.numel() * 4 if "env" in flags else 0)
            bounds.append(_bound(base["bytes"] + extra, base["flops"]))
            per_ray = [(n, a, b) for n, a, b in per_ray if a is not None]
            scale = max(b.abs().max().item() for _, _, b in per_ray)
            for name, a, b in per_ray:
                share, worst = _grad_beyond(a, b, scale)
                if share > SHADE_GRAD_LANE_BUDGET:
                    raise AssertionError(
                        f"{tag} {key} {i}: {name} differs from the plain "
                        f"version beyond {SHADE_GRAD_RTOL} * |g| + "
                        f"{SHADE_GRAD_ATOL} * {scale:.3e} on {share:.2e} of "
                        f"lanes (largest difference {worst:.3e} * "
                        f"{scale:.3e})")
                by_output[name] = max(by_output.get(name, 0.0), worst)
            def hold_tables(outs, label=""):
                # every scene table of ``outs`` against the plain version's
                # float64 sums, the padding of the stack zero
                where = f"{tag} {key} {i}{label}"
                for name, a, b, terms in _variant_tables(is_surface, flags,
                                                         outs, want):
                    if a is None:
                        continue
                    b = b.double().reshape(a.shape)
                    top = b.abs().max().item()
                    err = (a.double() - b).abs()
                    e = err.max().item()
                    if not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"{where}: {name} is not finite")
                    if terms is None:
                        # the colour table against its largest |sum|
                        if not (e <= SCATTER_RTOL * top if top > 0
                                else not bool(a.any())):
                            raise AssertionError(
                                f"{where}: {name} is off by {e:.3e} > "
                                f"{SCATTER_RTOL} * {top:.3e}")
                        by_output[name + label] = max(
                            by_output.get(name + label, 0.0),
                            e / top if top > 0 else 0.0)
                        continue
                    # a scene table, each entry against the sum of its own
                    # lanes' |terms|
                    bound = SCATTER_RTOL * terms.double().reshape(a.shape) \
                        + TABLE_ATOL
                    worst = (err / bound).max().item()
                    if not worst <= 1.0:
                        raise AssertionError(
                            f"{where}: {name} is off by up to {worst:.3e} "
                            f"times {SCATTER_RTOL} * its lanes' |terms| + "
                            f"{TABLE_ATOL}")
                    over = f"{name}{label} over its bound"
                    by_output[over] = max(by_output.get(over, 0.0), worst)
                    if top > 0:
                        key_max = f"{name}{label} over max|sum|"
                        by_output[key_max] = max(by_output.get(key_max, 0.0),
                                                 e / top)
                    if name == "g_textures":
                        # the stack's padding past each texture's size
                        for t, (h, w) in enumerate(scene.tex_sizes.tolist()):
                            if bool(a[t, h:].any()) or bool(a[t, :, w:].any()):
                                raise AssertionError(
                                    f"{where}: the padding of texture {t} "
                                    f"got a cotangent")

            hold_tables(got)
            # the texture or env variant's first design, the material
            # variant's sums' first design, on the same inputs: per-ray
            # cotangents bit-equal, its tables held the same way
            tabled_here = ("textures" if is_surface else "env") in flags
            first_kw = {"_old_table_design": True} if tabled_here else \
                {"_old_sums_design": True} if is_surface and summed else None
            if first_kw is not None:
                first = kernel(*args, **kwargs, **first_kw)
                bad = [j for j, (a, b) in enumerate(zip(got[:shared],
                                                        first[:shared]))
                       if (a is None) != (b is None)
                       or a is not None and not torch.equal(a, b)]
                if bad:
                    raise AssertionError(f"{tag} {key} {i}: outputs {bad} of "
                                         f"the first design differ from the "
                                         f"redesign's")
                hold_tables(first, " (first design)")
                del first
            del want
            # the default instantiation on the same inputs
            default = kernel(*args)
            bad = [j for j, (a, b) in enumerate(zip(got[:shared],
                                                    default[:shared]))
                   if (a is None) != (b is None)
                   or a is not None and not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"{tag} {key} {i}: outputs {bad} differ "
                                     f"from the default instantiation's")
            del default
            olds, news = _paired_ms(lambda: kernel(*args),
                                    lambda: kernel(*args, **kwargs), 20)
            ms.append(sum(news) / 2)
            default_ms.append(sum(olds) / 2)
            plain_ms.append(device_ms(plain, 2))
            if first_kw is not None:
                # the first design against the redesign: old, new, new, old
                firsts, again = _paired_ms(
                    lambda: kernel(*args, **kwargs, **first_kw),
                    lambda: kernel(*args, **kwargs), 20)
                first_ms.append(sum(firsts) / 2)
                beside_ms.append(sum(again) / 2)
                print(f"shade {key} [{tag} {i}]: its first design, the "
                      f"redesign, the redesign, its first design "
                      f"{', '.join(f'{t:.4f}' for t in (firsts[0], again[0], again[1], firsts[1]))}"
                      f" ms", flush=True)
            print(f"shade {key} [{tag} {i}]: default, variant, variant, "
                  f"default "
                  f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
                  f" ms; plain {plain_ms[-1]:.2f} ms; bound "
                  f"{bounds[-1]['bound_ms']:.4f} ms ({bounds[-1]['bytes']} B, "
                  f"by {bounds[-1]['bound_by']}); largest difference per "
                  f"output over its scale "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in by_output.items())}",
                  flush=True)
        out[key] = dict(launches=len(calls),
                        max_abs_err=max((v for k, v in by_output.items()
                                         if not k.endswith("its bound")),
                                        default=0.0),
                        by_output=by_output, ms=ms, default_ms=default_ms,
                        plain_ms=plain_ms, bound=_sum_bounds(bounds),
                        paths=table_paths[key], first_design_ms=first_ms,
                        redesign_beside_first_ms=beside_ms)
        got = out[key]
        print(f"shade {key} on the {tag}: {got['launches']} launches "
              f"(texture or env path {got['paths']}), {_list(ms)} ms = "
              f"{sum(ms):.4f} ms (the default instantiation on the same "
              f"inputs {sum(default_ms):.4f} ms"
              + (f"; the first design {sum(first_ms):.4f} ms against "
                 f"{sum(beside_ms):.4f} ms in the same turns" if first_ms
                 else "")
              + f"); plain {sum(plain_ms):.2f} ms; bound "
              f"{got['bound']['bound_ms']:.4f} ms", flush=True)
    return out


def _instance_calls(run, expected, tag):
    """Every launch of the two backward kernels' instance variants in
    ``run()`` (``shade_surface_backward_cuda(..., instances=True)`` and
    ``resolve_scene_backward_cuda(..., instances=True)``, with the flags it
    was given: the material or texture variant in the same surface launch),
    kept with its inputs and outputs, then held against its plain version on
    the same inputs (the reference with the same flags: the surface's
    autograd of the plain stage with the transforms' reads as leaves, the
    resolve's closed form; the transforms summed over the lanes in float64):
    every per-ray cotangent under its tolerance on every lane (the
    surface's ``_grad_beyond``, the resolve's ``RAY_GRAD_RTOL`` * max|g|),
    the colour and corner tables within ``SCATTER_RTOL`` * their largest
    |sum|, each transform entry within ``SCATTER_RTOL`` * the sum of its own
    lanes' |terms| + ``TABLE_ATOL``; and against the default instantiation
    on the same inputs: every per-ray cotangent bit-equal, the two timed
    default, variant, variant, default (a resolve backward asked for
    neither the rays' nor the table's gradient has nothing to launch on
    the default instantiation: its time is the wrapper's return, counted
    apart in ``default_launches``); the surface's also against its sums'
    first design (``_old_sums_design``) on the same inputs: every per-ray
    cotangent bit-equal, its colour table and transforms held as the
    redesign's, the two timed first design, redesign, redesign, first
    design.  Fails unless each launched ``expected`` times, counted as the
    variant (the surface's on its sums' redesign).  Returns {"surface_bwd
    instances" | "resolve_bwd instances": dict(launches, default_launches,
    max_abs_err, by_output, ms, default_ms, plain_ms, first_design_ms,
    redesign_beside_first_ms (the surface's; lists), bound)}."""
    import torch

    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.render.gpuscene import INSTANCE_FIELDS
    from vrt_torch.render.renderer import (resolve_scene_backward_reference,
                                           shade_surface_backward_reference)

    before = (dict(k4.VARIANT_LAUNCHES), dict(kr.VARIANT_LAUNCHES),
              dict(k4.SUMS_DESIGN_LAUNCHES))
    with _recording(k4, "shade_surface_backward_cuda") as surf, \
            _recording(kr, "resolve_scene_backward_cuda") as res:
        run()
    torch.cuda.synchronize()
    launched = (k4.VARIANT_LAUNCHES["surface_bwd instances"]
                - before[0]["surface_bwd instances"],
                kr.VARIANT_LAUNCHES["backward instances"]
                - before[1]["backward instances"])
    sums_designs = {k: k4.SUMS_DESIGN_LAUNCHES[k] - before[2][k]
                    for k in before[2]}
    surf = [c for c in surf if c[1].get("instances")]
    res = [c for c in res if c[1].get("instances")]
    if (len(surf), len(res)) != (expected, expected) or \
            launched != (expected, expected) or \
            sums_designs != {"surface_bwd sums warp": expected,
                             "surface_bwd sums first": 0}:
        raise AssertionError(f"the {tag} called the surface backward's "
                             f"instance variant {len(surf)} times and the "
                             f"resolve backward's {len(res)} times (variant "
                             f"launches {launched}, sums' designs "
                             f"{sums_designs}), expected {expected} each")
    out = {}
    for key, calls in (("surface_bwd instances", surf),
                       ("resolve_bwd instances", res)):
        is_surface = key.startswith("surface")
        kernel = k4.shade_surface_backward_cuda if is_surface \
            else kr.resolve_scene_backward_cuda
        by_output, ms, default_ms, plain_ms, bounds = {}, [], [], [], []
        first_ms, beside_ms = [], []
        default_launches = 0
        for i, (args, kwargs, got) in enumerate(calls):
            scene = args[0]
            flags = {k: v for k, v in kwargs.items()
                     if k in ("material", "textures", "instances", "g_k")}
            if is_surface:
                rays_grad, table_grad = (tuple(args[10:]) + (True, True))[:2]

                def plain():
                    return shade_surface_backward_reference(
                        *args[:10], acc_dtype=torch.float64, **flags)

                want = plain()
                per_ray = list(zip(("g_o_w", "g_d_w", "g_t", "g_n_obj"),
                                   got[:4], want[:4]))
                base = _surface_bwd_bound(scene, args, rays_grad,
                                          table_grad)
                table = ("g_colors", got[4], want[4])
            else:
                rays_grad, table_grad = (tuple(args[7:9]) + (True, True))[:2]

                def plain():
                    return resolve_scene_backward_reference(
                        *args[:7], acc_dtype=torch.float64, instances=True)

                want = plain()
                per_ray = list(zip(("g_o_w", "g_d_w"), got[:2], want[:2]))
                base = _resolve_bwd_bound(scene, args[3], args[4], rays_grad,
                                          table_grad)
                table = ("g_corners", got[2], want[2])
            # the variant's own bytes: its [I,10] accumulator written once
            bounds.append(_bound(base["bytes"] + scene.num_instances * 40,
                                 base["flops"]))
            # (the primary rays of a fixed camera ask for no ray gradient)
            per_ray = [(n, a, b) for n, a, b in per_ray if a is not None]
            scale = max((b.abs().max().item() for _, _, b in per_ray),
                        default=0.0)
            for name, a, b in per_ray:
                if is_surface:
                    share, worst = _grad_beyond(a, b, scale)
                    ok = share <= SHADE_GRAD_LANE_BUDGET
                else:
                    e = (a - b).abs().max().item()
                    worst = e / scale if scale > 0 else e
                    ok = bool(torch.isfinite(a).all()) \
                        and worst <= RAY_GRAD_RTOL
                if not ok:
                    raise AssertionError(f"{tag} {key} {i}: {name} differs "
                                         f"from the plain version (largest "
                                         f"difference {worst:.3e} * "
                                         f"{scale:.3e})")
                by_output[name] = max(by_output.get(name, 0.0), worst)
            def hold_tables(outs, label=""):
                # the colour or corner table against its largest |sum|,
                # each transform entry against its lanes' |terms|
                name, b = table[0], table[2]
                a = outs[4] if is_surface else outs[2]
                if a is not None:
                    top = b.abs().max().item()
                    e = (a.double() - b.double().reshape(a.shape)).abs() \
                        .max().item()
                    if not (bool(torch.isfinite(a).all())
                            and (e <= SCATTER_RTOL * top if top > 0
                                 else not bool(a.any()))):
                        raise AssertionError(
                            f"{tag} {key} {i}{label}: {name} is off by "
                            f"{e:.3e} > {SCATTER_RTOL} * {top:.3e}")
                    by_output[name + label] = max(
                        by_output.get(name + label, 0.0),
                        e / top if top > 0 else 0.0)
                for name, a, b, terms in zip(INSTANCE_FIELDS, outs[-3:],
                                             want[-4:-1], want[-1]):
                    b = b.double().reshape(a.shape)
                    err = (a.double() - b).abs()
                    bound = SCATTER_RTOL * terms.double().reshape(a.shape) \
                        + TABLE_ATOL
                    worst = (err / bound).max().item()
                    if not (bool(torch.isfinite(a).all()) and worst <= 1.0):
                        raise AssertionError(
                            f"{tag} {key} {i}{label}: {name} is off by up to "
                            f"{worst:.3e} times {SCATTER_RTOL} * its lanes' "
                            f"|terms| + {TABLE_ATOL}")
                    top = b.abs().max().item()
                    for k, v in ((f"g_{name}{label} over its bound", worst),
                                 (f"g_{name}{label} over max|sum|",
                                  err.max().item() / top if top > 0
                                  else 0.0)):
                        by_output[k] = max(by_output.get(k, 0.0), v)

            hold_tables(got)
            if is_surface:
                # the sums' first design on the same inputs: per-ray
                # cotangents bit-equal, its tables held the same way
                first = kernel(*args, **kwargs, _old_sums_design=True)
                bad = [j for j in range(4)
                       if (got[j] is None) != (first[j] is None)
                       or got[j] is not None
                       and not torch.equal(got[j], first[j])]
                if bad:
                    raise AssertionError(f"{tag} {key} {i}: outputs {bad} of "
                                         f"the sums' first design differ "
                                         f"from the redesign's")
                hold_tables(first, " (first design)")
                del first
            del want
            # the default instantiation on the same inputs
            default_kw = {k: v for k, v in kwargs.items()
                          if k != "instances"}
            default = kernel(*args, **default_kw)
            n = 4 if is_surface else 2
            bad = [j for j, (a, b) in enumerate(zip(got[:n], default[:n]))
                   if (a is None) != (b is None)
                   or a is not None and not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"{tag} {key} {i}: outputs {bad} differ "
                                     f"from the default instantiation's")
            del default
            olds, news = _paired_ms(lambda: kernel(*args, **default_kw),
                                    lambda: kernel(*args, **kwargs), 20)
            ms.append(sum(news) / 2)
            default_ms.append(sum(olds) / 2)
            plain_ms.append(device_ms(plain, 2))
            if is_surface:
                # the sums' first design against the redesign: old, new,
                # new, old
                firsts, again = _paired_ms(
                    lambda: kernel(*args, **kwargs, _old_sums_design=True),
                    lambda: kernel(*args, **kwargs), 20)
                first_ms.append(sum(firsts) / 2)
                beside_ms.append(sum(again) / 2)
                print(f"{key} [{tag} {i}]: its sums' first design, the "
                      f"redesign, the redesign, the first design "
                      f"{', '.join(f'{t:.4f}' for t in (firsts[0], again[0], again[1], firsts[1]))}"
                      f" ms", flush=True)
            launches_default = is_surface or rays_grad or table_grad
            default_launches += launches_default
            print(f"{key} [{tag} {i}]: "
                  + ("" if launches_default else "(the default launches "
                     "nothing: no ray or table gradient asked) ")
                  + f"default, variant, variant, default "
                  f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
                  f" ms; plain {plain_ms[-1]:.2f} ms; bound "
                  f"{bounds[-1]['bound_ms']:.4f} ms ({bounds[-1]['bytes']} B, "
                  f"by {bounds[-1]['bound_by']}); largest difference per "
                  f"output "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in by_output.items())}",
                  flush=True)
        out[key] = dict(launches=len(calls),
                        default_launches=default_launches,
                        max_abs_err=max((v for k, v in by_output.items()
                                         if not k.endswith("its bound")),
                                        default=0.0),
                        by_output=by_output, ms=ms, default_ms=default_ms,
                        plain_ms=plain_ms, first_design_ms=first_ms,
                        redesign_beside_first_ms=beside_ms,
                        bound=_sum_bounds(bounds))
        got = out[key]
        print(f"{key} on the {tag}: {got['launches']} launches, {_list(ms)} "
              f"ms = {sum(ms):.4f} ms (the default instantiation on the same "
              f"inputs {sum(default_ms):.4f} ms, "
              f"{default_launches} of them launching"
              + (f"; the sums' first design {sum(first_ms):.4f} ms against "
                 f"{sum(beside_ms):.4f} ms in the same turns" if first_ms
                 else "")
              + f"); plain {sum(plain_ms):.2f} ms; bound "
              f"{got['bound']['bound_ms']:.4f} ms", flush=True)
    return out


MATERIAL_STEP_KEYS = ("sdf", "voxel_colors", "tint", "roughness", "metallic",
                      "k", "dir_light_dir", "dir_light_strength")
# the texture-and-env step's parameters (phase 8): with the material
# constants and the sun's strength they take both backward kernels'
# variants in one launch each
TEXTURE_STEP_KEYS = ("sdf", "tint", "roughness", "metallic", "tex_scale",
                     "textures", "env", "dir_light_strength")
# the pose step's parameters (phase 8): config6's SDF and colours and the
# instance transforms, through the surface and the resolve backward's
# instance variants
POSE_STEP_KEYS = ("sdf", "voxel_colors", "inst_pos", "inst_rot", "inst_scale")


@contextlib.contextmanager
def _eager_shading_by_lane(kept, plain_resolve=False):
    """``_eager_shading``, each material, texture-scale and instance
    transform read of a surface stage (its ``take``), each texture and env
    tap (``fetch``) and each light table of both stages read as one row a
    lane (``renderer._lane_lights``), so that the caller can differentiate
    the loss in those rows and sum their terms in float64: every read is
    kept in ``kept`` as (field, rows, how to sum them into the table).
    With ``plain_resolve`` every level also resolves on
    ``resolve_scene_reference`` under autograd, its transform reads kept
    the same way."""
    import torch

    from vrt_torch.render import renderer as tren
    from vrt_torch.render.gpuscene import INSTANCE_FIELDS, MATERIAL_FIELDS
    from vrt_torch.shade import texture as tex

    def lights(scene, lanes):
        lit, views = tren._lane_lights(scene, lanes)
        for f, (v, axis) in views.items():
            if v.requires_grad:
                kept.append((f, v, lambda g, axis=axis, shape=getattr(
                    scene, f).shape: g.sum(dim=axis).reshape(shape)))
        return lit

    def rows_of(name, table, rows, idx):
        # the rows' gradient summed into the table viewed as [rows, ...]
        if rows.requires_grad:
            kept.append((name, rows, lambda g, shape=table.shape: torch.zeros(
                (table.numel() // max(torch.Size(g.shape[1:]).numel(), 1),)
                + g.shape[1:], dtype=g.dtype, device=g.device)
                .index_add_(0, idx, g).reshape(shape)))
        return rows

    def fetcher(scene):
        names = {id(scene.textures): "textures", id(scene.env): "env"}

        def fetch(table, *index):
            return rows_of(names[id(table)], table,
                           tex.fetch_rows(table, *index),
                           tex.flat_index(index, table.shape))
        return fetch

    def taker(scene):
        names = {id(getattr(scene, f)): f
                 for f in MATERIAL_FIELDS + ("tex_scale",) + INSTANCE_FIELDS}

        def take(table, idx):
            return rows_of(names[id(table)], table, table[idx], idx)
        return take

    def surface(scene, o_w, *args, **kwargs):
        return tren.shade_surface_reference(lights(scene, o_w.shape[0]),
                                            o_w, *args, take=taker(scene),
                                            fetch=fetcher(scene), **kwargs)

    def resolve(scene, o_w, d_w, hit, inst):
        return tren.resolve_scene_reference(scene, o_w, d_w, hit, inst,
                                            take=taker(scene))

    def combine(scene, rec, d_w, *args, **kwargs):
        return tren.shade_combine_reference(lights(scene, d_w.shape[0]),
                                            rec, d_w, *args,
                                            fetch=fetcher(scene), **kwargs)

    saved = tren.shade_stages, tren.resolve_scene
    tren.shade_stages = lambda *_: (surface, combine)
    if plain_resolve:
        tren.resolve_scene = resolve
    try:
        yield
    finally:
        tren.shade_stages, tren.resolve_scene = saved


@contextlib.contextmanager
def _plain_backward(terms):
    """The shade Functions' and ``ResolveScene``'s backward kernels replaced
    by their plain versions on the same saved inputs
    (``shade_surface_backward_reference`` /
    ``shade_combine_backward_reference`` with the launch's variant flags:
    autograd of the plain stages, each scene table summed over the lanes in
    float64; ``resolve_scene_backward_reference``, the closed form, with
    ``instances`` where the launch had it), in the wrappers' output format:
    a step's forward on the kernels and its backward on the plain versions.
    Each table's sum of its lanes' |terms| is added into ``terms`` (by
    field, float64)."""
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import (INSTANCE_FIELDS, LIGHT_FIELDS,
                                           MATERIAL_FIELDS)
    from vrt_torch.render.renderer import (resolve_scene_backward_reference,
                                           shade_combine_backward_reference,
                                           shade_surface_backward_reference)

    def add(fields, sums):
        for f, t in zip(fields, sums):
            terms[f] = terms[f] + t if f in terms else t

    def surface(scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce, cots,
                rays_grad=True, table_grad=True, g_k=None, material=False,
                textures=False, instances=False):
        want = shade_surface_backward_reference(
            scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce, cots,
            g_k=g_k, material=material, textures=textures,
            instances=instances)
        out, rest = list(want[:5]), list(want[5:])
        if not rays_grad:
            out[0] = out[1] = None
        if not table_grad:
            out[4] = None
        if material:
            out += rest[:4]
            add(MATERIAL_FIELDS, rest[4])
            rest = rest[5:]
        if textures:
            out += rest[:2]
            add(("tex_scale", "textures"), rest[2])
            rest = rest[3:]
        if instances:
            out += rest[:3]
            add(INSTANCE_FIELDS, rest[3])
        return tuple(out)

    def resolve(scene, o_w, d_w, hit, inst, g_t, g_n, rays_grad=True,
                table_grad=True, instances=False):
        want = resolve_scene_backward_reference(
            scene, o_w, d_w, hit, inst, g_t, g_n, instances=instances)
        out = [want[0] if rays_grad else None,
               want[1] if rays_grad else None,
               want[2] if table_grad else None]
        if instances:
            out += want[3:6]
            add(INSTANCE_FIELDS, want[6])
        return tuple(out)

    def combine(scene, rec, d_w, n_obj, hit_mask, unlit_attr, refl_rgb,
                blocked, mode, g_rgb, needs=None, lights=False, env=False):
        want = shade_combine_backward_reference(
            scene, rec, d_w, n_obj, hit_mask, unlit_attr, refl_rgb, blocked,
            mode, g_rgb, lights=lights, env=env)
        out = list(want[:9])
        if lights:
            out += [want[9], want[10]]
            add(LIGHT_FIELDS, want[11])
        if env:
            out.append(want[-2])
            add(("env",), want[-1:])
        return tuple(out)

    saved = (k4.shade_surface_backward_cuda, k4.shade_combine_backward_cuda,
             kr.resolve_scene_backward_cuda)
    (k4.shade_surface_backward_cuda, k4.shade_combine_backward_cuda,
     kr.resolve_scene_backward_cuda) = surface, combine, resolve
    try:
        yield
    finally:
        (k4.shade_surface_backward_cuda, k4.shade_combine_backward_cuda,
         kr.resolve_scene_backward_cuda) = saved


def _table_step(dev, card, sync, zero_counts, counts, timed, scene, cams,
                keys, what, flags, sdf_step=None, per_entry=False,
                profile_plain=True, first_designs=False):
    """A 1080p fit step of ``scene`` from ``cams`` with the scene tables
    ``keys`` among its parameters (Adam at 1e-2 towards zero targets): on
    the kernels (every level through the shade Functions, the backward
    kernels' variants ``flags``: (the surface's, the combine's), one launch
    each a level; with "instances" among the surface's also the resolve
    backward's instance variant), and the same step forced onto the plain
    pair (``_eager_shading``: the plain stages under autograd; with
    "instances" resolve too, on ``resolve_scene_reference`` under autograd
    over K3), old, new, new, old (the kernels' medians of 3, one step on
    the plain route, which takes seconds), with the SDF-and-colour
    step ``sdf_step`` of phase 8 beside it in the same order where given.
    One step on the kernels, the counts set to 0 just before it: 3 + 3
    forward and 3 + 3 backward shade launches and 3 + 3 fused resolve
    launches, no K3 launch, each backward those variants (its counts are
    the ``launches`` returned).  The loss and its gradients
    on each route (the step's loss function differentiated): the losses
    within 1e-5, the SDF's (and the colours') gradient at ``FIT_COS_TOL``
    and ``FIT_DIFF_TOL`` (``BF16_DIFF_TOL`` for a bf16 corner table), each
    other table's gradient within ``SCATTER_RTOL`` * its largest |sum| of
    the plain route's float64 sum (``_eager_shading_by_lane``: the lanes'
    terms of every read summed in float64, held within 1e-3 of max|sum| of
    autograd's own f32 sums, which shows that no read was missed).  With
    ``per_entry`` the tables are held instead against the same step with
    the backward on the plain versions (``_plain_backward``: the kernels'
    own forward, the tables summed in float64), each entry within
    ``SCATTER_RTOL`` * the sum of its own lanes' |terms| + ``TABLE_ATOL``,
    as the launches are held; the plain pair's float64 sums, whose forward
    on the plain stages rounds otherwise (a smooth mirror's highlight turns
    that into a relative 1e-4 of a lane's cotangent, as the per-ray gates
    allow), are reported beside them, with the check that no read was
    missed.  Device
    ops, busy time and peak memory of a step on each route (without
    ``profile_plain`` the plain route's peak is that of its timed steps and
    it is not profiled); every variant launch of one step held by
    ``_variant_calls`` (the instance variants' by ``_instance_calls``).
    The one step's texture and env launches are the redesigns
    (``TABLE_DESIGN_LAUNCHES``); with ``first_designs`` the step also runs
    with them on their first designs (``_first_table_designs``), first
    design, redesign, redesign, first design (medians of 3), and is
    profiled there too.  Returns dict(routes (ms, peak, busy, device ops),
    launches, designs (the texture and env launches by design), grads,
    held (``_variant_calls``'s), loss, plain_loss)."""
    import numpy as np
    import torch

    from vrt_torch.diff.fit import (graft_and_rebuild, make_fit_step,
                                    render_views)
    from vrt_torch.diff.optim import adam
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render import renderer as tren
    from vrt_torch.render.gpuscene import RenderMode

    posed = "instances" in flags[0]
    params = {k: scene.volumes.sdf if k == "sdf" else getattr(scene, k)
              for k in keys}
    targets = torch.zeros((len(cams), FRAME_W * FRAME_H, 3), device=dev)
    opt = adam(1e-2)
    state = opt.init(params)
    step = make_fit_step(scene, cams, FRAME_W, FRAME_H, RenderMode(), opt)

    def kernel_step():
        return step(params, state, targets)[2]

    def plain_step():
        with _eager_shading(), (_plain_resolve_path() if posed
                                else contextlib.nullcontext()):
            return kernel_step()

    def value_and_grad(kept=()):
        # the step's loss and its gradients, also in the rows in ``kept``
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        s = graft_and_rebuild(scene, leaves)
        loss = torch.mean((render_views(s, cams, FRAME_W, FRAME_H,
                                        RenderMode()) - targets) ** 2)
        grads = torch.autograd.grad(
            loss, list(leaves.values()) + [rows for _, rows, _ in kept],
            allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(list(leaves.values()), grads)] \
            + list(grads[len(leaves):])
        return loss.detach(), dict(zip(leaves, grads)), grads[len(leaves):]

    # one step on the kernels, the counts set to 0 just before it: every
    # level through the Function pair, every backward the variants
    picked, pairs = tren.shade_stages, []

    def spy(*args):
        pairs.append(picked(*args))
        return pairs[-1]

    kernel_step()
    sync()
    zero_counts()
    tables = dict(k4.TABLE_LAUNCHES)
    designs = dict(k4.TABLE_DESIGN_LAUNCHES)
    sums = dict(k4.SUMS_DESIGN_LAUNCHES)
    tren.shade_stages = spy
    try:
        kernel_step()
        sync()
    finally:
        tren.shade_stages = picked
    got, variants = counts(), dict(k4.VARIANT_LAUNCHES)
    variants.update({k: k4.TABLE_LAUNCHES[k] - tables[k] for k in tables})
    variants["resolve_bwd instances"] = kr.VARIANT_LAUNCHES[
        "backward instances"]
    designs = {k: k4.TABLE_DESIGN_LAUNCHES[k] - designs[k] for k in designs}
    sums = {k: k4.SUMS_DESIGN_LAUNCHES[k] - sums[k] for k in sums}
    functions = (tren._shade_surface_function, tren._shade_combine_function)
    levels = _resolves(scene)
    surface, combine = flags
    paths = (f"surface_bwd textures "
             f"{k4.table_path(scene.textures, k4.TEXTURE_SHARED_BYTES)}",
             f"combine_bwd env {k4.table_path(scene.env, k4.ENV_SHARED_BYTES)}")
    launched = {"surface_bwd material": "material" in surface,
                "combine_bwd lights": "lights" in combine,
                paths[0]: "textures" in surface, paths[1]: "env" in combine,
                "surface_bwd instances": posed,
                "resolve_bwd instances": posed}
    want = {k: levels * launched.get(k, False) for k in variants}
    want_designs = {"surface_bwd textures warp": levels * ("textures"
                                                           in surface),
                    "surface_bwd textures first": 0,
                    "combine_bwd env warp": levels * ("env" in combine),
                    "combine_bwd env first": 0}
    # the instance variant and the material variant without the texture
    # variant on their sums' redesign
    want_designs["surface_bwd sums warp"] = levels * (posed or (
        "material" in surface and "textures" not in surface))
    want_designs["surface_bwd sums first"] = 0
    designs.update(sums)
    if pairs != [functions] * levels or any(
            got[k] != levels for k in ("surface", "combine", "surface_bwd",
                                       "combine_bwd", "resolve",
                                       "resolve_bwd")) or \
            got["gather"] or got["scatter"] or variants != want or \
            designs != want_designs:
        raise AssertionError(f"the {what} shaded on {pairs} with launches "
                             f"{got}, variants {variants}, designs "
                             f"{designs}, expected {want}, {want_designs}")
    loss, grads, _ = value_and_grad()
    kept = []
    with _eager_shading_by_lane(kept, plain_resolve=posed):
        plain_loss, plain_grads, by_lane = value_and_grad(kept)
    sync()
    own_terms = {}
    if per_entry:
        # the same step with the backward on the plain versions, on the
        # kernels' own forward
        with _plain_backward(own_terms):
            _, own_grads, _ = value_and_grad()
        sync()
    # each scene table's gradient summed over its reads' lanes in float64
    sums = {k: torch.zeros(params[k].shape, dtype=torch.float64,
                           device=params[k].device)
            for k in keys if k not in ("sdf", "voxel_colors")}
    terms = {k: v.clone() for k, v in sums.items()}
    for (f, rows, fold), g in zip(kept, by_lane):
        if f in sums and g is not None:
            sums[f] += fold(g.double())
            terms[f] += fold(g.double().abs())
    del kept, by_lane
    rel = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
    if not rel < FIT_LOSS_RTOL:
        raise AssertionError(f"the {what}'s loss {float(loss)} against the "
                             f"plain route's {float(plain_loss)}")
    by_key = {}
    for k in keys:
        b = grads[k].double().cpu().numpy().ravel()
        if k in sums:
            a = sums[k].cpu().numpy().ravel()
            f32 = plain_grads[k].double().cpu().numpy().ravel()
        else:
            a = plain_grads[k].double().cpu().numpy().ravel()
        top = np.abs(a).max()
        diff = float(np.abs(a - b).max() / top) if top > 0 else 0.0
        ok = np.isfinite(b).all() and (top > 0 or not b.any())
        if k in ("sdf", "voxel_colors"):
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            # the SDF's gradient through a bf16 corner table: one bf16 step
            tol = BF16_DIFF_TOL if k == "sdf" and scene.volumes.corners.dtype \
                == torch.bfloat16 else FIT_DIFF_TOL
            ok = ok and 1 - cos < FIT_COS_TOL and diff < tol
            by_key[k] = dict(one_minus_cos=1 - cos, diff_over_max=diff)
        else:
            # the float64 sum against autograd's f32 one of the same route
            # shows that every read of the table was kept
            own = float(np.abs(a - f32).max() / top) if top > 0 else 0.0
            ok = ok and own <= 1e-3
            by_key[k] = dict(diff_over_max=diff,
                             plain_f32_sum_diff_over_max=own)
            if per_entry:
                bound = SCATTER_RTOL * terms[k].cpu().numpy().ravel() \
                    + TABLE_ATOL
                c = own_grads[k].double().cpu().numpy().ravel()
                own_bound = SCATTER_RTOL * own_terms[k].double().cpu() \
                    .numpy().ravel() + TABLE_ATOL
                over = float((np.abs(c - b) / own_bound).max())
                ok = ok and over <= 1.0 and top > 0
                by_key[k].update(
                    diff_over_entry_bound=float(
                        (np.abs(a - b) / bound).max()),
                    cos=float(a @ b / (np.linalg.norm(a)
                                       * np.linalg.norm(b))),
                    plain_backward_over_entry_bound=over)
            else:
                ok = ok and diff <= SCATTER_RTOL
        print(f"  {what}, grad {k} against the plain route: {by_key[k]}",
              flush=True)
        if not ok:
            raise AssertionError(f"the {what}'s {k} gradient disagrees with "
                                 f"the plain route's")
    del grads, plain_grads, sums, terms, own_terms
    if per_entry:
        del own_grads

    plain_peak = []

    def plain_ms():
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plain_step()
        sync()
        plain_peak.append(torch.cuda.max_memory_allocated() / 2**30)
        return (time.perf_counter() - t0) * 1e3

    zero_counts()
    meds = [plain_ms(), statistics.median(timed(kernel_step, 3)[0]) * 1e3,
            statistics.median(timed(kernel_step, 3)[0]) * 1e3, plain_ms()]
    print(f"{what} on {card}, the plain pair under autograd against the "
          f"shade kernels' variants in the order old, new, new, old "
          f"(kernels: medians of 3; plain: one step): "
          f"{', '.join(f'{t:.2f}' for t in meds)} ms", flush=True)
    routes = {"plain": dict(ms=[meds[0], meds[3]]),
              "kernels": dict(ms=[meds[1], meds[2]])}
    runs = [("plain", plain_step), ("kernels", kernel_step)]
    if first_designs:
        def first_step():
            with _first_table_designs():
                return kernel_step()

        d0 = dict(k4.TABLE_DESIGN_LAUNCHES)
        first_step()
        sync()
        took = {k: k4.TABLE_DESIGN_LAUNCHES[k] - d0[k] for k in d0}
        if took != {k: v for k, v in zip(
                want_designs, (0, want_designs["surface_bwd textures warp"],
                               0, want_designs["combine_bwd env warp"]))}:
            raise AssertionError(f"the {what} on the first designs launched "
                                 f"{took}")
        beside = [statistics.median(timed(run, 3)[0]) * 1e3
                  for run in (first_step, kernel_step, kernel_step,
                              first_step)]
        print(f"{what} on {card}, the texture and env variants' first "
              f"designs against the redesigns, medians of 3 in the order "
              f"old, new, new, old: "
              f"{', '.join(f'{t:.2f}' for t in beside)} ms", flush=True)
        routes.update(first_table_designs=dict(ms=[beside[0], beside[3]]),
                      kernels_beside_first=dict(ms=[beside[1], beside[2]]))
        runs.append(("first_table_designs", first_step))
    if sdf_step is not None:
        beside = [statistics.median(timed(run, 3)[0]) * 1e3
                  for run in (sdf_step, kernel_step, kernel_step, sdf_step)]
        print(f"config6 fit step on {card}, the SDF and the colours against "
              f"the {what} on the kernels, medians of 3 in the order sdf, "
              f"tables, tables, sdf: "
              f"{', '.join(f'{t:.2f}' for t in beside)} ms", flush=True)
        routes.update(sdf_colour_step=dict(ms=[beside[0], beside[3]]),
                      kernels_beside_it=dict(ms=[beside[1], beside[2]]))
    for tag, run in runs:
        if tag == "plain" and not profile_plain:
            routes[tag]["peak_gib"] = max(plain_peak)
            print(f"{what} on {card}, {tag}: median "
                  f"{statistics.median(routes[tag]['ms']):.2f} ms, peak "
                  f"max_memory_allocated {routes[tag]['peak_gib']:.2f} GiB "
                  f"(not profiled)", flush=True)
            continue
        # the peak of the profiled step
        sync()
        torch.cuda.reset_peak_memory_stats()
        prof = _profile(run, sync, statistics.median(routes[tag]["ms"]),
                        what=f"one {what} ({tag})")
        routes[tag]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if prof is not None:
            routes[tag].update(busy_ms=prof["busy_ms"],
                               device_ops=prof["device_ops"],
                               device_records=prof["device_records"])
        print(f"{what} on {card}, {tag}: median "
              f"{statistics.median(routes[tag]['ms']):.2f} ms, peak "
              f"max_memory_allocated {routes[tag]['peak_gib']:.2f} GiB"
              + ("" if prof is None else
                 f", device busy {prof['busy_ms']:.1f} ms in "
                 f"{prof['device_ops']} device ops"), flush=True)
    zero_counts()
    held = _instance_calls(kernel_step, levels, what) if posed \
        else _variant_calls(kernel_step, levels, what, *flags)
    return dict(routes=routes, launches=variants, designs=designs,
                grads=by_key, held=held, loss=float(loss),
                plain_loss=float(plain_loss))


def _rebuild_calls(run, expected, tag):
    """Every accel rebuild (``kernels.accel.rebuild_accel_cuda``: its
    pyramid launch and its rebuild launch) and every pack backward in
    ``run()`` (a fit step), kept with its inputs and outputs, then held
    against its plain version on the same inputs: the pyramid's levels
    against ``occupancy_pyramid_reference`` of the plain flags and the
    pyramid against its first design (ceil(R / 3) launches), the accel,
    its u8 view and the table against ``rebuild_accel_reference`` (the eager
    ``build_accel``, ``_accel_u8`` and torch pack) and the table against the
    first design's pack kernel (``pack_corners_cuda``), all bit for bit; the
    SDF's gradient bit-equal to the pack backward's first design and to its
    tiled kernel (the step's launch ran the one the library picks) and within
    ``PACK_GRAD_RTOL * max|g|`` of ``pack_corners_backward_reference`` (the
    slices' transpose in autograd's order; bit-equality reported).  Timed
    in the order old, new, new, old, each with its bound: the pyramid
    against its first design (whose first launch is also timed alone), the
    plain pyramid beside them; the rebuild kernel (on the launch's own
    pyramid) against the first design's pack kernel; the whole rebuild
    (pyramid and rebuild) against the eager ``build_accel`` + ``_accel_u8``
    + the first design's pack, what a step ran before; the backward the
    library picks against its first design, and the tiled kernel against
    the first design; beside them the plain versions (the eager
    rebuild, autograd of the torch pack) and, for the pack, one PyTorch
    call that packs the 8 corner channels (a strided view of ``unfold``s
    copied once: ``library_ms``).  Fails unless each ran ``expected``
    times.  Returns {"pyramid" | "rebuild" | "pack" | "pack_bwd" | "whole":
    dict(launches, max_abs_err, bit_equal, ms, plain_ms, old_ms,
    library_ms, tiled_ms, first_launch_ms, bound, shape)}, "pack_bwd" with
    ``designs``, the step's launches by the design that ran."""
    import torch

    from vrt_torch.kernels import accel as ka
    from vrt_torch.kernels import pack as kp
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.types import _accel_u8, pack_cell_corners_reference
    from vrt_torch.volume.accel import (build_accel_reference,
                                        cell_corner_signs_differ)

    with _recording(ka, "rebuild_accel_cuda") as rebuilds, \
            _recording(ka, "accel_pyramid_cuda") as pyramids, \
            _recording(kp, "pack_corners_backward_cuda") as bwd:
        before = dict(kp.BWD_LAUNCHES)
        run()
        designs = {k: kp.BWD_LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    if (len(rebuilds), len(pyramids), len(bwd)) != (expected,) * 3:
        raise AssertionError(f"the {tag} rebuilt the accel {len(rebuilds)} "
                             f"times (pyramids {len(pyramids)}) and ran the "
                             f"pack backward {len(bwd)} times, expected "
                             f"{expected} each")
    boxes = {k: dict(ms=[], plain_ms=[], old_ms=[], library_ms=[],
                     tiled_ms=[], first_launch_ms=[], bounds=[], launches=0,
                     bit=True, err=0.0, shape=None)
             for k in ("pyramid", "rebuild", "pack", "pack_bwd", "whole")}

    def timed(box, old, new, plain=None, library=None, old_is_plain=False):
        olds, news = _paired_ms(old, new, 10)
        box["ms"].append(sum(news) / 2)
        box["old_ms"].append(sum(olds) / 2)
        box["plain_ms"].append(sum(olds) / 2 if old_is_plain
                               else device_ms(plain, 5))
        if library is not None:
            box["library_ms"].append(device_ms(library, 10))
        return olds, news

    def line(name, box, olds, news, old_name, nbytes):
        b = box["bounds"][-1]["bound_ms"]
        print(f"{name} [{tag}]: {box['shape']}; {old_name}, new, new, "
              f"{old_name} {', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
              f" ms; plain {box['plain_ms'][-1]:.4f} ms"
              + (f"; library {box['library_ms'][-1]:.4f} ms"
                 if box["library_ms"] else "")
              + f"; bound {b:.4f} ms ({nbytes} B) = {b / box['ms'][-1]:.0%} "
              f"of the kernel", flush=True)

    for ((sdf, levels, dtype, channels), _, (table, accel, view)), \
            (_, _, pyramid) in zip(rebuilds, pyramids):
        lead, c = tuple(sdf.shape[:-3]), sdf.shape[-1] - 1
        sdf = sdf.detach()
        fold = accel if channels == 9 else None
        # the pyramid
        box = boxes["pyramid"]
        with torch.no_grad():
            want = ka.occupancy_pyramid_reference(
                cell_corner_signs_differ(sdf), levels)
        got = ka.pyramid_levels(pyramid, lead, c, levels)
        if len(got) != levels or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{tag}: the accel pyramid differs from "
                                 f"the plain pyramid")
        if not torch.equal(pyramid, ka.accel_pyramid_cuda(
                sdf, levels, _old_design=True)):
            raise AssertionError(f"{tag}: the one-launch pyramid differs "
                                 f"from its first design")
        del want, got
        box["launches"] += 1
        box["shape"] = f"{levels} levels over {tuple(sdf.shape)}"
        nbytes = sdf.numel() * 4 + pyramid.numel()
        box["bounds"].append(_bound(nbytes, 0))
        olds, news = timed(
            box, lambda: ka.accel_pyramid_cuda(sdf, levels, _old_design=True),
            lambda: ka.accel_pyramid_cuda(sdf, levels),
            lambda: ka.occupancy_pyramid_reference(
                cell_corner_signs_differ(sdf), levels))
        # the first design's time by launch: its first (levels 1..3 from the
        # SDF) alone, the others as the rest
        first = device_ms(lambda: ka.accel_pyramid_cuda(
            sdf, min(levels, 3), _old_design=True), 10)
        box["first_launch_ms"].append(first)
        line("accel pyramid, one launch (old: the first design in "
             f"{-(-levels // 3)} launches, its first {first:.4f} ms, the "
             f"others {sum(olds) / 2 - first:.4f} ms)", box, olds, news,
             "first design", nbytes)
        # the rebuild kernel, against the plain rebuild and the first
        # design's pack
        box = boxes["rebuild"]
        with torch.no_grad():
            want = ka.rebuild_accel_reference(sdf, levels, dtype, channels)
            first = kp.pack_corners_cuda(sdf, fold, dtype)
        if not (torch.equal(accel, want[1]) and torch.equal(view, want[2])
                and torch.equal(table, want[0])):
            raise AssertionError(f"{tag}: the accel rebuild differs from "
                                 f"the plain rebuild")
        if not torch.equal(table, first):
            raise AssertionError(f"{tag}: the rebuild's table differs from "
                                 f"the first design's pack")
        del want, first
        box["launches"] += 1
        box["shape"] = f"{tuple(table.shape)} {table.dtype}, accel, u8 view"
        # the pyramid's levels 2.. (level 1 the kernel takes from its own
        # cells' flags)
        level1 = sdf.numel() // (c + 1) ** 3 * (c // 2) ** 3 if levels else 0
        nbytes = sdf.numel() * 4 + pyramid.numel() - level1 \
            + accel.numel() * 5 + table.numel() * table.element_size()
        box["bounds"].append(_bound(nbytes, 0))
        olds, news = timed(
            box, lambda: kp.pack_corners_cuda(sdf, fold, dtype),
            lambda: ka.rebuild_accel_cuda(sdf, levels, dtype, channels,
                                          pyramid=pyramid),
            lambda: ka.rebuild_accel_reference(sdf, levels, dtype,
                                               channels))
        line("accel rebuild kernel (old: the first design's pack)", box,
             olds, news, "pack", nbytes)
        # the first design's pack (a comparator now), with the library's
        # copy of the 8 corner channels
        box = boxes["pack"]
        box["shape"] = f"{tuple(table.shape)} {table.dtype}"
        nbytes = sdf.numel() * 4 + table.numel() * table.element_size() \
            + (0 if fold is None else fold.numel() * 4)
        box["bounds"].append(_bound(nbytes, 0))
        win = sdf.unfold(-3, 2, 1).unfold(-3, 2, 1).unfold(-3, 2, 1)
        win = win.permute(*range(win.ndim - 3), -1, -2, -3)
        if channels == 8 and not torch.equal(
                win.to(dtype, memory_format=torch.contiguous_format)
                .reshape(table.shape), table):
            raise AssertionError(f"{tag}: the library's pack differs")
        olds, news = timed(
            box, lambda: pack_cell_corners_reference(sdf, fold, dtype),
            lambda: kp.pack_corners_cuda(sdf, fold, dtype), old_is_plain=True,
            library=(lambda: win.to(dtype, memory_format=torch
                                    .contiguous_format))
            if channels == 8 else None)
        line("corner pack, first design", box, olds, news, "torch pack",
             nbytes)
        # the whole rebuild against what a step ran before
        box = boxes["whole"]
        box["shape"] = boxes["rebuild"]["shape"]
        nbytes = sdf.numel() * 4 + accel.numel() * 5 \
            + table.numel() * table.element_size()
        box["bounds"].append(_bound(nbytes, 0))

        def eager_then_pack():
            a = build_accel_reference(sdf, levels)
            return _accel_u8(a), kp.pack_corners_cuda(
                sdf, a if channels == 9 else None, dtype)

        olds, news = timed(
            box, eager_then_pack,
            lambda: ka.rebuild_accel_cuda(sdf, levels, dtype, channels),
            lambda: ka.rebuild_accel_reference(sdf, levels, dtype,
                                               channels))
        line("accel rebuild, pyramid and rebuild (old: eager build_accel, "
             "_accel_u8 and the first design's pack)", box, olds, news,
             "eager", nbytes)
    for ((g,), _, got), ((sdf, levels, dtype, channels), _, (_, accel, _)) \
            in zip(bwd, rebuilds):
        box = boxes["pack_bwd"]
        old = kp.pack_corners_backward_cuda(g, _old_design=True)
        tiled = kp.pack_corners_backward_cuda(g, _tiled=True)
        want = kp.pack_corners_backward_reference(g, g.shape[-2] + 1)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item() / scale if scale else 0.0
        bit = bool(torch.equal(got, want))
        if not (torch.equal(got, old) and torch.equal(tiled, old)):
            raise AssertionError(f"{tag}: the pack backward's designs "
                                 f"differ (the step's, the tiled kernel, "
                                 f"the first design)")
        if not (scale > 0 and bool(torch.isfinite(got).all())
                and err <= PACK_GRAD_RTOL):
            raise AssertionError(f"{tag}: the corner pack's backward is off "
                                 f"by {err:.3e} of max|g| {scale:.3e}")
        del want, old, tiled
        box["err"], box["bit"] = max(box["err"], err), box["bit"] and bit
        box["launches"] += 1
        nbytes = g.numel() * g.element_size() + got.numel() * 4
        box["bounds"].append(_bound(nbytes, 0))
        box["shape"] = f"{tuple(g.shape)} {g.dtype}"
        leaf = sdf.detach().requires_grad_(True)
        packed = pack_cell_corners_reference(
            leaf, accel if channels == 9 else None, dtype)
        olds, news = timed(
            box, lambda: kp.pack_corners_backward_cuda(g, _old_design=True),
            lambda: kp.pack_corners_backward_cuda(g),
            lambda: torch.autograd.grad(packed, leaf, g, retain_graph=True))
        del leaf, packed
        # the tiled kernel where the choice does not take it, and beside the
        # first design where it does
        t_olds, t_news = _paired_ms(
            lambda: kp.pack_corners_backward_cuda(g, _old_design=True),
            lambda: kp.pack_corners_backward_cuda(g, _tiled=True), 10)
        box["tiled_ms"].append(sum(t_news) / 2)
        print(f"corner pack backward [{tag}]: the step's launches by design "
              f"{designs}; bit-equal to the first design and the tiled "
              f"kernel, within {err:.2e} of max|g| of the plain version "
              f"(bit-equal {bit}); first design, tiled, tiled, first design "
              f"{', '.join(f'{t:.4f}' for t in (t_olds[0], t_news[0], t_news[1], t_olds[1]))}"
              f" ms", flush=True)
        line("corner pack backward, the library's choice", box, olds, news,
             "first design", nbytes)
    out = {}
    for name, box in boxes.items():
        out[name] = dict(
            launches=box["launches"], max_abs_err=box["err"],
            bit_equal=box["bit"], ms=sum(box["ms"]),
            plain_ms=sum(box["plain_ms"]), old_ms=sum(box["old_ms"]),
            library_ms=(sum(box["library_ms"]) if box["library_ms"]
                        else None),
            tiled_ms=sum(box["tiled_ms"]) if box["tiled_ms"] else None,
            first_launch_ms=(sum(box["first_launch_ms"])
                             if box["first_launch_ms"] else None),
            bound=_sum_bounds(box["bounds"]), shape=box["shape"])
    out["pack_bwd"]["designs"] = designs
    torch.cuda.empty_cache()
    return out


def _adam_held(calls, tag, reps=10):
    """Every Adam kernel call of ``calls`` (``kernels.optim.adam_step_cuda``
    recorded as (args, kwargs, outputs)) held against its plain version
    (``adam_step_reference``, the eager arithmetic) on the same inputs, bit
    for bit on every leaf (p + u or u, mu', nu'); then timed in the order
    plain, kernel, kernel, plain, beside the library's fused Adam step
    (``torch.optim.Adam(fused=True).step()`` on clones of the same leaves
    with the same gradients: one PyTorch call computing the same function
    in its own rounding order, a yardstick the port never calls) and the
    bound (per element p, g, mu, nu read and p, mu, nu written, 28 B, or 24
    B for the update variant; ``ADAM_FLOPS`` f32 operations).  Returns
    dict(launches, bit_equal, max_abs_err, ms, plain_ms, old_ms, library_ms,
    bound, shape, elements)."""
    import torch

    from vrt_torch.kernels import optim as ko
    from vrt_torch.kernels._timing import device_ms

    box = dict(launches=0, bit_equal=True, max_abs_err=0.0, ms=0.0,
               plain_ms=0.0, old_ms=0.0, library_ms=0.0, bounds=[],
               shape=None, elements=0)
    for args, kwargs, got in calls:
        params, grads, mu, nu, c1, c2, b1, b2, lr, eps = args[:10]
        apply = args[10] if len(args) > 10 else kwargs.get("apply", True)
        want = ko.adam_step_reference(params, grads, mu, nu, c1, c2, b1, b2,
                                      lr, eps, apply)
        for a, b in zip(got, want):
            for k in grads:
                err = (a[k] - b[k]).abs().max().item() if a[k].numel() else 0
                box["max_abs_err"] = max(box["max_abs_err"], err)
                if not torch.equal(a[k], b[k]):
                    raise AssertionError(f"{tag}: the Adam kernel differs "
                                         f"from its plain version on leaf "
                                         f"{k!r} by {err:.3e}")
        del want
        n = sum(g.numel() for g in grads.values())
        box["elements"] += n
        box["launches"] += 1
        box["shape"] = ", ".join(f"{k or 'planes'} {tuple(g.shape)}"
                                 for k, g in grads.items())
        b = _bound(n * (28 if apply else 24), n * ADAM_FLOPS)
        box["bounds"].append(b)

        def kernel():
            return ko.adam_step_cuda(params, grads, mu, nu, c1, c2, b1, b2,
                                     lr, eps, apply)

        def plain():
            return ko.adam_step_reference(params, grads, mu, nu, c1, c2, b1,
                                          b2, lr, eps, apply)

        olds, news = _paired_ms(plain, kernel, reps)
        box["ms"] += sum(news) / 2
        box["plain_ms"] += sum(olds) / 2
        leaves = [(params[k] if apply else mu[k]).clone().requires_grad_(True)
                  for k in grads]
        for leaf, k in zip(leaves, grads):
            leaf.grad = grads[k]
        lib = torch.optim.Adam(leaves, lr=lr, betas=(b1, b2), eps=eps,
                               fused=True)
        lib.step()
        library = device_ms(lib.step, reps)
        box["library_ms"] += library
        del lib, leaves
        print(f"Adam kernel [{tag}]: {box['shape']} ({n} elements, "
              f"{'p + u' if apply else 'u'}), bit-equal to the plain "
              f"version; plain, new, new, plain "
              f"{', '.join(f'{t:.4f}' for t in (olds[0], news[0], news[1], olds[1]))}"
              f" ms; torch.optim.Adam(fused=True).step() {library:.4f} ms "
              f"(not bit-equal: its own rounding order); bound "
              f"{b['bound_ms']:.4f} ms ({b['bytes']} B) = "
              f"{b['bound_ms'] / (sum(news) / 2):.0%} of the kernel",
              flush=True)
    box["old_ms"] = box["plain_ms"]
    box["bound"] = _sum_bounds(box.pop("bounds"))
    torch.cuda.empty_cache()
    return box


def _rebuild_ops(scene):
    """The aten operations that ``diff.fit.rebuild_accel(scene)`` dispatches
    (on CUDA tensors ``RebuildAccel``'s allocations alone: no eager op of
    ``build_accel`` or ``_accel_u8``) and the accel kernels' launches."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from vrt_torch.diff.fit import rebuild_accel
    from vrt_torch.kernels import accel as ka

    ops = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    before = dict(ka.LAUNCHES)
    with Ops():
        rebuild_accel(scene)
    torch.cuda.synchronize()
    return ops, {k: ka.LAUNCHES[k] - before[k] for k in before}


@contextlib.contextmanager
def _eager_shading():
    """The renderer with every level's shading on the plain stages (eager
    PyTorch, about a thousand launches a level): what a frame took before
    the two shade kernels."""
    from vrt_torch.render import renderer as tren

    saved = tren.shade_stages
    tren.shade_stages = lambda *_: (tren.shade_surface_reference,
                                    tren.shade_combine_reference)
    try:
        yield
    finally:
        tren.shade_stages = saved


@contextlib.contextmanager
def _first_table_designs():
    """The backward wrappers with the texture and env variants on their
    first designs (``_old_table_design``; the instance variant's texture
    path has the redesign alone): what the Functions launched before the
    redesign."""
    from vrt_torch.kernels import shade as k4

    surface = k4.shade_surface_backward_cuda
    combine = k4.shade_combine_backward_cuda

    def old_surface(*args, **kwargs):
        if kwargs.get("textures") and not kwargs.get("instances"):
            kwargs["_old_table_design"] = True
        return surface(*args, **kwargs)

    def old_combine(*args, **kwargs):
        if kwargs.get("env"):
            kwargs["_old_table_design"] = True
        return combine(*args, **kwargs)

    k4.shade_surface_backward_cuda = old_surface
    k4.shade_combine_backward_cuda = old_combine
    try:
        yield
    finally:
        k4.shade_surface_backward_cuda = surface
        k4.shade_combine_backward_cuda = combine


@contextlib.contextmanager
def _cached_constants():
    """``torch.tensor`` / ``torch.as_tensor`` of host data onto the card, and
    a Python list used as an index (``x[..., [2, 0, 1]]``), answered from a
    cache after the first call: the eager stages build their small constants
    from Python lists, and a copy from pageable memory cannot be captured
    into a CUDA graph."""
    import numpy as np
    import torch

    saved = (torch.tensor, torch.as_tensor, torch.Tensor.__getitem__)
    cache = {}

    def getitem(self, idx):
        if self.device.type == "cuda" and isinstance(idx, tuple) and \
                any(isinstance(i, list) for i in idx):
            idx = tuple(cached(saved[0])(i, dtype=torch.long,
                                         device=self.device)
                        if isinstance(i, list) else i for i in idx)
        return saved[2](self, idx)

    def cached(make):
        def fn(data, *args, **kwargs):
            dev = kwargs.get("device")
            if isinstance(data, torch.Tensor) or dev is None or \
                    torch.device(dev).type != "cuda":
                return make(data, *args, **kwargs)
            blob = np.asarray(data)
            key = (make.__name__, blob.tobytes(), blob.shape, str(blob.dtype),
                   str(args), str(sorted(kwargs.items())))
            if key not in cache:
                cache[key] = make(data, *args, **kwargs)
            return cache[key]
        return fn

    torch.tensor, torch.as_tensor = cached(saved[0]), cached(saved[1])
    torch.Tensor.__getitem__ = getitem
    try:
        yield
    finally:
        torch.tensor, torch.as_tensor, torch.Tensor.__getitem__ = saved


def _graph_yardstick(render, sync, card):
    """The yardstick of the shade kernels: the frame with eager shading
    captured once into a CUDA graph and replayed, so that its thousands of
    launches cost the host nothing.  Timed, used nowhere in the port.
    Returns the replay's median ms; a capture or replay that fails, or a
    replayed frame that is not the eager frame, fails the run."""
    import torch

    with _eager_shading(), torch.no_grad():
        want = render()
        with _cached_constants():
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(2):
                    render()
            torch.cuda.current_stream().wait_stream(stream)
            sync()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                img = render()
    sync()
    runs = []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        graph.replay()
        sync()
        runs.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(img, want):
        raise AssertionError("the replayed graph does not give the eager "
                             "frame")
    med = statistics.median(runs[1:])
    print(f"yardstick on {card}: the 1080p frame with eager shading as "
          f"one CUDA graph replays in {med:.2f} ms (runs "
          f"{', '.join(f'{r:.2f}' for r in runs[1:])} ms), equal to the "
          f"eager frame", flush=True)
    return med


# the seconds the torch.compile yardstick may take in all (its compiles of
# the plain surface stage took 50-108 s on an NVIDIA H100 80GB HBM3 at
# 700 W, of the combine stage 10-19 s): past it a stage prints "not
# measured", so that the run keeps its time limit
COMPILE_LIMIT_S = 240


def _compile_yardstick(render, sync, card, limit_s=COMPILE_LIMIT_S):
    """The second yardstick: ``torch.compile`` of the two plain stages, each
    timed on the inputs of every launch of one 1080p frame beside the kernel
    on the same inputs.  Used nowhere in the port.  Returns {"surface" |
    "combine": dict(ms, kernel_ms (summed over the frame's launches),
    compile_s)}, or None for a stage that does not compile within
    ``limit_s`` seconds in all (then nothing is measured)."""
    import signal

    import torch

    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.render.renderer import (shade_combine_reference,
                                           shade_surface_reference)

    with _recording(k4, "shade_surface_cuda") as surf, \
            _recording(k4, "shade_combine_cuda") as comb, torch.no_grad():
        render()
    sync()

    def too_long(*_):
        raise TimeoutError(f"no result within {limit_s} s")

    out = {}
    before = signal.signal(signal.SIGALRM, too_long)
    signal.alarm(limit_s)
    try:
        for name, plain, kernel, calls in (
                ("surface", shade_surface_reference, k4.shade_surface_cuda,
                 surf),
                ("combine", shade_combine_reference, k4.shade_combine_cuda,
                 comb)):
            out[name] = None
            try:
                t0 = time.perf_counter()
                compiled = torch.compile(plain)
                with torch.no_grad():
                    compiled(*calls[0][0])
                    sync()
                    compile_s = time.perf_counter() - t0
                    ms = [device_ms(lambda: compiled(*args), 5)
                          for args, _, _ in calls]
                kernel_ms = [device_ms(lambda: kernel(*args), 20)
                             for args, _, _ in calls]
                out[name] = dict(ms=sum(ms), kernel_ms=sum(kernel_ms),
                                 compile_s=compile_s)
                print(f"yardstick on {card}: torch.compile of the plain "
                      f"{name} stage on the 1080p frame's {len(calls)} "
                      f"launches {_list(ms)} ms = {sum(ms):.4f} ms (compiled "
                      f"in {compile_s:.0f} s) against the kernel's "
                      f"{_list(kernel_ms)} ms = {sum(kernel_ms):.4f} ms",
                      flush=True)
            except Exception as e:  # a yardstick: reported, not fatal
                print(f"yardstick: torch.compile of the plain {name} stage "
                      f"gave no time ({type(e).__name__}: {str(e)[:200]}): "
                      f"not measured", flush=True)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, before)
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


def _resolves(scene, lit=True):
    """Resolves one frame makes, and launches of each shade kernel: one per
    radiance level (the mirror bounce needs lit mode)."""
    from vrt_torch.render.renderer import MAX_RAY_RECURSION_DEPTH as cap

    return cap if scene.any_reflective and lit else 1


def _expected_k3(scene, plain_resolve=False, eager_shading=False):
    """K3 gathers a frame or a fit step makes (and, under a graph, as many
    scatters): with the shading on the plain stages (``eager_shading``) one
    colour sample per lit radiance level with per-voxel colours (the shade
    kernels read the colour rows themselves) and, with resolve on the plain
    path (``plain_resolve``), one more per resolve."""
    return _resolves(scene) * (int(scene.use_voxel_colors and eager_shading)
                               + int(plain_resolve))


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
    that launched it, from torch.profiler.  Returns dict(ops (the
    operators that took device time), busy_ms, device_ops, device_records),
    or None where the profiler saw none.  ``device_records`` counts the
    device's records, which CUPTI may drop at the start of a trace
    (``vrt_torch/apps/probe_profiler.py``; busy time and the operator list
    then miss them too); ``device_ops`` the host's launch calls
    (``LAUNCH_CALLS``, one a kernel, copy or fill), or the records where
    they are more (a call the list does not name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vrt_torch.kernels._timing import LAUNCH_CALLS

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
    records = sum(r[1] for r in rows)
    launches = max(records,
                   sum(e.count for e in events if e.key in LAUNCH_CALLS))

    def share(*names):
        ms = sum(r[0] for r in rows if any(n in r[2] for n in names))
        return f"{ms:.1f} ms = {100 * ms / busy:.0f}% of busy"

    print(f"profile of {what}: device busy {busy:.1f} ms = "
          f"{100 * busy / frame_ms:.0f}% of its {frame_ms:.1f} ms; "
          f"K1 {share('march_kernel', 'march_scene_kernel', 'march_scene_capped_kernel')}; "
          f"K3 {share('rows_kernel')}; "
          f"fused resolve {share('resolve_kernel', 'resolve_bwd_kernel', 'resolve_bwd_merged_kernel')}; "
          f"shade {share('surface_kernel', 'combine_kernel', 'surface_resident_kernel', 'combine_resident_kernel')} and its "
          f"backward {share('surface_bwd_kernel', 'surface_bwd_merged_kernel', 'combine_bwd_kernel')}; "
          f"{launches} device ops ({records} device records)", flush=True)
    for ms, count, key in rows[:top]:
        print(f"  kernel {ms:8.2f} ms {count:5d}x {key[:80]}", flush=True)
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key,
                   str(e.input_shapes)[:60])
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), reverse=True)
    for ms, count, key, shapes in ops[:top]:
        print(f"  op {ms:8.2f} ms {count:5d}x {key} {shapes}", flush=True)
    return dict(ops={op[2] for op in ops}, busy_ms=busy,
                op_shapes=[(op[2], op[3]) for op in ops],
                device_ops=launches, device_records=records, kernels=rows)


def _per_array_upload(consts, dev):
    """The per-frame constants as one pageable ``.to(device)`` per array:
    what an incremental sync would cost without the pinned block."""
    import numpy as np
    import torch

    return {k: torch.as_tensor(np.asarray(v)).to(dev)
            for k, v in consts.items()}


def _engine_path(dev, card, sync, zero_counts, counts):
    """Phase 9: the scene graph, the engine loop, ``render_scale`` and the
    CLIs at 1920x1080.  Returns dict(launches (scene, resolve: of the engine
    frames), scene (the first and last frame's scene marches against their
    plain versions), fused (their fused resolves), numbers)."""
    import tempfile

    import numpy as np
    import torch

    from vrt_torch.apps import demo as demo_app
    from vrt_torch.apps import render as render_app
    from vrt_torch.engine.engine import (Engine, EngineInstance, _Readback,
                                         to_unorm8, upsample_bilinear)
    from vrt_torch.io.image import read_png
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scene import scene as scene_mod
    from vrt_torch.scenes import flagship_graph, flagship_scene

    mode = RenderMode()
    numbers = {}

    # -- the scene graph against build_scene ---------------------------------
    t0 = time.perf_counter()
    host, sphere_obj, box_obj = flagship_graph(7)
    t1 = time.perf_counter()
    gpu = host.to_gpu(accel_mode="chebyshev", device=dev)
    sync()
    t2 = time.perf_counter()
    direct = flagship_scene(7, "chebyshev", device=dev)
    corners = gpu.volumes.corners
    print(f"scene graph: bake {t1 - t0:.1f}s, Scene.to_gpu {t2 - t1:.1f}s, "
          f"corners {tuple(corners.shape)} {corners.dtype} = "
          f"{corners.numel() * corners.element_size() / 1e6:.0f} MB",
          flush=True)
    a = render_image(gpu, FRAME_W, FRAME_H, mode)
    b = render_image(direct, FRAME_W, FRAME_H, mode)
    if not (torch.equal(a, b) and bool(torch.isfinite(a).all())):
        raise AssertionError("the scene graph's 1080p frame differs from "
                             "build_scene's")
    print(f"scene graph vs build_scene: 1080p frames equal bit for bit "
          f"({a.shape[0]}x{a.shape[1]}, {a[..., :3].std().item():.3f} std)",
          flush=True)
    del a, b, direct, gpu

    # -- the engine at full width --------------------------------------------
    class Orbit(EngineInstance):
        """Moves both objects, the camera and the light every frame."""
        frame = 0

        def on_engine_update(self, engine, dt):
            from vrt_torch.core import quat as vq

            a = np.deg2rad(3.0 * self.frame)
            sphere_obj.position = np.asarray(
                [30.0 * np.sin(a), -70.0 - 20.0 * np.cos(a), 10.0 * np.sin(a)],
                np.float32)
            box_obj.rotation = np.asarray(
                vq.from_euler_degrees(0.0, 30.0 + 2.0 * self.frame, 0.0))
            cam = engine.scene.active_camera
            cam.position = np.asarray([320.0, 4.0 * np.sin(a), 40.0],
                                      np.float32)
            engine.scene.active_directional_light.rotation = np.asarray(
                vq.from_euler_degrees(0.0, 45.0 + self.frame, -30.0))
            self.frame += 1

    def tensors(g):
        v = g.volumes
        return dict(corners=v.corners, sdf=v.sdf, accel=v.accel,
                    accel_u8=v.accel_u8, materials=v.materials,
                    textures=g.textures, env=g.env,
                    voxel_colors=g.voxel_colors)

    want_counts = dict(k1=0, scene=5, resolve=3, resolve_bwd=0, gather=0,
                       scatter=0, scatter_v4=0, scatter_scalar=0, surface=3,
                       combine=3, surface_bwd=0, combine_bwd=0)
    launches = dict(scene=0, resolve=0, surface=0, combine=0)
    held = {}

    def loop(pipelined, frames, tag):
        inst = Orbit()
        engine = Engine(inst, FRAME_W, FRAME_H, mode, pipelined=pipelined,
                        device=dev)
        engine.set_scene(host)
        before, ptrs = None, None
        runs, returned, syncs = [], [], []

        def one_frame():
            nonlocal before, ptrs
            inst.on_engine_update(engine, 1.0 / 60.0)
            host.tick(1.0 / 60.0)
            zero_counts()
            t0 = time.perf_counter()
            returned.append(engine.render_frame())
            runs.append(time.perf_counter() - t0)
            got = counts()
            host.post_render()
            if got != want_counts:
                raise AssertionError(f"launches of {tag} engine frame "
                                     f"{len(runs) - 1}: {got}, expected "
                                     f"{want_counts}")
            for name in launches:
                launches[name] += got[name]
            now = tensors(engine._gpu_scene)
            if before is not None:
                for name, t in now.items():
                    if t is not before[name] or t.data_ptr() != ptrs[name]:
                        raise AssertionError(
                            f"{tag} engine frame {len(runs) - 1}: an "
                            f"incremental sync_gpu replaced {name}")
            before = now
            ptrs = {name: t.data_ptr() for name, t in now.items()}

        def held_frame(which):
            # every scene-march, fused-resolve and shade launch of this
            # frame against its plain version on the same inputs
            box = {}
            name = f"{tag} engine frame {which}"

            def marches():
                box["scene"] = _scene_calls(one_frame, 5, name)

            def resolves():
                box["fused"] = _resolve_calls(marches, 3, name)
            box["shade"] = _shade_calls(resolves, 3, name)
            held[(tag, which)] = box

        sync()
        held_frame("first")          # also the warm-up and the full sync
        for _ in range(frames):
            one_frame()
        sync()
        steady = runs[1:]
        held_frame("last")
        last = engine.drain()
        sync()
        if pipelined:
            if returned[0] is not None or any(f is None
                                              for f in returned[1:]):
                raise AssertionError("the pipelined engine's first frame "
                                     "must be None and no later one")
        elif any(f is None for f in returned):
            raise AssertionError("a synchronous frame came back None")
        want = to_unorm8(render_image(engine._gpu_scene, FRAME_W, FRAME_H,
                                      mode)).cpu().numpy()
        if last.dtype != np.uint8 or last.shape != (FRAME_H, FRAME_W, 4):
            raise AssertionError(f"last_frame is {last.dtype} {last.shape}")
        if not np.array_equal(last, want):
            raise AssertionError(f"{tag}: last_frame differs from the UNORM "
                                 f"of render_image on the synced scene")
        if len({f.tobytes() for f in returned[-3:] if f is not None}) != 3:
            raise AssertionError(f"{tag}: frames handed out are not "
                                 f"distinct")
        med = statistics.median(steady) * 1e3
        print(f"engine {FRAME_W}x{FRAME_H} {tag} on {card}: median "
              f"{med:.1f} ms/frame over {len(steady)} frames (runs "
              f"{', '.join(f'{r * 1e3:.1f}' for r in steady)} ms), "
              f"{FRAME_W * FRAME_H / med * 1e3:.0f} rays/s; per frame scene "
              f"march 5, fused resolve 3, shade surface 3 and combine 3, "
              f"per-lane K1 0, K3 0; volume, "
              f"accel, texture and env tensors kept by every incremental "
              f"sync; last_frame uint8 {last.shape} equal to the UNORM of "
              f"render_image", flush=True)
        return engine, med

    engine, pipelined_ms = loop(True, 12, "pipelined")
    numbers["engine_pipelined_frame_ms"] = pipelined_ms
    del engine
    engine, numbers["engine_sync_frame_ms"] = loop(False, 12, "synchronous")

    # render_image alone on the same synced scene, for the engine's overhead
    synced = engine._gpu_scene
    runs = []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        img = render_image(synced, FRAME_W, FRAME_H, mode)
        sync()
        runs.append((time.perf_counter() - t0) * 1e3)
    numbers["render_image_f32_scene_ms"] = statistics.median(runs[1:])

    # resize + UNORM + readback alone
    rb = _Readback()

    def post(frame_in, upsample):
        def go():
            x = frame_in
            if upsample:
                x = upsample_bilinear(x, FRAME_H, FRAME_W)
            return rb.finish(rb.start(to_unorm8(x)))
        return go

    low_w, low_h = round(FRAME_W * 0.71), round(FRAME_H * 0.71)
    low = render_image(synced, low_w, low_h, mode)
    for tag, go in (("unorm_readback_ms", post(img, False)),
                    ("resize_unorm_readback_ms", post(low, True))):
        go()
        runs = []
        for _ in range(7):
            sync()
            t0 = time.perf_counter()
            go()
            runs.append((time.perf_counter() - t0) * 1e3)
        numbers[tag] = statistics.median(runs)

    # the incremental sync: host time on an idle card, and with a frame in
    # flight, as one pinned block and as one pageable copy per array
    consts = dict(
        inst_pos=np.zeros((2, 3), np.float32),
        inst_rot=np.zeros((2, 4), np.float32),
        inst_scale=np.ones((2, 3), np.float32),
        cam_pos=np.zeros(3, np.float32), cam_rot=np.zeros(4, np.float32),
        cam_fov=np.float32(60.0), dir_light_dir=np.zeros(3, np.float32),
        dir_light_strength=np.float32(6.0),
        inst_volume=np.zeros(2, np.int32))

    def host_ms(fn, in_flight, n=7):
        runs = []
        for _ in range(n):
            sync()
            if in_flight:
                render_image(synced, FRAME_W, FRAME_H, mode)
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        sync()
        return statistics.median(runs)

    block = {k: v for k, v in consts.items() if k != "inst_volume"}
    for tag, fn in (
            ("sync_gpu_incremental", lambda: host.sync_gpu(synced,
                                                           device=dev)),
            ("upload_pinned_block", lambda: scene_mod._upload_block(block,
                                                                    dev)),
            ("upload_per_array_pageable", lambda: _per_array_upload(consts,
                                                                    dev))):
        numbers[tag + "_idle_ms"] = host_ms(fn, False)
        numbers[tag + "_in_flight_ms"] = host_ms(fn, True)
    if host.sync_gpu(synced, device=dev).volumes is not synced.volumes:
        raise AssertionError("an incremental sync_gpu rebuilt the volumes")

    # a voxel edit forces a full rebuild
    mid = sphere_obj.volume.n_voxels // 2
    sphere_obj.volume.set_voxel((mid, mid, mid), 25.0)
    sync()
    t0 = time.perf_counter()
    rebuilt = host.sync_gpu(synced, device=dev)
    sync()
    numbers["sync_gpu_full_ms"] = (time.perf_counter() - t0) * 1e3
    if rebuilt.volumes is synced.volumes or \
            rebuilt.volumes.corners is synced.volumes.corners or \
            rebuilt.volumes.sdf[0, mid, mid, mid].item() != 25.0:
        raise AssertionError("set_voxel did not force a full sync_gpu")
    host.post_render()
    del rebuilt, img, low

    prof = _profile(lambda: engine.render_frame(), sync,
                    numbers["engine_sync_frame_ms"],
                    what="one synchronous 1080p engine frame")
    if prof is not None:
        numbers["engine_frame_busy_ms"] = prof["busy_ms"]
        numbers["engine_frame_device_ops"] = prof["device_ops"]
        for tag in ("sync", "pipelined"):
            numbers[f"engine_frame_busy_share_of_{tag}_frame"] = (
                prof["busy_ms"] / numbers[f"engine_{tag}_frame_ms"])
    del engine, synced
    print(f"engine numbers on {card}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in numbers.items()), flush=True)

    # -- render_scale = 0.71 -------------------------------------------------
    scaled = Engine(EngineInstance(), FRAME_W, FRAME_H, mode,
                    pipelined=False, render_scale=0.71, device=dev)
    scaled.set_scene(host)
    scaled.render_frame()                                      # warm-up
    runs = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        got = scaled.render_frame()
        runs.append((time.perf_counter() - t0) * 1e3)
    if (scaled._rw, scaled._rh) != (low_w, low_h):
        raise AssertionError(f"render size {scaled._rw}x{scaled._rh}")
    if got.dtype != np.uint8 or got.shape != (FRAME_H, FRAME_W, 4):
        raise AssertionError(f"scaled frame is {got.dtype} {got.shape}")
    low = render_image(scaled._gpu_scene, low_w, low_h, mode)
    if not bool(torch.isfinite(low).all()):
        raise AssertionError("the low-resolution frame is not finite")
    want = to_unorm8(upsample_bilinear(low.cpu(), FRAME_H, FRAME_W)).numpy()
    lsb = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    numbers["render_scale_071_frame_ms"] = statistics.median(runs)
    print(f"engine render_scale=0.71 on {card}: {low_w}x{low_h} -> "
          f"{got.shape[1]}x{got.shape[0]}, median "
          f"{numbers['render_scale_071_frame_ms']:.1f} ms/frame, within "
          f"{lsb} LSB of F.interpolate on the CPU of the same frame",
          flush=True)
    if lsb > 1 or got[..., :3].std() < 5:
        raise AssertionError(f"the upsampled frame is off by {lsb} LSB")
    del scaled, low, host

    # -- the CLIs at 1080p ---------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "demo")
        zero_counts()
        t0 = time.perf_counter()
        demo_engine = demo_app.main([
            "--frames", "8", "--width", str(FRAME_W), "--height",
            str(FRAME_H), "--out", out])
        demo_s = time.perf_counter() - t0
        got = counts()
        if (got["scene"], got["resolve"], got["surface"], got["combine"],
                got["k1"]) != (8 * 5, 8 * 3, 8 * 3, 8 * 3, 0):
            raise AssertionError(f"the demo's launches {got}")
        names = sorted(os.listdir(out))
        pngs = [read_png(os.path.join(out, n)) for n in names]
        if len(names) != 7 or any(p.shape != (FRAME_H, FRAME_W, 4)
                                  for p in pngs):
            raise AssertionError(f"the demo wrote {names}")
        if not np.array_equal(pngs[-1], demo_engine.last_frame):
            raise AssertionError("the demo's last PNG differs from "
                                 "engine.last_frame")
        if np.array_equal(pngs[0], pngs[-1]) or pngs[-1][..., :3].std() < 5:
            raise AssertionError("the demo's frames do not move")
        print(f"python -m vrt_torch.apps.demo --frames 8 at "
              f"{FRAME_W}x{FRAME_H} on {card}: {len(names)} PNGs in "
              f"{demo_s:.1f}s, the last equal "
              f"to engine.last_frame; launches {got['scene']} scene "
              f"marches, {got['resolve']} fused resolves, {got['surface']} + "
              f"{got['combine']} shade launches", flush=True)
        for name in ("scene", "resolve", "surface", "combine"):
            launches[f"demo_{name}"] = got[name]

        png = os.path.join(tmp, "torus.png")
        zero_counts()
        t0 = time.perf_counter()
        render_app.main([os.path.join(ROOT, "assets", "torus.vox"), "--env",
                         os.path.join(ROOT, "assets", "skybox.dds"),
                         "--width", str(FRAME_W), "--height", str(FRAME_H),
                         "-o", png])
        render_s = time.perf_counter() - t0
        got = counts()
        img = read_png(png)
        colours = len(np.unique(img.reshape(-1, 4), axis=0))
        if img.shape != (FRAME_H, FRAME_W, 4) or colours < 100 or \
                got["scene"] < 1 or got["resolve"] < 1 or got["k1"] != 0 or \
                got["surface"] < 1 or got["combine"] != got["surface"]:
            raise AssertionError(f"the render CLI's PNG: {img.shape}, "
                                 f"{colours} colours, launches {got}")
        print(f"python -m vrt_torch.apps.render assets/torus.vox --env "
              f"assets/skybox.dds at {FRAME_W}x{FRAME_H} on {card}: {colours} "
              f"distinct colours, {render_s:.1f}s; launches {got['scene']} "
              f"scene marches, {got['resolve']} fused resolves, "
              f"{got['surface']} + {got['combine']} shade launches",
              flush=True)
        for name in ("scene", "resolve", "surface", "combine"):
            launches[f"render_{name}"] = got[name]

    first = held[("pipelined", "first")]
    return dict(launches=launches, numbers=numbers, held=held,
                scene=first["scene"], fused=first["fused"],
                shade=first["shade"])


@contextlib.contextmanager
def _timing(module, name, box, key, after=None):
    """Add the host seconds of every call of ``module.name`` to
    ``box[key]``; ``after(args, result)`` may note more."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        box[key] = box.get(key, 0.0) + time.perf_counter() - t0
        if after is not None:
            after(args, out)
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _no_numpy_voxelizer():
    """Fail on any call of the numpy voxelizer: the import must take the
    native library."""
    from vrt_torch.io import voxelize as vox

    saved = vox.voxelize_mesh

    def refuse(*args, **kwargs):
        raise AssertionError("the import took the numpy voxelizer")

    vox.voxelize_mesh = refuse
    try:
        yield
    finally:
        vox.voxelize_mesh = saved


def _run_cli(args, tag, timeout=600, echo=False):
    """``python -m <args>`` from the checkout's root in a process of its
    own; fails unless it exits 0.  With ``echo`` its standard error is
    printed.  Returns its host seconds."""
    import subprocess

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{tag} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    if echo:
        for line in proc.stderr.strip().splitlines():
            print(f"  {tag}: {line}", flush=True)
    return seconds


def _config3(dev, card, sync, zero_counts, counts, gxx_s):
    """Phase 10: the import chain and config3's 257^3 voxelized torus at
    1920x1080 (``vrt/apps/bench.py``'s ``bench_voxelized_mesh``).  The
    native library, which phase 2 built (g++ took ``gxx_s``), loads;
    ``voxelized_torus_scene(8)`` writes the torus as
    a glTF mesh, voxelizes it through the library (never the numpy
    voxelizer), writes and reads its ``.vox`` file and builds the scene
    (chebyshev accel, bf16 corner table, no colour table), each step timed
    on the host; three 1080p frames after a warm-up with their launches
    asserted, a profile of one (device busy time, at most
    ``FRAME_OPS_MAX`` device ops; taken again, up to three times, while
    CUPTI drops a tenth of the device records or more: a few launch calls
    leave no record in every profile); every scene-march, fused-resolve and
    shade launch of one frame against its plain version, as in phase 3,
    with its time and bound; the 160x90 frame against ``vrt``'s CPU
    render (``CONFIG3_FIXTURE``) at phase 5's tolerance; the voxelize and
    render CLIs in processes of their own.  Returns dict(counts (of the
    three frames), held (scene, fused, shade of the held frame),
    numbers)."""
    import tempfile

    import numpy as np
    import torch

    from vrt_torch import native
    from vrt_torch.apps import make_assets
    from vrt_torch.apps import voxelize as vox_app
    from vrt_torch.io.image import read_png
    from vrt_torch.io.voxfile import load_scene
    from vrt_torch.march import types as mtypes
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scenes import TORUS_MESH, voxelized_torus_scene

    mode = RenderMode()
    numbers = {}

    # -- the native library, built in phase 2 ----------------------------------
    numbers["gxx_s"] = gxx_s
    if not native.lib:
        raise AssertionError("the native library did not load")
    print(f"native library: g++ {gxx_s:.2f}s in phase 2, loaded from "
          f"{native.library_path().name}", flush=True)

    # -- the import: glTF -> .vox -> device scene ---------------------------
    inner = {}

    def vox_size(args, _):
        inner["vox_bytes"] = os.path.getsize(args[1])

    with _no_numpy_voxelizer(), \
            _timing(vox_app, "voxelize_mesh_native", inner, "voxelize"), \
            _timing(vox_app, "save_scene", inner, "vox_write", vox_size), \
            _timing(mtypes, "build_accel_chebyshev", inner, "accel"), \
            _timing(mtypes, "pack_cell_corners", inner, "corner_table"):
        scene, seconds = voxelized_torus_scene(8, device=dev)
    sync()
    vols = scene.volumes
    corners = vols.corners
    n = int(vols.n[0])
    dmax = int((vols.accel >> 1).max())
    numbers.update({f"{k}_s": v for k, v in seconds.items()})
    numbers.update({f"{k}_s": v for k, v in inner.items() if k != "vox_bytes"})
    numbers["vox_bytes"] = inner["vox_bytes"]
    numbers["corner_table_bytes"] = corners.numel() * corners.element_size()
    print(f"config3 import on {card}: mesh and glTF {seconds['mesh']:.2f}s; "
          f"convert {seconds['convert']:.2f}s (native voxelize "
          f"{inner['voxelize']:.2f}s, .vox write {inner['vox_write']:.2f}s, "
          f"{inner['vox_bytes'] / 1e6:.0f} MB); .vox read "
          f"{seconds['load']:.2f}s; build_scene {seconds['build']:.2f}s "
          f"(chebyshev accel {inner['accel']:.2f}s, largest distance {dmax}; "
          f"corner table {inner['corner_table']:.2f}s); {n}^3 voxels, "
          f"corners {tuple(corners.shape)} {corners.dtype} = "
          f"{numbers['corner_table_bytes'] / 1e6:.0f} MB", flush=True)
    if n != 257 or corners.dtype != torch.bfloat16 or \
            tuple(corners.shape) != (1, 256, 256, 256, 8):
        raise AssertionError(f"config3's table: n {n}, corners "
                             f"{tuple(corners.shape)} {corners.dtype}")
    # without per-voxel colours the scene keeps a 1x1x1 placeholder
    if scene.use_voxel_colors or scene.voxel_color_corners is not None or \
            tuple(scene.voxel_colors.shape) != (1, 1, 1, 1, 3):
        raise AssertionError("config3 built a colour table")
    if scene.any_reflective or scene.num_instances != 1:
        raise AssertionError(f"config3: reflective {scene.any_reflective}, "
                             f"{scene.num_instances} instances")

    def frame(w=FRAME_W, h=FRAME_H):
        return lambda: render_image(scene, w, h, mode)

    # -- three 1080p frames after a warm-up ------------------------------------
    frame()()
    sync()
    zero_counts()
    runs = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        img = frame()()
        sync()
        runs.append(time.perf_counter() - t0)
    c3_counts = counts()
    levels, traces = _resolves(scene), _traces(scene)
    want = dict(k1=0, scene=3 * traces, resolve=3 * levels, resolve_bwd=0,
                gather=0, scatter=0, scatter_v4=0, scatter_scalar=0,
                surface=3 * levels, combine=3 * levels, surface_bwd=0,
                combine_bwd=0)
    if c3_counts != want:
        raise AssertionError(f"launches in 3 config3 frames {c3_counts}, "
                             f"expected {want}")
    if tuple(img.shape) != (FRAME_H, FRAME_W, 4) or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError(f"config3 frame {tuple(img.shape)}, finite "
                             f"{bool(torch.isfinite(img).all())}")
    median = statistics.median(runs) * 1e3
    numbers["frame_ms"] = median
    print(f"config3 1080p frame on {card}: median {median:.1f} ms (runs "
          f"{', '.join(f'{r * 1e3:.1f}' for r in runs)} ms), "
          f"{FRAME_W * FRAME_H / median * 1e3:.0f} rays/s; launches in 3 "
          f"frames: scene march {c3_counts['scene']}, fused resolve "
          f"{c3_counts['resolve']}, shade surface {c3_counts['surface']} and "
          f"combine {c3_counts['combine']}, per-lane K1 {c3_counts['k1']}, "
          f"K3 {c3_counts['gather']}", flush=True)
    for _ in range(3):
        prof = _profile(frame(), sync, median,
                        what="one 1080p config3 frame")
        if prof is None or \
                prof["device_records"] >= 0.9 * prof["device_ops"]:
            break
        print(f"config3 profile: {prof['device_records']} device records "
              f"for {prof['device_ops']} launch calls (CUPTI dropped "
              f"records at the start of the trace); profiling again",
              flush=True)
    if prof is not None:
        numbers["frame_device_records"] = prof["device_records"]
        numbers["frame_busy_ms"] = prof["busy_ms"]
        numbers["frame_device_ops"] = prof["device_ops"]
        if prof["device_ops"] > FRAME_OPS_MAX:
            raise AssertionError(f"the config3 frame: {prof['device_ops']} "
                                 f"device ops")

    # -- every launch of one frame against its plain version -------------------
    held = {}
    tag = "config3 1080p frame"

    def marches():
        held["scene"] = _scene_calls(frame(), traces, tag)

    def resolves():
        held["fused"] = _resolve_calls(marches, levels, tag)
    held["shade"] = _shade_calls(resolves, levels, tag)
    rows = [("scene march", held["scene"]["ms"], held["scene"]["plain_ms"],
             held["scene"]["bound"]),
            ("fused resolve", [held["fused"]["ms"]],
             [held["fused"]["plain_ms"]], held["fused"]["bound"])]
    rows += [(f"shade {stage}", held["shade"][stage]["ms"],
              held["shade"][stage]["plain_ms"], held["shade"][stage]["bound"])
             for stage in ("surface", "combine")]
    print(f"config3 kernels at {n}^3 on {card}: " + "; ".join(
        f"{name} {sum(ms):.4f} ms (plain {sum(plain):.2f} ms), bound "
        f"{b['bound_ms']:.4f} ms ({b['bytes']} B, by {b['bound_by']}) = "
        f"{b['bound_ms'] / sum(ms):.0%} of the kernel"
        for name, ms, plain, b in rows) + "; lanes on the step cap "
          f"(kernel, plain) per trace {held['scene']['capped']}", flush=True)

    # -- anchored to vrt's CPU render ---------------------------------------
    want = np.load(CONFIG3_FIXTURE)
    got = render_image(scene, 160, 90, mode)[..., :3].cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError("config3's 160x90 frame has non-finite pixels")
    diff = np.abs(got - want)
    q90 = float(np.quantile(diff, 0.90))
    mean = float(diff.mean())
    outl = float((diff.max(axis=-1) > 0.1).mean())
    print(f"config3 160x90 vs vrt fixture: q90 {q90:.2e} (< 0.015), mean "
          f"{mean:.2e} (< 0.01), pixels off > 0.1 {outl:.2e} (< 0.03)",
          flush=True)
    if not (q90 < 0.015 and mean < 0.01 and outl < 0.03):
        raise AssertionError("config3's 160x90 frame disagrees with the vrt "
                             "fixture")
    numbers.update(fixture_q90=q90, fixture_mean=mean, fixture_outliers=outl)
    sdf = vols.sdf[0].cpu().numpy()
    del scene, vols, corners, img

    # -- the CLIs, each in a process of its own ------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        gltf = os.path.join(tmp, "torus_8.gltf")
        verts, faces = make_assets.torus_mesh(**TORUS_MESH)
        make_assets.write_gltf_mesh(gltf, verts, faces, name="torus_8")
        vox = os.path.join(tmp, "torus_8.vox")
        png = os.path.join(tmp, "torus_8.png")
        numbers["voxelize_cli_s"] = _run_cli(
            ["vrt_torch.apps.voxelize", gltf, "-o", vox],
            "python -m vrt_torch.apps.voxelize")
        (vol,) = load_scene(vox).volumes
        if not np.array_equal(vol.sdf, sdf):
            raise AssertionError("the voxelize CLI's grid differs from "
                                 "voxelized_torus_scene's")
        numbers["render_cli_s"] = _run_cli(
            ["vrt_torch.apps.render", vox, "--width", str(FRAME_W),
             "--height", str(FRAME_H), "-o", png],
            "python -m vrt_torch.apps.render")
        out = read_png(png)
        colours = len(np.unique(out.reshape(-1, out.shape[-1]), axis=0))
        if out.shape != (FRAME_H, FRAME_W, 4) or colours < 100:
            raise AssertionError(f"the render CLI's PNG: {out.shape}, "
                                 f"{colours} colours")
    print(f"python -m vrt_torch.apps.voxelize torus_8.gltf: "
          f"{numbers['voxelize_cli_s']:.1f}s, the same {n}^3 grid; python -m "
          f"vrt_torch.apps.render torus_8.vox --width {FRAME_W} --height "
          f"{FRAME_H}: {numbers['render_cli_s']:.1f}s, a {out.shape[0]}x"
          f"{out.shape[1]} PNG of {colours} colours", flush=True)
    return dict(counts=c3_counts, held=held, numbers=numbers)


# ---- phase 11: config5 and the ray-sharded frame ------------------------------

CONFIG5_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "config5_r9_slab4_160x90.npy")
CONFIG5_RANKS = 4     # model ranks of the slab frame, all on cuda:0 (gloo)
SHARDED_RANKS = 2     # data ranks of the ray-sharded flagship frame
RANK_TIMEOUT = 600.0  # seconds a world of ranks may take
# a K7 launch moves, per ray, o, d, t_max in (28 B) and the hit out (45 B)
SLAB_IN_BYTES, SLAB_OUT_BYTES = 28, 45


def _slab_bound(tables, hit, interp):
    """K7's bound from what these rays need (its result ``hit``, equal to
    the twin's): 73 B a ray, one accel byte a node step and a cell's 8
    voxels of the planes (32 B) a surface or solid-entry hit in interp mode
    (one density a step in cube mode), no table beyond the planes' bytes."""
    rays = hit.hit.numel()
    steps = int(hit.steps.sum())
    rows = int(((hit.kind == 1) | (hit.kind == 2)).sum())
    table = min(steps, tables["accel_u8"].numel())
    if interp:
        table += min(rows * 32, tables["sdf"].numel() * 4)
    else:
        table += min(4 * steps, tables["sdf"].numel() * 4)
    flops = rays * LANE_FLOPS + steps * STEP_FLOPS + rows * SURFACE_FLOPS
    return _bound(rays * (SLAB_IN_BYTES + SLAB_OUT_BYTES) + table, flops)


def _hits_equal(a, b):
    """Fields of two MarchHits that differ (NaN equal to NaN)."""
    import torch

    bad = {}
    for f in ("hit", "t", "kind", "cell", "t_in", "t_out", "face_normal",
              "steps"):
        x, y = getattr(a, f), getattr(b, f)
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) \
            if x.is_floating_point() else x == y
        if not bool(same.all()):
            bad[f] = int((~same).sum())
    return bad


def _rank_counts():
    from vrt_torch.dist import mesh
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import optim as ko
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import rows as k3
    from vrt_torch.kernels import shade as k4

    return dict(k7=k1.SLAB_LAUNCHES, k1=k1.LAUNCHES, scene=k1.SCENE_LAUNCHES,
                resolve=kr.LAUNCHES["forward"],
                slab_resolve=kr.SLAB_LAUNCHES["forward"],
                resolve_bwd=kr.LAUNCHES["backward"],
                slab_resolve_bwd=kr.SLAB_LAUNCHES["backward"],
                surface=k4.LAUNCHES["surface"],
                combine=k4.LAUNCHES["combine"],
                surface_bwd=k4.LAUNCHES["surface_bwd"],
                combine_bwd=k4.LAUNCHES["combine_bwd"],
                gather=k3.LAUNCHES["K3 gather"],
                scatter=k3.LAUNCHES["K3 scatter"],
                adam=ko.LAUNCHES["apply"], adam_update=ko.LAUNCHES["update"],
                collectives={k: v for k, v in mesh.STATS.items()
                             if k != "seconds"})


def _rank_zero_counts():
    from vrt_torch.dist import mesh
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import optim as ko
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import rows as k3
    from vrt_torch.kernels import shade as k4

    k1.SLAB_LAUNCHES = k1.LAUNCHES = k1.SCENE_LAUNCHES = 0
    _reset(ko.LAUNCHES)
    _reset(k3.LAUNCHES)
    _reset(kr.SLAB_LAUNCHES)
    _reset(kr.LAUNCHES)
    _reset(k4.LAUNCHES)
    mesh.reset_stats()


def _rank_frames(render, n=3):
    """``n`` frames of ``render()`` after a warm-up, each from a barrier of
    all ranks to the card's end on this rank (host clock), with this rank's
    launches and the collectives' host seconds over the ``n``."""
    import torch
    import torch.distributed as dist

    from vrt_torch.dist import mesh

    render()
    torch.cuda.synchronize()
    _rank_zero_counts()
    runs = []
    for _ in range(n):
        dist.barrier()
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return img, runs, _rank_counts(), mesh.STATS["seconds"]


def _one_at_a_time(fn):
    """``fn()`` on each rank in turn while the others wait at a barrier,
    so that no other rank shares the card while one is timed."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r == dist.get_rank():
            out = fn()
        dist.barrier()
    return out


def _frame_peak_gb(render, slab):
    """The card's peak memory (GB, max_memory_allocated from a reset) of
    this rank over one ``render(slab)`` of a fresh copy of ``slab`` (its
    tables, packed or not, built inside), after the frame's own buffers
    were freed."""
    import dataclasses

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    render(dataclasses.replace(slab))
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def _config5_rank(rank, world, td, geometry):
    """One model rank of phase 11's slab frame: its slab of config5 from
    ``td``, the stub scene, the 1080p frames (launches and host clock), the
    160x90 frame, every K7 and slab-resolve launch against its plain version
    and against its first design (the packed table), both designs timed
    (old, new, new, old) while the other ranks wait, with K7's live lanes
    and SIMT efficiency, the peak memory of a frame on either design, and
    the halo refresh after rank 2's plane edit, against a fresh split of
    the edited volume."""
    import dataclasses

    import numpy as np
    import torch

    from vrt_torch.dist import brick, mesh
    from vrt_torch.dist.slab_render import (SlabTracer, default_fit_scene,
                                            render_slab_image)
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.march import MAX_ITERATIONS

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for build in (k1.build, kr.build, k4.build):
        build()                               # built by the parent: loads
    m = mesh.make_render_mesh(1, world, "cuda")
    group = mesh.axis_group(m, mesh.MODEL_AXIS)[0]
    with np.load(os.path.join(td, f"slab{rank}.npz")) as f:
        slab = brick.SlabVolume(**{k: torch.from_numpy(f[k]).to(dev)
                                   for k in brick._FIELDS})
    n, h, ext, light = geometry
    scene = default_fit_scene(n, h, ext, light, device=dev)
    out = {"backend": mesh.init_distributed("gloo")}

    def frame(w, hh, sl=None):
        return render_slab_image(scene, slab if sl is None else sl, m, w, hh)

    img, runs, counts, coll_s = _rank_frames(
        lambda: frame(FRAME_W, FRAME_H))
    out.update(frame_s=runs, counts=counts, collective_s=coll_s)
    # a frame's peak memory on either design (every rank renders together)
    out["peak_gb"] = {
        table: _frame_peak_gb(lambda sl: frame(FRAME_W, FRAME_H, sl),
                              dataclasses.replace(slab, table=table))
        for table in ("packed", "planes")}
    if rank == 0:
        out["frame"] = img[..., :3].cpu().numpy()
    small = frame(160, 90)
    if rank == 0:
        out["small"] = small[..., :3].cpu().numpy()

    # every K7 and slab-resolve launch of a 480x270 and a 1080p frame
    held = {}
    for tag, (w, hh) in (("480x270", (SMALL_W, SMALL_H)),
                         ("1080p", (FRAME_W, FRAME_H))):
        with _recording(k1, "march_slab_cuda") as marches, \
                _recording(kr, "resolve_slab_cuda") as resolves:
            frame(w, hh)
        torch.cuda.synchronize()
        held[tag] = (marches, resolves)

    def plain_march(args, kw):
        return brick.march_volume_slab_reference(*args, **kw)

    def plain_resolve(args):
        sc, sl, o_w, d_w, hit, inst = args
        o, d = SlabTracer(sl, group)._object_rays(sc, o_w, d_w)
        return brick.resolve_slab_hits(sl, o, d, hit)

    packed = dataclasses.replace(slab, table="packed")   # the first design

    def check():
        """Every launch against its plain version and its first design,
        the 1080p ones timed; run on this rank while the others wait."""
        k7 = dict(launches_small=len(held["480x270"][0]), diffs=[],
                  old_diffs=[], capped=[], ms=[], old_ms=[], plain_ms=[],
                  bounds=[], steps=[], live=[], simt=[], simt_live=[])
        rs = dict(launches_small=len(held["480x270"][1]), diffs=[],
                  old_diffs=[], design_diffs=[], ms=[], old_ms=[],
                  packed_ms=[], plain_ms=[], owned=[], bounds=[])
        for tag, (marches, resolves) in held.items():
            for i, (args, kw, got) in enumerate(marches):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                want = plain_march(args, kw)
                end.record()
                end.synchronize()
                old = (packed,) + tuple(args[1:])
                k7["diffs"].append((tag, i, _hits_equal(got, want)))
                k7["old_diffs"].append((tag, i, _hits_equal(
                    got, k1.march_slab_cuda(*old, **kw))))
                k7["capped"].append(
                    (tag, i, int((got.steps >= MAX_ITERATIONS).sum()),
                     int((want.steps >= MAX_ITERATIONS).sum())))
                if tag == "1080p":
                    live = want.steps > 0
                    k7["live"].append(int(live.sum()))
                    k7["simt"].append(_simt(want.steps))
                    k7["simt_live"].append(_simt(want.steps[live]))
                    k7["plain_ms"].append(start.elapsed_time(end))
                    k7["steps"].append(int(want.steps.sum()))
                    k7["bounds"].append(_slab_bound(args[0].march_tables,
                                                    want, args[4]))
                    olds, news = _paired_ms(
                        lambda: k1.march_slab_cuda(*old, **kw),
                        lambda: k1.march_slab_cuda(*args, **kw), 10)
                    k7["ms"].append(news)
                    k7["old_ms"].append(olds)
                del want
            for i, (args, _, got) in enumerate(resolves):
                with torch.no_grad():
                    want = plain_resolve(args)
                hit, sl = args[4], args[1]
                owned = (hit.hit & (hit.cell[:, 0] >= sl.cell_lo)
                         & (hit.cell[:, 0] < sl.cell_hi))
                bad = {}
                for name, a, b in zip(("t", "normal", "unlit"), got, want):
                    a, b = a[owned], b[owned]
                    same = (a == b) | ((a != a) & (b != b))
                    if not bool(same.all()):
                        bad[name] = int((~same).sum())
                rs["diffs"].append((tag, i, bad))
                rs["owned"].append((tag, i, int(owned.sum())))
                # bit-equal to the packed table but on the surface hits this
                # rank does not own (their cells may leave its planes)
                old = (args[0], packed) + tuple(args[2:])
                lanes = owned | (hit.kind != 1)
                rs["old_diffs"].append((tag, i, [
                    name for name, a, b in zip(
                        ("t", "normal", "unlit"), got,
                        kr.resolve_slab_cuda(*old))
                    if not _nan_equal(a[lanes], b[lanes])]))
                # the kernel's first design over the same planes, outputs
                # filled first: bit-equal on every lane
                with _filled_outputs():
                    new = kr.resolve_slab_cuda(*args)
                    first = kr.resolve_slab_cuda(*args, _old_design=True)
                rs["design_diffs"].append((tag, i, [
                    name for name, a, b in zip(("t", "normal", "unlit"), new,
                                               first)
                    if not _nan_equal(a, b)]))
                del new, first
                if tag == "1080p":
                    olds, news = _paired_ms(
                        lambda: kr.resolve_slab_cuda(*args,
                                                     _old_design=True),
                        lambda: kr.resolve_slab_cuda(*args), 10)
                    rs["ms"].append(news)
                    rs["old_ms"].append(olds)
                    rs["packed_ms"].append(device_ms(
                        lambda: kr.resolve_slab_cuda(*old), 10))
                    rs["plain_ms"].append(device_ms(
                        lambda: plain_resolve(args), 3))
                    rs["bounds"].append(_slab_resolve_bound(hit, sl))
                del want
        return k7, rs

    k7, rs = _one_at_a_time(check)
    out.update(k7=k7, resolve=rs, cell_lo=int(slab.cell_lo),
               cell_hi=int(slab.cell_hi))
    del held, marches, resolves, k7, rs, packed

    # the halo refresh: rank 2 edits its plane cell_lo + 1 (in rank 1's
    # right halo); after the exchange every slab is a fresh split's
    with np.load(os.path.join(td, "edit.npz")) as f:
        pattern = torch.from_numpy(f["pattern"]).to(dev)
    sdf = slab.sdf.clone()
    if rank == 2:
        sdf[brick.HALO + 1] += pattern
    refreshed = brick.exchange_halos(dataclasses.replace(slab, sdf=sdf),
                                     group)
    with np.load(os.path.join(td, f"fresh{rank}.npz")) as f:
        fresh = torch.from_numpy(f["sdf"]).to(dev)
    out["halo_equal"] = bool(torch.equal(refreshed.sdf, fresh))
    out["halo_changed"] = bool(not torch.equal(refreshed.sdf, slab.sdf))
    out["staged"] = mesh.STATS["staged"]
    return out


def _slab_voxels(hit, slab, offsets):
    """The distinct voxels of the slab's planes that the surface hits'
    cells at ``offsets`` (rows of ``_OFFS7``) read, each once."""
    import torch

    from vrt_torch.dist.brick import _slab_voxel_index
    from vrt_torch.march import isosurface as iso

    surf = hit.kind == 1
    dev = hit.cell.device
    cells = hit.cell[surf][:, None, :] + torch.as_tensor(offsets, device=dev)
    lin, valid = _slab_voxel_index(
        slab, cells[..., None, :] + torch.as_tensor(iso.CORNERS, device=dev))
    return int(torch.unique(lin[valid]).numel())


def _slab_resolve_bound(hit, slab):
    """The slab resolve's bound from what these hits need, as
    ``_resolve_bound`` counts it, on the planes: each distinct voxel (4 B)
    of the cells of the surface hits' six neighbours, once."""
    from vrt_torch.march.resolve import _OFFS7

    rays = hit.kind.numel()
    n_surf = int((hit.kind == 1).sum())
    n_solid = int((hit.kind == 2).sum())
    n_debug = int((hit.kind == 5).sum())
    nbytes = (rays * (8 + 17) + (rays - n_surf - n_debug) * 12
              + (n_surf + n_solid) * 28 + n_surf * 12
              + 4 * _slab_voxels(hit, slab, _OFFS7[1:]))
    return _bound(nbytes, n_surf * RESOLVE_FLOPS)


def _sharded_rank(rank, world):
    """One data rank of phase 11's ray-sharded flagship frame at 1080p."""
    import torch

    from vrt_torch.dist import mesh
    from vrt_torch.dist.sharding import render_image_sharded
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for build in (k1.build, kr.build, k4.build):
        build()
    scene = flagship_scene(7, "chebyshev", torch.bfloat16, device=dev)
    m = mesh.make_render_mesh(world, 1, "cuda")
    img, runs, counts, coll_s = _rank_frames(
        lambda: render_image_sharded(scene, FRAME_W, FRAME_H, RenderMode(),
                                     m))
    return dict(img=img.cpu().numpy() if rank == 0 else None, frame_s=runs,
                counts=counts, collective_s=coll_s)


def _config5(dev, card, sync, td, ptxas):
    """Phase 11: config5 of ``vrt/apps/scaling.py`` (the 513^3 CSG volume,
    octree accel, ``default_fit_scene``) sharded into 4 x-slabs over 4 model
    ranks, every rank a process on this card joined over gloo; and the
    flagship frame split over 2 data ranks.  The ranks' slabs are written to
    ``td`` as ``slab<rank>.npz`` (phase 12 reads them again).  ``ptxas``
    holds phase 2's register counts (K7's two designs among them).  Returns
    dict(numbers, k7, launches, geometry)."""
    import numpy as np
    import torch

    from vrt_torch.core import quat as vq
    from vrt_torch.dist import brick, mesh
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image
    from vrt_torch.scenes import (CONFIG5_LIGHT_EULER, config5_scene,
                                  config5_slab_volume, flagship_scene)
    from vrt_torch.volume.volume import VoxelVolume

    t0 = time.perf_counter()
    vol = config5_slab_volume(9)
    bake_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slabs = brick.shard_volume(vol, CONFIG5_RANKS)
    shard_s = time.perf_counter() - t0
    n = vol.n_voxels
    print(f"config5: {n}^3 ({vol.sdf.nbytes / 1e9:.2f} GB f32), bake "
          f"{bake_s:.1f}s, shard_volume into {CONFIG5_RANKS} slabs of "
          f"{slabs.sdf.shape[1]} planes {shard_s:.1f}s", flush=True)
    light = np.asarray(vq.forward_vector(vq.from_euler_degrees(
        *CONFIG5_LIGHT_EULER)), np.float32)
    geometry = (n, vol.cell_size, vol.extends, light)

    # the replicated frame of the same volume (f32 table, octree accel)
    t0 = time.perf_counter()
    rep = config5_scene(vol, dev, stub=False)
    sync()
    build_s = time.perf_counter() - t0
    render_image(rep, FRAME_W, FRAME_H)
    sync()
    t0 = time.perf_counter()
    replicated = render_image(rep, FRAME_W, FRAME_H)[..., :3].cpu().numpy()
    rep_s = time.perf_counter() - t0
    print(f"config5 replicated scene: build {build_s:.1f}s, corners "
          f"{tuple(rep.volumes.corners.shape)} {rep.volumes.corners.dtype}; "
          f"1080p frame {1e3 * rep_s:.1f} ms", flush=True)
    del rep
    torch.cuda.empty_cache()

    # the edit of the halo check: a fresh split of the edited volume
    pattern = np.random.default_rng(5).normal(scale=2.0, size=(n, n)
                                              ).astype(np.float32)
    plane = int(slabs.cell_lo[2]) + 1
    edited = vol.sdf.copy()
    edited[plane] += pattern
    fresh = brick.shard_volume(VoxelVolume(vol.resolution, vol.extends,
                                           sdf=edited), CONFIG5_RANKS)
    del edited, vol
    for s in range(CONFIG5_RANKS):
        local = slabs.local(s, "cpu")
        np.savez(os.path.join(td, f"slab{s}.npz"),
                 **{f: getattr(local, f).numpy() for f in brick._FIELDS})
        np.savez(os.path.join(td, f"fresh{s}.npz"), sdf=fresh.sdf[s].numpy())
    np.savez(os.path.join(td, "edit.npz"), pattern=pattern)
    del fresh, slabs
    t0 = time.perf_counter()
    ranks = mesh.spawn_world(_config5_rank, CONFIG5_RANKS,
                             args=(td, geometry), backend="gloo",
                             timeout=RANK_TIMEOUT)
    world_s = time.perf_counter() - t0
    print(f"config5: {CONFIG5_RANKS} ranks on {card} over "
          f"{ranks[0]['backend']} ({world_s:.1f}s for the world)", flush=True)

    # the slab frame against the replicated one (_compare's gates)
    got = ranks[0]["frame"]
    if not np.isfinite(got).all():
        raise AssertionError("config5 slab frame has non-finite pixels")
    diff = np.abs(replicated - got).max(axis=-1)
    within, worst = float((diff < 1e-5).mean()), float(diff.max())
    beyond = float((diff > 0.25).mean())
    print(f"config5 1080p slab frame vs replicated: {within:.4%} of pixels "
          f"within 1e-5 (> 97%), max {worst:.3e} (< 0.25), > 0.25 on "
          f"{beyond:.2e} (< 1%)", flush=True)
    if not (within > 0.97 and worst < 0.25 and beyond < 0.01):
        raise AssertionError("config5 slab frame disagrees with the "
                             "replicated frame")
    # the anchor: vrt's CPU render of the same frame at 160x90
    want = np.load(CONFIG5_FIXTURE)
    d90 = np.abs(ranks[0]["small"] - want)
    q90, mean = float(np.quantile(d90, 0.90)), float(d90.mean())
    outl = float((d90.max(axis=-1) > 0.1).mean())
    print(f"config5 160x90 vs vrt fixture: q90 {q90:.2e} (< 0.015), mean "
          f"{mean:.2e} (< 0.01), pixels off > 0.1 {outl:.2e} (< 0.03)",
          flush=True)
    if not (q90 < 0.015 and mean < 0.01 and outl < 0.03):
        raise AssertionError("config5 160x90 frame disagrees with the vrt "
                             "fixture")

    # K7, the slab resolve, the launches, the halo refresh on every rank
    per_rank = {"k7_ms": [], "k7_old_ms": [], "k7_plain_ms": [],
                "resolve_ms": [], "resolve_old_ms": [],
                "resolve_packed_ms": [],
                "resolve_plain_ms": [], "steps": [], "frame_ms": [],
                "collective_share": [], "live": [], "simt": [],
                "simt_live": [], "peak_gb": [], "old_peak_gb": []}

    def regs(kernel, threads):
        got = ptxas.get(kernel)
        if got is None:
            return "ptxas: not in this run's log"
        lo, hi = got["registers"]
        return (f"{lo}-{hi} registers at {threads} threads a block, warp "
                f"slots {got['occupancy'][0]:.0%}-{got['occupancy'][1]:.0%}")
    k7_bounds, rs_bounds = [], []
    for r, x in enumerate(ranks):
        c = x["counts"]
        frames = len(x["frame_s"])
        want_c = dict(k7=2 * frames, k1=0, scene=0, resolve=frames,
                      slab_resolve=frames, surface=frames, combine=frames)
        seen = {k: c[k] for k in want_c}
        print(f"config5 rank {r} (cells [{x['cell_lo']}, {x['cell_hi']})): "
              f"launches over {frames} frames {seen}; collectives "
              f"{c['collectives']}; frames {_list([1e3 * t for t in x['frame_s']])}"
              f" ms, collectives {x['collective_s']:.3f}s of "
              f"{sum(x['frame_s']):.3f}s", flush=True)
        if seen != want_c:
            raise AssertionError(f"config5 rank {r}: launches {seen}, "
                                 f"expected {want_c}")
        k7, rs = x["k7"], x["resolve"]
        if (k7["launches_small"], rs["launches_small"]) != (2, 1):
            raise AssertionError(f"config5 rank {r}: a 480x270 frame "
                                 f"launched K7 {k7['launches_small']} and "
                                 f"the slab resolve {rs['launches_small']} "
                                 f"times, expected 2 and 1")
        for tag, i, bad in k7["diffs"]:
            if bad:
                raise AssertionError(f"config5 rank {r}: K7 {tag} launch {i}"
                                     f" differs from the twin: {bad}")
        for tag, i, bad in k7["old_diffs"]:
            if bad:
                raise AssertionError(f"config5 rank {r}: K7 {tag} launch {i}"
                                     f" differs from its first design: "
                                     f"{bad}")
        if any(c[2] or c[3] for c in k7["capped"]):
            raise AssertionError(f"config5 rank {r}: K7 lanes on the step "
                                 f"cap {k7['capped']}")
        for tag, i, bad in rs["diffs"]:
            if bad:
                raise AssertionError(f"config5 rank {r}: slab resolve {tag} "
                                     f"{i} differs from its plain version on"
                                     f" owned lanes: {bad}")
        for tag, i, bad in rs["old_diffs"]:
            if bad:
                raise AssertionError(f"config5 rank {r}: slab resolve {tag} "
                                     f"{i} differs from the packed table's: "
                                     f"{bad}")
        for tag, i, bad in rs["design_diffs"]:
            if bad:
                raise AssertionError(f"config5 rank {r}: slab resolve {tag} "
                                     f"{i} differs from the kernel's first "
                                     f"design over the planes: {bad}")
        if not (x["halo_equal"] and (x["halo_changed"] or r not in (1, 2))):
            raise AssertionError(f"config5 rank {r}: halo refresh equal "
                                 f"{x['halo_equal']}, changed "
                                 f"{x['halo_changed']}")
        k7_new = [statistics.mean(t) for t in k7["ms"]]
        k7_old = [statistics.mean(t) for t in k7["old_ms"]]
        per_rank["k7_ms"].append(sum(k7_new))
        per_rank["k7_old_ms"].append(sum(k7_old))
        per_rank["k7_plain_ms"].append(sum(k7["plain_ms"]))
        per_rank["resolve_ms"].append(sum(statistics.mean(t)
                                          for t in rs["ms"]))
        per_rank["resolve_old_ms"].append(sum(statistics.mean(t)
                                              for t in rs["old_ms"]))
        per_rank["resolve_packed_ms"].append(sum(rs["packed_ms"]))
        per_rank["resolve_plain_ms"].append(sum(rs["plain_ms"]))
        per_rank["live"].append(k7["live"])
        per_rank["simt"].append(k7["simt"])
        per_rank["simt_live"].append(k7["simt_live"])
        per_rank["peak_gb"].append(x["peak_gb"]["planes"])
        per_rank["old_peak_gb"].append(x["peak_gb"]["packed"])
        per_rank["steps"].append(k7["steps"][0])
        per_rank["frame_ms"].append(1e3 * statistics.median(x["frame_s"]))
        per_rank["collective_share"].append(x["collective_s"]
                                            / sum(x["frame_s"]))
        k7_bounds += k7["bounds"]
        rs_bounds += rs["bounds"]
        print(f"config5 rank {r}: K7 equal to the twin and to its first "
              f"design field by field on {len(k7['diffs'])} launches "
              f"(480x270 and 1080p), lanes on the step cap (kernel, plain) "
              f"{[c[2:] for c in k7['capped']]}; slab resolve equal to its "
              f"plain version on {[o[2] for o in rs['owned']]} owned lanes, "
              f"to the packed table's on them and on every lane but a "
              f"surface hit, and to the kernel's first design over the "
              f"planes bit for bit on every lane; halo refresh equal to a "
              f"fresh split (staged sends {x['staged']}); a 1080p frame's "
              f"peak memory {x['peak_gb']['planes']:.3f} GB on the planes, "
              f"{x['peak_gb']['packed']:.3f} GB on the packed table",
              flush=True)
        for i, launch in enumerate(("primary", "shadow")):
            print(f"config5 rank {r} K7 1080p {launch}: live lanes "
                  f"{k7['live'][i]} of {FRAME_W * FRAME_H}, SIMT efficiency "
                  f"{k7['simt'][i]:.3f} in launch order, "
                  f"{k7['simt_live'][i]:.3f} in dense warps of the live "
                  f"lanes, steps {k7['steps'][i]}; redesign "
                  f"{_list(k7['ms'][i])} ms "
                  f"({regs('march_slab_capped_kernel', 64)}), first design "
                  f"{_list(k7['old_ms'][i])} ms "
                  f"({regs('march_slab_kernel', 256)}), old, new, new, old; "
                  f"twin {k7['plain_ms'][i]:.2f} ms; bound "
                  f"{k7['bounds'][i]['bound_ms']:.4f} ms", flush=True)
        print(f"config5 rank {r} slab resolve 1080p over the planes: "
              f"first design, redesign, redesign, first design "
              f"{_list([rs['old_ms'][0][0], *rs['ms'][0], rs['old_ms'][0][1]])}"
              f" ms ({regs('resolve_lean_kernel', RESOLVE_THREADS)}; "
              f"first design {regs('resolve_kernel', 256)}); the redesign "
              f"over the packed table {_list(rs['packed_ms'])} ms; plain "
              f"{_list(rs['plain_ms'])} ms; bound "
              f"{rs['bounds'][0]['bound_ms']:.4f} ms", flush=True)
    k7_bound, rs_bound = _sum_bounds(k7_bounds), _sum_bounds(rs_bounds)
    k7_new, k7_old = sum(per_rank["k7_ms"]), sum(per_rank["k7_old_ms"])
    print(f"config5 K7 over the {CONFIG5_RANKS} ranks' 1080p frame: "
          f"redesign {k7_new:.4f} ms = "
          f"{k7_bound['bound_ms'] / k7_new:.0%} of the bound "
          f"{k7_bound['bound_ms']:.4f} ms, first design {k7_old:.4f} ms = "
          f"{k7_bound['bound_ms'] / k7_old:.0%}; slab resolve on the "
          f"planes {sum(per_rank['resolve_ms']):.4f} ms = "
          f"{rs_bound['bound_ms'] / sum(per_rank['resolve_ms']):.0%} of its "
          f"bound {rs_bound['bound_ms']:.4f} ms, its first design "
          f"{sum(per_rank['resolve_old_ms']):.4f} ms; the redesign on the "
          f"packed table {sum(per_rank['resolve_packed_ms']):.4f} ms",
          flush=True)
    if not k7_new <= k7_old:
        raise AssertionError(f"K7's redesign ({k7_new:.4f} ms) is slower "
                             f"than its first design ({k7_old:.4f} ms)")
    steps = per_rank["steps"]
    print(f"config5 per-rank primary march steps {steps} (max/mean "
          f"{max(steps) / (sum(steps) / len(steps)):.3f}); frame host median "
          f"{statistics.median(per_rank['frame_ms']):.1f} ms; collectives "
          f"{_list(per_rank['collective_share'])} of the host clock", flush=True)

    # the ray-sharded flagship frame against render_image, bit for bit
    flagship = flagship_scene(7, "chebyshev", torch.bfloat16, device=dev)
    want_img = render_image(flagship, FRAME_W, FRAME_H, RenderMode())
    want_img = want_img.cpu().numpy()
    del flagship
    torch.cuda.empty_cache()
    sharded = mesh.spawn_world(_sharded_rank, SHARDED_RANKS, backend="gloo",
                               timeout=RANK_TIMEOUT)
    same = sharded[0]["img"] == want_img
    print(f"ray-sharded flagship 1080p over {SHARDED_RANKS} data ranks: "
          f"equal to render_image on {same.mean():.6%} of values; frame "
          f"{_list([1e3 * t for t in sharded[0]['frame_s']])} ms; "
          f"collectives {sharded[0]['collective_s']:.3f}s of "
          f"{sum(sharded[0]['frame_s']):.3f}s", flush=True)
    if not same.all():
        raise AssertionError("the ray-sharded frame differs from "
                             "render_image")
    sh_launches = {}
    for r, x in enumerate(sharded):
        c = x["counts"]
        frames = len(x["frame_s"])
        want_c = dict(k7=0, k1=0, scene=5 * frames, resolve=3 * frames,
                      surface=3 * frames, combine=3 * frames)
        seen = {k: c[k] for k in want_c}
        if seen != want_c:
            raise AssertionError(f"sharded rank {r}: launches {seen}, "
                                 f"expected {want_c}")
        for k, v in seen.items():
            sh_launches[k] = sh_launches.get(k, 0) + v
    c5 = {k: sum(x["counts"][k] for x in ranks)
          for k in ("k7", "slab_resolve", "surface", "combine")}
    numbers = dict(
        card=card, bake_s=bake_s, shard_s=shard_s,
        replicated_frame_ms=1e3 * rep_s,
        slab_frame_host_median_ms=statistics.median(per_rank["frame_ms"]),
        slab_frame_ms_by_rank=per_rank["frame_ms"],
        collective_share_by_rank=per_rank["collective_share"],
        primary_march_steps_by_rank=steps,
        k7_ms_by_rank=per_rank["k7_ms"],
        k7_old_design_ms_by_rank=per_rank["k7_old_ms"],
        k7_plain_ms_by_rank=per_rank["k7_plain_ms"],
        k7_live_lanes_by_rank=per_rank["live"],
        k7_simt_by_rank=per_rank["simt"],
        k7_simt_live_lanes_by_rank=per_rank["simt_live"],
        slab_resolve_ms_by_rank=per_rank["resolve_ms"],
        slab_resolve_old_design_ms_by_rank=per_rank["resolve_old_ms"],
        slab_resolve_packed_table_ms_by_rank=per_rank["resolve_packed_ms"],
        slab_resolve_plain_ms_by_rank=per_rank["resolve_plain_ms"],
        slab_frame_peak_gb_by_rank=per_rank["peak_gb"],
        slab_frame_old_design_peak_gb_by_rank=per_rank["old_peak_gb"],
        vs_replicated=dict(within_1e5=within, max=worst, beyond_025=beyond),
        fixture_160x90=dict(q90=q90, mean=mean, off_01=outl),
        sharded_frame_host_median_ms=1e3 * statistics.median(
            sharded[0]["frame_s"]),
        sharded_collective_share=sharded[0]["collective_s"]
        / sum(sharded[0]["frame_s"]))
    return dict(numbers=numbers, launches=c5, sharded_launches=sh_launches,
                geometry=geometry,
                k7=dict(ms=k7_new, per_rank_ms=per_rank["k7_ms"],
                        old_ms=k7_old, per_rank_old_ms=per_rank["k7_old_ms"],
                        plain_ms=sum(per_rank["k7_plain_ms"]),
                        per_rank_plain_ms=per_rank["k7_plain_ms"],
                        bound=k7_bound),
                resolve=dict(ms=sum(per_rank["resolve_ms"]),
                             old_ms=sum(per_rank["resolve_old_ms"]),
                             packed_ms=sum(per_rank["resolve_packed_ms"]),
                             plain_ms=sum(per_rank["resolve_plain_ms"]),
                             bound=rs_bound))


# ---- phase 12: config5's slab fit, the crossed and DP steps, scaling ---------

SLAB_FIT_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                "slab_fit_r5_slab4_12x12.npz")
SLABFIT_RAYS = 4096       # vrt/apps/scaling.py's traffic: rays from
SLABFIT_TARGET = 0.4      # default_rng(0), targets of 0.4, Adam at 1e-2
SLABFIT_LR = 1e-2
SLABFIT_STEPS = 3
CROSSED_RESOLUTION = 7    # 129^3: the crossed step against the 1x2 step
DP_RANKS = 2              # data ranks of config6's DP step
SCALING_TIMEOUT = 600
# the kernel of the first design's table pack (torch.stack of 8 strided
# slices) as the profiler names it; the step's other cats and stacks run it
# too, on a few MB, so a step whose such kernels take this long in all
# (ms of device time) packs a table (config5's pack takes ~25 ms of a
# profile with 4 ranks sharing the card); its backward runs as strided
# copies of the generic elementwise kernel, which no name tells apart
PACK_KERNEL, PACK_KERNEL_MS = "CatArrayBatchedCopy", 1.0
# a rank's peak memory in a slab fit step on the planes lies this far below
# the first design's at least (the 1.1 GB table and its 1.1 GB gradient)
SLABFIT_PEAK_GAIN_GB = 1.5


class _PlainSlabResolve:
    """Stands in for ``kernels.resolve.ResolveSlab``: the slab's resolve in
    plain PyTorch under autograd (``brick.resolve_slab_hits``), on the
    card."""

    @staticmethod
    def apply(o_w, d_w, table, scene, slab, hit, inst):
        from vrt_torch.dist import brick
        from vrt_torch.render.renderer import _world_to_object

        o, d = _world_to_object(scene.inst_pos[0], scene.inst_rot[0],
                                scene.inst_scale[0], o_w, d_w)
        return brick.resolve_slab_hits(slab, o, d, hit)


@contextlib.contextmanager
def _plain_slab_resolve():
    from vrt_torch.kernels import resolve as kr

    fn = kr.ResolveSlab
    kr.ResolveSlab = _PlainSlabResolve
    try:
        yield
    finally:
        kr.ResolveSlab = fn


class _RecordingOptimizer:
    """An optimizer of ``vrt_torch.diff.optim`` that keeps the gradient a
    step hands it (after the step's own all-reduces)."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params=None):
        self.grads = grads
        return self.inner.update(grads, state, params)

    def apply(self, params, grads, state):
        self.grads = grads
        return self.inner.apply(params, grads, state)


def _grad_gates(got, want):
    """(1 - cosine, largest difference / largest |want|) of two gradients
    (tensors or dicts of them), summed in float64 on the host."""
    import numpy as np

    if isinstance(want, dict):
        got = [got[k] for k in want]
        want = list(want.values())
    else:
        got, want = [got], [want]
    a = np.concatenate([np.asarray(w.detach().double().cpu()
                                   if hasattr(w, "detach") else w,
                                   np.float64).ravel() for w in want])
    b = np.concatenate([np.asarray(g.detach().double().cpu()
                                   if hasattr(g, "detach") else g,
                                   np.float64).ravel() for g in got])
    scale = np.abs(a).max()
    if scale == 0.0 and not b.any():
        return 0.0, 0.0
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(1.0 - cos), float(np.abs(a - b).max() / scale)


def _busy_ms(fn, top=6):
    """Device busy time in ms of one ``fn()`` from torch.profiler (the sum
    of its kernels' device time; ranks that share the card stretch each
    other's kernels), its ``top`` kernels as (ms, count, name) and all of
    them as (ms, count, full name), or (None, [], []) where the profiler
    saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    return (busy or None), [(ms, n, key[:70]) for ms, n, key in rows[:top]], \
        rows


def _slab_resolve_bwd_bound(hit, slab, rays_grad):
    """The slab backward's bound from what these hits need, as
    ``_resolve_bwd_bound`` counts it, for the work the op does (the
    planes' gradient): per ray the kind (4 B) and, with ``rays_grad``, the
    ray gradients written (24 B); the ray, its instance and g_t (32 B) on
    surface and solid-entry hits; t, the cell and g_normal (28 B) on
    surface hits; each distinct voxel of the planes (4 B) that the hit
    cell and its six neighbours read, once; the f32 gradient of the planes
    [span, N, N] written once."""
    from vrt_torch.march.resolve import _OFFS7

    rays = hit.kind.numel()
    n_surf = int((hit.kind == 1).sum())
    n_solid = int((hit.kind == 2).sum())
    nbytes = (rays * (4 + 24 * int(rays_grad)) + (n_surf + n_solid) * 32
              + n_surf * 28 + 4 * _slab_voxels(hit, slab, _OFFS7)
              + slab.sdf.numel() * 4)
    return _bound(nbytes, n_surf * RESOLVE_BWD_FLOPS)


def _r5_volume():
    """tests/test_brick.py's volume (a sphere plus a box, 33^3), the 12x12
    slab fit's of ``SLAB_FIT_FIXTURE``."""
    import numpy as np

    from vrt_torch.volume import sdf as S
    from vrt_torch.volume.volume import VoxelVolume

    csg = S.CSG(shape=S.Sphere(radius=55.0))
    csg.add_child(S.Box(extends=(70.0, 25.0, 25.0),
                        position=np.array([0.0, 0.0, 40.0], np.float32)),
                  S.ADD)
    return VoxelVolume.from_generator(csg, 5, 100.0)


def _slabfit_rank(rank, world, td, geometry, geometry7):
    """One rank of phase 12's slab fit world (4 ranks on this card, gloo):
    config5's 513^3 slab fit step (``scaling.py``'s traffic) on the first
    design (the packed table) and on the planes, old, new, new, old, each
    after a warm-up, timed from a barrier with its launches, collectives,
    peak memory and a profile; the slab resolve's backward launch of one
    step against autograd of ``resolve_slab_hits``, the closed form and
    the first design, both designs timed while the other ranks wait, with
    the first design's pack and pack backward; the step's plane gradients
    against the same step on the plain slab resolve; the 12x12 step of
    ``SLAB_FIT_FIXTURE``; and over a 2x2 mesh the crossed step at 129^3
    against the 1x2 step on the same rays."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from vrt_torch.apps.scaling import scaling_rays
    from vrt_torch.core import quat as vq
    from vrt_torch.diff.fit import _value_and_grad
    from vrt_torch.diff.optim import adam, sgd
    from vrt_torch.dist import brick, mesh, slab_render
    from vrt_torch.dist.slab_render import (default_fit_scene,
                                            make_slab_fit_step,
                                            make_slab_fit_step_crossed)
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import optim as ko
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.types import MarchHit
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import _world_to_object

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for build in (k1.build, kr.build, k4.build, ko.build):
        build()                               # built by the parent: loads
    m = mesh.make_render_mesh(1, world, "cuda")
    group = mesh.axis_group(m, mesh.MODEL_AXIS)[0]

    def load(name):
        with np.load(os.path.join(td, name)) as f:
            return brick.SlabVolume(**{k: torch.from_numpy(f[k]).to(dev)
                                       for k in brick._FIELDS})

    slab = load(f"slab{rank}.npz")
    n, h, ext, light = geometry
    scene = default_fit_scene(n, h, ext, light, device=dev)
    o_np, d_np = scaling_rays(SLABFIT_RAYS)
    o, d = (torch.from_numpy(x).to(dev) for x in (o_np, d_np))
    local = SLABFIT_RAYS // world
    mine = slice(rank * local, (rank + 1) * local)
    om, dm = o[mine].contiguous(), d[mine].contiguous()
    targets = torch.full((local, 3), SLABFIT_TARGET, device=dev)
    opt = adam(SLABFIT_LR)
    step = make_slab_fit_step(m, opt, scene)
    params0 = slab.sdf.clone()

    def stepper(table):
        """One step on ``table`` at a time, from the planes ``params0``."""
        sl = dataclasses.replace(slab, table=table)
        box = dict(params=params0.clone(), state=opt.init(params0))

        def one():
            box["params"], box["state"], loss = step(
                box["params"], box["state"], sl, om, dm, targets)
            return loss

        return one, box

    def side(table):
        """The step on ``table``: a warm-up, SLABFIT_STEPS timed steps
        (peak memory from a reset after the warm-up, the table packs among
        them counted) and a profiled one."""
        one, box = stepper(table)
        losses = [float(one())]               # warm-up
        torch.cuda.synchronize()
        _rank_zero_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        with _counting(brick, "_pack_slab_corners") as packs:
            for _ in range(SLABFIT_STEPS):
                dist.barrier()
                t0 = time.perf_counter()
                loss = one()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
                losses.append(float(loss))
        res = dict(table=table, step_s=runs, losses=losses,
                   counts=_rank_counts(), collective_s=mesh.STATS["seconds"],
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   moved=float((box["params"] != params0).float().mean()),
                   packs=packs[0])
        res["busy_ms"], res["busy_top"], rows = _busy_ms(one)
        res["cat_ms"] = sum(ms for ms, _, key in rows if PACK_KERNEL in key)
        return res

    out = dict(cell_lo=int(slab.cell_lo), cell_hi=int(slab.cell_hi),
               sides=[side(t) for t in ("packed", "planes", "planes",
                                        "packed")])
    torch.cuda.empty_cache()
    one, _ = stepper("planes")

    # the slab resolve's forward and backward launches of one step
    with _recording(kr, "resolve_slab_cuda") as fwds, \
            _recording(kr, "resolve_slab_backward_cuda") as bwds:
        one()
    torch.cuda.synchronize()
    if (len(fwds), len(bwds)) != (1, 1):
        raise AssertionError(f"slab fit rank {rank}: {len(fwds)} slab "
                             f"resolves and {len(bwds)} backwards a step")

    def check():
        (fargs, _, _), (bargs, bkw, (_, _, got)) = fwds[0], bwds[0]
        sc, sl, o_w, d_w, hit, inst = fargs
        g_t, g_n = bargs[6], bargs[7]
        lanes = (g_t != 0) | (g_n != 0).any(dim=-1)
        # the first design: the packed table of the same planes (pargs with
        # the ray gradients, as_step as the step asks)
        pk = dataclasses.replace(sl, sdf=sl.sdf.detach(), table="packed")
        pargs = (bargs[0], pk) + tuple(bargs[2:8])
        as_step = (bargs[0], pk) + tuple(bargs[2:])
        # autograd of resolve_slab_hits on the lanes with a cotangent
        planes2 = sl.sdf.detach().clone().requires_grad_(True)
        sub = MarchHit(**{f.name: (None if getattr(hit, f.name) is None
                                   else getattr(hit, f.name)[lanes])
                          for f in dataclasses.fields(MarchHit)})
        ob, db = _world_to_object(sc.inst_pos[0], sc.inst_rot[0],
                                  sc.inst_scale[0], o_w[lanes], d_w[lanes])
        t, nrm, _ = brick.resolve_slab_hits(
            dataclasses.replace(sl, sdf=planes2), ob, db, sub)
        ((t * g_t[lanes]).sum() + (nrm * g_n[lanes]).sum()).backward()
        # the closed form into the planes, summed in float64
        w_o, w_d, want64 = brick.resolve_slab_backward_reference(
            sc, sl, o_w, d_w, hit, g_t, g_n, acc_dtype=torch.float64)
        res = {}
        for name, want in (("autograd", planes2.grad),
                           ("closed_form_f64", want64)):
            scale = want.abs().max().item()
            res[f"table_err_{name}"] = (
                (got.double() - want.double()).abs().max().item() / scale
                if scale else float("nan"))
        del want64
        # the ray gradients (the step asks for none: rays need no
        # gradient), against the packed table's two designs
        g_o, g_d, _ = kr.resolve_slab_backward_cuda(
            sc, sl, o_w, d_w, hit, inst, g_t, g_n, table_grad=False)
        o_old, d_old, acc_old = kr.resolve_slab_backward_cuda(*pargs)
        o_first, d_first, _ = kr.resolve_slab_backward_cuda(
            *pargs, _old_design=True)
        res["ray_err"] = max(
            (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            for a, b in ((g_o, w_o), (g_d, w_d)))
        res["ray_bit_equal_old"] = all(
            torch.equal(a, b) for a, b in ((g_o, o_old), (g_d, d_old),
                                           (g_o, o_first), (g_d, d_first)))
        # the first design's table gradient through the pack's backward
        planes = pk.sdf.clone().requires_grad_(True)
        corners = brick._pack_slab_corners(planes)
        cot = acc_old.reshape(corners.shape)
        torch.autograd.backward(corners, cot, retain_graph=True)
        res["table_diff_old"] = ((planes.grad - got).abs().max().item()
                                 / max(got.abs().max().item(), 1e-30))
        res["owned_lanes"] = int(lanes.sum())
        res["old_ms"], res["ms"] = _paired_ms(
            lambda: kr.resolve_slab_backward_cuda(*as_step, **bkw),
            lambda: kr.resolve_slab_backward_cuda(*bargs, **bkw), 10)
        res["pack_ms"] = device_ms(
            lambda: brick._pack_slab_corners(pk.sdf), 10)
        res["pack_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
            corners, planes, cot, retain_graph=True), 10)
        del corners, cot, acc_old, planes, pk, pargs, as_step
        res["plain_ms"] = device_ms(
            lambda: brick.resolve_slab_backward_reference(
                sc, sl, o_w, d_w, hit, g_t, g_n), 3)
        res["bound"] = _slab_resolve_bwd_bound(hit, sl, bargs[8])
        res["shape"] = list(got.shape)
        return res

    out["bwd"] = _one_at_a_time(check)
    del fwds, bwds
    torch.cuda.empty_cache()

    # the step's Adam launch on this rank's planes against its plain
    # version, timed while the other ranks wait
    with _recording(ko, "adam_step_cuda") as adam_calls:
        one()
    torch.cuda.synchronize()
    if len(adam_calls) != 1:
        raise AssertionError(f"slab fit rank {rank}: {len(adam_calls)} Adam "
                             f"launches a step")
    out["adam"] = _one_at_a_time(
        lambda: _adam_held(adam_calls, f"slab fit rank {rank}, the planes"))
    del adam_calls
    torch.cuda.empty_cache()

    # the step's plane gradients against the same step on the plain
    # slab resolve (autograd of resolve_slab_hits on the card)
    pixels = float(targets.numel() * world)
    loss_fn = slab_render._slab_loss_fn(scene, RenderMode(), slab, om, dm,
                                        targets, group, group, group,
                                        pixels)
    lk, gk = _value_and_grad(lambda p: loss_fn(p["sdf"]), {"sdf": params0})
    with _plain_slab_resolve():
        lp, gp = _value_and_grad(lambda p: loss_fn(p["sdf"]),
                                 {"sdf": params0})
    out["vs_plain"] = dict(loss=float(lk), plain_loss=float(lp),
                           gates=_grad_gates(gk["sdf"], gp["sdf"]))
    del gk, gp
    torch.cuda.empty_cache()

    # the 12x12 step of SLAB_FIT_FIXTURE (vrt's, SGD at 1e-2)
    vol12 = _r5_volume()
    sl12 = brick.shard_volume(vol12, world).local(rank, dev)
    light12 = np.asarray(vq.forward_vector(vq.from_euler_degrees(
        0.0, 45.0, -30.0)), np.float32)
    scene12 = default_fit_scene(vol12.n_voxels, vol12.cell_size,
                                vol12.extends, light12, device=dev)
    o12, d12 = camera_rays(
        torch.tensor([300.0, 0.0, 0.0], device=dev),
        torch.tensor(np.asarray(vq.from_euler_degrees(0.0, 180.0, 0.0)),
                     dtype=torch.float32, device=dev),
        torch.tensor(60.0, device=dev), 12, 12)
    rows12 = 144 // world
    mine12 = slice(rank * rows12, (rank + 1) * rows12)
    rec = _RecordingOptimizer(sgd(1e-2))
    p12, _, l12 = make_slab_fit_step(m, rec, scene12)(
        sl12.sdf.clone(), rec.init(sl12.sdf), sl12,
        o12[mine12].contiguous(), d12[mine12].contiguous(),
        torch.zeros((rows12, 3), device=dev))
    out["fixture"] = dict(params=p12.cpu().numpy(),
                          grad=rec.grads.cpu().numpy(), loss=float(l12),
                          params0=sl12.sdf.cpu().numpy())

    # the crossed step over a 2x2 mesh at 129^3 against the 1x2 step (each
    # data row runs it on every ray) on the same rays, SGD at 1e-2
    m2 = mesh.make_render_mesh(2, world // 2, "cuda")
    _, model, s2 = mesh.axis_group(m2, mesh.MODEL_AXIS)
    _, flat, total = mesh.axis_group(m2, (mesh.DATA_AXIS, mesh.MODEL_AXIS))
    sl7 = load(f"c7_slab{model}.npz")
    n7, h7, ext7 = geometry7
    scene7 = default_fit_scene(n7, h7, ext7, light, device=dev)
    res7 = {}
    for name, parts, index, make in (
            ("crossed", total, flat, make_slab_fit_step_crossed),
            ("single", s2, model, make_slab_fit_step)):
        rows = SLABFIT_RAYS // parts
        sel = slice(index * rows, (index + 1) * rows)
        rec = _RecordingOptimizer(sgd(1e-2))
        _, _, loss7 = make(m2, rec, scene7)(
            sl7.sdf.clone(), rec.init(sl7.sdf), sl7, o[sel].contiguous(),
            d[sel].contiguous(),
            torch.full((rows, 3), SLABFIT_TARGET, device=dev))
        res7[name] = (float(loss7), rec.grads)
    out["crossed"] = dict(loss=res7["crossed"][0], single_loss=res7["single"][0],
                          gates=_grad_gates(res7["crossed"][1],
                                            res7["single"][1]),
                          model=model)
    # the crossed step with Adam: one Adam launch a rank on the model
    # rank's planes, held against its plain version
    rows = SLABFIT_RAYS // total
    sel = slice(flat * rows, (flat + 1) * rows)
    opt7 = adam(SLABFIT_LR)
    before = ko.LAUNCHES["apply"]
    with _recording(ko, "adam_step_cuda") as adam7:
        make_slab_fit_step_crossed(m2, opt7, scene7)(
            sl7.sdf.clone(), opt7.init(sl7.sdf), sl7, o[sel].contiguous(),
            d[sel].contiguous(),
            torch.full((rows, 3), SLABFIT_TARGET, device=dev))
    torch.cuda.synchronize()
    out["crossed"]["adam_launches"] = ko.LAUNCHES["apply"] - before
    out["crossed"]["adam"] = _one_at_a_time(
        lambda: _adam_held(adam7, f"crossed step rank {rank}", reps=3))
    return out


def _dp_rank(rank, world):
    """One data rank of phase 12's DP step: config6 (the flagship at
    resolution 6 with colours, one camera, zero targets) at 1920x1080 split
    over ``world`` data ranks.  ``make_fit_step_dp`` with Adam at 1e-2:
    a warm-up, then timed steps from a barrier (launches, collectives, peak
    memory, a profile's busy time); then one step with SGD at 1e-2 from the
    start, whose loss, gradient and parameters the parent holds against
    ``make_fit_step`` on one rank."""
    import torch
    import torch.distributed as dist

    from vrt_torch.diff.fit import _f32
    from vrt_torch.diff.optim import adam, sgd
    from vrt_torch.dist import mesh
    from vrt_torch.dist.sharding import make_fit_step_dp
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import optim as ko
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import shade as k4
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for build in (k1.build, kr.build, k4.build, ko.build):
        build()
    scene = flagship_scene(6, use_colors=True, device=dev)
    params0 = {"sdf": scene.volumes.sdf, "voxel_colors": scene.voxel_colors}
    cam = FIT_CAMS[0]
    o, d = camera_rays(_f32(cam["position"], dev), _f32(cam["rotation"], dev),
                       _f32(cam.get("fov", 60.0), dev), FRAME_W, FRAME_H)
    targets = torch.zeros((o.shape[0], 3), device=dev)
    m = mesh.make_render_mesh(world, 1, "cuda")
    opt = adam(1e-2)
    step = make_fit_step_dp(RenderMode(), m, opt)
    box = dict(params=dict(params0), state=opt.init(params0))

    def one():
        box["params"], box["state"], loss = step(
            box["params"], box["state"], scene, o, d, targets)
        return loss

    losses = [float(one())]
    torch.cuda.synchronize()
    _rank_zero_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        loss = one()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    out = dict(step_s=runs, losses=losses, counts=_rank_counts(),
               collective_s=mesh.STATS["seconds"],
               peak_bytes=torch.cuda.max_memory_allocated())
    out["busy_ms"], out["busy_top"], _ = _busy_ms(one)
    rec = _RecordingOptimizer(sgd(1e-2))
    p1, _, loss1 = make_fit_step_dp(RenderMode(), m, rec)(
        dict(params0), rec.init(params0), scene, o, d, targets)
    out.update(sgd_loss=float(loss1),
               sgd_grads={k: v.cpu().numpy() for k, v in rec.grads.items()},
               sgd_params={k: v.cpu().numpy() for k, v in p1.items()})
    return out


def _slabfit(dev, card, sync, td, geometry):
    """Phase 12: config5's training step (``make_slab_fit_step`` on its
    513^3 slabs, which phase 11 wrote to ``td``) over 4 model ranks on this
    card, the 12x12 step against ``vrt``'s (``SLAB_FIT_FIXTURE``), the
    crossed step over 2x2 at 129^3 against the 1x2 step, config6's DP step
    over 2 data ranks against ``make_fit_step`` on one, and
    ``vrt_torch.apps.scaling`` in a process of its own.  Returns
    dict(numbers, launches, dp_launches, bwd)."""
    import numpy as np
    import torch

    from vrt_torch.diff.fit import make_fit_step
    from vrt_torch.diff.optim import sgd
    from vrt_torch.dist import brick, mesh
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import config5_slab_volume, flagship_scene

    # the crossed step's 129^3 volume, in 2 slabs
    vol7 = config5_slab_volume(CROSSED_RESOLUTION)
    slabs7 = brick.shard_volume(vol7, 2)
    for s in range(2):
        local = slabs7.local(s, "cpu")
        np.savez(os.path.join(td, f"c7_slab{s}.npz"),
                 **{f: getattr(local, f).numpy() for f in brick._FIELDS})
    geometry7 = (vol7.n_voxels, vol7.cell_size, vol7.extends)
    del vol7, slabs7

    t0 = time.perf_counter()
    ranks = mesh.spawn_world(_slabfit_rank, CONFIG5_RANKS,
                             args=(td, geometry, geometry7), backend="gloo",
                             timeout=RANK_TIMEOUT)
    world_s = time.perf_counter() - t0
    print(f"phase 12, slab fit: {CONFIG5_RANKS} ranks on {card} over gloo "
          f"({world_s:.1f}s for the world); config5 {geometry[0]}^3, "
          f"{SLABFIT_RAYS} rays from default_rng(0), targets "
          f"{SLABFIT_TARGET}, Adam at {SLABFIT_LR}", flush=True)
    steps = SLABFIT_STEPS
    want_c = dict(k7=2 * steps, k1=0, scene=0, resolve=steps,
                  slab_resolve=steps, resolve_bwd=steps,
                  slab_resolve_bwd=steps, surface=steps, combine=steps,
                  surface_bwd=steps, combine_bwd=steps, gather=0, scatter=0,
                  adam=steps, adam_update=0)
    per_rank = {"step_ms": [], "old_step_ms": [], "collective_share": [],
                "peak_gb": [], "old_peak_gb": [], "busy_ms": [],
                "old_busy_ms": [], "bwd_ms": [], "bwd_old_ms": [],
                "pack_ms": [], "pack_bwd_ms": [], "bwd_plain_ms": []}
    bwd_bounds, bwd_err, ray_err = [], 0.0, 0.0
    adam_held = []              # each rank's Adam launch on its planes
    slab_launches = {}          # the first step on the planes, every rank
    for r, x in enumerate(ranks):
        by = {"planes": [], "packed": []}
        for sd in x["sides"]:
            seen = {k: sd["counts"][k] for k in want_c}
            by[sd["table"]].append(sd)
            step_ms = [1e3 * t for t in sd["step_s"]]
            share = sd["collective_s"] / sum(sd["step_s"])
            print(f"slab fit rank {r} (cells [{x['cell_lo']}, "
                  f"{x['cell_hi']})) on the {sd['table']} table: steps "
                  f"{_list(step_ms)} ms (host, from a barrier), collectives "
                  f"{sd['collective_s']:.4f}s = {share:.1%}; peak "
                  f"max_memory_allocated {sd['peak_bytes'] / 1e9:.3f} GB; "
                  f"busy {sd['busy_ms']} ms a step; table packs "
                  f"{sd['packs']} over {steps} steps, {PACK_KERNEL} "
                  f"{sd['cat_ms']:.3f} ms of the profiled step; losses "
                  f"{', '.join(f'{v:.6f}' for v in sd['losses'])} (warm-up "
                  f"first); {sd['moved']:.4%} of the planes moved; launches "
                  f"over {steps} steps {seen}; collectives "
                  f"{sd['counts']['collectives']}", flush=True)
            for ms, count, key in sd["busy_top"]:
                print(f"  slab fit rank {r} profile ({sd['table']}): "
                      f"{ms:8.3f} ms {count:4d}x {key}", flush=True)
            if seen != want_c:
                raise AssertionError(f"slab fit rank {r} ({sd['table']}): "
                                     f"launches {seen}, expected {want_c}")
            if not (np.isfinite(sd["losses"]).all() and sd["moved"] > 0):
                raise AssertionError(f"slab fit rank {r}: losses "
                                     f"{sd['losses']}, moved {sd['moved']}")
        new, old = by["planes"], by["packed"]
        if any(sd["packs"] or sd["cat_ms"] >= PACK_KERNEL_MS for sd in new) \
                or any(sd["packs"] != steps for sd in old):
            raise AssertionError(
                f"slab fit rank {r}: table packs on the planes "
                f"{[(sd['packs'], sd['cat_ms']) for sd in new]} (packs, "
                f"{PACK_KERNEL} ms), on the packed table "
                f"{[(sd['packs'], sd['cat_ms']) for sd in old]}")
        peak = max(sd["peak_bytes"] for sd in new) / 1e9
        old_peak = min(sd["peak_bytes"] for sd in old) / 1e9
        print(f"slab fit rank {r}: peak {peak:.3f} GB on the planes, "
              f"{old_peak:.3f} GB on the packed table ({old_peak - peak:.3f}"
              f" GB less, >= {SLABFIT_PEAK_GAIN_GB})", flush=True)
        if not old_peak - peak >= SLABFIT_PEAK_GAIN_GB:
            raise AssertionError(f"slab fit rank {r}: peak {peak:.3f} GB on "
                                 f"the planes against {old_peak:.3f} GB")
        for k, v in {k: new[0]["counts"][k] for k in want_c}.items():
            slab_launches[k] = slab_launches.get(k, 0) + v
        b = x["bwd"]
        print(f"slab fit rank {r}: slab resolve backward on "
              f"{b['owned_lanes']} owned lanes into the planes' f32 gradient "
              f"{b['shape']}: vs autograd of resolve_slab_hits "
              f"{b['table_err_autograd']:.2e}, vs the closed form in "
              f"float64 {b['table_err_closed_form_f64']:.2e} of max|g| "
              f"(< {SCATTER_RTOL}); ray gradients {b['ray_err']:.2e} "
              f"(< {RAY_GRAD_RTOL}), bit-equal to the packed table's two "
              f"designs {b['ray_bit_equal_old']}, the packed table's "
              f"gradient through the pack {b['table_diff_old']:.2e}; "
              f"{_list(b['ms'])} ms (the packed table "
              f"{_list(b['old_ms'])}, old, new, new, old; its pack "
              f"{b['pack_ms']:.4f} and pack backward {b['pack_bwd_ms']:.4f};"
              f" closed form {b['plain_ms']:.4f}, bound "
              f"{b['bound']['bound_ms']:.4f} by {b['bound']['bound_by']})",
              flush=True)
        if not (b["table_err_autograd"] <= SCATTER_RTOL
                and b["table_err_closed_form_f64"] <= SCATTER_RTOL
                and b["ray_err"] <= RAY_GRAD_RTOL
                and b["ray_bit_equal_old"]
                and b["table_diff_old"] <= SCATTER_RTOL):
            raise AssertionError(f"slab fit rank {r}: the slab resolve's "
                                 f"backward disagrees: {b}")
        vp = x["vs_plain"]
        print(f"slab fit rank {r}: step gradient vs the step on the plain "
              f"slab resolve: 1 - cos {vp['gates'][0]:.2e} (< "
              f"{FIT_COS_TOL}), max diff / max|g| {vp['gates'][1]:.2e} (< "
              f"{FIT_DIFF_TOL}); loss {vp['loss']:.7f} vs "
              f"{vp['plain_loss']:.7f}", flush=True)
        if not (vp["gates"][0] < FIT_COS_TOL and vp["gates"][1] < FIT_DIFF_TOL
                and abs(vp["loss"] - vp["plain_loss"])
                <= FIT_LOSS_RTOL * abs(vp["plain_loss"])):
            raise AssertionError(f"slab fit rank {r}: the step disagrees "
                                 f"with the plain slab resolve's: {vp}")
        per_rank["step_ms"].append(statistics.median(
            1e3 * t for sd in new for t in sd["step_s"]))
        per_rank["old_step_ms"].append(statistics.median(
            1e3 * t for sd in old for t in sd["step_s"]))
        per_rank["collective_share"].append(
            sum(sd["collective_s"] for sd in new)
            / sum(sum(sd["step_s"]) for sd in new))
        per_rank["peak_gb"].append(peak)
        per_rank["old_peak_gb"].append(old_peak)
        per_rank["busy_ms"].append([sd["busy_ms"] for sd in new])
        per_rank["old_busy_ms"].append([sd["busy_ms"] for sd in old])
        per_rank["bwd_ms"].append(statistics.mean(b["ms"]))
        per_rank["bwd_old_ms"].append(statistics.mean(b["old_ms"]))
        per_rank["pack_ms"].append(b["pack_ms"])
        per_rank["pack_bwd_ms"].append(b["pack_bwd_ms"])
        per_rank["bwd_plain_ms"].append(b["plain_ms"])
        bwd_bounds.append(b["bound"])
        bwd_err = max(bwd_err, b["table_err_autograd"],
                      b["table_err_closed_form_f64"])
        ray_err = max(ray_err, b["ray_err"])
        adam_held.append(x["adam"])

    # the 12x12 step against vrt's (the fixture)
    with np.load(SLAB_FIT_FIXTURE) as f:
        fix = {k: f[k] for k in f.files}
    got_grad = np.stack([x["fixture"]["grad"] for x in ranks])
    got_params = np.stack([x["fixture"]["params"] for x in ranks])
    params0 = np.stack([x["fixture"]["params0"] for x in ranks])
    cos12, diff12 = _grad_gates(got_grad, fix["grad"])
    loss12 = ranks[0]["fixture"]["loss"]
    same12 = float((got_params == fix["params"]).mean())
    moved12 = float((fix["params"] != params0).mean())
    print(f"slab fit 12x12 on {CONFIG5_RANKS} ranks vs vrt "
          f"({os.path.basename(SLAB_FIT_FIXTURE)}): loss {loss12:.7f} vs "
          f"{float(fix['loss']):.7f}; gradient 1 - cos {cos12:.2e} (< "
          f"{FIT_COS_TOL}), max diff / max|g| {diff12:.2e} (< "
          f"{FIT_DIFF_TOL}); updated planes equal on {same12:.4%} of values "
          f"({moved12:.4%} of vrt's moved)", flush=True)
    if not (cos12 < FIT_COS_TOL and diff12 < FIT_DIFF_TOL
            and abs(loss12 - float(fix["loss"]))
            <= FIT_LOSS_RTOL * abs(float(fix["loss"]))):
        raise AssertionError("the 12x12 slab fit step disagrees with vrt's")

    # the crossed step against the 1x2 step
    cr = [x["crossed"] for x in ranks]
    cr_cos = max(c["gates"][0] for c in cr)
    cr_diff = max(c["gates"][1] for c in cr)
    print(f"crossed 2x2 step at {geometry7[0]}^3 vs the 1x2 step on the "
          f"same rays: loss {cr[0]['loss']:.7f} vs {cr[0]['single_loss']:.7f};"
          f" gradient 1 - cos {cr_cos:.2e} (< {FIT_COS_TOL}), max diff / "
          f"max|g| {cr_diff:.2e} (< {FIT_DIFF_TOL})", flush=True)
    if not (cr_cos < FIT_COS_TOL and cr_diff < FIT_DIFF_TOL
            and all(abs(c["loss"] - c["single_loss"])
                    <= FIT_LOSS_RTOL * abs(c["single_loss"]) for c in cr)):
        raise AssertionError("the crossed step disagrees with the 1x2 step")
    print(f"crossed 2x2 step with Adam: Adam launches by rank "
          f"{[c['adam_launches'] for c in cr]}, each bit-equal to its plain "
          f"version, {_list([c['adam']['ms'] for c in cr])} ms", flush=True)
    if any(c["adam_launches"] != 1 or c["adam"]["launches"] != 1
           for c in cr):
        raise AssertionError("the crossed step did not launch the Adam "
                             "kernel once a rank")
    adam_numbers = dict(
        ms=sum(a["ms"] for a in adam_held),
        per_rank_ms=[a["ms"] for a in adam_held],
        plain_ms=sum(a["plain_ms"] for a in adam_held),
        library_ms=sum(a["library_ms"] for a in adam_held),
        bound=_sum_bounds([a["bound"] for a in adam_held]),
        max_abs_err=max(a["max_abs_err"] for a in adam_held + [
            c["adam"] for c in cr]),
        shape=adam_held[0]["shape"],
        crossed_ms=[c["adam"]["ms"] for c in cr],
        crossed_launches=sum(c["adam_launches"] for c in cr))
    del ranks

    # config6's DP step: make_fit_step on one rank (SGD at 1e-2) first
    scene = flagship_scene(6, use_colors=True, device=dev)
    params0 = {"sdf": scene.volumes.sdf, "voxel_colors": scene.voxel_colors}
    rec = _RecordingOptimizer(sgd(1e-2))
    one = make_fit_step(scene, FIT_CAMS, FRAME_W, FRAME_H, RenderMode(), rec)
    p1, _, loss1 = one(dict(params0), rec.init(params0),
                       torch.zeros((1, FRAME_W * FRAME_H, 3), device=dev))
    single = dict(loss=float(loss1),
                  grads={k: v.cpu().numpy() for k, v in rec.grads.items()},
                  params={k: v.cpu().numpy() for k, v in p1.items()})
    traces, levels = _traces(scene), _resolves(scene)
    del scene, params0, rec, one, p1, loss1
    torch.cuda.empty_cache()
    sync()
    dp = mesh.spawn_world(_dp_rank, DP_RANKS, backend="gloo",
                          timeout=RANK_TIMEOUT)
    want_dp = dict(k7=0, k1=0, scene=3 * traces, resolve=3 * levels,
                   slab_resolve=0, resolve_bwd=3 * levels, slab_resolve_bwd=0,
                   surface=3 * levels, combine=3 * levels,
                   surface_bwd=3 * levels, combine_bwd=3 * levels, gather=0,
                   scatter=0, adam=3, adam_update=0)
    dp_launches = {}
    for r, x in enumerate(dp):
        seen = {k: x["counts"][k] for k in want_dp}
        share = x["collective_s"] / sum(x["step_s"])
        print(f"DP step rank {r} of {DP_RANKS} (config6 1920x1080, Adam at "
              f"1e-2): steps {_list([1e3 * t for t in x['step_s']])} ms "
              f"(host, from a barrier), collectives {share:.1%}, busy "
              f"{x['busy_ms']} ms a step, peak {x['peak_bytes'] / 1e9:.2f} "
              f"GB; losses {', '.join(f'{v:.6f}' for v in x['losses'])}; "
              f"launches over 3 steps {seen}; collectives "
              f"{x['counts']['collectives']}", flush=True)
        if r == 0:
            for ms, count, key in x["busy_top"]:
                print(f"  DP rank 0 profile: {ms:8.3f} ms {count:4d}x {key}",
                      flush=True)
        if seen != want_dp:
            raise AssertionError(f"DP rank {r}: launches {seen}, expected "
                                 f"{want_dp}")
        for k, v in seen.items():
            dp_launches[k] = dp_launches.get(k, 0) + v
    for k in single["params"]:
        if not np.array_equal(dp[0]["sgd_params"][k], dp[1]["sgd_params"][k]):
            raise AssertionError(f"the DP replicas of {k} differ")
    dp_cos, dp_diff = _grad_gates(dp[0]["sgd_grads"], single["grads"])
    same_dp = {k: float((dp[0]["sgd_params"][k] == v).mean())
               for k, v in single["params"].items()}
    print(f"DP step (SGD at 1e-2) over {DP_RANKS} ranks vs make_fit_step on "
          f"one: loss {dp[0]['sgd_loss']:.7f} vs {single['loss']:.7f}; "
          f"gradient 1 - cos {dp_cos:.2e} (< {FIT_COS_TOL}), max diff / "
          f"max|g| {dp_diff:.2e} (< {FIT_DIFF_TOL}); updated parameters "
          f"equal on {same_dp}; the replicas equal bit for bit", flush=True)
    if not (dp_cos < FIT_COS_TOL and dp_diff < FIT_DIFF_TOL
            and abs(dp[0]["sgd_loss"] - single["loss"])
            <= FIT_LOSS_RTOL * abs(single["loss"])):
        raise AssertionError("the DP step disagrees with make_fit_step")

    # the scaling app in a process of its own
    out_path = os.path.join(td, "scaling.jsonl")
    scaling_s = _run_cli(["vrt_torch.apps.scaling", "--res", "9", "--rays",
                          str(SLABFIT_RAYS), "--steps", "3", "--shards", "1",
                          "2", "4", "--out", out_path],
                         "vrt_torch.apps.scaling", timeout=SCALING_TIMEOUT)
    with open(out_path) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    rows, summary = lines[:-1], lines[-1]
    for row in rows:
        print(f"scaling: {json.dumps(row)}", flush=True)
    print(f"scaling: {json.dumps(summary)} ({scaling_s:.1f}s; one card "
          f"shared by S ranks: the efficiencies are one card's)",
          flush=True)
    if [row["model_shards"] for row in rows] != [1, 2, 4] or not all(
            np.isfinite(row["loss"]) for row in rows):
        raise AssertionError(f"scaling rows {rows}")

    numbers = dict(
        card=card, slab_fit_step_host_median_ms_by_rank=per_rank["step_ms"],
        slab_fit_step_host_median_ms=statistics.median(per_rank["step_ms"]),
        slab_fit_old_design_step_host_median_ms_by_rank=per_rank[
            "old_step_ms"],
        slab_fit_collective_share_by_rank=per_rank["collective_share"],
        slab_fit_peak_gb_by_rank=per_rank["peak_gb"],
        slab_fit_old_design_peak_gb_by_rank=per_rank["old_peak_gb"],
        slab_fit_busy_ms_by_rank=per_rank["busy_ms"],
        slab_fit_old_design_busy_ms_by_rank=per_rank["old_busy_ms"],
        slab_pack_ms_by_rank=per_rank["pack_ms"],
        slab_pack_backward_ms_by_rank=per_rank["pack_bwd_ms"],
        slab_fit_world_s=world_s,
        fixture_12x12=dict(one_minus_cos=cos12, diff=diff12, loss=loss12,
                           vrt_loss=float(fix["loss"]),
                           params_equal=same12),
        crossed_vs_single=dict(one_minus_cos=cr_cos, diff=cr_diff),
        dp_step_host_median_ms_by_rank=[
            1e3 * statistics.median(x["step_s"]) for x in dp],
        dp_collective_share_by_rank=[
            x["collective_s"] / sum(x["step_s"]) for x in dp],
        dp_busy_ms_by_rank=[x["busy_ms"] for x in dp],
        dp_peak_gb_by_rank=[x["peak_bytes"] / 1e9 for x in dp],
        dp_vs_single=dict(one_minus_cos=dp_cos, diff=dp_diff,
                          loss=dp[0]["sgd_loss"],
                          single_loss=single["loss"],
                          params_equal=same_dp),
        scaling=dict(rows=rows, summary=summary, seconds=scaling_s))
    return dict(numbers=numbers, dp_launches=dp_launches,
                launches=slab_launches, adam=adam_numbers,
                bwd=dict(ms=sum(per_rank["bwd_ms"]),
                         per_rank_ms=per_rank["bwd_ms"],
                         old_ms=sum(per_rank["bwd_old_ms"]),
                         per_rank_old_ms=per_rank["bwd_old_ms"],
                         pack_ms=sum(per_rank["pack_ms"]),
                         pack_bwd_ms=sum(per_rank["pack_bwd_ms"]),
                         plain_ms=sum(per_rank["bwd_plain_ms"]),
                         max_abs_err=bwd_err, ray_err=ray_err,
                         bound=_sum_bounds(bwd_bounds)))


# ---- phase 13: the bench app, config7's 12 instances, config4's 257^3 fit ----

CONFIG7_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "config7_r6_64x64.npy")
CONFIG7_SIZE = 512
CONFIG4_SIZE, CONFIG4_VIEWS = 256, 2


def _bench_app(card):
    """``python -m vrt_torch.apps.bench`` over ``vrt``'s eight cells in a
    process of its own, its table written to a temporary directory: exit
    0, a title naming ``card``, eight rows with ``vrt``'s labels in
    ``vrt``'s order, every time and rate positive.  The table is printed.
    Returns dict(seconds, rows (label, ms, rays_per_s))."""
    import tempfile

    from vrt_torch.apps import bench

    labels = [bench.config3_label(257) if c == 3 else
              bench.config4_label(CONFIG4_VIEWS, CONFIG4_SIZE) if c == 4
              else bench.LABELS[c] for c in bench.ORDER]
    tag = "python -m vrt_torch.apps.bench"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "BENCH.md")
        seconds = _run_cli(["vrt_torch.apps.bench", "--configs",
                            *(str(c) for c in bench.ORDER), "--out", out],
                           tag, timeout=900, echo=True)
        with open(out) as f:
            lines = f.read().strip().splitlines()
    print(f"{tag} --configs {' '.join(str(c) for c in bench.ORDER)} on "
          f"{card}: {seconds:.1f}s; its table:", flush=True)
    for line in lines:
        print(f"  {line}", flush=True)
    rows = []
    for line in lines[4:]:
        label, ms, rps = (c.strip() for c in line.strip("|").split("|"))
        rows.append(dict(label=label, ms=float(ms),
                         rays_per_s=float(rps.replace(",", ""))))
    if lines[0] != f"# vrt_torch benchmarks on {card}" or \
            lines[2] != "| config | ms/frame | rays/s |" or \
            [r["label"] for r in rows] != labels or \
            not all(r["ms"] > 0 and r["rays_per_s"] > 0 for r in rows):
        raise AssertionError(f"the bench app's table is not vrt's eight "
                             f"rows: {lines}")
    return dict(seconds=seconds, rows=rows)


def _kernel_rows(held, tag):
    """Each held kernel's summed ms, plain ms and bound, printed."""
    rows = {}
    for name, got in held.items():
        for stage in (("surface", "combine") if name == "shade" else
                      ("surface_bwd", "combine_bwd") if name == "shade_bwd"
                      else (None,)):
            box = got[stage] if stage else got
            ms, plain = box["ms"], box["plain_ms"]
            ms = sum(ms) if isinstance(ms, list) else ms
            plain = sum(plain) if isinstance(plain, list) else plain
            rows[stage or name] = dict(ms=ms, plain_ms=plain,
                                       bound=box["bound"])
    print(f"{tag} kernels: " + "; ".join(
        f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.2f} ms), bound "
        f"{r['bound']['bound_ms']:.4f} ms ({r['bound']['bytes']} B, by "
        f"{r['bound']['bound_by']}) = {r['bound']['bound_ms'] / r['ms']:.0%} "
        f"of the kernel" for k, r in rows.items()), flush=True)
    return rows


def _config7(dev, card, sync, zero_counts, counts):
    """Phase 13, config7 (``vrt/apps/bench.py``'s
    ``bench_many_instances``): 12 instances of two resolution-6 volumes
    (``bench.config7_scene``) at 512x512.  Three frames after a warm-up,
    their launches asserted; every scene-march launch of one frame against
    ``march_scene_reference`` over the twin (the 0.1% gate) and beside its
    first design (old, new, new, old), with its SIMT efficiency and the
    lanes on the 255-step cap; every fused-resolve and shade launch against
    its plain version; the 64x64 frame against ``vrt``'s CPU render
    (``CONFIG7_FIXTURE``) at the f32 golden tolerances of
    tests/test_golden_full.py.  Returns dict(counts (of the three frames),
    held, numbers)."""
    import numpy as np
    import torch

    from vrt_torch.apps import bench
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image

    mode, size = RenderMode(), CONFIG7_SIZE
    scene = bench.config7_scene(6, device=dev)
    if scene.num_instances != 12:
        raise AssertionError(f"config7: {scene.num_instances} instances")

    def frame():
        return render_image(scene, size, size, mode)

    frame()
    sync()
    zero_counts()
    runs = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        img = frame()
        sync()
        runs.append(time.perf_counter() - t0)
    c7_counts = counts()
    levels, traces = _resolves(scene), _traces(scene)
    want = dict(k1=0, scene=3 * traces, resolve=3 * levels, resolve_bwd=0,
                gather=0, scatter=0, scatter_v4=0, scatter_scalar=0,
                surface=3 * levels, combine=3 * levels, surface_bwd=0,
                combine_bwd=0)
    if c7_counts != want:
        raise AssertionError(f"launches in 3 config7 frames {c7_counts}, "
                             f"expected {want}")
    if tuple(img.shape) != (size, size, 4) or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError("config7's frame is not finite")
    median = statistics.median(runs) * 1e3
    print(f"config7 {size}x{size} frame on {card}: median {median:.2f} ms "
          f"(runs {', '.join(f'{r * 1e3:.2f}' for r in runs)} ms), "
          f"{size * size / median * 1e3:.0f} rays/s; per frame scene march "
          f"{traces}, fused resolve {levels}, shade surface and combine "
          f"{levels} each", flush=True)

    held = {}
    tag = f"config7 {size}x{size} frame"

    def marches():
        held["scene"] = _scene_calls(frame, traces, tag, width=size)

    def resolves():
        held["fused"] = _resolve_calls(marches, levels, tag)
    held["shade"] = _shade_calls(resolves, levels, tag)
    _kernel_rows(held, f"config7 on {card}")

    want = np.load(CONFIG7_FIXTURE)
    got = render_image(scene, 64, 64, mode)[..., :3].cpu().numpy()
    diff = np.abs(got - want)
    q98 = float(np.quantile(diff, 0.98))
    mean = float(diff.mean())
    outl = float((diff.max(axis=-1) > 0.05).mean())
    print(f"config7 64x64 vs vrt fixture: q98 {q98:.2e} (< 6e-3), mean "
          f"{mean:.2e} (< 2.5e-3), pixels off > 0.05 {outl:.2e} (< 0.005)",
          flush=True)
    if not (np.isfinite(got).all() and q98 < 6e-3 and mean < 2.5e-3
            and outl < 0.005):
        raise AssertionError("config7's 64x64 frame disagrees with the vrt "
                             "fixture")
    numbers = dict(frame_ms=median, runs_ms=[r * 1e3 for r in runs],
                   launches_per_frame=traces + 3 * levels,
                   fixture_q98=q98, fixture_mean=mean,
                   fixture_outliers=outl,
                   capped=held["scene"]["capped"],
                   simt_flat=held["scene"]["simt_flat"],
                   simt_tiled=held["scene"]["simt_tiled"])
    return dict(counts=c7_counts, held=held, numbers=numbers)


def _config4(dev, card, sync, zero_counts, counts):
    """Phase 13, config4 (``vrt/apps/bench.py``'s ``bench_fit_257``): the
    257^3 sphere with per-voxel colours and a bf16 corner table
    (``bench.config4_scene``), 2 views of 256x256, zero targets, Adam at
    1e-2, through ``make_fit_step``.  Its colours lie above
    ``COLOR_CORNER_BUDGET_BYTES``: the f32 [1,257,257,257,3] grid with no
    packed view, as ``vrt`` leaves them.  Three steps after a warm-up,
    their launches (the corner pack and its backward once a step, the
    colour repack never) and peak ``max_memory_allocated``; every
    scene-march, fused-resolve (forward and backward), shade (forward and
    backward, on the unpacked grid) and corner-pack (forward and backward)
    launch of one step against its plain version; the step's gradients on
    the kernels against the same step on the plain stages (eager shading,
    resolve on the plain path) at phase 8's cosine (``FIT_COS_TOL``), the
    f32 colour grid's within ``FIT_DIFF_TOL`` and the SDF's within
    ``BF16_DIFF_TOL`` of the largest |g| (with the kernel step's spread
    against itself run again beside it); a profile of one step (busy time),
    and the device time of ``rebuild_accel`` and ``build_accel`` at 257^3
    each alone.  Returns dict(counts (of the three steps), held,
    numbers)."""
    import torch

    from vrt_torch.apps import bench
    from vrt_torch.diff import fit as fitmod
    from vrt_torch.diff.fit import (_value_and_grad, graft_and_rebuild,
                                    graft_params, make_fit_step,
                                    rebuild_accel, render_views)
    from vrt_torch.diff.optim import adam
    from vrt_torch.kernels import accel as ka
    from vrt_torch.kernels import optim as ko
    from vrt_torch.kernels import pack as kp
    from vrt_torch.kernels._timing import device_ms
    from vrt_torch.march.types import _accel_u8
    from vrt_torch.render.gpuscene import RenderMode, color_table
    from vrt_torch.volume.accel import build_accel, build_accel_reference

    mode, size, views = RenderMode(), CONFIG4_SIZE, CONFIG4_VIEWS
    t0 = time.perf_counter()
    scene, cams = bench.config4_scene(8, views, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    corners, colors = scene.volumes.corners, color_table(scene)
    table_mb = corners.numel() * corners.element_size() / 1e6
    colour_mb = colors.numel() * colors.element_size() / 1e6
    print(f"config4 scene on {card}: built in {build_s:.1f}s; corners "
          f"{tuple(corners.shape)} {corners.dtype} = {table_mb:.0f} MB, "
          f"colours sampled from {tuple(colors.shape)} {colors.dtype} = "
          f"{colour_mb:.0f} MB (packed view: "
          f"{scene.voxel_color_corners is not None})", flush=True)
    if tuple(corners.shape) != (1, 256, 256, 256, 8) or \
            corners.dtype != torch.bfloat16:
        raise AssertionError("config4's corner table is not 257^3 bf16")
    if scene.voxel_color_corners is not None or \
            colors is not scene.voxel_colors or \
            tuple(colors.shape) != (1, 257, 257, 257, 3) or \
            colors.dtype != torch.float32:
        raise AssertionError("config4's colours are not the unpacked f32 "
                             "257^3 grid")
    params = bench._fit_params(scene)
    opt = adam(bench.ADAM_LR)
    state = opt.init(params)
    step = make_fit_step(scene, cams, size, size, mode, opt)
    targets = torch.zeros((views, size * size, 3), device=dev)
    start = {k: v.clone() for k, v in params.items()}
    params, state, loss = step(params, state, targets)        # warm-up
    sync()
    losses = [float(loss)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    runs = []
    with _counting(fitmod, "pack_voxel_color_corners") as repacks:
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, targets)
            sync()
            runs.append(time.perf_counter() - t0)
            losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    c4_counts = counts()
    c4_packs = dict(kp.LAUNCHES)
    c4_accel = dict(ka.LAUNCHES)
    c4_adam = dict(ko.LAUNCHES)
    if repacks[0] != 0 or c4_packs != dict(pack=0, pack_bwd=3) or \
            c4_accel != dict(pyramid=3, rebuild=3) or \
            c4_adam != dict(apply=3, update=0):
        raise AssertionError(f"3 config4 steps: {repacks[0]} colour "
                             f"repacks (expected 0), corner packs "
                             f"{c4_packs} (expected 0 and 3 backward), "
                             f"accel {c4_accel} (expected the pyramid 3: "
                             f"8 levels in 1 launch, the rebuild 3), Adam "
                             f"{c4_adam} (expected 3)")
    levels, traces = _resolves(scene), _traces(scene)
    want = dict(k1=0, scene=3 * views * traces, resolve=3 * views * levels,
                resolve_bwd=3 * views * levels, gather=0, scatter=0,
                scatter_v4=0, scatter_scalar=0, surface=3 * views * levels,
                combine=3 * views * levels,
                surface_bwd=3 * views * levels,
                combine_bwd=3 * views * levels)
    if c4_counts != want:
        raise AssertionError(f"launches in 3 config4 steps {c4_counts}, "
                             f"expected {want}")
    moved = {k: (v != start[k]).float().mean().item()
             for k, v in params.items()}
    del start
    median = statistics.median(runs) * 1e3
    print(f"config4 fit step ({views} views {size}x{size}) on {card}: "
          f"median {median:.1f} ms/step (runs "
          f"{', '.join(f'{r * 1e3:.1f}' for r in runs)} ms), "
          f"{views * size * size / median * 1e3:.0f} rays/s forward+"
          f"backward; peak max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"losses {', '.join(f'{v:.6f}' for v in losses)} (warm-up first); "
          f"per step {c4_counts['scene'] // 3} scene marches, "
          f"{c4_counts['resolve'] // 3} fused resolves and their "
          f"backwards, {c4_counts['surface'] // 3} shade surface and "
          f"combine launches and their backwards, "
          f"{c4_accel['pyramid'] // 3} accel pyramid launch, "
          f"{c4_accel['rebuild'] // 3} accel rebuild, "
          f"{c4_packs['pack_bwd'] // 3} pack backward (by design in 3 "
          f"steps {dict(kp.BWD_LAUNCHES)}) and {c4_adam['apply'] // 3} "
          f"Adam launch, 0 colour repacks; "
          f"entries moved "
          f"{', '.join(f'{k} {v:.2%}' for k, v in moved.items())}",
          flush=True)
    if not all(v == v for v in losses) or not all(moved.values()):
        raise AssertionError(f"config4: losses {losses}, moved {moved}")

    def one_step():
        return step(params, state, targets)

    held = {}
    tag = f"config4 fit step ({views} views {size}x{size})"
    held["scene"] = _scene_calls(one_step, views * traces, tag, width=size)
    held["fused"] = _resolve_calls(one_step, views * levels, tag)
    held["resolve_bwd"] = _resolve_bwd_calls(one_step, views * levels, tag)
    held["shade"] = _shade_calls(one_step, views * levels, tag)
    held["shade_bwd"] = _shade_bwd_calls(one_step, views * levels, tag)
    rows = _kernel_rows(held, f"config4 on {card}")
    held["pack"] = _rebuild_calls(one_step, 1, tag)
    with _recording(ko, "adam_step_cuda") as adam_calls:
        one_step()
    if len(adam_calls) != 1:
        raise AssertionError(f"a config4 step called the Adam kernel "
                             f"{len(adam_calls)} times")
    held["adam"] = _adam_held(adam_calls, tag)
    del adam_calls

    # the optimizer region waits on the card nowhere: a step whose
    # Adam.apply runs under set_sync_debug_mode("error"), where a
    # synchronising call raises; beside it, whether the mode catches the
    # host-to-device copy of a Python scalar that Adam made twice a step
    # before (``torch.tensor(b, device=...)``)
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.tensor(opt.b1, device=dev)
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    apply = opt.apply

    def apply_no_sync(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return apply(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    opt.apply = apply_no_sync
    before = dict(ko.LAUNCHES)
    try:
        one_step()
        sync()
    finally:
        del opt.apply
    if ko.LAUNCHES["apply"] - before["apply"] != 1:
        raise AssertionError("the step under the sync check launched no "
                             "Adam kernel")
    print(f"config4 step on {card}: Adam.apply ran under "
          f"set_sync_debug_mode('error') without a synchronising call; the "
          f"mode {'raised' if caught else 'did not raise'} on the former "
          f"torch.tensor(b1, device=...)", flush=True)

    # the step's gradients on the kernels against the plain stages
    def loss_fn(p):
        s = graft_and_rebuild(scene, p)
        return torch.mean((render_views(s, cams, size, size, mode)
                           - targets) ** 2)

    lk, gk = _value_and_grad(loss_fn, params)
    _, again = _value_and_grad(loss_fn, params)
    with _plain_resolve_path(), _eager_shading():
        lp, gp = _value_and_grad(loss_fn, params)
    gates = {k: _grad_gates(gk[k], gp[k]) for k in gk}
    spread = {k: _grad_gates(again[k], gk[k]) for k in gk}
    # the SDF's cotangents pass through the bf16 corner table; the colours'
    # reach the f32 grid without a cast
    diff_tol = dict(sdf=BF16_DIFF_TOL, voxel_colors=FIT_DIFF_TOL)
    print(f"config4 step's gradients on the kernels against the plain "
          f"stages (eager shading, resolve on the plain path): loss "
          f"{float(lk):.8f} vs {float(lp):.8f}; " + "; ".join(
              f"{k}: 1 - cosine {c:.2e} (< {FIT_COS_TOL}), max diff / "
              f"max|g| {d:.2e} (< {diff_tol[k]:.2e}; the kernel step "
              f"against itself run again: {spread[k][0]:.2e}, "
              f"{spread[k][1]:.2e})" for k, (c, d) in gates.items()),
          flush=True)
    if not all(c < FIT_COS_TOL and d < diff_tol[k]
               for k, (c, d) in gates.items()):
        raise AssertionError("config4's kernel step disagrees with its "
                             "plain step")
    del gk, gp, again
    torch.cuda.empty_cache()

    # where a step's device time goes
    prof = _profile(one_step, sync, median, what="one config4 fit step")
    pieces = {}
    sdf = params["sdf"]
    pieces["build_accel"] = device_ms(lambda: build_accel(sdf, 8), 3)
    pieces["build_accel_eager"] = device_ms(
        lambda: build_accel_reference(sdf, 8), 3)
    pieces["accel_u8_eager"] = device_ms(
        lambda: _accel_u8(scene.volumes.accel), 3)
    pieces["rebuild_accel"] = device_ms(lambda: rebuild_accel(
        graft_params(scene, params, repack=False)), 3)
    torch.cuda.empty_cache()
    whole, pack_bwd = held["pack"]["whole"], held["pack"]["pack_bwd"]
    kernels_ms = sum(r["ms"] for r in rows.values()) + whole["ms"] \
        + pack_bwd["ms"] + held["adam"]["ms"]
    busy = None if prof is None else prof["busy_ms"]
    print(f"config4 step's device time on {card}: busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'}, peak "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; each piece alone: "
          f"rebuild_accel {pieces['rebuild_accel']:.3f} ms (the accel "
          f"kernels and the graft; build_accel on the kernels "
          f"{pieces['build_accel']:.3f} ms, eager "
          f"{pieces['build_accel_eager']:.3f} ms, the eager _accel_u8 "
          f"{pieces['accel_u8_eager']:.3f} ms), the pyramid and rebuild "
          f"{whole['ms']:.4f} ms (eager build_accel, _accel_u8 and the "
          f"first design's pack {whole['old_ms']:.3f} ms) and the pack "
          f"backward {pack_bwd['ms']:.4f} ms (first design "
          f"{pack_bwd['old_ms']:.4f} ms, autograd of the torch pack "
          f"{pack_bwd['plain_ms']:.3f} ms), Adam {held['adam']['ms']:.4f} "
          f"ms (eager {held['adam']['plain_ms']:.3f} ms); the hand-written "
          f"kernels {kernels_ms:.3f} ms"
          + ("" if busy is None else
             f" = {kernels_ms / busy:.0%} of the busy time ("
             f"{busy - kernels_ms:.2f} ms outside them)"), flush=True)
    numbers = dict(step_ms=median, runs_ms=[r * 1e3 for r in runs],
                   peak_gib=peak / 2**30, losses=losses,
                   launches_per_step={
                       **{k: v // 3 for k, v in c4_counts.items() if v},
                       **{k: v // 3 for k, v in c4_packs.items()},
                       **{f"accel {k}": v // 3 for k, v in c4_accel.items()},
                       **{f"Adam {k}": v // 3 for k, v in c4_adam.items()},
                       "colour_repack": repacks[0] // 3},
                   corner_table_mb=table_mb, colour_grid_mb=colour_mb,
                   build_s=build_s, busy_ms=busy,
                   device_ops=None if prof is None else prof["device_ops"],
                   pieces_ms=pieces, kernels_ms=kernels_ms, vs_plain=gates,
                   sync_check_catches_scalar_copy=caught,
                   capped=held["scene"]["capped"],
                   simt_flat=held["scene"]["simt_flat"])
    return dict(counts=c4_counts, packs=c4_packs, accel=c4_accel,
                adam=c4_adam, held=held, numbers=numbers)


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

    from vrt_torch import native
    from vrt_torch.apps import probe_gather as probe
    from vrt_torch.kernels import accel as ka
    from vrt_torch.kernels import gather as gk
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import optim as ko
    from vrt_torch.kernels import pack as kp
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.kernels import rows as k3
    from vrt_torch.kernels import shade as k4
    from vrt_torch.kernels._build import ptxas_usage, warp_slots
    from vrt_torch.march.march import march_lanes, march_lanes_reference
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import (DIR_SHADOW_TMAX, RADIANCE_TMAX,
                                           march_scene, march_scene_any_hit,
                                           render_image, resolve_scene)
    from vrt_torch.render.gpuscene import (LIGHT_FIELDS, MATERIAL_FIELDS,
                                           TEXTURE_FIELDS)
    from vrt_torch.scenes import (flagship_scene, padded_sampled_tables,
                                  shading_scene)

    # ---- 1. device ---------------------------------------------------------
    started = time.perf_counter()

    def _mark(phase):
        # the run's seconds so far, as each phase starts (the run must end
        # well within its 1200 s)
        print(f"phase {phase} starts at {time.perf_counter() - started:.1f}s",
              flush=True)

    card = probe.card()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _mark(2)
    # ---- 2. build: one nvcc per source, all started together ---------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        logs = {"K1 (march.cu)": pool.submit(k1.build),    # K1 and K7
                "gather (gather.cu)": pool.submit(gk.build),
                "K3 (rows.cu)": pool.submit(k3.build),
                "fused resolve, forward and backward (resolve.cu)":
                pool.submit(kr.build),
                "K4 shade, surface and combine, forward and backward (shade.cu)":
                pool.submit(k4.build),
                "corner pack and its backward (pack.cu)":
                pool.submit(kp.build),
                "accel pyramid and rebuild (accel.cu)":
                pool.submit(ka.build),
                "Adam update (optim.cu)": pool.submit(ko.build)}
        gxx = pool.submit(native.build)
        logs = {name: f.result() for name, f in logs.items()}
        gxx_s = gxx.result()
    print(f"build: {time.perf_counter() - t0:.1f}s; the import's native "
          f"library (vrt_torch/native/vrtnative.cpp): g++ {gxx_s:.2f}s (0 "
          f"where it was built before)", flush=True)
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {name}: {line}", flush=True)
    for name in ("fused resolve, forward and backward (resolve.cu)",
                 "K4 shade, surface and combine, forward and backward (shade.cu)"):
        spills = [line for line in logs[name].splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes "
                  "spill loads" not in line]
        print(f"{name}: {len(spills)} kernels spill registers"
              + "".join(f"\n  {line.strip()}" for line in spills),
              flush=True)
    ptxas = {}
    for name, log, kernel, threads in (
            ("K1 (march.cu)", "K1 (march.cu)", "march_kernel", 256),
            ("K7 (march.cu)", "K1 (march.cu)", "march_slab_capped_kernel",
             64),
            ("K7 (march.cu)", "K1 (march.cu)", "march_slab_kernel", 256),
            ("K1 (march.cu)", "K1 (march.cu)", "march_scene_capped_kernel", 64),
            ("K1 (march.cu)", "K1 (march.cu)", "march_scene_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_bwd_merged_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_bwd_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_bwd_textures_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "combine_bwd_env_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_bwd_textures_warp_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "combine_bwd_env_warp_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_bwd_instances_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_bwd_sums_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_resident_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_voxels_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "surface_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "combine_resident_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "combine_kernel", 256),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "combine_bwd_resident_kernel",
             COMBINE_BWD_THREADS),
            ("K4 (shade.cu)", "K4 shade, surface and combine, forward and "
             "backward (shade.cu)", "combine_bwd_kernel", 256),
            ("fused resolve (resolve.cu)", "fused resolve, forward and "
             "backward (resolve.cu)", "resolve_lean_kernel",
             RESOLVE_THREADS),
            ("fused resolve (resolve.cu)", "fused resolve, forward and "
             "backward (resolve.cu)", "resolve_kernel", 256),
            ("fused resolve (resolve.cu)", "fused resolve, forward and "
             "backward (resolve.cu)", "resolve_bwd_merged_kernel", 256),
            ("fused resolve (resolve.cu)", "fused resolve, forward and "
             "backward (resolve.cu)", "resolve_bwd_instances_kernel", 256),
            ("fused resolve (resolve.cu)", "fused resolve, forward and "
             "backward (resolve.cu)", "resolve_bwd_kernel", 256),
            ("corner pack (pack.cu)", "corner pack and its backward "
             "(pack.cu)", "pack_kernel", 256),
            ("corner pack (pack.cu)", "corner pack and its backward "
             "(pack.cu)", "pack_bwd_kernel", 256),
            ("corner pack (pack.cu)", "corner pack and its backward "
             "(pack.cu)", "pack_bwd_tiled_kernel", 256),
            ("accel (accel.cu)", "accel pyramid and rebuild (accel.cu)",
             "pyramid_one_kernel", 256),
            ("accel (accel.cu)", "accel pyramid and rebuild (accel.cu)",
             "pyramid_cells_kernel", 256),
            ("accel (accel.cu)", "accel pyramid and rebuild (accel.cu)",
             "pyramid_kernel", 256),
            ("accel (accel.cu)", "accel pyramid and rebuild (accel.cu)",
             "rebuild_kernel", 256),
            ("Adam (optim.cu)", "Adam update (optim.cu)", "adam_kernel",
             256)):
        # the shade backward kernels' default launches apart from their
        # material and light variants (the last template argument)
        split = kernel in ("surface_bwd_merged_kernel", "surface_bwd_kernel",
                           "combine_bwd_resident_kernel",
                           "combine_bwd_kernel", "surface_bwd_textures_kernel",
                           "combine_bwd_env_kernel",
                           "surface_bwd_textures_warp_kernel",
                           "combine_bwd_env_warp_kernel",
                           "surface_bwd_sums_kernel")
        # the sums redesign's material-alone instantiations apart from its
        # instance variant's (its last template argument, kInst)
        pair = ((False, f"{kernel} material"), (True, f"{kernel} instances")) \
            if kernel == "surface_bwd_sums_kernel" \
            else ((False, kernel), (True, f"{kernel} variant"))
        for last, key in (pair if split else ((None, kernel),)):
            got = ptxas_usage(logs[log], kernel, last)
            if got is None:
                print(f"ptxas, {name} {key}: not in the log (the library "
                      f"was built before this run)", flush=True)
                continue
            got["occupancy"] = [warp_slots(r, threads)
                                for r in got["registers"][::-1]]
            ptxas[key] = got
            print(f"ptxas, {name} {key} ({threads} threads a block): "
                  f"{got['variants']} variants, {got['registers'][0]}-"
                  f"{got['registers'][1]} registers, stack frame "
                  f"{got['stack_bytes'][0]}-{got['stack_bytes'][1]} bytes, "
                  f"spills {got['spill_bytes'][0]}-{got['spill_bytes'][1]} "
                  f"bytes; warp slots the registers leave filled "
                  f"{got['occupancy'][0]:.0%}-{got['occupancy'][1]:.0%}",
                  flush=True)

    _mark(3)
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

    # the fused resolve: the three launches of a 1080p frame, and the three
    # of a config6 fit step (under a graph) with their three backwards
    fused = _resolve_calls(frame(mode), _resolves(scene), "1080p frame")
    fused_fit = _resolve_calls(lambda: fit[1](*fit[2:]), _resolves(fit[0]),
                               "config6 fit step")
    bwd = _resolve_bwd_calls(lambda: fit[1](*fit[2:]), _resolves(fit[0]),
                             "config6 fit step")
    print(f"fused resolve on the config6 fit step on {card}: forward "
          f"{fused_fit['ms']:.4f} ms in {fused_fit['launches']} launches "
          f"(bound {fused_fit['bound']['bound_ms']:.4f} ms), backward "
          f"{_list(bwd['ms'])} ms = {sum(bwd['ms']):.4f} ms (first design "
          f"in the same call {_list(bwd['old_ms'])} ms = "
          f"{sum(bwd['old_ms']):.4f} ms); plain closed "
          f"form {_list(bwd['plain_ms'])} ms = {sum(bwd['plain_ms']):.4f} ms; "
          f"bound {bwd['bound']['bound_ms']:.4f} ms ({bwd['bound']['bytes']} "
          f"B, by {bwd['bound']['bound_by']})", flush=True)

    # the shade kernels of a config6 fit step: the three levels' forward
    # launches (through the shade Functions) and their backward launches
    fit_shade = _shade_calls(lambda: fit[1](*fit[2:]), _resolves(fit[0]),
                             "config6 fit step")
    shade_bwd = _shade_bwd_calls(lambda: fit[1](*fit[2:]), _resolves(fit[0]),
                                 "config6 fit step")

    # the two shade kernels: every launch of the three 1080p frames and of an
    # unlit one, and of 480x270 frames of a scene with textures, two point
    # lights and a spot light, without and with per-voxel colours
    unlit = RenderMode(lit=False)
    shade_runs = {}
    for tag, m in (("interp", mode), ("cube", cube), ("overlay", overlay),
                   ("unlit", unlit)):
        shade_runs[tag] = _shade_calls(frame(m), _resolves(scene, m.lit),
                                       f"1080p {tag} frame")
    for tag, colors in (("lights", False), ("lights_colors", True)):
        busy = shading_scene(6, 2, 1, colors=colors, device=dev)
        shade_runs[tag] = _shade_calls(
            lambda: render_image(busy, SMALL_W, SMALL_H, mode),
            _resolves(busy), f"480x270 textured frame with 2 point lights "
            f"and a spot light, colours={colors}")
        del busy
    # the backward kernels' material and light variants: a loss on the same
    # frames differentiated in the material constants and the lights, each
    # variant launch against its plain version and the default
    # instantiation on the same inputs
    variant_runs = {}
    for tag, colors in (("lights", False), ("lights_colors", True)):
        busy = shading_scene(6, 2, 1, colors=colors, device=dev)
        variant_runs[tag] = _variant_calls(
            _table_loss(busy, SMALL_W, SMALL_H, mode,
                        MATERIAL_FIELDS + LIGHT_FIELDS),
            _resolves(busy), f"480x270 textured frame with 2 point lights "
            f"and a spot light, colours={colors}, a loss in the materials "
            f"and the lights")
        del busy
    # the texture and env variants: a loss on the lights frame
    # differentiated in the texture scale, the textures and the env, with
    # the scene's own tables (their sums in shared memory) and with the
    # same texels in a [3,256,256,3] stack and the env at twice its side
    # (past the shared budgets: f32 atomics into the tables)
    table_runs = {}
    lights_scene = shading_scene(6, 2, 1, device=dev)
    for path, busy in (("shared", lights_scene),
                       ("global", padded_sampled_tables(lights_scene))):
        table_runs[path] = _variant_calls(
            _table_loss(busy, SMALL_W, SMALL_H, mode, TEXTURE_FIELDS),
            _resolves(busy), f"480x270 textured frame with 2 point lights "
            f"and a spot light, a loss in the texture scale, the textures "
            f"and the env ({path} table sums)", ("textures",), ("env",))
        took = [v["paths"] for v in table_runs[path].values()]
        if any(t[path] != _resolves(busy) for t in took):
            raise AssertionError(f"the {path} tables' variant launches took "
                                 f"the paths {took}")
        del busy
    del lights_scene
    # the instance variants: a loss differentiated in the instance
    # transforms on the lights frame with its first instance posed (a
    # quaternion of norm 1.05, an uneven scale: scenes.posed_instances) and
    # on config7's 12 instances at 512x512 (the first posed too)
    from vrt_torch.apps.bench import config7_scene
    from vrt_torch.render.gpuscene import INSTANCE_FIELDS
    from vrt_torch.scenes import posed_instances

    instance_runs = {}
    for tag, busy, w, h in (
            ("480x270_lights", posed_instances(shading_scene(6, 2, 1,
                                                             device=dev)),
             SMALL_W, SMALL_H),
            ("config7_512x512", posed_instances(config7_scene(6, 12, dev)),
             512, 512)):
        instance_runs[tag] = _instance_calls(
            _table_loss(busy, w, h, mode, INSTANCE_FIELDS), _resolves(busy),
            f"{tag} frame, its first instance posed, a loss in the instance "
            f"transforms")
        del busy

    # K3: every launch of one 1080p frame on the candidate-loop path, of one
    # config6 fit step with eager shading (the colour rows: the default step
    # has no K3 launch, its shade kernels read the colour rows) and of that
    # step with resolve on the plain path (the 9-channel corner rows)
    def old_frame():
        with _candidate_loop_path():
            render_image(scene, FRAME_W, FRAME_H, mode)

    k3_frame = _k3_calls(old_frame, "1080p frame, candidate-loop path")
    if k3_frame["gather"]["launches"] != _expected_k3(scene, True):
        raise AssertionError(f"the 1080p frame launched K3 "
                             f"{k3_frame['gather']['launches']} times, "
                             f"expected {_expected_k3(scene, True)}")
    def eager_step():
        with _eager_shading():
            fit[1](*fit[2:])

    k3_fit = _k3_calls(eager_step, "config6 fit step, eager shading")

    def plain_step():
        with _plain_resolve_path():
            fit[1](*fit[2:])

    k3_plain = _k3_calls(plain_step, "config6 fit step, plain resolve")
    for got, plain_resolve, eager in ((k3_fit, False, True),
                                      (k3_plain, True, False)):
        for op in ("gather", "scatter"):
            if got[op]["launches"] != _expected_k3(fit[0], plain_resolve,
                                                   eager):
                raise AssertionError(
                    f"the config6 fit step launched K3 {op} "
                    f"{got[op]['launches']} times, expected "
                    f"{_expected_k3(fit[0], plain_resolve, eager)}")
    if set(k3_fit["scatter"]["paths"]) != {"v4"}:
        raise AssertionError(f"the colour rows' scatters took "
                             f"{k3_fit['scatter']['paths']}")
    if set(k3_plain["scatter"]["paths"]) != {"scalar"}:
        raise AssertionError(f"the plain resolve path's scatters took "
                             f"{k3_plain['scatter']['paths']}")
    del fit
    print(f"K3 device time on {card}: 1080p frame gathers "
          f"{k3_frame['gather']['ms']:.4f} ms (plain "
          f"{k3_frame['gather']['plain_ms']:.4f}, library "
          f"{k3_frame['gather']['library_ms']:.4f}, bound "
          f"{k3_frame['gather']['bound']['bound_ms']:.4f} ms); config6 fit "
          f"step with eager shading: gathers {k3_fit['gather']['ms']:.4f} ms "
          f"(plain "
          f"{k3_fit['gather']['plain_ms']:.4f}, library "
          f"{k3_fit['gather']['library_ms']:.4f}, bound "
          f"{k3_fit['gather']['bound']['bound_ms']:.4f} ms), scatters "
          f"{k3_fit['scatter']['ms']:.4f} ms (plain "
          f"{k3_fit['scatter']['plain_ms']:.4f}, library "
          f"{k3_fit['scatter']['library_ms']:.4f}, bound "
          f"{k3_fit['scatter']['bound']['bound_ms']:.4f} ms), the same "
          f"scatters on the scalar path "
          f"{k3_fit['scatter_scalar']['ms']:.4f} ms, max scatter error "
          f"{k3_fit['scatter']['max_abs_err']:.3e}; the step with resolve on "
          f"the plain path: gathers {k3_plain['gather']['ms']:.4f} ms (bound "
          f"{k3_plain['gather']['bound']['bound_ms']:.4f} ms), scatters "
          f"{k3_plain['scatter']['ms']:.4f} ms (bound "
          f"{k3_plain['scatter']['bound']['bound_ms']:.4f} ms)", flush=True)

    _mark(4)
    # ---- 4. the frames -----------------------------------------------------
    def zero_counts():
        k1.LAUNCHES = k1.SCENE_LAUNCHES = 0
        _reset(kr.LAUNCHES)
        _reset(k3.LAUNCHES)
        _reset(k3.SCATTER_LAUNCHES)
        _reset(k4.LAUNCHES)
        _reset(k4.PATH_LAUNCHES)
        _reset(k4.VARIANT_LAUNCHES)
        _reset(k4.TABLE_LAUNCHES)
        _reset(k4.SUMS_DESIGN_LAUNCHES)
        _reset(kr.VARIANT_LAUNCHES)
        _reset(kp.LAUNCHES)
        _reset(kp.BWD_LAUNCHES)
        _reset(ka.LAUNCHES)
        _reset(ko.LAUNCHES)

    def counts():
        return dict(k1=k1.LAUNCHES, scene=k1.SCENE_LAUNCHES,
                    resolve=kr.LAUNCHES["forward"],
                    resolve_bwd=kr.LAUNCHES["backward"],
                    gather=k3.LAUNCHES["K3 gather"],
                    scatter=k3.LAUNCHES["K3 scatter"],
                    scatter_v4=k3.SCATTER_LAUNCHES["v4"],
                    scatter_scalar=k3.SCATTER_LAUNCHES["scalar"],
                    surface=k4.LAUNCHES["surface"],
                    combine=k4.LAUNCHES["combine"],
                    surface_bwd=k4.LAUNCHES["surface_bwd"],
                    combine_bwd=k4.LAUNCHES["combine_bwd"])

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
                    resolve=3 * _resolves(scene), resolve_bwd=0, gather=0,
                    scatter=0, scatter_v4=0, scatter_scalar=0,
                    surface=3 * _resolves(scene),
                    combine=3 * _resolves(scene), surface_bwd=0,
                    combine_bwd=0)
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"1080p {tag} frame has non-finite pixels")
        if tuple(img.shape) != (FRAME_H, FRAME_W, 4):
            raise AssertionError(f"{tag} frame shape {tuple(img.shape)}")
        if got != want:
            raise AssertionError(f"launches in 3 {tag} frames {got}, "
                                 f"expected {want}")
        paths = dict(k4.PATH_LAUNCHES)
        for stage in ("surface", "combine"):
            if paths[f"{stage} v4"] + paths[f"{stage} scalar"] != got[stage]:
                raise AssertionError(f"paths of 3 {tag} frames {paths}")
        got["paths"] = paths
        median = statistics.median(runs)
        print(f"1080p {tag} frame on {card}: median {median * 1e3:.1f} ms "
              f"(runs {', '.join(f'{f * 1e3:.1f}' for f in runs)} ms), "
              f"{FRAME_W * FRAME_H / median:.0f} rays/s; launches in 3 "
              f"frames: scene march {got['scene']}, fused resolve "
              f"{got['resolve']}, shade surface {got['surface']} and combine "
              f"{got['combine']}, per-lane K1 {got['k1']}, K3 gathers "
              f"{got['gather']}; shade paths {got['paths']}", flush=True)
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
            old_counts["gather"] != 2 * 2 * 6 * _expected_k3(scene, True):
        raise AssertionError(f"launches of the paired frames {old_counts}")

    # eager shading (the plain stages) against the two shade kernels, in one
    # call; the old side launches no shade kernel
    def eager(run):
        def go():
            with _eager_shading():
                return run()
        return go

    zero_counts()
    for tag, m in (("interp", mode), ("cube", cube)):
        meds = []
        for run in (eager(frame(m)), frame(m), frame(m), eager(frame(m))):
            meds.append(statistics.median(timed(run, 5)[0]) * 1e3)
        paired[f"shade_{tag}"] = meds
        print(f"1080p {tag} frame on {card}, eager shading against the two "
              f"shade kernels, medians of 5 in the order old, new, new, old: "
              f"{', '.join(f'{t:.2f}' for t in meds)} ms", flush=True)
    got = counts()
    if (got["surface"], got["combine"]) != (2 * 2 * 6 * _resolves(scene),) * 2 \
            or got["scene"] != 2 * 4 * 6 * _traces(scene):
        raise AssertionError(f"launches of the paired shading frames {got}")

    # the first designs of the scene march and of the shade forward pair
    # against the redesigns, in one call
    def old_design(run):
        def go():
            with _old_designs():
                return run()
        return go

    zero_counts()
    for tag, m in (("interp", mode), ("cube", cube), ("overlay", overlay)):
        meds = []
        for run in (old_design(frame(m)), frame(m), frame(m),
                    old_design(frame(m))):
            meds.append(statistics.median(timed(run, 5)[0]) * 1e3)
        paired[f"march_design_{tag}"] = meds
        print(f"1080p {tag} frame on {card}, the first designs of the scene "
              f"march, the fused resolve and the shade forward pair against "
              f"the redesigns, medians of 5 in the order old, new, new, old: "
              f"{', '.join(f'{t:.2f}' for t in meds)} ms", flush=True)
    got = counts()
    paths = dict(k4.PATH_LAUNCHES)
    if got["scene"] != 3 * 4 * 6 * _traces(scene) or got["k1"] != 0 or \
            (got["surface"], got["combine"]) != (3 * 4 * 6
                                                 * _resolves(scene),) * 2 or \
            (paths["surface v4"] + paths["surface scalar"],
             paths["combine v4"] + paths["combine scalar"]) != (
                 3 * 2 * 6 * _resolves(scene),) * 2:
        raise AssertionError(f"launches of the paired design frames {got}, "
                             f"paths {paths}")

    _mark(5)
    # ---- 5. anchored to the JAX reference ----------------------------------
    zero_counts()
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
    got = counts()
    if (got["surface"], got["combine"]) != (_resolves(scene) + 1,) * 2:
        raise AssertionError(f"the fixture frames' shade launches {got}")

    _mark(6)
    # ---- 6. where the time goes ---------------------------------------------
    prof = _profile(frame(mode), sync, frame_s * 1e3)
    if prof is not None and "aten::sort" in prof["ops"]:
        raise AssertionError("the 1080p frame still sorts on the device")
    frame_ops = None
    if prof is not None:
        # what is left is camera_rays and the glue of trace_radiance: no
        # gather from a table, and no cat but camera_basis' of 3-vectors
        import re

        frame_ops = prof["device_ops"]
        wide_cats = [shapes for op, shapes in prof["op_shapes"]
                     if op == "aten::cat" and
                     max(map(int, re.findall(r"\d+", shapes) or [0])) > 4096]
        print(f"1080p frame: {frame_ops} device ops (at most "
              f"{FRAME_OPS_MAX}); operators with device time: "
              f"{sorted(prof['ops'])}", flush=True)
        if frame_ops > FRAME_OPS_MAX or "aten::index" in prof["ops"] or \
                wide_cats:
            raise AssertionError(f"the 1080p frame: {frame_ops} device ops, "
                                 f"operators {sorted(prof['ops'])}, cats of "
                                 f"{wide_cats}")
    flagship = scene
    del scene

    _mark(7)
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

    _mark(8)
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
    fit_paths = dict(k4.PATH_LAUNCHES)
    fit_packs = dict(kp.LAUNCHES)
    fit_bwd_designs = dict(kp.BWD_LAUNCHES)
    fit_accel = dict(ka.LAUNCHES)
    fit_adam = dict(ko.LAUNCHES)
    step_s = statistics.median(runs)
    n_rays = len(FIT_CAMS) * FRAME_W * FRAME_H
    print(f"config6 fit step 1920x1080 on {card}: median "
          f"{step_s * 1e3:.1f} ms/step (runs "
          f"{', '.join(f'{r * 1e3:.1f}' for r in runs)} ms), "
          f"{n_rays / step_s:.0f} rays/s forward+backward; peak "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; losses "
          f"{', '.join(f'{v:.6f}' for v in losses)} (warm-up first); per "
          f"step scene march {fit_counts['scene'] / 3:g}, fused resolve "
          f"forward {fit_counts['resolve'] / 3:g} and backward "
          f"{fit_counts['resolve_bwd'] / 3:g}, shade surface "
          f"{fit_counts['surface'] / 3:g} and combine "
          f"{fit_counts['combine'] / 3:g}, their backward "
          f"{fit_counts['surface_bwd'] / 3:g} and "
          f"{fit_counts['combine_bwd'] / 3:g}, K3 gathers "
          f"{fit_counts['gather'] / 3:g} and scatters "
          f"{fit_counts['scatter'] / 3:g}, per-lane K1 "
          f"{fit_counts['k1'] / 3:g}", flush=True)
    levels = _resolves(fit_scene)
    want = dict(k1=0, scene=3 * _traces(fit_scene), resolve=3 * levels,
                resolve_bwd=3 * levels, gather=0, scatter=0, scatter_v4=0,
                scatter_scalar=0, surface=3 * levels, combine=3 * levels,
                surface_bwd=3 * levels, combine_bwd=3 * levels)
    if fit_counts != want:
        raise AssertionError(f"launches in 3 fit steps {fit_counts}, "
                             f"expected {want}")
    # rebuild_accel rebuilds the accel and packs the 9-channel f32 table
    # once a step: the pyramid in 1 launch (6 levels), the rebuild in 1,
    # the pack backward in 1 (on the card's first design here, where the
    # tiled kernel's grid is less than a wave); the first design's pack
    # never; Adam.apply one Adam launch over both leaves
    if fit_packs != dict(pack=0, pack_bwd=3) or \
            fit_accel != dict(pyramid=3, rebuild=3) or \
            fit_adam != dict(apply=3, update=0):
        raise AssertionError(f"accel, pack and Adam launches in 3 fit steps "
                             f"{fit_accel}, {fit_packs}, {fit_adam}, "
                             f"expected the pyramid 3, the rebuild 3, the "
                             f"pack backward 3, the first design's pack 0, "
                             f"Adam 3")
    print(f"config6 fit steps: accel pyramid {fit_accel['pyramid'] / 3:g}, "
          f"rebuild {fit_accel['rebuild'] / 3:g}, pack backward "
          f"{fit_packs['pack_bwd'] / 3:g} (by design in 3 steps "
          f"{fit_bwd_designs}) and Adam {fit_adam['apply'] / 3:g} launches "
          f"a step", flush=True)
    for stage in ("surface", "combine", "combine_bwd"):
        if fit_paths[f"{stage} v4"] + fit_paths[f"{stage} scalar"] != \
                fit_counts[stage]:
            raise AssertionError(f"paths of 3 fit steps {fit_paths}")
    print(f"config6 fit steps: shade paths {fit_paths}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite fit losses {losses}")
    for k, v in params.items():
        moved = (v != start[k]).float().mean().item()
        print(f"  {k}: {moved:.4%} of entries moved", flush=True)
        if moved == 0.0:
            raise AssertionError(f"the fit did not move {k}")
    del start

    # the step with resolve on the plain path over K3 (what a step took
    # before the fused resolve had a backward), and the step with eager
    # shading (the plain stages under autograd: what a step took before the
    # shade kernels had a backward), each against the default path; every
    # run starts from the same parameters and optimizer state
    def one_step():
        return step(params, state, targets)[2]

    # the accel rebuild and the pack backward of one step against their
    # plain versions and first designs, timed beside them; the step's Adam
    # launch against its plain version
    fit_pack = _rebuild_calls(one_step, 1, "config6 fit step")
    with _recording(ko, "adam_step_cuda") as adam_calls:
        one_step()
    if len(adam_calls) != 1:
        raise AssertionError(f"a config6 fit step called the Adam kernel "
                             f"{len(adam_calls)} times")
    fit_adam_held = _adam_held(adam_calls, "config6 fit step")
    del adam_calls
    # rebuild_accel on the card dispatches no eager op of build_accel or
    # _accel_u8: RebuildAccel's allocations, then its kernels
    from vrt_torch.diff.fit import graft_params
    ops, launched = _rebuild_ops(graft_params(fit_scene, params,
                                              repack=False))
    eager = sorted({op for op in ops if op not in REBUILD_OPS})
    print(f"config6 rebuild_accel on {card}: aten ops {ops}, launches "
          f"{launched}", flush=True)
    if eager or launched != dict(pyramid=1, rebuild=1):
        raise AssertionError(f"rebuild_accel dispatched eager ops {eager} "
                             f"and launched {launched}, expected none and "
                             f"the pyramid 1, the rebuild 1")

    def old_step():
        with _plain_resolve_path():
            return one_step()

    def eager_step():
        with _eager_shading():
            return one_step()

    zero_counts()
    meds = []
    for run in (old_step, one_step, one_step, old_step):
        meds.append(statistics.median(timed(run, 3)[0]) * 1e3)
    print(f"config6 fit step on {card}, resolve on the plain path over K3 "
          f"against the fused resolve and its backward, medians of 3 in the "
          f"order old, new, new, old: "
          f"{', '.join(f'{t:.2f}' for t in meds)} ms", flush=True)
    paired["fit"] = meds
    plain_counts = counts()
    want = dict(k1=0, scene=16 * _traces(fit_scene), resolve=8 * levels,
                resolve_bwd=8 * levels,
                gather=8 * _expected_k3(fit_scene, True),
                scatter=8 * _expected_k3(fit_scene, True), scatter_v4=0,
                scatter_scalar=8 * levels, surface=16 * levels,
                combine=16 * levels, surface_bwd=16 * levels,
                combine_bwd=16 * levels)
    if plain_counts != want:
        raise AssertionError(f"launches of the paired fit steps "
                             f"{plain_counts}, expected {want}")
    zero_counts()
    meds = []
    for run in (eager_step, one_step, one_step, eager_step):
        meds.append(statistics.median(timed(run, 3)[0]) * 1e3)
    print(f"config6 fit step on {card}, eager shading under autograd "
          f"against the shade kernels and their backward, medians of 3 in "
          f"the order old, new, new, old: "
          f"{', '.join(f'{t:.2f}' for t in meds)} ms", flush=True)
    paired["fit_shading"] = meds
    eager_counts = counts()

    # the first designs of the scene march, the shade forward pair, the
    # surface backward and the resolve backward against the redesigned
    # kernels
    def old_design_step():
        with _old_designs():
            return one_step()

    zero_counts()
    meds = []
    for run in (old_design_step, one_step, one_step, old_design_step):
        meds.append(statistics.median(timed(run, 3)[0]) * 1e3)
    print(f"config6 fit step on {card}, the first designs of the scene "
          f"march, the fused resolve forward and backward and the shade "
          f"forward and backward pairs against the redesigned kernels, "
          f"medians of 3 in the order old, new, new, old: "
          f"{', '.join(f'{t:.2f}' for t in meds)} ms", flush=True)
    paired["fit_designs"] = meds
    got = counts()
    paths = dict(k4.PATH_LAUNCHES)
    if (got["scene"], got["surface"], got["combine"], got["surface_bwd"],
            got["combine_bwd"]) \
            != (16 * _traces(fit_scene),) + (16 * levels,) * 4 or \
            (paths["surface v4"] + paths["surface scalar"],
             paths["combine v4"] + paths["combine scalar"],
             paths["combine_bwd v4"] + paths["combine_bwd scalar"]) != \
            (8 * levels,) * 3:
        raise AssertionError(f"launches of the paired design steps {got}, "
                             f"paths {paths}")
    want = dict(k1=0, scene=16 * _traces(fit_scene), resolve=16 * levels,
                resolve_bwd=16 * levels,
                gather=8 * _expected_k3(fit_scene, eager_shading=True),
                scatter=8 * _expected_k3(fit_scene, eager_shading=True),
                scatter_v4=8 * _expected_k3(fit_scene, eager_shading=True),
                scatter_scalar=0, surface=8 * levels, combine=8 * levels,
                surface_bwd=8 * levels, combine_bwd=8 * levels)
    if eager_counts != want:
        raise AssertionError(f"launches of the paired eager-shading fit "
                             f"steps {eager_counts}, expected {want}")
    sides, profiles = {}, {}
    for tag, run, what in (
            ("old", old_step, "resolve on the plain path over K3"),
            ("eager_shading", eager_step,
             "eager shading under autograd, K3 for the colour rows"),
            ("old_designs", old_design_step, "the first designs of the scene "
             "march, the fused resolve forward and backward and the shade "
             "forward and backward pairs"),
            ("new", one_step, "the fused resolve, the shade kernels and "
             "their backward kernels")):
        sync()
        torch.cuda.reset_peak_memory_stats()
        run()
        sync()
        side_peak = torch.cuda.max_memory_allocated()
        prof = _profile(run, sync, step_s * 1e3,
                        what=f"one config6 fit step ({tag}: {what})")
        sides[tag] = dict(peak_gib=side_peak / 2**30,
                          **({} if prof is None else
                             {"busy_ms": prof["busy_ms"],
                              "device_ops": prof["device_ops"],
                              "device_records": prof["device_records"]}))
        print(f"config6 fit step on {card}, {tag}: peak "
              f"max_memory_allocated {side_peak / 2**30:.2f} GiB"
              + ("" if prof is None else
                 f", device busy {prof['busy_ms']:.1f} ms in "
                 f"{prof['device_ops']} device ops"), flush=True)
        profiles[tag] = prof
        if tag == "new" and prof is not None and \
                prof["device_ops"] not in FIT_STEP_OPS:
            # name the kernels whose counts differ from the first designs'
            # step, profiled just before (the same code around the two)
            before = {k: n for _, n, k in
                      (profiles.get("old_designs") or {}).get("kernels", [])}
            now = {k: n for _, n, k in prof["kernels"]}
            for key in sorted(set(before) | set(now)):
                if before.get(key, 0) != now.get(key, 0):
                    print(f"  {before.get(key, 0):4d}x on the first designs, "
                          f"{now.get(key, 0):4d}x here: {key[:100]}",
                          flush=True)
            raise AssertionError(
                f"a config6 fit step takes {prof['device_ops']} device ops, "
                f"expected {FIT_STEP_OPS[0]} to {FIT_STEP_OPS[-1]}")
    # the step with the material constants and the directional light among
    # the parameters, on the kernels' variants and on the plain pair
    mat_step = _table_step(
        dev, card, sync, zero_counts, counts, timed,
        flagship_scene(6, use_colors=True, device=dev), FIT_CAMS,
        MATERIAL_STEP_KEYS, "config6 material-and-light fit step",
        (("material",), ("lights",)), sdf_step=one_step)
    paired["fit_materials"] = mat_step["routes"]["plain"]["ms"][:1] \
        + mat_step["routes"]["kernels"]["ms"] \
        + mat_step["routes"]["plain"]["ms"][1:]
    # the pose step: config6's SDF and colours and the instance transforms
    # among the parameters, on the surface and the resolve backward's
    # instance variants (no plain stage, no K3) and on the plain route
    # (eager shading, resolve on the plain path over K3), one plain step a
    # side; its transforms held entry by entry against the same step with
    # the backward on the plain versions
    pose_step = _table_step(
        dev, card, sync, zero_counts, counts, timed,
        flagship_scene(6, use_colors=True, device=dev), FIT_CAMS,
        POSE_STEP_KEYS, "config6 pose fit step", (("instances",), ()),
        sdf_step=one_step, per_entry=True, profile_plain=False)
    paired["fit_poses"] = pose_step["routes"]["plain"]["ms"][:1] \
        + pose_step["routes"]["kernels"]["ms"] \
        + pose_step["routes"]["plain"]["ms"][1:]
    del fit_scene, step, params, state, targets
    # the step with the texture scale, the textures and the env among the
    # parameters, beside the material constants and the sun's strength:
    # the shading scene (three seeded textures, an 8x8 env, 2 point lights
    # and a spot light; chebyshev, a bf16 corner table) at 1080p from its
    # own camera, on the kernels' texture and env variants (each in one
    # launch with the material and the light variant) and on the plain
    # pair, one plain step on each side
    tex_scene = shading_scene(6, 2, 1, colors=False, accel_mode="chebyshev",
                              march_dtype=torch.bfloat16, device=dev)
    tex_step = _table_step(
        dev, card, sync, zero_counts, counts, timed, tex_scene,
        [dict(position=tex_scene.cam_pos, rotation=tex_scene.cam_rot,
              fov=tex_scene.cam_fov)],
        TEXTURE_STEP_KEYS, "1080p texture-and-env fit step",
        (("material", "textures"), ("lights", "env")),
        per_entry=True, first_designs=True)
    paired["fit_textures"] = tex_step["routes"]["plain"]["ms"][:1] \
        + tex_step["routes"]["kernels"]["ms"] \
        + tex_step["routes"]["plain"]["ms"][1:]
    del tex_scene

    # the card's fit loss and gradients against vrt's (CPU) on the fixture
    from vrt_torch.diff.fit import (_value_and_grad, graft_and_rebuild,
                                    render_views)
    small = flagship_scene(4, use_colors=True, device=dev)
    fixture = np.load(FIT_FIXTURE)

    def small_loss(p):
        s = graft_and_rebuild(small, p)
        return torch.mean((render_views(s, FIT_CAMS, 64, 36, RenderMode())
                           - 0.25) ** 2)

    zero_counts()
    got_loss, grads = _value_and_grad(
        small_loss, {"sdf": small.volumes.sdf,
                     "voxel_colors": small.voxel_colors})
    small_counts = counts()
    levels = _resolves(small)
    if small_counts != dict(k1=0, scene=_traces(small), resolve=levels,
                            resolve_bwd=levels, gather=0, scatter=0,
                            scatter_v4=0, scatter_scalar=0, surface=levels,
                            combine=levels, surface_bwd=levels,
                            combine_bwd=levels):
        raise AssertionError(f"the 64x36 fit's launches {small_counts}: "
                             f"not through the shade kernels' backward")
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

    _mark(9)
    # ---- 9. the engine path ------------------------------------------------
    eng = _engine_path(dev, card, sync, zero_counts, counts)
    for box in eng["held"].values():
        scene_err = max(scene_err, box["scene"]["max_abs_err"])
    eng_launches = eng["launches"]

    _mark(10)
    # ---- 10. the import chain and config3 ------------------------------------
    c3 = _config3(dev, card, sync, zero_counts, counts, gxx_s)
    scene_err = max(scene_err, c3["held"]["scene"]["max_abs_err"])
    c3_counts, c3_held = c3["counts"], c3["held"]

    _mark(11)
    # ---- 11. config5's slab frame and the ray-sharded frame, and
    # ---- 12. its fit steps, the DP step and the scaling app -----------------
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        c5 = _config5(dev, card, sync, td, ptxas)
        sf = _slabfit(dev, card, sync, td, c5["geometry"])

    _mark(13)
    # ---- 13. the bench app, config7's 12 instances, config4's 257^3 fit ----
    app = _bench_app(card)
    c7 = _config7(dev, card, sync, zero_counts, counts)
    c4 = _config4(dev, card, sync, zero_counts, counts)
    scene_err = max(scene_err, c7["held"]["scene"]["max_abs_err"],
                    c4["held"]["scene"]["max_abs_err"])

    _mark("the yardsticks")
    # ---- the yardsticks of the shade kernels, after every phase
    def flagship_frame():
        return render_image(flagship, FRAME_W, FRAME_H, mode)

    graph_ms = _graph_yardstick(flagship_frame, sync, card)
    compiled = _compile_yardstick(flagship_frame, sync, card,
                                  limit_s=COMPILE_LIMIT_S)
    del flagship

    def bound_keys(b):
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "bound_bytes": b["bytes"], "bound_operations": b["flops"]}

    def sums_keys(step, key, kernel):
        # a material or instance variant's sums: its first design against
        # the redesign (the default) over the step's 3 launches in the
        # order first, redesign, redesign, first (per level: the primary
        # rays first), the step's launches by sums' design, ptxas of the
        # redesign beside the default instantiation's
        held = step["held"][key]
        return {
            "first_design_ms": sum(held["first_design_ms"]),
            "redesign_beside_first_ms": sum(held["redesign_beside_first_ms"]),
            "per_launch_first_design_ms": held["first_design_ms"],
            "per_launch_redesign_beside_first_ms":
            held["redesign_beside_first_ms"],
            "launches_by_design": {
                d: step["designs"][f"surface_bwd sums {d}"]
                for d in ("warp", "first")},
            "ptxas_redesign": ptxas.get(kernel),
            "ptxas_default_instantiation": ptxas.get(
                "surface_bwd_merged_kernel")}

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
            "library_cases_ms": sum(r["ms"] for r in with_lib),
            **({"old_design_ms": sum(r["old_ms"] for r in rows),
                "by_case": {r["name"]: {"ms": r["ms"], "old_design_ms":
                                        r["old_ms"],
                                        "library_ms": r["library_ms"],
                                        "bound_ms": r["bound_ms"]}
                            for r in rows}}
               if name == "GP-C" else {})})
    scene_all = {tag: c["scene"] for tag, c in
                 (("interp", frame_counts), ("cube", cube_counts),
                  ("debug_overlay", overlay_counts),
                  ("fit_steps", fit_counts))}
    scene_all.update(engine_frames=eng_launches["scene"],
                     demo_cli=eng_launches["demo_scene"],
                     render_cli=eng_launches["render_scene"],
                     config3=c3_counts["scene"],
                     sharded_flagship=c5["sharded_launches"]["scene"],
                     dp_fit_steps=sf["dp_launches"]["scene"],
                     config7=c7["counts"]["scene"],
                     config4_fit_steps=c4["counts"]["scene"])
    eng_scene, eng_fused = eng["scene"], eng["fused"]

    def shade_paths(stage):
        return {"frames": frame_counts[stage] + cube_counts[stage]
                + overlay_counts[stage], "fit_steps": fit_counts[stage],
                "engine_frames": eng_launches[stage],
                "demo_cli": eng_launches[f"demo_{stage}"],
                "render_cli": eng_launches[f"render_{stage}"],
                "config3": c3_counts[stage],
                "config5": c5["launches"][stage],
                "sharded_flagship": c5["sharded_launches"][stage],
                "slab_fit_steps": sf["launches"][stage],
                "dp_fit_steps": sf["dp_launches"][stage],
                "config7": c7["counts"][stage],
                "config4_fit_steps": c4["counts"][stage]}

    def held_entry(box):
        # a path of phase 13 held launch by launch: its kernel time, plain
        # time and bound (the sums over the launches of one frame or step)
        ms = box["ms"] if isinstance(box["ms"], list) else [box["ms"]]
        plain = box["plain_ms"] if isinstance(box["plain_ms"], list) \
            else [box["plain_ms"]]
        return {"ms": sum(ms), "plain_ms": sum(plain), "per_launch_ms": ms,
                **({"old_design_ms": sum(box["old_ms"])}
                   if "old_ms" in box else {}), **bound_keys(box["bound"])}

    def config3_entry(launches, ms, plain_ms, bound):
        # config3's 1080p frame at 257^3: the three frames' launches, and
        # the held frame's per-launch times, plain times and bound
        return {"launches": launches, "ms": sum(ms),
                "plain_ms": sum(plain_ms), "per_launch_ms": ms,
                **bound_keys(bound)}
    _mark("the kernels' line")
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
         "old_design_ms": sum(scene_runs["interp"]["old_ms"]),
         "ptxas": {k: ptxas.get(k) for k in ("march_scene_capped_kernel",
                                              "march_scene_kernel")},
         "by_path": {t: {"ms": sum(g["ms"]), "plain_ms": sum(g["plain_ms"]),
                         "old_design_ms": sum(g["old_ms"]),
                         "per_launch_ms": g["ms"],
                         "per_launch_old_design_ms": g["old_ms"],
                         "simt_efficiency_launch_order": g["simt_flat"],
                         "simt_efficiency_8x4_tiles": g["simt_tiled"],
                         **bound_keys(g["bound"])}
                     for t, g in list(scene_runs.items())
                     + [("engine_frame", eng_scene),
                        ("config3", c3_held["scene"]),
                        ("config7", c7["held"]["scene"]),
                        ("config4_fit_step", c4["held"]["scene"])]},
         "config3": {**config3_entry(
             c3_counts["scene"], c3_held["scene"]["ms"],
             c3_held["scene"]["plain_ms"], c3_held["scene"]["bound"]),
             "capped_lanes_kernel_plain": c3_held["scene"]["capped"]}},
        {"name": "K7 slab march", "route": "cuda",
         "source": "vrt_torch/csrc/march.cu",
         "replaces": "vrt/dist/brick.py:153 (march_volume_slab, an XLA "
                     "while-loop: no Pallas kernel)",
         "launches": c5["launches"]["k7"] + sf["launches"]["k7"],
         "launches_by_path": {"config5": c5["launches"]["k7"],
                              "slab_fit_steps": sf["launches"]["k7"]},
         "max_abs_err": 0.0,
         "path": "the redesign (march_slab_capped_kernel over the slab's "
                 "planes); old_design_ms: the first design "
                 "(march_slab_kernel over the packed table), old, new, new, "
                 "old in the same call, equal field by field",
         # one 1080p frame's launches (primary and shadow) on each of the
         # 4 ranks, each rank timed alone; ms, plain_ms and the bound are
         # the sums over the ranks
         "ms": c5["k7"]["ms"], "per_rank_ms": c5["k7"]["per_rank_ms"],
         "old_design_ms": c5["k7"]["old_ms"],
         "per_rank_old_design_ms": c5["k7"]["per_rank_old_ms"],
         "plain_ms": c5["k7"]["plain_ms"],
         "per_rank_plain_ms": c5["k7"]["per_rank_plain_ms"],
         **bound_keys(c5["k7"]["bound"]), "library_ms": None,
         "ptxas": {k: ptxas.get(k) for k in ("march_slab_capped_kernel",
                                              "march_slab_kernel")}},
        {"name": "fused resolve", "route": "cuda",
         "source": "vrt_torch/csrc/resolve.cu",
         "replaces": "vrt/march/resolve.py:61 (resolve_hits under "
                     "vrt/render/renderer.py:210, XLA ops: no Pallas "
                     "kernel)",
         "launches": frame_counts["resolve"] + cube_counts["resolve"]
         + overlay_counts["resolve"] + fit_counts["resolve"]
         + eng_launches["resolve"] + eng_launches["demo_resolve"]
         + eng_launches["render_resolve"] + c3_counts["resolve"]
         + c5["launches"]["slab_resolve"]
         + c5["sharded_launches"]["resolve"]
         + sf["launches"]["slab_resolve"] + sf["dp_launches"]["resolve"]
         + c7["counts"]["resolve"] + c4["counts"]["resolve"],
         "launches_by_path": {"frames": frame_counts["resolve"]
                              + cube_counts["resolve"]
                              + overlay_counts["resolve"],
                              "fit_steps": fit_counts["resolve"],
                              "engine_frames": eng_launches["resolve"],
                              "demo_cli": eng_launches["demo_resolve"],
                              "render_cli": eng_launches["render_resolve"],
                              "config3": c3_counts["resolve"],
                              "config5": c5["launches"]["slab_resolve"],
                              "sharded_flagship":
                              c5["sharded_launches"]["resolve"],
                              "slab_fit_steps": sf["launches"]["slab_resolve"],
                              "dp_fit_steps": sf["dp_launches"]["resolve"],
                              "config7": c7["counts"]["resolve"],
                              "config4_fit_steps": c4["counts"]["resolve"]},
         "config7": held_entry(c7["held"]["fused"]),
         "config4_fit_step": held_entry(c4["held"]["fused"]),
         "max_abs_err": fused["max_abs_err"], "ms": fused["ms"],
         "plain_ms": fused["plain_ms"],
         "plain_over_k3_ms": fused["over_k3_ms"],
         **bound_keys(fused["bound"]), "library_ms": None,
         "path": "the redesign (resolve_lean_kernel); old_design_ms: "
                 "the first design (resolve_kernel), old, new, new, old in "
                 "the same call; every held launch bit-equal to it with "
                 "outputs filled with NaN first",
         "per_launch_ms": fused["per_launch_ms"],
         "old_design_ms": sum(fused["old_ms"]),
         "per_launch_old_design_ms": fused["old_ms"],
         "bit_equal_to_old_design": True,
         "ptxas": {k: ptxas.get(k) for k in ("resolve_lean_kernel",
                                              "resolve_kernel")},
         "fit_step": {"ms": fused_fit["ms"],
                      "old_design_ms": sum(fused_fit["old_ms"]),
                      "per_launch_ms": fused_fit["per_launch_ms"],
                      "plain_ms": fused_fit["plain_ms"],
                      "plain_over_k3_ms": fused_fit["over_k3_ms"],
                      **bound_keys(fused_fit["bound"])},
         "engine_frame": {"ms": eng_fused["ms"],
                          "old_design_ms": sum(eng_fused["old_ms"]),
                          "plain_ms": eng_fused["plain_ms"],
                          "plain_over_k3_ms": eng_fused["over_k3_ms"],
                          **bound_keys(eng_fused["bound"])},
         "config3": {**config3_entry(
             c3_counts["resolve"], [c3_held["fused"]["ms"]],
             [c3_held["fused"]["plain_ms"]], c3_held["fused"]["bound"]),
             "old_design_ms": sum(c3_held["fused"]["old_ms"]),
             "plain_over_k3_ms": c3_held["fused"]["over_k3_ms"]},
         # the slab's planes (x origin): one launch a rank a 1080p frame,
         # summed over the 4 ranks, each timed alone; the first design over
         # the planes old, new, new, old, the redesign over the packed
         # table beside them
         "config5": {"launches": c5["launches"]["slab_resolve"],
                     "ms": c5["resolve"]["ms"],
                     "old_design_ms": c5["resolve"]["old_ms"],
                     "packed_table_ms": c5["resolve"]["packed_ms"],
                     "plain_ms": c5["resolve"]["plain_ms"],
                     **bound_keys(c5["resolve"]["bound"])}},
        {"name": "fused resolve backward", "route": "cuda",
         "source": "vrt_torch/csrc/resolve.cu",
         "replaces": "vrt/march/resolve.py:61 (XLA's transpose of "
                     "resolve_hits and of its row gather, "
                     "vrt/march/isosurface.py:204: no Pallas kernel)",
         "launches": fit_counts["resolve_bwd"]
         + sf["launches"]["slab_resolve_bwd"]
         + sf["dp_launches"]["resolve_bwd"] + c4["counts"]["resolve_bwd"],
         "launches_by_path": {"fit_steps": fit_counts["resolve_bwd"],
                              "slab_fit_steps":
                              sf["launches"]["slab_resolve_bwd"],
                              "dp_fit_steps":
                              sf["dp_launches"]["resolve_bwd"],
                              "config4_fit_steps":
                              c4["counts"]["resolve_bwd"]},
         "config4_fit_step": held_entry(c4["held"]["resolve_bwd"]),
         "max_abs_err": max(bwd["max_abs_err"],
                            c4["held"]["resolve_bwd"]["max_abs_err"]),
         "max_ray_grad_err_over_max": bwd["ray_err"],
         "ms": sum(bwd["ms"]), "plain_ms": sum(bwd["plain_ms"]),
         **bound_keys(bwd["bound"]), "library_ms": None,
         "per_launch_ms": bwd["ms"],
         "old_design_ms": sum(bwd["old_ms"]),
         "per_launch_old_design_ms": bwd["old_ms"],
         # every compared launch is asserted bit-equal to the first design
         "ray_grads_bit_equal_to_old_design": True,
         "table_diff_to_old_design": bwd["table_diff"],
         "ptxas": {k: ptxas.get(k) for k in ("resolve_bwd_merged_kernel",
                                              "resolve_bwd_kernel")}},
        {"name": "fused resolve backward (slab)", "route": "cuda",
         "source": "vrt_torch/csrc/resolve.cu",
         "replaces": "vrt/dist/brick.py:329 (XLA's transpose of "
                     "resolve_slab_hits and its voxel fetch _slab_fetch "
                     ":115: no Pallas kernel)",
         "path": "the planes variant of the merged backward, into an f32 "
                 "gradient of one rank's planes (ResolveSlab over the "
                 "planes): config5's 513^3 slab fit step, one launch a rank "
                 "a step; old_design_ms: the first design (the kSlab "
                 "variant into the packed table's 1.1 GB accumulator), old, "
                 "new, new, old, with its table's pack and pack backward "
                 "beside it",
         "launches": sf["launches"]["slab_resolve_bwd"],
         "launches_by_path": {"slab_fit_steps":
                              sf["launches"]["slab_resolve_bwd"]},
         "max_abs_err": sf["bwd"]["max_abs_err"],
         "max_abs_err_is": "the planes' gradient against autograd of "
                           "resolve_slab_hits and the closed form in "
                           "float64, over their largest |g|",
         "max_ray_grad_err_over_max": sf["bwd"]["ray_err"],
         # one step's launch on each of the 4 ranks, each timed alone; the
         # sums over the ranks
         "ms": sf["bwd"]["ms"], "per_rank_ms": sf["bwd"]["per_rank_ms"],
         "plain_ms": sf["bwd"]["plain_ms"],
         "old_design_ms": sf["bwd"]["old_ms"],
         "per_rank_old_design_ms": sf["bwd"]["per_rank_old_ms"],
         "old_design_pack_ms": sf["bwd"]["pack_ms"],
         "old_design_pack_backward_ms": sf["bwd"]["pack_bwd_ms"],
         **bound_keys(sf["bwd"]["bound"]), "library_ms": None,
         "ptxas": ptxas.get("resolve_bwd_merged_kernel")},
        *({"name": f"K4 shade {stage}", "route": "cuda",
           "source": "vrt_torch/csrc/shade.cu",
           "replaces": replaces,
           "launches": sum(by.values()), "launches_by_path": by,
           "max_abs_err": max(g[stage]["max_abs_err"]
                              for g in list(shade_runs.values())
                              + [box["shade"]
                                 for box in eng["held"].values()]
                              + [c3_held["shade"], c7["held"]["shade"],
                                 c4["held"]["shade"]]),
           "tolerance": {"rtol": SHADE_RTOL, "atol": SHADE_ATOL,
                         "lanes_beyond": SHADE_FLOAT_BUDGET,
                         "boolean_flips": LANE_BUDGET},
           "lanes_beyond": max(g[stage]["lanes_beyond"]
                               for g in list(shade_runs.values())
                               + [box["shade"]
                                  for box in eng["held"].values()]
                               + [c3_held["shade"], c7["held"]["shade"],
                                  c4["held"]["shade"]]),
           "bit_equal_outputs": shade_runs["interp"][stage]["bit_equal"],
           "rounded_outputs": shade_runs["interp"][stage]["rounded"],
           "ms": sum(shade_runs["interp"][stage]["ms"]),
           "plain_ms": sum(shade_runs["interp"][stage]["plain_ms"]),
           **bound_keys(shade_runs["interp"][stage]["bound"]),
           "library_ms": None,
           "per_launch_ms": shade_runs["interp"][stage]["ms"],
           "old_design_ms": sum(shade_runs["interp"][stage]["old_ms"]),
           "per_launch_old_design_ms": shade_runs["interp"][stage]["old_ms"],
           # every compared launch is asserted bit-equal to the first design
           "bit_equal_to_old_design": True,
           "paths": {"frames": {p: frame_counts["paths"][f"{stage} {p}"]
                                + cube_counts["paths"][f"{stage} {p}"]
                                + overlay_counts["paths"][f"{stage} {p}"]
                                for p in ("v4", "scalar")},
                     "fit_steps": {p: fit_paths[f"{stage} {p}"]
                                   for p in ("v4", "scalar")},
                     **{t: g[stage]["paths"] for t, g in shade_runs.items()
                        if t.startswith("lights")}},
           "ptxas": {k: ptxas.get(k) for k in (
               f"{stage}_resident_kernel", f"{stage}_kernel")},
           "by_path": {t: {"ms": sum(g[stage]["ms"]),
                           "old_design_ms": sum(g[stage]["old_ms"]),
                           "per_launch_ms": g[stage]["ms"],
                           "per_launch_old_design_ms": g[stage]["old_ms"],
                           "plain_ms": sum(g[stage]["plain_ms"]),
                           **bound_keys(g[stage]["bound"])}
                       for t, g in list(shade_runs.items())
                       + [("engine_frame", eng["shade"]),
                          ("fit_step", fit_shade),
                          ("config3", c3_held["shade"]),
                          ("config7", c7["held"]["shade"]),
                          ("config4_fit_step", c4["held"]["shade"])]},
           "config3": config3_entry(
               c3_counts[stage], c3_held["shade"][stage]["ms"],
               c3_held["shade"][stage]["plain_ms"],
               c3_held["shade"][stage]["bound"])}
          for stage, replaces, by in (
              ("surface",
               "vrt/render/renderer.py:306 (_shade_lit's head with "
               "_per_ray_instance :182, _voxel_color_sample :229, "
               "_shade_unlit_mode :447, vrt/shade/texture.py:69, XLA-fused "
               "jnp: no Pallas kernel)", shade_paths("surface")),
              ("combine",
               "vrt/render/renderer.py:306 (_shade_lit's tail with the "
               "selects of trace_radiance :478, tonemap :607, "
               "vrt/shade/brdf.py:66, lights.py:8, texture.py:150, "
               "XLA-fused jnp: no Pallas kernel)", shade_paths("combine")))),
        *({"name": f"K4 shade {stage} backward", "route": "cuda",
           "source": "vrt_torch/csrc/shade.cu",
           "replaces": replaces,
           "launches": fit_counts[f"{stage}_bwd"]
           + sf["launches"][f"{stage}_bwd"]
           + sf["dp_launches"][f"{stage}_bwd"]
           + c4["counts"][f"{stage}_bwd"],
           "launches_by_path": {
               "config4_fit_steps": c4["counts"][f"{stage}_bwd"],
               "fit_steps": fit_counts[f"{stage}_bwd"],
               "slab_fit_steps": sf["launches"][f"{stage}_bwd"],
               "dp_fit_steps": sf["dp_launches"][f"{stage}_bwd"],
               "paired_fit_steps": plain_counts[f"{stage}_bwd"]
               + eager_counts[f"{stage}_bwd"],
               "fit_64x36": small_counts[f"{stage}_bwd"]},
           "max_abs_err": max(
               shade_bwd[f"{stage}_bwd"]["max_abs_err"],
               c4["held"]["shade_bwd"][f"{stage}_bwd"]["max_abs_err"]),
           "config4_fit_step": held_entry(
               c4["held"]["shade_bwd"][f"{stage}_bwd"]),
           "max_abs_err_is": "the largest difference of any output over "
                             "the launch's largest |plain| cotangent (the "
                             "colour table's over its own)",
           "by_output": shade_bwd[f"{stage}_bwd"]["by_output"],
           "tolerance": {"rtol": SHADE_GRAD_RTOL, "atol_of_max": SHADE_GRAD_ATOL,
                         "lanes_beyond": SHADE_GRAD_LANE_BUDGET,
                         "table_rtol_of_max": SCATTER_RTOL},
           "lanes_beyond": shade_bwd[f"{stage}_bwd"]["lanes_beyond"],
           "ms": sum(shade_bwd[f"{stage}_bwd"]["ms"]),
           "plain_ms": sum(shade_bwd[f"{stage}_bwd"]["plain_ms"]),
           **bound_keys(shade_bwd[f"{stage}_bwd"]["bound"]),
           "library_ms": None,
           "per_launch_ms": shade_bwd[f"{stage}_bwd"]["ms"],
           "old_design_ms": sum(shade_bwd[f"{stage}_bwd"]["old_ms"]),
           "per_launch_old_design_ms": shade_bwd[f"{stage}_bwd"]["old_ms"],
           **({"per_launch_ms_without_the_table":
               shade_bwd["surface_bwd"]["no_table_ms"],
               "per_ray_bit_equal_to_old_design":
               shade_bwd["surface_bwd"]["bit_equal_to_old"],
               "colour_rows": shade_bwd["surface_bwd"]["contention"],
               "ptxas": {k: ptxas.get(k) for k in (
                   "surface_bwd_merged_kernel", "surface_bwd_kernel")}}
              if stage == "surface" else {
               "path": "the redesign (combine_bwd_resident_kernel); "
                       "old_design_ms: the first design "
                       "(combine_bwd_kernel), old, new, new, old in the "
                       "same call; every held launch bit-equal to it on "
                       "all nine cotangents with outputs filled with NaN "
                       "first",
               "bit_equal_to_old_design": True,
               "paths": {"fit_step": shade_bwd["combine_bwd"]["paths"],
                         "config4_fit_step":
                         c4["held"]["shade_bwd"]["combine_bwd"]["paths"]},
               "ptxas": {k: ptxas.get(k) for k in (
                   "combine_bwd_resident_kernel", "combine_bwd_kernel")}})}
          for stage, replaces in (
              ("surface",
               "vrt/render/renderer.py:306 (XLA's transpose of _shade_lit's "
               "head, _voxel_color_sample :229 and its row gather, "
               "_shade_unlit_mode :447, vrt/shade/texture.py: no Pallas "
               "kernel)"),
              ("combine",
               "vrt/render/renderer.py:306 (XLA's transpose of _shade_lit's "
               "tail, the selects of trace_radiance :478, vrt/shade/brdf.py, "
               "lights.py, texture.py sample_env: no Pallas kernel)"))),
        *({"name": f"K4 shade {stage} (unpacked colours)", "route": "cuda",
           "source": "vrt_torch/csrc/shade.cu",
           "replaces": replaces,
           "launches": c4["counts"][stage],
           "launches_by_path": {"config4_fit_steps": c4["counts"][stage]},
           "max_abs_err": box["max_abs_err"],
           **held_entry(box), "library_ms": None, **extra}
          for stage, box, replaces, extra in (
              ("surface", c4["held"]["shade"]["surface"],
               "vrt/render/renderer.py:249 (_voxel_color_sample's unpacked "
               "branch under _shade_lit :306, XLA-fused jnp: no Pallas "
               "kernel)",
               {"path": "surface_voxels_kernel on the f32 voxel grid "
                        "(colour layout 2: 8 voxel rows a hit, the colours "
                        "above COLOR_CORNER_BUDGET_BYTES): config4's fit "
                        "step; old_design_ms: the resident "
                        "kernel (surface_resident_kernel, this layout's "
                        "kernel before), old, new, new, old in the same "
                        "call; first_design_ms: surface_kernel; every held "
                        "launch bit-equal to both with outputs filled with "
                        "NaN first",
                "first_design_ms": sum(
                    c4["held"]["shade"]["surface"]["first_ms"]),
                "per_launch_first_design_ms":
                    c4["held"]["shade"]["surface"]["first_ms"],
                "per_launch_old_design_ms":
                    c4["held"]["shade"]["surface"]["old_ms"],
                "bit_equal_to_old_design": True,
                "paths": c4["held"]["shade"]["surface"]["paths"],
                "ptxas": {k: ptxas.get(k) for k in (
                    "surface_voxels_kernel", "surface_resident_kernel",
                    "surface_kernel")}}),
              ("surface_bwd", c4["held"]["shade_bwd"]["surface_bwd"],
               "vrt/render/renderer.py:249 (XLA's transpose of "
               "_voxel_color_sample's unpacked branch, its 8 voxel gathers' "
               "scatter-add: no Pallas kernel)",
               {"path": "the surface backward on the f32 voxel grid "
                        "(colour layout 2): config4's fit step"}))),
        *({"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "path": path,
           "launches": launches,
           "launches_by_path": {"fit_steps": by_path[0],
                                "config4_fit_steps": by_path[1]},
           "max_abs_err": max(fit_pack[key]["max_abs_err"],
                              c4["held"]["pack"][key]["max_abs_err"]),
           "bit_equal_to_plain": fit_pack[key]["bit_equal"]
           and c4["held"]["pack"][key]["bit_equal"],
           # config4's launch, timed old, new, new, old against `old`
           "ms": c4["held"]["pack"][key]["ms"],
           "plain_ms": c4["held"]["pack"][key]["plain_ms"],
           "old_ms": c4["held"]["pack"][key]["old_ms"], "old": old,
           **bound_keys(c4["held"]["pack"][key]["bound"]),
           "library_ms": c4["held"]["pack"][key]["library_ms"],
           "shape": c4["held"]["pack"][key]["shape"],
           # the backward: the step's launches by the design the library
           # picked, and the tiled kernel's time, forced
           **({"designs": c4["held"]["pack"][key]["designs"],
               "tiled_ms": c4["held"]["pack"][key]["tiled_ms"]}
              if key == "pack_bwd" else {}),
           "config6_fit_step": {
               "ms": fit_pack[key]["ms"],
               "plain_ms": fit_pack[key]["plain_ms"],
               "old_ms": fit_pack[key]["old_ms"],
               "shape": fit_pack[key]["shape"],
               **({"designs": fit_pack[key]["designs"],
                   "tiled_ms": fit_pack[key]["tiled_ms"]}
                  if key == "pack_bwd" else {}),
               **bound_keys(fit_pack[key]["bound"])},
           "ptxas": ptxas.get(kernel),
           # the pyramid's first design timed by launch: its first alone
           **({"old_first_launch_ms": {
               "config4_fit_step": c4["held"]["pack"][key]["first_launch_ms"],
               "config6_fit_step": fit_pack[key]["first_launch_ms"]},
               "plain": "the plain pyramid (max-pools of the plain flags)"}
              if key == "pyramid" else {}),
           # the pyramid and the rebuild as one function, against what a
           # step ran before (eager build_accel and _accel_u8, the first
           # design's pack), old, new, new, old
           **({"with_pyramid": {
               side: {"ms": got["whole"]["ms"],
                      "old_ms": got["whole"]["old_ms"],
                      "plain_ms": got["whole"]["plain_ms"],
                      **bound_keys(got["whole"]["bound"])}
               for side, got in (("config4_fit_step", c4["held"]["pack"]),
                                 ("config6_fit_step", fit_pack))}}
              if key == "rebuild" else {})}
          for name, key, source, kernel, launches, by_path, old, path,
          replaces in (
              ("accel pyramid", "pyramid", "vrt_torch/csrc/accel.cu",
               "pyramid_one_kernel",
               fit_accel["pyramid"] + c4["accel"]["pyramid"],
               (fit_accel["pyramid"], c4["accel"]["pyramid"]),
               "its first design (pyramid_cells_kernel, pyramid_kernel: "
               "ceil(R / 3) launches)",
               "diff/fit.py::rebuild_accel -> kernels/accel.py::"
               "RebuildAccel: one launch a fit step (the first design: "
               "config6 2, config4 3); volume/accel.py::build_accel on CUDA "
               "tensors",
               "vrt/volume/accel.py:41-92 (cell_corner_signs_differ and "
               "build_skip_level's max-pools under build_accel, "
               "vrt/diff/fit.py:77 rebuild_accel: XLA-fused jnp, no Pallas "
               "kernel)"),
              ("accel rebuild", "rebuild", "vrt_torch/csrc/accel.cu",
               "rebuild_kernel",
               fit_accel["rebuild"] + c4["accel"]["rebuild"],
               (fit_accel["rebuild"], c4["accel"]["rebuild"]),
               "the first design's pack kernel (pack_corners_cuda)",
               "diff/fit.py::rebuild_accel -> RebuildAccel: once a fit "
               "step, the accel, its u8 view and the corner table (config6 "
               "f32 x 9, config4 bf16 x 8)",
               "vrt/volume/accel.py:41-92 (build_skip_level's repeats and "
               "the pack of build_accel), vrt/march/types.py:25 "
               "pack_cell_corners and the u8 view of the march, under "
               "vrt/diff/fit.py:77 rebuild_accel (XLA-fused: no Pallas "
               "kernel)"),
              ("corner pack", "pack", "vrt_torch/csrc/pack.cu",
               "pack_kernel", fit_packs["pack"] + c4["packs"]["pack"],
               (fit_packs["pack"], c4["packs"]["pack"]),
               "the torch pack (its plain version)",
               "march/types.py::pack_cell_corners -> PackCorners on CUDA "
               "tensors (graft_params with repack; a table with a given "
               "accel): the first design of the fit step's pack, 0 "
               "launches on the fit step since the accel rebuild",
               "vrt/march/types.py:25 (pack_cell_corners under "
               "vrt/diff/fit.py:77 rebuild_accel and :31 graft_params, "
               "XLA-fused slices and a stack: no Pallas kernel)"),
              ("corner pack backward", "pack_bwd", "vrt_torch/csrc/pack.cu",
               "pack_bwd_tiled_kernel",
               fit_packs["pack_bwd"] + c4["packs"]["pack_bwd"],
               (fit_packs["pack_bwd"], c4["packs"]["pack_bwd"]),
               "its first design (pack_bwd_kernel)",
               "RebuildAccel's and PackCorners' backward: once a fit step, "
               "the tiled kernel where its grid fills the card (config4), "
               "the first design below (config6)",
               "vrt/march/types.py:25 (XLA's transpose of "
               "pack_cell_corners' slices under jax.value_and_grad of the "
               "fit step: no Pallas kernel)"))),
        *({"name": name, "route": "cuda",
           "source": "vrt_torch/csrc/shade.cu",
           "replaces": replaces,
           "path": path,
           # the variant's launches in phase 8's one material-and-light
           # step on the kernels, counted from 0 just before it
           "launches": mat_step["launches"][key],
           "launches_by_path": {
               "config6_material_light_step": mat_step["launches"][key]},
           "max_abs_err": max(mat_step["held"][key]["max_abs_err"],
                              *(r[key]["max_abs_err"]
                                for r in variant_runs.values())),
           "max_abs_err_is": "the largest difference of any per-ray output "
                             "over the launch's largest |plain| cotangent, "
                             "or of a table over its largest |plain sum| "
                             "(summed in float64)",
           "by_output": mat_step["held"][key]["by_output"],
           "tolerance": {"rtol": SHADE_GRAD_RTOL,
                         "atol_of_max": SHADE_GRAD_ATOL,
                         "lanes_beyond": SHADE_GRAD_LANE_BUDGET,
                         "table_rtol_of_its_abs_terms": SCATTER_RTOL,
                         "table_atol": TABLE_ATOL,
                         "step_table_rtol_of_max": SCATTER_RTOL},
           # config6's 1080p material-and-light step, its three launches
           "ms": sum(mat_step["held"][key]["ms"]),
           "per_launch_ms": mat_step["held"][key]["ms"],
           "default_instantiation_ms": sum(mat_step["held"][key]
                                           ["default_ms"]),
           "plain_ms": sum(mat_step["held"][key]["plain_ms"]),
           **bound_keys(mat_step["held"][key]["bound"]),
           "library_ms": None,
           "by_path": {f"480x270_{t}": {
               "ms": sum(r[key]["ms"]),
               "default_instantiation_ms": sum(r[key]["default_ms"]),
               "plain_ms": sum(r[key]["plain_ms"]),
               **({"first_design_ms": sum(r[key]["first_design_ms"]),
                   "redesign_beside_first_ms": sum(
                       r[key]["redesign_beside_first_ms"])}
                  if r[key]["first_design_ms"] else {}),
               **bound_keys(r[key]["bound"])}
               for t, r in variant_runs.items()},
           **(sums_keys(mat_step, key, "surface_bwd_sums_kernel material")
              if key == "surface_bwd material" else {}),
           "ptxas": {k: ptxas.get(f"{k} variant") for k in kernels}}
          for name, key, kernels, path, replaces in (
              ("K4 shade surface backward (material variant)",
               "surface_bwd material",
               ("surface_bwd_merged_kernel", "surface_bwd_kernel"),
               "ShadeSurface's backward where a material constant (tint, "
               "roughness, metallic, k) needs a gradient: "
               "shade_surface_backward_cuda(..., material=True): without "
               "the texture variant surface_bwd_sums_kernel (the sums' "
               "redesign: a hit lane's staged values, its cotangents formed "
               "after its code and summed over the warp into a warp's "
               "partial sums, one atomic a block a word); first_design_ms: "
               "the merged kernel's kMat instantiation, behind "
               "_old_sums_design",
               "vrt/render/renderer.py:340-360 (XLA's transpose of "
               "_shade_lit's material reads in the tint, roughness, "
               "metallic and k under jax.value_and_grad of the fit step: "
               "no Pallas kernel)"),
              ("K4 shade combine backward (light variant)",
               "combine_bwd lights",
               ("combine_bwd_resident_kernel", "combine_bwd_kernel"),
               "ShadeCombine's backward where the record's k or a light "
               "table needs a gradient: shade_combine_backward_cuda(..., "
               "lights=True), the resident kernel's kGrad instantiation",
               "vrt/render/renderer.py:395-440 (XLA's transpose of "
               "_shade_lit's lights, vrt/shade/brdf.py:32-66 and "
               "vrt/shade/lights.py:8-17, in the lights and k under "
               "jax.value_and_grad of the fit step: no Pallas kernel)"))),
        *({"name": name, "route": "cuda",
           "source": "vrt_torch/csrc/shade.cu",
           "replaces": replaces,
           "path": path,
           # the variant's launches in phase 8's one texture-and-env step
           # on the kernels, counted from 0 just before it (each a launch
           # of both this variant and the material or light variant)
           "launches": tex_step["launches"][f"{alone} shared"]
           + tex_step["launches"][f"{alone} global"],
           "launches_by_path": {
               "texture_and_env_step_shared":
               tex_step["launches"][f"{alone} shared"],
               "texture_and_env_step_global":
               tex_step["launches"][f"{alone} global"]},
           "launches_by_design": {
               d: tex_step["designs"][f"{alone} {d}"]
               for d in ("warp", "first")},
           "max_abs_err": max(tex_step["held"][key]["max_abs_err"],
                              *(r[alone]["max_abs_err"]
                                for r in table_runs.values())),
           "max_abs_err_is": "the largest difference of any per-ray output "
                             "over the launch's largest |plain| cotangent, "
                             "or of a table over its largest |plain sum| "
                             "(summed in float64)",
           "by_output": tex_step["held"][key]["by_output"],
           "tolerance": {"rtol": SHADE_GRAD_RTOL,
                         "atol_of_max": SHADE_GRAD_ATOL,
                         "lanes_beyond": SHADE_GRAD_LANE_BUDGET,
                         "table_rtol_of_its_abs_terms": SCATTER_RTOL,
                         "table_atol": TABLE_ATOL,
                         "step_table_rtol_of_max": SCATTER_RTOL},
           # the 1080p texture-and-env step, its three launches (with the
           # material or light variant in the same launch)
           "ms": sum(tex_step["held"][key]["ms"]),
           "per_launch_ms": tex_step["held"][key]["ms"],
           "default_instantiation_ms": sum(tex_step["held"][key]
                                           ["default_ms"]),
           "plain_ms": sum(tex_step["held"][key]["plain_ms"]),
           **bound_keys(tex_step["held"][key]["bound"]),
           "library_ms": None,
           # its first design on the same inputs, first design, redesign,
           # redesign, first design: the three launches' sums
           "old_design_ms": sum(tex_step["held"][key]["first_design_ms"]),
           "redesign_beside_old_ms": sum(
               tex_step["held"][key]["redesign_beside_first_ms"]),
           "per_launch_old_design_ms":
           tex_step["held"][key]["first_design_ms"],
           "step_on_old_designs_ms":
           tex_step["routes"]["first_table_designs"],
           "step_on_redesigns_ms":
           tex_step["routes"]["kernels_beside_first"],
           "by_path": {f"480x270_{p}_alone": {
               "ms": sum(r[alone]["ms"]),
               "default_instantiation_ms": sum(r[alone]["default_ms"]),
               "old_design_ms": sum(r[alone]["first_design_ms"]),
               "redesign_beside_old_ms": sum(
                   r[alone]["redesign_beside_first_ms"]),
               "plain_ms": sum(r[alone]["plain_ms"]),
               **bound_keys(r[alone]["bound"])}
               for p, r in table_runs.items()},
           "ptxas": {k: ptxas.get(k) for k in (
               kernel, f"{kernel} variant", first, f"{first} variant")}}
          for name, key, alone, kernel, first, path, replaces in (
              ("K4 shade surface backward (texture variant)",
               "surface_bwd material+textures", "surface_bwd textures",
               "surface_bwd_textures_warp_kernel",
               "surface_bwd_textures_kernel",
               "ShadeSurface's backward where the texture scale or the "
               "textures need a gradient: shade_surface_backward_cuda(..., "
               "textures=True), surface_bwd_textures_warp_kernel (the "
               "redesign: the merged kernel's body with kTex and kStaged, "
               "a hit lane's taps staged and summed over the warp after "
               "the lanes' code; kMat with the material variant); "
               "old_design_ms: its first design, surface_bwd_textures_"
               "kernel (each tap merged inside the lanes' code), behind "
               "_old_table_design; the textures' sums in shared memory "
               "where the stack fits TEXTURE_SHARED_BYTES, else f32 "
               "atomics",
               "vrt/render/renderer.py:346-356 and :459-461 (XLA's "
               "transpose of _shade_lit's and _shade_unlit_mode's texture "
               "samples, vrt/shade/texture.py:25-103, in tex_scale and the "
               "textures under jax.value_and_grad of the fit step: no "
               "Pallas kernel)"),
              ("K4 shade combine backward (env variant)",
               "combine_bwd lights+env", "combine_bwd env",
               "combine_bwd_env_warp_kernel", "combine_bwd_env_kernel",
               "ShadeCombine's backward where the env needs a gradient: "
               "shade_combine_backward_cuda(..., env=True), "
               "combine_bwd_env_warp_kernel (the redesign: the resident "
               "kernel's body with kEnv and kWarpTaps, a warp's miss "
               "lanes' four taps summed over the warp at once; kGrad with "
               "the light variant); old_design_ms: its first design, "
               "combine_bwd_env_kernel, behind _old_table_design; the "
               "cube's sums in shared memory where it fits "
               "ENV_SHARED_BYTES, else f32 atomics",
               "vrt/render/renderer.py:528 (XLA's transpose of the miss "
               "lanes' sample_env, vrt/shade/texture.py:106-152, in the env "
               "under jax.value_and_grad of the fit step: no Pallas "
               "kernel)"))),
        *({"name": name, "route": "cuda", "source": source,
           "replaces": replaces,
           "path": path,
           # the variant's launches in phase 8's one pose step on the
           # kernels, counted from 0 just before it
           "launches": pose_step["launches"][key],
           "launches_by_path": {
               "config6_pose_step": pose_step["launches"][key]},
           "max_abs_err": max(pose_step["held"][key]["max_abs_err"],
                              *(r[key]["max_abs_err"]
                                for r in instance_runs.values())),
           "max_abs_err_is": "the largest difference of any per-ray output "
                             "over the launch's largest |plain| cotangent, "
                             "of the colour or corner table over its "
                             "largest |plain sum|, or of a transform over "
                             "its largest |plain sum| (summed in float64)",
           "by_output": pose_step["held"][key]["by_output"],
           "tolerance": {"rtol": SHADE_GRAD_RTOL,
                         "atol_of_max": SHADE_GRAD_ATOL,
                         "lanes_beyond": SHADE_GRAD_LANE_BUDGET,
                         "ray_rtol_of_max": RAY_GRAD_RTOL,
                         "table_rtol_of_max": SCATTER_RTOL,
                         "transform_rtol_of_its_abs_terms": SCATTER_RTOL,
                         "transform_atol": TABLE_ATOL},
           # config6's 1080p pose step, its three launches
           "ms": sum(pose_step["held"][key]["ms"]),
           "per_launch_ms": pose_step["held"][key]["ms"],
           "default_instantiation_ms": sum(pose_step["held"][key]
                                           ["default_ms"]),
           "plain_ms": sum(pose_step["held"][key]["plain_ms"]),
           **bound_keys(pose_step["held"][key]["bound"]),
           "library_ms": None,
           "by_path": {t: {
               "ms": sum(r[key]["ms"]),
               "default_instantiation_ms": sum(r[key]["default_ms"]),
               "default_launches": r[key]["default_launches"],
               "plain_ms": sum(r[key]["plain_ms"]),
               **({"first_design_ms": sum(r[key]["first_design_ms"]),
                   "redesign_beside_first_ms": sum(
                       r[key]["redesign_beside_first_ms"])}
                  if r[key]["first_design_ms"] else {}),
               **bound_keys(r[key]["bound"])}
               for t, r in instance_runs.items()},
           **(sums_keys(pose_step, key, "surface_bwd_sums_kernel instances")
              if key == "surface_bwd instances" else {}),
           "ptxas": {kernel: ptxas.get(kernel)}}
          for name, key, source, kernel, path, replaces in (
              ("K4 shade surface backward (instance variant)",
               "surface_bwd instances", "vrt_torch/csrc/shade.cu",
               "surface_bwd_instances_kernel",
               "ShadeSurface's backward where an instance transform (pos, "
               "rot, scale) needs a gradient: shade_surface_backward_cuda("
               "..., instances=True), surface_bwd_sums_kernel (the sums' "
               "redesign, the merged kernel's body with kInst and "
               "kWarpSums; kMat and kTex in the same launch where asked): a "
               "hit lane stages what its transform cotangents follow from "
               "at the textures' hit point, the colour sample's ray and the "
               "world normal, an epilogue forms them after its code, the "
               "warp sums them by a butterfly (a segmented merge where its "
               "lanes name several instances) into a warp's partial sums, "
               "one atomic a block a word; first_design_ms: "
               "surface_bwd_instances_kernel (each lane's cotangents "
               "carried through its code, merged by instance, shared "
               "atomics), behind _old_sums_design",
               "vrt/render/renderer.py:62-75 (XLA's transpose of "
               "_world_to_object and _object_normal_to_world in "
               "_shade_lit :306-366, _voxel_color_sample :229-232 and "
               "_shade_unlit_mode :457, through _per_ray_instance's gather "
               ":182, in inst_pos, inst_rot, inst_scale under "
               "jax.value_and_grad of the fit step: no Pallas kernel)"),
              ("fused resolve backward (instance variant)",
               "resolve_bwd instances", "vrt_torch/csrc/resolve.cu",
               "resolve_bwd_instances_kernel",
               "ResolveScene's backward where an instance transform needs a "
               "gradient: resolve_scene_backward_cuda(..., instances=True), "
               "resolve_bwd_instances_kernel (resolve_bwd_merged_kernel's "
               "rounds with kInst on a scene's packed f32 or bf16 table): a "
               "carrying lane's transform cotangents from its object-space "
               "ray's, a warp's lanes merged by instance, a block's partial "
               "sums in shared memory, one atomic a block a word",
               "vrt/render/renderer.py:62-69 and :210-219 (XLA's transpose "
               "of _world_to_object under resolve_scene, through "
               "_per_ray_instance's gather :182, in inst_pos, inst_rot, "
               "inst_scale under jax.value_and_grad of the fit step: no "
               "Pallas kernel)"))),
        {"name": "Adam update", "route": "cuda",
         "source": "vrt_torch/csrc/optim.cu",
         "replaces": "vrt/diff/fit.py:168-169 and :217-226 "
                     "(optimizer.update, optax's scale_by_adam and "
                     "scale(-lr), and optax.apply_updates inside the jitted "
                     "fit steps, XLA-fused elementwise: no Pallas kernel)",
         "path": "diff/optim.py::Adam.apply (Adam.update: the variant that "
                 "writes u) on CUDA tensors: one launch a fit step over its "
                 "leaves in make_fit_step, make_fit_step_view, the DP step "
                 "and both slab steps",
         "launches": fit_adam["apply"] + c4["adam"]["apply"]
         + sf["launches"]["adam"] + sf["dp_launches"]["adam"]
         + sf["adam"]["crossed_launches"],
         "launches_by_path": {"fit_steps": fit_adam["apply"],
                              "config4_fit_steps": c4["adam"]["apply"],
                              "slab_fit_steps": sf["launches"]["adam"],
                              "dp_fit_steps": sf["dp_launches"]["adam"],
                              "crossed_slab_fit_step":
                              sf["adam"]["crossed_launches"]},
         "max_abs_err": max(c4["held"]["adam"]["max_abs_err"],
                            fit_adam_held["max_abs_err"],
                            sf["adam"]["max_abs_err"]),
         "bit_equal_to_plain": True,
         # config4's launch, timed plain, new, new, plain
         "ms": c4["held"]["adam"]["ms"],
         "plain_ms": c4["held"]["adam"]["plain_ms"],
         "old_ms": c4["held"]["adam"]["plain_ms"],
         "old": "its plain version (the eager arithmetic)",
         **bound_keys(c4["held"]["adam"]["bound"]),
         "library_ms": c4["held"]["adam"]["library_ms"],
         "library": "torch.optim.Adam(fused=True).step(), not bit-equal",
         "shape": c4["held"]["adam"]["shape"],
         "config6_fit_step": {"ms": fit_adam_held["ms"],
                              "plain_ms": fit_adam_held["plain_ms"],
                              "library_ms": fit_adam_held["library_ms"],
                              "shape": fit_adam_held["shape"],
                              **bound_keys(fit_adam_held["bound"])},
         "slab_fit_step_planes": {"ms": sf["adam"]["ms"],
                                  "per_rank_ms": sf["adam"]["per_rank_ms"],
                                  "plain_ms": sf["adam"]["plain_ms"],
                                  "library_ms": sf["adam"]["library_ms"],
                                  "shape": sf["adam"]["shape"],
                                  **bound_keys(sf["adam"]["bound"])},
         "ptxas": ptxas.get("adam_kernel")},
        {"name": "K3 gather", "route": "cuda",
         "source": "vrt_torch/csrc/rows.cu",
         "replaces": "vrt/march/isosurface.py:181 (take_rows, an XLA "
                     "gather: no Pallas kernel)",
         "path": "the colour rows of a fit step with eager shading, the "
                 "corner rows of resolve on the plain path: 0 launches on "
                 "the default frame and fit step",
         "launches": old_counts["gather"] + plain_counts["gather"]
         + eager_counts["gather"],
         "launches_by_path": {"fit_steps": fit_counts["gather"],
                              "candidate_loop_frames":
                              old_counts["gather"],
                              "plain_resolve_fit_steps":
                              plain_counts["gather"],
                              "eager_shading_fit_steps":
                              eager_counts["gather"]},
         "max_abs_err": 0.0, "ms": k3_fit["gather"]["ms"],
         "plain_ms": k3_fit["gather"]["plain_ms"],
         **bound_keys(k3_fit["gather"]["bound"]),
         "library_ms": k3_fit["gather"]["library_ms"],
         "frame": {"ms": k3_frame["gather"]["ms"],
                   "plain_ms": k3_frame["gather"]["plain_ms"],
                   "library_ms": k3_frame["gather"]["library_ms"],
                   **bound_keys(k3_frame["gather"]["bound"])},
         "plain_resolve_step": {
             "ms": k3_plain["gather"]["ms"],
             "plain_ms": k3_plain["gather"]["plain_ms"],
             "library_ms": k3_plain["gather"]["library_ms"],
             **bound_keys(k3_plain["gather"]["bound"])}},
        {"name": "K3 scatter (v4)", "route": "cuda",
         "source": "vrt_torch/csrc/rows.cu",
         "replaces": "vrt/march/isosurface.py:204 (_take_rows_bwd, an XLA "
                     "scatter-add: no Pallas kernel)",
         "path": "16-byte vector reductions: the colour rows of a fit step "
                 "with eager shading (0 launches on the default step)",
         "launches": eager_counts["scatter_v4"],
         "max_abs_err": k3_fit["scatter"]["max_abs_err"],
         "ms": k3_fit["scatter"]["ms"],
         "plain_ms": k3_fit["scatter"]["plain_ms"],
         **bound_keys(k3_fit["scatter"]["bound"]),
         "library_ms": k3_fit["scatter"]["library_ms"]},
        {"name": "K3 scatter (scalar)", "route": "cuda",
         "source": "vrt_torch/csrc/rows.cu",
         "replaces": "vrt/march/isosurface.py:204 (_take_rows_bwd, an XLA "
                     "scatter-add: no Pallas kernel)",
         "path": "one f32 atomic per element: the 9-channel corner rows of "
                 "a fit step with resolve on the plain path (0 launches on "
                 "the default step); ms, plain_ms, bound and library_ms are "
                 "of the eager-shading step's colour-row scatters forced "
                 "onto this path",
         "launches": plain_counts["scatter_scalar"],
         "max_abs_err": max(k3_fit["scatter_scalar"]["max_abs_err"],
                            k3_plain["scatter_scalar"]["max_abs_err"]),
         "ms": k3_fit["scatter_scalar"]["ms"],
         "plain_ms": k3_fit["scatter_scalar"]["plain_ms"],
         **bound_keys(k3_fit["scatter_scalar"]["bound"]),
         "library_ms": k3_fit["scatter_scalar"]["library_ms"],
         "plain_resolve_step": {
             "ms": k3_plain["scatter"]["ms"],
             "plain_ms": k3_plain["scatter"]["plain_ms"],
             "library_ms": k3_plain["scatter"]["library_ms"],
             **bound_keys(k3_plain["scatter"]["bound"])}}] + gp,
        "paired_ms_old_new_new_old": paired,
        "frame_device_ops": frame_ops,
        "eager_frame_as_cuda_graph_ms": graph_ms,
        "plain_stages_under_torch_compile": compiled,
        "config6_step_old_new": sides,
        "config6_material_light_step": {k: mat_step[k] for k in (
            "routes", "launches", "grads", "loss", "plain_loss")},
        "texture_and_env_step": {k: tex_step[k] for k in (
            "routes", "launches", "designs", "grads", "loss",
            "plain_loss")},
        "config6_pose_step": {k: pose_step[k] for k in (
            "routes", "launches", "grads", "loss", "plain_loss")},
        "engine": eng["numbers"],
        "config3": c3["numbers"],
        "config5": c5["numbers"],
        "slabfit": sf["numbers"],
        "bench_app": app,
        "config7": c7["numbers"],
        "config4": c4["numbers"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
