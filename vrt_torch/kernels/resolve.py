"""The fused resolve, forward and backward: build, bind and launch
``vrt_torch/csrc/resolve.cu``.

    resolve_scene_cuda(scene, o_w, d_w, hit, inst)
        -> (t f32 [R], object-space normal f32 [R,3], unlit bool [R])
    resolve_scene_backward_cuda(scene, o_w, d_w, hit, inst, g_t, g_normal)
        -> (g_o_w f32 [R,3], g_d_w f32 [R,3], g_corners f32 [V*C^3, ch])
        (instances=True: and of inst_pos, inst_rot, inst_scale)
    ResolveScene.apply(o_w, d_w, corners, inst_pos, inst_rot, inst_scale,
                       scene, hit, inst)
        -> (t, normal, unlit), differentiable in o_w, d_w, corners and the
           instance transforms
    resolve_slab_cuda(scene, slab, o_w, d_w, hit, inst)
    resolve_slab_backward_cuda(scene, slab, o_w, d_w, hit, inst, g_t,
                               g_normal)
        -> (g_o_w, g_d_w, g_planes f32 [span, N, N]; the first design's
            g_corners f32 [cx*C*C, 8])
    ResolveSlab.apply(o_w, d_w, slab.resolve_table, scene, slab, hit, inst)
        -> (t, normal, unlit), differentiable in o_w, d_w and the slab's
           planes (the first design: its packed corner table)

Forward: the kernel computes what
``vrt_torch.render.renderer.resolve_scene_reference`` (its plain version)
computes; the [R,7,8] corner rows of the plain version never reach device
memory.  Its redesign, the default: one thread a ray, a lane's kind, t and
face normal loaded at once (one round trip for a lane without a hit, where
the first design took two), a hit lane's ray, instance and cell at once
after them, the registers capped so that more warps fill the card.  Its
first design (private ``_old_design``) stays as ``chip_smoke.py``'s
comparator; the two are bit-equal on every lane.
Backward: one thread per ray computes what
``renderer.resolve_scene_backward_reference`` (its plain version, the
closed form of ``march.resolve.resolve_hits_backward``) computes, from the
rays, the hit's kind, t and cell and the two cotangents: it re-reads the 7
rows on surface lanes and keeps every intermediate in registers; the lanes
of a warp that hit one cell sum their corner cotangents (a shuffle tree)
before one of them adds them into an f32 accumulator with 16-byte
reductions (its rows 16 bytes wide: ``accumulator``).  Built with
``--fmad=false`` like K1, so the forward rounds as eager PyTorch does and
equals its plain version bit for bit; the backward sums in another order
than autograd and its reductions in an order that changes from run to
run, so it agrees with its plain version to rounding.  Its first design
(one scalar atomic a channel, private ``_old_design``) stays as
``chip_smoke.py``'s comparator; the two give bit-equal ray gradients.

The backward's instance variant (``resolve_bwd_instances_kernel``, the
merged kernel's rounds with ``kInst``; packed f32 and bf16 tables) also
returns the cotangents of the instance transforms: each lane's from the
object-space cotangents of its ray, the lanes of a warp on one instance
summed first, a block's partial sums in shared memory, one f32 atomic a
block a word into an f32 [I,10] accumulator (pos 3, rot 4, scale 3).  The
wrapper launches it only where a transform needs a gradient; every other
launch is the default instantiation, whose code is as it was.

``ResolveScene`` is what ``renderer.resolve_scene`` calls.  On CUDA tensors
its forward and backward are the two kernels; on CPU tensors, and only
there, their plain versions.

``ResolveSlab`` is the same pair over one rank's slab of a slab-sharded
volume (``vrt_torch.dist.brick``).  By default (``slab.table ==
"planes"``) the kernels read the slab's voxel planes, a cell's 8 corners
voxel by voxel (a voxel outside the volume or the planes reads 0), and the
backward's merged kernel adds the corner cotangents into an f32 gradient of
the planes' shape that the wrapper zeroes: the planes are the Function's
differentiable input and no table exists.  The first design (``"packed"``)
reads the slab's packed f32 table of cx x-rows, row x holding global cell
``x_voxel0 + x``, through the slab's variants of both backward designs,
which skip a cell outside those rows as the forward reads zeros there; its
table's gradient reaches the planes by autograd through the pack
(``brick._pack_slab_corners``, eight strided slices).  On CPU tensors:
``brick.resolve_slab_hits`` forward and the closed form
``brick.resolve_slab_backward_reference`` of the slab's table.

``LAUNCHES`` counts the launches of each kernel; ``SLAB_LAUNCHES`` the
launches over a slab's table (``resolve_slab_cuda`` and
``resolve_slab_backward_cuda``), and ``VARIANT_LAUNCHES`` the backward
launches of the instance variant, which ``LAUNCHES`` counts too.
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels.march import MAX_INSTANCES
from vrt_torch.kernels.march import _check as _check_tensor
from vrt_torch.kernels.march import _stream
from vrt_torch.march.types import MarchHit

LAUNCHES = {"forward": 0, "backward": 0}
SLAB_LAUNCHES = {"forward": 0, "backward": 0}
VARIANT_LAUNCHES = {"backward instances": 0}
# the words of one instance's cotangents in the instance variants'
# accumulators (csrc/scene.cuh kInstanceWords: pos 3, rot 4, scale 3); a
# block sums those of up to the scene march's MAX_INSTANCES in shared
# memory (csrc/resolve.cu kMaxInstanceGrads)
INSTANCE_WORDS = 10

NVCC_FLAGS = ["--fmad=false"]

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load the kernel.  Returns
    the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("resolve.cu", NVCC_FLAGS, headers=["scene.cuh"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vrt_resolve_scene.argtypes = ([ptr] * 11 + [i32] + [ptr] * 4
                                      + [i32] * 6 + [ctypes.c_longlong]
                                      + [ptr] * 3 + [i32] * 2 + [ptr])
    lib.vrt_resolve_scene.restype = i32
    lib.vrt_resolve_scene_bwd.argtypes = ([ptr] * 12 + [i32] + [ptr] * 4
                                          + [i32] * 6 + [ctypes.c_longlong]
                                          + [ptr] * 3 + [i32] * 3 + [ptr]
                                          + [ptr])
    lib.vrt_resolve_scene_bwd.restype = i32
    _lib = lib
    return log


def _check(x, name, dtype, shape, device):
    _check_tensor(x, name, dtype, shape, device, who="resolve")


def load_path(corners) -> str:
    """The kernel's load path for a corner table: "v16" (16-byte loads)
    where its rows and its base are 16-byte aligned, else "ldg" (one load
    per element)."""
    row_bytes = corners.shape[-1] * corners.element_size()
    aligned = row_bytes % 16 == 0 and corners.data_ptr() % 16 == 0
    return "v16" if aligned else "ldg"


def _empty(shape, dtype, dev):
    """An output of the forward kernel (a seam for the runs that fill it
    first, to show the lanes a design leaves unwritten)."""
    return torch.empty(shape, dtype=dtype, device=dev)


def _forward(o_w, d_w, hit: MarchHit, inst, table_args, x0, cx, planes,
             old_design, dev, who):
    """Allocate the forward's outputs and launch it (the redesign, or with
    ``old_design`` the first design): returns (t, normal, unlit)."""
    rays = o_w.shape[0]
    t = _empty((rays,), torch.float32, dev)
    normal = _empty((rays, 3), torch.float32, dev)
    unlit = _empty((rays,), torch.bool, dev)
    if rays == 0:
        return t, normal, unlit
    build()
    err = _lib.vrt_resolve_scene(
        o_w.data_ptr(), d_w.data_ptr(), inst.data_ptr(),
        hit.kind.data_ptr(), hit.t.data_ptr(), hit.cell.data_ptr(),
        hit.face_normal.data_ptr(), *table_args, x0, cx, rays, t.data_ptr(),
        normal.data_ptr(), unlit.data_ptr(), planes, int(not old_design),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"{who} launch failed: cudaError {err}")
    LAUNCHES["forward"] += 1
    return t, normal, unlit


def instance_table(scene, dev, check):
    """The scene's instance table as the kernels take it: ((volume i32 [I],
    pos [I,3], rot [I,4], scale [I,3]), I), each checked by ``check``.  A
    scene without instances, whose every ray is a miss, gets one identity
    instance of volume 0."""
    n_inst = scene.num_instances
    if n_inst == 0:
        return (torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros((1, 3), device=dev),
                torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev),
                torch.ones((1, 3), device=dev)), 1
    table = (scene.inst_volume, scene.inst_pos, scene.inst_rot,
             scene.inst_scale)
    check(table[0], "inst_volume", torch.int32, (n_inst,), dev)
    check(table[1], "inst_pos", torch.float32, (n_inst, 3), dev)
    check(table[2], "inst_rot", torch.float32, (n_inst, 4), dev)
    check(table[3], "inst_scale", torch.float32, (n_inst, 3), dev)
    return table, n_inst


def _check_inputs(scene, o_w, d_w, hit: MarchHit, inst, who):
    """Check what both kernels read; returns (device, rays, the instance
    table's four tensors and its length)."""
    if o_w.device.type != "cuda":
        raise ValueError(f"{who} runs on CUDA tensors, got {o_w.device}")
    dev = o_w.device
    rays = o_w.shape[0]
    _check(o_w, "o_w", torch.float32, (rays, 3), dev)
    _check(d_w, "d_w", torch.float32, (rays, 3), dev)
    _check(inst, "inst", torch.int32, (rays,), dev)
    _check(hit.kind, "hit.kind", torch.int32, (rays,), dev)
    _check(hit.t, "hit.t", torch.float32, (rays,), dev)
    _check(hit.cell, "hit.cell", torch.int32, (rays, 3), dev)
    vols = scene.volumes
    nv = vols.n.shape[0]
    cc = vols.corners.shape[1]
    ch = vols.corners.shape[-1]
    if ch not in (8, 9):
        raise ValueError(f"resolve takes 8 or 9 corner channels, got {ch}")
    if vols.corners.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resolve takes f32 or bf16 corners, got "
                         f"{vols.corners.dtype}")
    _check(vols.n, "n", torch.int32, (nv,), dev)
    _check(vols.cell_size, "cell_size", torch.float32, (nv,), dev)
    _check(vols.extends, "extends", torch.float32, (nv,), dev)
    _check(vols.corners, "corners", vols.corners.dtype,
           (nv, cc, cc, cc, ch), dev)
    table, n_inst = instance_table(scene, dev, _check)
    return dev, rays, table, n_inst


def _scene_args(scene, table, n_inst):
    """The instance table and the volume tables as both C functions take
    them."""
    vols = scene.volumes
    corners = vols.corners
    return (*(x.data_ptr() for x in table), n_inst, vols.n.data_ptr(),
            vols.cell_size.data_ptr(), vols.extends.data_ptr(),
            corners.data_ptr(), corners.shape[1], corners.shape[-1],
            int(corners.dtype == torch.bfloat16),
            int(load_path(corners) == "v16"))


def resolve_scene_cuda(scene, o_w, d_w, hit: MarchHit, inst,
                       _old_design: bool = False):
    """Launch the fused resolve on ``torch.cuda.current_stream()`` for the
    hits ``(hit, inst)`` of ``march_scene`` on world rays ``o_w``, ``d_w``
    against ``scene`` (a GPUScene).  Records no autograd graph
    (``ResolveScene`` adds it).  The kernel is the redesign (a lane's kind,
    t and face normal loaded at once, its ray, instance and cell at once
    after them where it has a hit, registers capped for occupancy); the
    private ``_old_design`` launches the first design, the comparator of the
    timing runs, bit-equal to it on every lane.  Raises on any input the
    kernel does not take; never falls back."""
    dev, rays, table, n_inst = _check_inputs(scene, o_w, d_w, hit, inst,
                                             "the fused resolve")
    _check(hit.face_normal, "hit.face_normal", torch.float32, (rays, 3), dev)
    args = _scene_args(scene, table, n_inst)
    return _forward(o_w, d_w, hit, inst, args, 0,
                    scene.volumes.corners.shape[1], 0, _old_design, dev,
                    "fused resolve")


def resolve_slab_cuda(scene, slab, o_w, d_w, hit: MarchHit, inst,
                      _old_design: bool = False):
    """Launch the fused resolve on ``torch.cuda.current_stream()`` for the
    combined hits of the slab march (``vrt_torch.dist.slab_render``): world
    rays through the transform of ``scene``'s one instance, the corner
    rows read from one rank's slab (a local
    ``vrt_torch.dist.brick.SlabVolume``): from its voxel planes
    (``march_tables["sdf"]``, plane x holding global plane ``x_voxel0 +
    x``), a voxel outside the volume or the planes reading 0; with
    ``slab.table == "packed"`` from its slab-local f32 table, whose row x
    is global cell ``x_voxel0 + x`` (a cell outside the volume or the rows
    reads zeros).  What ``vrt_torch.dist.brick.resolve_slab_hits`` computes
    on the lanes whose hit cell the slab owns (both tables equal there but
    on a cell with a voxel outside the volume); no graph.  The kernel is
    the redesign, ``_old_design`` the first design, as
    ``resolve_scene_cuda`` takes them.  Counted in ``LAUNCHES["forward"]``
    and ``SLAB_LAUNCHES["forward"]``.  Raises on any input the kernel does
    not take; never falls back."""
    dev, rays, table, n_inst, tb = _check_slab_inputs(
        scene, slab, o_w, d_w, hit, inst, "the slab's fused resolve")
    _check(hit.face_normal, "hit.face_normal", torch.float32, (rays, 3), dev)
    n, h, ext, _ = tb["volume"]
    corners, cc, ch, bf16, v16, x0, cx = _slab_table_args(slab)
    args = (*(x.data_ptr() for x in table), n_inst, n.data_ptr(),
            h.data_ptr(), ext.data_ptr(), corners, cc, ch, bf16, v16)
    out = _forward(o_w, d_w, hit, inst, args, x0, cx,
                   int(slab.table == "planes"), _old_design, dev,
                   "the slab's fused resolve")
    if rays:
        SLAB_LAUNCHES["forward"] += 1
    return out


def _check_slab_inputs(scene, slab, o_w, d_w, hit, inst, who):
    """What both slab kernels read, checked: (device, rays, the instance
    table with the slab as its volume 0, 1, the slab's ``march_tables``)."""
    dev, rays, table, n_inst = _check_inputs(scene, o_w, d_w, hit, inst, who)
    if n_inst != 1:
        raise ValueError(f"{who} takes a scene of one instance, got "
                         f"{n_inst}")
    tb = slab.march_tables
    span, nn = tb["sdf"].shape[0], tb["sdf"].shape[-1]
    _check(tb["sdf"], "slab planes", torch.float32, (span, nn, nn), dev)
    if slab.table == "packed":
        _check(tb["corners"], "slab corners", torch.float32,
               (span - 1, nn - 1, nn - 1, 8), dev)
    n, h, ext, volume0 = tb["volume"]
    for x, name, dtype in ((n, "n", torch.int32), (h, "cell_size",
                                                    torch.float32),
                           (ext, "extends", torch.float32),
                           (volume0, "instance volume", torch.int32)):
        _check(x, f"slab {name}", dtype, (1,), dev)
    # the instance's transform, with the slab as its volume 0
    return dev, rays, (volume0,) + tuple(table[1:]), n_inst, tb


def _slab_table_args(slab):
    """The slab's table as both C functions take it: (table, cc, ch, bf16,
    v16, x0, cx): the planes (cx their span) or the first design's packed
    rows."""
    tb = slab.march_tables
    if slab.table == "planes":
        planes = tb["sdf"]
        return (planes.data_ptr(), planes.shape[-1] - 1, 8, 0, 0, tb["x0"],
                planes.shape[0])
    corners = tb["corners"]
    return (corners.data_ptr(), corners.shape[1], 8, 0,
            int(load_path(corners) == "v16"), tb["x0"], corners.shape[0])


def accumulator(rows: int, ch: int, device):
    """The redesigned backward's f32 accumulator for a table of ``rows``
    rows of ``ch`` channels: (a zeroed [rows, w] buffer, w = ``ch``
    rounded up to a multiple of 4, and its [rows, ch] view).  Rows of 16
    bytes take the kernel's 16-byte reductions (8 channels: the buffer is
    the view; a 9-channel table's rows get 12 floats, the last 4 never
    written), and the view costs no copy."""
    width = -(-ch // 4) * 4
    buf = torch.zeros((rows, width), dtype=torch.float32, device=device)
    return buf, buf[:, :ch]


def instance_grads(acc):
    """The instance transforms' cotangents, (pos [I,3], rot [I,4], scale
    [I,3]) in ``INSTANCE_FIELDS`` order: views of the instance variant's f32
    [I, INSTANCE_WORDS] accumulator ``acc``."""
    return acc[:, :3], acc[:, 3:7], acc[:, 7:]


def resolve_scene_backward_cuda(scene, o_w, d_w, hit: MarchHit, inst, g_t,
                                g_normal, rays_grad: bool = True,
                                table_grad: bool = True,
                                _old_design: bool = False,
                                instances: bool = False):
    """Launch the fused resolve's backward on
    ``torch.cuda.current_stream()``: the cotangents ``g_t`` [R] and
    ``g_normal`` [R,3] of ``resolve_scene_cuda``'s t and normal, pulled
    back to the world rays and to the corner table (an f32 [V*C^3, ch]
    view of ``accumulator``'s buffer, zeroed here and added into by
    reductions; the caller casts it to the table's dtype).  Reads
    ``hit.kind``, ``hit.t`` and ``hit.cell`` only.  ``rays_grad=False`` /
    ``table_grad=False`` skip an output nobody needs and return None for
    it.  ``instances`` launches the instance variant, which returns three
    more: the cotangents of the instance transforms (``instance_grads``:
    pos [I,3], rot [I,4], scale [I,3], views of one f32 accumulator zeroed
    here), whatever ``rays_grad`` and ``table_grad`` say; a scene without
    instances gets empty ones and the default launch.  ``_old_design`` runs
    the first design (one scalar atomic a channel into a contiguous
    [V*C^3, ch] buffer), the comparator of ``chip_smoke.py``: no path of the
    port takes it; its ray gradients equal the redesign's bit for bit; it
    has no instance variant.  Raises on any input the kernel does not take;
    never falls back."""
    if instances and _old_design:
        raise ValueError("the fused resolve backward's first design has no "
                         "instance variant")
    dev, rays, table, n_inst = _check_inputs(scene, o_w, d_w, hit, inst,
                                             "the fused resolve's backward")
    _check(g_t, "g_t", torch.float32, (rays,), dev)
    _check(g_normal, "g_normal", torch.float32, (rays, 3), dev)
    corners = scene.volumes.corners
    ch = corners.shape[-1]
    g_o_w = g_d_w = acc = buf = None
    if rays_grad:
        g_o_w = torch.empty((rays, 3), dtype=torch.float32, device=dev)
        g_d_w = torch.empty((rays, 3), dtype=torch.float32, device=dev)
    if table_grad:
        if _old_design:
            buf = acc = torch.zeros((corners.numel() // ch, ch),
                                    dtype=torch.float32, device=dev)
        else:
            buf, acc = accumulator(corners.numel() // ch, ch, dev)
    extra, g_inst = (), None
    if instances:
        if n_inst > MAX_INSTANCES:
            raise ValueError(f"the fused resolve backward's instance variant "
                             f"takes up to {MAX_INSTANCES} instances, got "
                             f"{n_inst}")
        g_inst = torch.zeros((scene.num_instances, INSTANCE_WORDS),
                             dtype=torch.float32, device=dev)
        extra = instance_grads(g_inst)
        if scene.num_instances == 0:
            g_inst = None
    if rays == 0 or not (rays_grad or table_grad or g_inst is not None):
        return (g_o_w, g_d_w, acc) + extra
    build()
    err = _lib.vrt_resolve_scene_bwd(
        o_w.data_ptr(), d_w.data_ptr(), inst.data_ptr(),
        hit.kind.data_ptr(), hit.t.data_ptr(), hit.cell.data_ptr(),
        g_t.data_ptr(), g_normal.data_ptr(),
        *_scene_args(scene, table, n_inst), 0, corners.shape[1], rays,
        g_o_w.data_ptr() if rays_grad else None,
        g_d_w.data_ptr() if rays_grad else None,
        buf.data_ptr() if table_grad else None,
        buf.shape[1] if table_grad else 0, int(not _old_design), 0,
        _stream(dev), g_inst.data_ptr() if g_inst is not None else None)
    if err != 0:
        raise RuntimeError(f"fused resolve backward launch failed: "
                           f"cudaError {err}")
    LAUNCHES["backward"] += 1
    if g_inst is not None:
        VARIANT_LAUNCHES["backward instances"] += 1
    return (g_o_w, g_d_w, acc) + extra


def resolve_slab_backward_cuda(scene, slab, o_w, d_w, hit: MarchHit, inst,
                               g_t, g_normal, rays_grad: bool = True,
                               table_grad: bool = True,
                               _old_design: bool = False):
    """Launch the slab resolve's backward on ``torch.cuda.current_stream()``:
    the cotangents ``g_t`` [R] and ``g_normal`` [R,3] of
    ``resolve_slab_cuda``'s t and normal pulled back to the world rays and
    to the rank's ``slab.resolve_table``.  By default the merged kernel's
    planes variant adds them into an f32 gradient of the planes' shape
    [span, N, N], which this zeroes: each corner into its voxel, nothing
    into a voxel outside the volume or the planes.  With ``slab.table ==
    "packed"`` (the first design) into an f32 [cx*C*C, 8] ``accumulator``
    that this zeroes, through the slab's variants of
    ``resolve_scene_backward_cuda``'s two designs (the merged kernel, or
    with ``_old_design`` the first, which only a packed table takes), the
    row of cell c at ``((c[0] - x0) * C + c[1]) * C + c[2]`` and nothing
    added for a cell outside the table's rows.  The ray gradients of every
    design are bit-equal.  Its plain version is
    ``brick.resolve_slab_backward_reference``.  Counted in
    ``LAUNCHES["backward"]`` and ``SLAB_LAUNCHES["backward"]``.  Raises on
    any input the kernel does not take; never falls back."""
    dev, rays, table, n_inst, tb = _check_slab_inputs(
        scene, slab, o_w, d_w, hit, inst, "the slab resolve's backward")
    _check(g_t, "g_t", torch.float32, (rays,), dev)
    _check(g_normal, "g_normal", torch.float32, (rays, 3), dev)
    planes = slab.table == "planes"
    if planes and _old_design:
        raise ValueError("the slab resolve backward's first design reads "
                         "the packed table")
    n, h, ext, _ = tb["volume"]
    g_o_w = g_d_w = acc = None
    if rays_grad:
        g_o_w = torch.empty((rays, 3), dtype=torch.float32, device=dev)
        g_d_w = torch.empty((rays, 3), dtype=torch.float32, device=dev)
    if table_grad:
        acc = (torch.zeros_like(tb["sdf"]) if planes else
               accumulator(tb["corners"].numel() // 8, 8, dev)[0])
    if rays == 0 or not (rays_grad or table_grad):
        return g_o_w, g_d_w, acc
    build()
    err = _lib.vrt_resolve_scene_bwd(
        o_w.data_ptr(), d_w.data_ptr(), inst.data_ptr(),
        hit.kind.data_ptr(), hit.t.data_ptr(), hit.cell.data_ptr(),
        g_t.data_ptr(), g_normal.data_ptr(), *(x.data_ptr() for x in table),
        n_inst, n.data_ptr(), h.data_ptr(), ext.data_ptr(),
        *_slab_table_args(slab), rays,
        g_o_w.data_ptr() if rays_grad else None,
        g_d_w.data_ptr() if rays_grad else None,
        acc.data_ptr() if table_grad else None, 8, int(not _old_design),
        int(planes), _stream(dev), None)
    if err != 0:
        raise RuntimeError(f"the slab resolve's backward launch failed: "
                           f"cudaError {err}")
    LAUNCHES["backward"] += 1
    SLAB_LAUNCHES["backward"] += 1
    return g_o_w, g_d_w, acc


class ResolveScene(torch.autograd.Function):
    """``resolve_scene`` with its gradient in the world rays, the corner
    table and the instance transforms: the two kernels on CUDA tensors
    (the backward's instance variant where ``inst_pos``, ``inst_rot`` or
    ``inst_scale`` needs a gradient), their plain versions on CPU tensors.
    ``corners`` is ``scene.volumes.corners`` and the three transforms are
    the scene's own (passed apart so that autograd sees them).  Saves the
    rays, the table and the hit's kind, t and cell: no rows, no weights."""

    @staticmethod
    def forward(ctx, o_w, d_w, corners, inst_pos, inst_rot, inst_scale,
                scene, hit, inst):
        if corners is not scene.volumes.corners:
            raise ValueError("ResolveScene: corners must be the scene's "
                             "corner table")
        for name, x in (("inst_pos", inst_pos), ("inst_rot", inst_rot),
                        ("inst_scale", inst_scale)):
            if x is not getattr(scene, name):
                raise ValueError(f"ResolveScene: {name} must be the scene's "
                                 f"own table")
        if o_w.device.type == "cuda":
            t, normal, unlit = resolve_scene_cuda(scene, o_w, d_w, hit, inst)
        else:
            from vrt_torch.render.renderer import resolve_scene_reference

            # no graph is recorded inside forward: this is the plain
            # version as a frame without a graph runs it
            t, normal, unlit = resolve_scene_reference(scene, o_w, d_w, hit,
                                                       inst)
        ctx.save_for_backward(o_w, d_w, corners, inst, hit.kind, hit.t,
                              hit.cell)
        ctx.scene = scene
        ctx.mark_non_differentiable(unlit)
        return t, normal, unlit

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_t, g_normal, _g_unlit):
        o_w, d_w, corners, inst, kind, t, cell = ctx.saved_tensors
        need = ctx.needs_input_grad
        rays_grad = need[0] or need[1]
        table_grad = need[2]
        instances = any(need[3:6])
        hit = MarchHit(hit=None, t=t, kind=kind, cell=cell, t_in=None,
                       t_out=None, face_normal=None, steps=None)
        # the default call as it was, the variant with its flag
        kwargs = {"instances": True} if instances else {}
        if o_w.device.type == "cuda":
            got = resolve_scene_backward_cuda(
                ctx.scene, o_w, d_w, hit, inst, g_t.contiguous(),
                g_normal.contiguous(), rays_grad, table_grad, **kwargs)
        else:
            from vrt_torch.render.renderer import \
                resolve_scene_backward_reference

            got = resolve_scene_backward_reference(
                ctx.scene, o_w, d_w, hit, inst, g_t, g_normal, **kwargs)
        g_o_w, g_d_w, acc = got[:3]
        g_inst = got[3:6] if instances else (None,) * 3
        g_corners = None
        if table_grad:
            g_corners = acc.to(corners.dtype).reshape(corners.shape)
        return (g_o_w if need[0] else None, g_d_w if need[1] else None,
                g_corners) + tuple(g if n else None
                                   for g, n in zip(g_inst, need[3:6])) \
            + (None, None, None)


class ResolveSlab(torch.autograd.Function):
    """The slab tracer's resolve with its gradient in the world rays and
    the rank's ``slab.resolve_table`` (the planes; the first design's packed
    corner table): ``resolve_slab_cuda`` and ``resolve_slab_backward_cuda``
    on CUDA tensors; on CPU tensors ``brick.resolve_slab_hits`` (its t and
    normal on the lanes whose hit the slab owns are the kernel's) and the
    closed form ``brick.resolve_slab_backward_reference``.  ``table`` is
    ``slab.resolve_table``, passed apart so that autograd sees it (the
    packed table carries the graph back to the planes through its pack).
    Saves the rays, the hit's kind, t and cell and the slab, whose table the
    backward re-reads."""

    @staticmethod
    def forward(ctx, o_w, d_w, table, scene, slab, hit, inst):
        if table is not slab.resolve_table:
            raise ValueError("ResolveSlab: table must be the slab's "
                             "resolve_table")
        if o_w.device.type == "cuda":
            t, normal, unlit = resolve_slab_cuda(scene, slab, o_w, d_w, hit,
                                                 inst)
        else:
            from vrt_torch.dist.brick import resolve_slab_hits
            from vrt_torch.render.renderer import _world_to_object

            o, d = _world_to_object(scene.inst_pos[0], scene.inst_rot[0],
                                    scene.inst_scale[0], o_w, d_w)
            t, normal, unlit = resolve_slab_hits(slab, o, d, hit)
        ctx.save_for_backward(o_w, d_w, inst, hit.kind, hit.t, hit.cell)
        ctx.scene, ctx.slab = scene, slab
        ctx.mark_non_differentiable(unlit)
        return t, normal, unlit

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_t, g_normal, _g_unlit):
        o_w, d_w, inst, kind, t, cell = ctx.saved_tensors
        rays_grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        table_grad = ctx.needs_input_grad[2]
        hit = MarchHit(hit=None, t=t, kind=kind, cell=cell, t_in=None,
                       t_out=None, face_normal=None, steps=None)
        if o_w.device.type == "cuda":
            g_o_w, g_d_w, acc = resolve_slab_backward_cuda(
                ctx.scene, ctx.slab, o_w, d_w, hit, inst, g_t.contiguous(),
                g_normal.contiguous(), rays_grad, table_grad)
        else:
            from vrt_torch.dist.brick import resolve_slab_backward_reference

            g_o_w, g_d_w, acc = resolve_slab_backward_reference(
                ctx.scene, ctx.slab, o_w, d_w, hit, g_t, g_normal)
        table = ctx.slab.resolve_table
        return (g_o_w if ctx.needs_input_grad[0] else None,
                g_d_w if ctx.needs_input_grad[1] else None,
                acc.reshape(table.shape) if table_grad else None,
                None, None, None, None)
