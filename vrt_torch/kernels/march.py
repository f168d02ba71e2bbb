"""K1 and K7: build, bind and launch the CUDA march
(``vrt_torch/csrc/march.cu``): the per-lane march ``march_lanes_cuda``, the
scene march ``march_scene_cuda`` (one launch per trace over all instances),
and K7, the slab march ``march_slab_cuda`` (one launch per trace against one
rank's slab of a slab-sharded volume, ``vrt_torch.dist.brick``).

The source is built by ``vrt_torch.kernels._build`` (nvcc by hand, a plain
C interface, ctypes) with ``--fmad=false`` besides, which keeps every
multiply and add separately rounded, as in the eager twin
(``vrt_torch.march.march.march_lanes_reference``).  K1 reads the u8 accel
and the corner table in every mode, and in cube mode the f32 voxel table
``sdf`` ([V,N,N,N], N = C + 1) as well; the wrapper passes and checks
``sdf`` in every mode.

The plain versions are ``vrt_torch.march.march.march_lanes_reference``,
``vrt_torch.render.renderer.march_scene_reference`` (and, for the any-hit
variant, the ``hit`` field of the latter's result) and
``vrt_torch.dist.brick.march_volume_slab_reference``.

``LAUNCHES`` counts the per-lane kernel's launches, ``SCENE_LAUNCHES`` the
scene march's and ``SLAB_LAUNCHES`` K7's: a run can show which of them its
frames went through.

The scene march has two designs in ``march.cu``.  The default, the capped
kernel, runs 64 threads a block with its registers capped.  The first
design (256 threads a block, registers uncapped) stays beside it as the
comparator of the timing runs, behind the wrapper's private
``_old_design``; no path of the port takes it.  Both give thread i ray i.

K7 has two designs too, chosen by the slab's ``table``: the default
(``"planes"``) reads a surface cell's corners from the slab's voxel planes
and runs the capped kernel (``kSlabThreads`` threads a block,
``kSlabMinBlocks`` blocks an SM); the first design (``"packed"``) reads
the slab-local packed corner table at 256 threads a block.  Both give the
twin's hits field by field.
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.march.types import DeviceVolume, MarchHit

LAUNCHES = 0
SCENE_LAUNCHES = 0
SLAB_LAUNCHES = 0
MAX_INSTANCES = 32  # kMaxInstances of march.cu

NVCC_FLAGS = ["--fmad=false"]

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load K1.  Returns the
    compiler's output (register and spill counts from ptxas), or "" when
    the library was already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("march.cu", NVCC_FLAGS, headers=["scene.cuh"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vrt_march_lanes.argtypes = ([ptr] * 10 + [i32] * 6
                                    + [ctypes.c_longlong] + [ptr] * 8 + [ptr])
    lib.vrt_march_lanes.restype = i32
    lib.vrt_march_scene.argtypes = ([ptr] * 8 + [i32] + [ptr] * 6 + [i32] * 7
                                    + [ctypes.c_longlong] + [ptr] * 9
                                    + [i32] + [ptr])
    lib.vrt_march_scene.restype = i32
    f32 = ctypes.c_float
    lib.vrt_march_slab.argtypes = ([ptr] * 3 + [ctypes.c_longlong]
                                   + [ptr] * 3 + [i32] * 6 + [f32] * 2
                                   + [i32] * 3 + [ptr] * 8 + [ptr])
    lib.vrt_march_slab.restype = i32
    _lib = lib
    return log


def _check(x: torch.Tensor, name: str, dtype, shape, device, who="K1"):
    if x.device != device:
        raise ValueError(f"{who}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{who}: {name} has dtype {x.dtype}, expected "
                         f"{dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def _check_volumes(vols: DeviceVolume, dev):
    """The stacked tables K1 reads; returns (cells per axis, channels)."""
    nv = vols.n.shape[0]
    cc = vols.accel.shape[1]
    ch = vols.corners.shape[-1]
    if ch not in (8, 9):
        raise ValueError(f"K1 takes 8 or 9 corner channels, got {ch}")
    if vols.corners.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K1 takes f32 or bf16 corners, got "
                         f"{vols.corners.dtype}")
    if vols.accel_mode not in ("octree", "chebyshev"):
        raise ValueError(f"K1: unknown accel_mode {vols.accel_mode!r}")
    _check(vols.n, "n", torch.int32, (nv,), dev)
    _check(vols.cell_size, "cell_size", torch.float32, (nv,), dev)
    _check(vols.extends, "extends", torch.float32, (nv,), dev)
    _check(vols.accel_u8, "accel_u8", torch.uint8, (nv, cc, cc, cc), dev)
    _check(vols.corners, "corners", vols.corners.dtype,
           (nv, cc, cc, cc, ch), dev)
    _check(vols.sdf, "sdf", torch.float32, (nv,) + (cc + 1,) * 3, dev)
    return cc, ch


def _empty_hit(lanes: int, dev) -> MarchHit:
    return MarchHit(
        hit=torch.empty(lanes, dtype=torch.bool, device=dev),
        t=torch.empty(lanes, dtype=torch.float32, device=dev),
        kind=torch.empty(lanes, dtype=torch.int32, device=dev),
        cell=torch.empty((lanes, 3), dtype=torch.int32, device=dev),
        t_in=torch.empty(lanes, dtype=torch.float32, device=dev),
        t_out=torch.empty(lanes, dtype=torch.float32, device=dev),
        face_normal=torch.empty((lanes, 3), dtype=torch.float32, device=dev),
        steps=torch.empty(lanes, dtype=torch.int32, device=dev))


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _table_args(vols: DeviceVolume, cc: int, ch: int):
    return (vols.n.data_ptr(), vols.cell_size.data_ptr(),
            vols.extends.data_ptr(), vols.accel_u8.data_ptr(),
            vols.corners.data_ptr(), vols.sdf.data_ptr(), cc, ch,
            int(vols.corners.dtype == torch.bfloat16),
            int(vols.accel_mode == "chebyshev"))


def _hit_args(h: MarchHit):
    return (h.hit.data_ptr(), h.t.data_ptr(), h.kind.data_ptr(),
            h.cell.data_ptr(), h.t_in.data_ptr(), h.t_out.data_ptr(),
            h.face_normal.data_ptr(), h.steps.data_ptr())


def march_lanes_cuda(vols: DeviceVolume, vol_ids, o, d, t_max,
                     interp: bool = True,
                     debug_overlay: bool = False) -> MarchHit:
    """Launch K1 on ``torch.cuda.current_stream()``: march lanes against
    per-lane volumes of a stacked DeviceVolume, in interp or cube mode,
    with or without the debug overlay.  Raises on any input K1 does not
    take; never falls back."""
    global LAUNCHES

    if o.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {o.device}")
    dev = o.device
    lanes = o.shape[0]
    _check(o, "o", torch.float32, (lanes, 3), dev)
    _check(d, "d", torch.float32, (lanes, 3), dev)
    _check(t_max, "t_max", torch.float32, (lanes,), dev)
    _check(vol_ids, "vol_ids", torch.int32, (lanes,), dev)
    cc, ch = _check_volumes(vols, dev)

    out = _empty_hit(lanes, dev)
    if lanes == 0:
        return out
    build()
    err = _lib.vrt_march_lanes(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), vol_ids.data_ptr(),
        *_table_args(vols, cc, ch), int(bool(interp)),
        int(bool(debug_overlay)), lanes, *_hit_args(out), _stream(dev))
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def march_scene_cuda(scene, o_w, d_w, t_max, interp: bool = True,
                     debug_overlay: bool = False, any_hit: bool = False,
                     _old_design: bool = False):
    """Launch K1's scene march on ``torch.cuda.current_stream()``: the
    closest hit of world rays over all instances of ``scene`` (a GPUScene
    with 1 to 32 instances) in one launch, what ``march_scene_reference``
    computes.  Returns (MarchHit with ``steps`` summed over the candidates
    marched, winning instance i32 [R], -1 for none); with ``any_hit`` only
    the bool [R] ``hit`` of that result, and the kernel stops at the first
    candidate that hits.  The private ``_old_design`` launches the first
    design, the comparator of the timing runs; the result is the same.
    Raises on any input the kernel does not take; never falls back."""
    global SCENE_LAUNCHES

    if o_w.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {o_w.device}")
    dev = o_w.device
    rays = o_w.shape[0]
    _check(o_w, "o_w", torch.float32, (rays, 3), dev)
    _check(d_w, "d_w", torch.float32, (rays, 3), dev)
    _check(t_max, "t_max", torch.float32, (rays,), dev)
    n_inst = scene.num_instances
    if not 1 <= n_inst <= MAX_INSTANCES:
        raise ValueError(f"K1's scene march takes 1 to {MAX_INSTANCES} "
                         f"instances, got {n_inst}")
    if any_hit and debug_overlay:
        raise ValueError("K1's any-hit scene march has no debug overlay")
    _check(scene.inst_volume, "inst_volume", torch.int32, (n_inst,), dev)
    _check(scene.inst_pos, "inst_pos", torch.float32, (n_inst, 3), dev)
    _check(scene.inst_rot, "inst_rot", torch.float32, (n_inst, 4), dev)
    _check(scene.inst_scale, "inst_scale", torch.float32, (n_inst, 3), dev)
    _check(scene.inst_active, "inst_active", torch.bool, (n_inst,), dev)
    vols = scene.volumes
    cc, ch = _check_volumes(vols, dev)

    if any_hit:
        hit = torch.empty(rays, dtype=torch.bool, device=dev)
        outs = (hit.data_ptr(),) + (None,) * 8
        result = hit
    else:
        out = _empty_hit(rays, dev)
        inst = torch.empty(rays, dtype=torch.int32, device=dev)
        outs = _hit_args(out) + (inst.data_ptr(),)
        result = (out, inst)
    if rays == 0:
        return result
    build()
    err = _lib.vrt_march_scene(
        o_w.data_ptr(), d_w.data_ptr(), t_max.data_ptr(),
        scene.inst_volume.data_ptr(), scene.inst_pos.data_ptr(),
        scene.inst_rot.data_ptr(), scene.inst_scale.data_ptr(),
        scene.inst_active.data_ptr(), n_inst, *_table_args(vols, cc, ch),
        int(bool(interp)), int(bool(debug_overlay)), int(bool(any_hit)),
        rays, *outs, int(not _old_design), _stream(dev))
    if err != 0:
        raise RuntimeError(f"K1 scene march launch failed: cudaError {err}")
    SCENE_LAUNCHES += 1
    return result


def march_slab_cuda(slab, o, d, t_max, interp: bool = True,
                    debug_overlay: bool = False) -> MarchHit:
    """Launch K7 on ``torch.cuda.current_stream()``: rays (object space)
    against one rank's slab (a local ``vrt_torch.dist.brick.SlabVolume`` on
    the card), hits in owned cells only, what
    ``march_volume_slab_reference`` computes.  Reads the slab's
    ``march_tables``: the owned cells' u8 accel and the voxel planes, and
    with ``slab.table == "packed"`` the slab-local corner table (the first
    design).  Raises on any input K7 does not take; never falls back."""
    global SLAB_LAUNCHES

    if o.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA tensors, got {o.device}")
    dev = o.device
    lanes = o.shape[0]
    _check(o, "o", torch.float32, (lanes, 3), dev, who="K7")
    _check(d, "d", torch.float32, (lanes, 3), dev, who="K7")
    _check(t_max, "t_max", torch.float32, (lanes,), dev, who="K7")
    if slab.accel_mode not in ("octree", "chebyshev"):
        raise ValueError(f"K7: unknown accel_mode {slab.accel_mode!r}")
    tb = slab.march_tables
    span, nn = tb["sdf"].shape[0], tb["sdf"].shape[-1]
    cc = nn - 1
    cps = tb["cell_hi"] - tb["cell_lo"]
    _check(tb["sdf"], "sdf", torch.float32, (span, nn, nn), dev, who="K7")
    corners = tb.get("corners")
    if slab.table == "packed":
        _check(corners, "corners", torch.float32, (span - 1, cc, cc, 8),
               dev, who="K7")
    _check(tb["accel_u8"], "accel_u8", torch.uint8, (cps, cc, cc), dev,
           who="K7")
    if tb["n"] != nn:
        raise ValueError(f"K7: a slab of {nn} voxels a side of a volume of "
                         f"{tb['n']}")
    out = _empty_hit(lanes, dev)
    if lanes == 0:
        return out
    build()
    err = _lib.vrt_march_slab(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), lanes,
        tb["accel_u8"].data_ptr(),
        corners.data_ptr() if slab.table == "packed" else None,
        tb["sdf"].data_ptr(), cc, span, tb["x0"], tb["cell_lo"],
        tb["cell_hi"], tb["n"], tb["h"], tb["ext"],
        int(slab.accel_mode == "chebyshev"), int(bool(interp)),
        int(bool(debug_overlay)), *_hit_args(out), _stream(dev))
    if err != 0:
        raise RuntimeError(f"K7 launch failed: cudaError {err}")
    SLAB_LAUNCHES += 1
    return out
