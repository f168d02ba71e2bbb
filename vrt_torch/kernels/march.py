"""K1: build, bind and launch the CUDA march (``vrt_torch/csrc/march.cu``).

The source is built by ``vrt_torch.kernels._build`` (nvcc by hand, a plain
C interface, ctypes) with ``--fmad=false`` besides, which keeps every
multiply and add separately rounded, as in the eager twin
(``vrt_torch.march.march.march_lanes_reference``).  K1 reads the u8 accel
and the corner table in every mode, and in cube mode the f32 voxel table
``sdf`` ([V,N,N,N], N = C + 1) as well; the wrapper passes and checks
``sdf`` in every mode.

``LAUNCHES`` counts the kernel's launches: a run can show that its frames
went through K1.
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.march.types import DeviceVolume, MarchHit

LAUNCHES = 0

NVCC_FLAGS = ["--fmad=false"]

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load K1.  Returns the
    compiler's output (register and spill counts from ptxas), or "" when
    the library was already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("march.cu", NVCC_FLAGS)
    fn = lib.vrt_march_lanes
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 10 + [i32] * 6 + [ctypes.c_longlong]
                   + [ptr] * 8 + [ptr])
    fn.restype = i32
    _lib = lib
    return log


def _check(x: torch.Tensor, name: str, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"K1: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"K1: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"K1: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"K1: {name} is not contiguous")


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

    hit = torch.empty(lanes, dtype=torch.bool, device=dev)
    t = torch.empty(lanes, dtype=torch.float32, device=dev)
    kind = torch.empty(lanes, dtype=torch.int32, device=dev)
    cell = torch.empty((lanes, 3), dtype=torch.int32, device=dev)
    t_in = torch.empty(lanes, dtype=torch.float32, device=dev)
    t_out = torch.empty(lanes, dtype=torch.float32, device=dev)
    face = torch.empty((lanes, 3), dtype=torch.float32, device=dev)
    steps = torch.empty(lanes, dtype=torch.int32, device=dev)
    out = MarchHit(hit=hit, t=t, kind=kind, cell=cell, t_in=t_in,
                   t_out=t_out, face_normal=face, steps=steps)
    if lanes == 0:
        return out
    build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    err = _lib.vrt_march_lanes(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), vol_ids.data_ptr(),
        vols.n.data_ptr(), vols.cell_size.data_ptr(),
        vols.extends.data_ptr(), vols.accel_u8.data_ptr(),
        vols.corners.data_ptr(), vols.sdf.data_ptr(),
        cc, ch, int(vols.corners.dtype == torch.bfloat16),
        int(vols.accel_mode == "chebyshev"), int(bool(interp)),
        int(bool(debug_overlay)), lanes,
        hit.data_ptr(), t.data_ptr(), kind.data_ptr(), cell.data_ptr(),
        t_in.data_ptr(), t_out.data_ptr(), face.data_ptr(),
        steps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
