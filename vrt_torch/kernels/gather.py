"""The gather probe's kernels (``vrt_torch/csrc/gather.cu``), their
wrappers and their plain-torch versions.

- GP-A ``take_along_axis``: ``torch.take_along_dim`` on a 2-D f32 table,
  along axis 0 or 1;
- GP-B ``row_gather``: ``src[idx]`` for a 1-D table or one of rows of
  1 to 128 elements (f32, i32, bf16, u8 or i8), by one of three load
  paths (``"ldg"``, ``"v16"``, ``"smem"``);
- GP-C ``onehot_gather``: ``onehot(idx, K) @ bf16(src)`` for an f32 [K, 8]
  table, as a direct gather of the bf16-rounded row (NaN in a column where
  another row is non-finite, as the matmul's 0 * Inf gives); its first
  design, on the tensor cores, stays behind ``_old_design``.

Each takes ``iters`` rounds when ``iters > 0``: round t reads at
``(idx + t) & mask``, and the rounds are summed into an f32 accumulator
that starts at 0 (or, for ``row_gather_cuda(..., reduce="last")``, the last
round wins).  The ``*_cuda`` wrappers check device, dtype, shape,
contiguity and alignment, raise on anything the kernels do not take, never
fall back, and count their launches in ``LAUNCHES``.  The kernels are
exact, so each must equal its plain version bit for bit.  Indices are
expected inside the table; a kernel reads 0 for one outside it, where the
plain version raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vrt_torch.kernels import _build

LAUNCHES = {"GP-A": 0, "GP-B": 0, "GP-C": 0}
PATHS = {"ldg": 0, "v16": 1, "smem": 2}
SMEM_BYTES = 232448          # a block's shared memory, 227 KB
_ELEM = {torch.float32: 4, torch.int32: 4, torch.bfloat16: 2,
         torch.uint8: 1, torch.int8: 1}

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load the gather kernels.
    Returns the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("gather.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vrt_take_along_axis.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
    lib.vrt_row_gather.argtypes = ([ptr] * 3 + [i64, i64] + [i32] * 6
                                   + [ptr])
    lib.vrt_onehot_gather.argtypes = [ptr] * 3 + [i32, i64, i32, i32, i32,
                                                   ptr]
    for fn in (lib.vrt_take_along_axis, lib.vrt_row_gather,
               lib.vrt_onehot_gather):
        fn.restype = i32
    _lib = lib
    return log


# ---- plain versions ---------------------------------------------------------

def _rounds(idx, iters, mask):
    """The index of every round, in the kernels' order."""
    if iters == 0:
        return [idx]
    return [(idx + t) & mask for t in range(iters)]


def take_along_axis_reference(src, idx, axis: int, iters: int = 0,
                              mask: int = -1):
    """``torch.take_along_dim``; with ``iters`` the rounds summed."""
    outs = [torch.take_along_dim(src, i.long(), dim=axis)
            for i in _rounds(idx, iters, mask)]
    if iters == 0:
        return outs[0]
    acc = torch.zeros_like(outs[0])
    for o in outs:
        acc = acc + o
    return acc


def row_gather_reference(src, idx, iters: int = 0, mask: int = -1,
                         reduce: str = "last"):
    """``src[idx]``; with ``iters`` the rounds summed, or the last one."""
    out = None
    for i in _rounds(idx, iters, mask):
        g = src[i.long()]
        if iters and reduce == "sum":
            out = (torch.zeros_like(g) if out is None else out) + g
        else:
            out = g
    return out


def onehot_gather_reference(src, idx, iters: int = 0, mask: int = -1):
    """``one_hot(idx, K) @ bf16(src)`` with f32 sums; with ``iters`` the
    rounds summed.  Exact even under TF32: the bf16 values fit its
    mantissa and every row has one nonzero product."""
    table = src.bfloat16().float()
    out = None
    for i in _rounds(idx, iters, mask):
        g = F.one_hot(i.long(), src.shape[0]).float() @ table
        out = g if iters == 0 else (
            (torch.zeros_like(g) if out is None else out) + g)
    return out


# ---- wrappers ---------------------------------------------------------------

def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _common(who, src, idx, iters, mask):
    if src.device.type != "cuda":
        raise ValueError(f"{who} runs on CUDA tensors, got {src.device}")
    dev = src.device
    if idx.device != dev:
        raise ValueError(f"{who}: idx is on {idx.device}, expected {dev}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{who}: idx has dtype {idx.dtype}, expected "
                         f"torch.int32")
    for name, x in (("src", src), ("idx", idx)):
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    if iters < 0:
        raise ValueError(f"{who}: iters {iters} < 0")
    if not -2 ** 31 <= mask < 2 ** 31:
        raise ValueError(f"{who}: mask {mask} is not a 32-bit int")
    return dev


def _launched(who, err):
    if err != 0:
        raise RuntimeError(f"{who} launch failed: cudaError {err}")
    LAUNCHES[who] += 1


def take_along_axis_cuda(src, idx, axis: int, iters: int = 0,
                         mask: int = -1):
    """GP-A on ``torch.cuda.current_stream()``."""
    dev = _common("GP-A", src, idx, iters, mask)
    if src.dtype != torch.float32 or src.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"GP-A takes a 2-D f32 table and 2-D indices, got "
                         f"{src.dtype} {tuple(src.shape)} and "
                         f"{tuple(idx.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"GP-A: axis {axis} is not 0 or 1")
    other = 1 - axis
    if idx.shape[other] != src.shape[other]:
        raise ValueError(f"GP-A: idx {tuple(idx.shape)} and src "
                         f"{tuple(src.shape)} differ on axis {other}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    build()
    _launched("GP-A", _lib.vrt_take_along_axis(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0],
        src.shape[1], idx.shape[0], idx.shape[1], axis, iters, mask,
        _stream(dev)))
    return out


def row_gather_cuda(src, idx, iters: int = 0, mask: int = -1,
                    reduce: str = "last", path: str = "ldg"):
    """GP-B on ``torch.cuda.current_stream()``: out has shape
    ``idx.shape + src.shape[1:]``."""
    dev = _common("GP-B", src, idx, iters, mask)
    if src.dtype not in _ELEM or src.dim() not in (1, 2):
        raise ValueError(f"GP-B takes a 1-D or 2-D table of 1, 2 or 4-byte "
                         f"elements, got {src.dtype} {tuple(src.shape)}")
    if path not in PATHS:
        raise ValueError(f"GP-B: unknown path {path!r}")
    if reduce not in ("last", "sum"):
        raise ValueError(f"GP-B: unknown reduce {reduce!r}")
    if reduce == "sum" and iters and src.dtype != torch.float32:
        raise ValueError(f"GP-B sums f32 tables only, got {src.dtype}")
    width = 1 if src.dim() == 1 else src.shape[1]
    if not 1 <= width <= 128:
        raise ValueError(f"GP-B takes rows of 1 to 128 elements, got {width}")
    row_bytes = width * _ELEM[src.dtype]
    if path == "v16" and row_bytes % 16:
        raise ValueError(f"GP-B: path v16 needs rows of a multiple of 16 "
                         f"bytes, got {row_bytes}")
    if path == "smem" and src.shape[0] * row_bytes > SMEM_BYTES:
        raise ValueError(f"GP-B: a {src.shape[0] * row_bytes}-byte table "
                         f"does not fit shared memory ({SMEM_BYTES})")
    out = torch.empty(tuple(idx.shape) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=dev)
    if out.numel() == 0:
        return out
    build()
    _launched("GP-B", _lib.vrt_row_gather(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0],
        idx.numel(), width, _ELEM[src.dtype], PATHS[path], iters, mask,
        int(reduce == "sum"), _stream(dev)))
    return out


def onehot_gather_cuda(src, idx, iters: int = 0, mask: int = -1,
                       _old_design: bool = False):
    """GP-C on ``torch.cuda.current_stream()``: f32 [len(idx), 8].  The
    direct gather; ``_old_design`` runs the first design (``mma.sync`` over
    the one-hot matrix), the probe's comparator, which no path takes.  Both
    equal ``onehot_gather_reference`` bit for bit on finite tables and give
    its NaN columns on others."""
    dev = _common("GP-C", src, idx, iters, mask)
    if src.dtype != torch.float32 or src.dim() != 2 or src.shape[1] != 8:
        raise ValueError(f"GP-C takes an f32 [K, 8] table, got {src.dtype} "
                         f"{tuple(src.shape)}")
    k = src.shape[0]
    if k == 0 or k % 16 or k * 8 * 2 + 32 > SMEM_BYTES:
        raise ValueError(f"GP-C takes K a multiple of 16 with K * 16 + 32 "
                         f"bytes <= {SMEM_BYTES}, got K = {k}")
    if idx.dim() != 1:
        raise ValueError(f"GP-C takes 1-D indices, got {tuple(idx.shape)}")
    out = torch.empty((idx.shape[0], 8), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    build()
    _launched("GP-C", _lib.vrt_onehot_gather(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), k, idx.shape[0],
        iters, mask, int(not _old_design), _stream(dev)))
    return out

