"""K3: the row gather of the voxel-colour sample (and of resolve where it
runs in plain PyTorch), with a scatter-add backward (``vrt_torch/csrc/rows.cu``).

    gather_rows(table [M, ch] f32|bf16, idx i32 [L], out_ch) -> f32 [L, out_ch]

reads the first ``out_ch`` channels of row ``idx[l]`` as float32, and a
zero row where ``idx[l] == -1``; such a lane gets no gradient.  Indices are
expected in [-1, M): an index >= M fails, in the kernels (a trap, so the
launch errors) as in the plain versions (an indexing error).  The gradient with respect to ``table`` adds every
lane's cotangent into its row: in f32, then one cast to the table's dtype,
as ``vrt``'s ``_take_rows_bwd`` accumulates (``vrt/march/isosurface.py``).

``gather_rows`` is the dispatcher the renderer calls: CUDA tensors go to
``GatherRows``, whose forward and backward are K3's two kernels, CPU
tensors to ``gather_rows_reference`` (``table[idx]`` with the mask,
differentiated by autograd).  The ``*_cuda`` wrappers check device, dtype,
shape and contiguity, raise on what the kernels do not take, never fall
back, and count their launches in ``LAUNCHES`` (the scatter's by path in
``SCATTER_LAUNCHES`` too).
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build

LAUNCHES = {"K3 gather": 0, "K3 scatter": 0}
# the scatter's launches again, by the path ``scatter_path`` named
SCATTER_LAUNCHES = {"v4": 0, "scalar": 0}
_ELEM = {torch.float32: 4, torch.bfloat16: 2}

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load K3.  Returns the
    compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("rows.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vrt_gather_rows.argtypes = [ptr] * 3 + [i64, i64] + [i32] * 4 + [ptr]
    lib.vrt_scatter_rows.argtypes = [ptr] * 3 + [i64, i64] + [i32] * 3 + [ptr]
    lib.vrt_gather_rows.restype = i32
    lib.vrt_scatter_rows.restype = i32
    _lib = lib
    return log


# ---- plain versions ---------------------------------------------------------

def gather_rows_reference(table, idx, out_ch: int):
    """``table[idx, :out_ch]`` as float32, zero rows where ``idx < 0``."""
    rows = table[idx.clamp_min(0).long(), :out_ch].float()
    return torch.where((idx >= 0)[:, None], rows, 0.0)


def scatter_rows_reference(grad, idx, rows: int, ch: int,
                           dtype=torch.float32):
    """K3's backward as ``index_add_`` in ``dtype``: [rows, ch] with
    ``grad[l]`` added into the first ``out_ch`` channels of row ``idx[l]``
    for every ``idx[l] >= 0``."""
    # masked lanes add an exact zero into row 0 instead of being dropped,
    # which keeps the shapes static (no host sync on CUDA tensors)
    keep = (idx >= 0)[:, None]
    acc = torch.zeros((rows, ch), dtype=dtype, device=grad.device)
    acc[:, :grad.shape[1]].index_add_(0, idx.clamp_min(0).long(),
                                      torch.where(keep, grad.to(dtype), 0.0))
    return acc


# ---- wrappers ---------------------------------------------------------------

def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _check_idx(who, idx, dev):
    if idx.device != dev:
        raise ValueError(f"{who}: idx is on {idx.device}, expected {dev}")
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError(f"{who}: idx must be a contiguous int32 vector, got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def load_path(table, out_ch: int) -> str:
    """The gather's load path for ``table``: "v16" (16-byte loads) where
    its rows, the gathered prefix and its base are 16-byte aligned, else
    "ldg" (one load per element)."""
    elem = _ELEM[table.dtype]
    aligned = ((table.shape[1] * elem) % 16 == 0 and (out_ch * elem) % 16 == 0
               and table.data_ptr() % 16 == 0)
    return "v16" if aligned else "ldg"


def scatter_path(grad, ch: int) -> str:
    """The scatter's path for cotangents ``grad`` [L, out_ch] into rows of
    ``ch`` channels: "v4" (one 16-byte vector reduction per four channels)
    where the rows of ``grad`` and of the accumulator and the base of
    ``grad`` are 16-byte aligned, else "scalar" (one f32 atomic per
    element)."""
    aligned = (grad.shape[1] % 4 == 0 and ch % 4 == 0
               and grad.data_ptr() % 16 == 0)
    return "v4" if aligned else "scalar"


def gather_rows_cuda(table, idx, out_ch: int):
    """Launch K3's gather on ``torch.cuda.current_stream()``; no autograd
    (``GatherRows`` adds it)."""
    who = "K3 gather"
    if table.device.type != "cuda":
        raise ValueError(f"{who} runs on CUDA tensors, got {table.device}")
    dev = table.device
    if table.dtype not in _ELEM:
        raise ValueError(f"{who} takes f32 or bf16 tables, got {table.dtype}")
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError(f"{who}: the table must be a contiguous [M, ch] "
                         f"tensor, got {tuple(table.shape)}")
    _check_idx(who, idx, dev)
    rows, ch = table.shape
    if not (0 < out_ch <= ch and out_ch % 4 == 0):
        raise ValueError(f"{who}: out_ch must be a multiple of 4 in "
                         f"(0, {ch}], got {out_ch}")
    lanes = idx.shape[0]
    out = torch.empty((lanes, out_ch), dtype=torch.float32, device=dev)
    if lanes == 0:
        return out
    build()
    err = _lib.vrt_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, lanes, ch,
        out_ch, _ELEM[table.dtype], int(load_path(table, out_ch) == "v16"),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"{who} launch failed: cudaError {err}")
    LAUNCHES[who] += 1
    return out


def scatter_rows_cuda(grad, idx, rows: int, ch: int):
    """Launch K3's scatter: a new zeroed f32 [rows, ch] buffer with
    ``grad[l]`` added into row ``idx[l]`` (its first ``grad.shape[1]``
    channels) by f32 atomics, for every ``idx[l] >= 0``, on the path
    ``scatter_path`` names."""
    who = "K3 scatter"
    if grad.device.type != "cuda":
        raise ValueError(f"{who} runs on CUDA tensors, got {grad.device}")
    dev = grad.device
    _check_idx(who, idx, dev)
    if (grad.dtype != torch.float32 or grad.ndim != 2
            or grad.shape[0] != idx.shape[0] or not grad.is_contiguous()):
        raise ValueError(f"{who}: grad must be a contiguous f32 [L, out_ch] "
                         f"tensor with L = {idx.shape[0]}, got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    out_ch = grad.shape[1]
    if not 0 < out_ch <= ch:
        raise ValueError(f"{who}: {out_ch} channels into rows of {ch}")
    acc = torch.zeros((rows, ch), dtype=torch.float32, device=dev)
    if idx.shape[0] == 0:
        return acc
    build()
    path = scatter_path(grad, ch)
    err = _lib.vrt_scatter_rows(grad.data_ptr(), idx.data_ptr(),
                                acc.data_ptr(), rows, idx.shape[0], ch,
                                out_ch, int(path == "v4"), _stream(dev))
    if err != 0:
        raise RuntimeError(f"{who} launch failed: cudaError {err}")
    LAUNCHES[who] += 1
    SCATTER_LAUNCHES[path] += 1
    return acc


class GatherRows(torch.autograd.Function):
    """K3's gather, differentiable in the table: the backward is K3's
    scatter, then one cast to the table's dtype."""

    @staticmethod
    def forward(ctx, table, idx, out_ch):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.ch = table.shape
        ctx.table_dtype = table.dtype
        return gather_rows_cuda(table, idx, out_ch)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        acc = scatter_rows_cuda(grad.contiguous(), idx, ctx.rows, ctx.ch)
        return acc.to(ctx.table_dtype), None, None


def gather_rows(table, idx, out_ch: int):
    """``table[idx, :out_ch]`` as f32 with zero rows at ``idx == -1``,
    differentiable in ``table``: K3 on CUDA tensors, the plain version on
    CPU tensors."""
    if table.device.type == "cuda":
        return GatherRows.apply(table, idx, out_ch)
    if table.device.type != "cpu":
        raise ValueError(f"no row gather for device {table.device}")
    return gather_rows_reference(table, idx, out_ch)
