"""The corner table's pack and its backward: build, bind and launch
``vrt_torch/csrc/pack.cu``.

    pack_corners_cuda(sdf f32 [..., N,N,N], accel i32 [..., C,C,C] | None,
                      dtype f32 | bf16) -> table [..., C,C,C, 8 | 9]
    pack_corners_backward_cuda(g [..., C,C,C, 8 | 9] f32 | bf16)
        -> g_sdf f32 [..., N,N,N]
    PackCorners.apply(sdf, accel, dtype): the pack, differentiable in sdf

The pack computes what ``vrt_torch.march.types.pack_cell_corners_reference``
(its plain version, the eight slices of ``vrt``'s ``pack_cell_corners``)
computes, bit for bit: a copy and one cast to nearest even, the accel folded
in as a 9th channel where ``accel`` is given (its skip clamped to 127 in a
bf16 table).  Its backward computes what ``pack_corners_backward_reference``
(the slices' transpose, corner by corner) computes, bit for bit: each voxel
sums the cotangents of the at most 8 corner entries that name it, in f32,
with no atomics, corner 7 first, the order in which autograd adds the
plain version's slices (so it equals autograd of the plain pack bit for
bit too); the 9th channel's cotangent reaches nothing.  The backward has
two designs, bit-equal: its redesign (``pack_bwd_tiled_kernel``: a block
walks a column of voxels along x, each cell plane read once as 16-byte
words into shared memory) and its first design (``pack_bwd_kernel``, one
thread a voxel gathering its terms from the cotangent).  By default the
kernel library picks the tiled kernel where its words align and its grid
fills the card with at least one wave of resident blocks (config4's 257^3
table), else the first design (config6's two 65^3 volumes, and any side or
cotangent the words do not fit); ``_old_design=True`` takes the first
design, ``_tiled=True`` the tiled kernel wherever its words align, and
``BWD_LAUNCHES`` counts the launches of each.  The fit step's pack is the
accel rebuild's (``kernels.accel.RebuildAccel``, whose backward is this
one); the pack kernel packs a table with a given accel.

``PackCorners`` joins them: on CUDA tensors the two kernels, on CPU tensors
the two plain versions.  ``march.types.pack_cell_corners`` takes it for a
CUDA tensor (the fit's in-step pack, ``diff.fit.rebuild_accel`` and
``graft_params``) and stays the plain version on CPU tensors and numpy
input.  The wrappers check device, dtype, shape and contiguity, raise on
what the kernels do not take, never fall back, and count their launches in
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels.march import _check as _check_tensor
from vrt_torch.kernels.march import _stream

LAUNCHES = {"pack": 0, "pack_bwd": 0}
# the pack backward's launches by the design that ran
BWD_LAUNCHES = {"first": 0, "tiled": 0}
_DTYPES = (torch.float32, torch.bfloat16)

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load the two kernels.
    Returns the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("pack.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vrt_pack_corners.argtypes = [ptr] * 3 + [i64] + [i32] * 3 + [ptr]
    lib.vrt_pack_corners_bwd.argtypes = [ptr] * 2 + [i64] + [i32] * 4 + [ptr]
    lib.vrt_pack_corners.restype = i32
    lib.vrt_pack_corners_bwd.restype = i32
    _lib = lib
    return log


# ---- plain versions ---------------------------------------------------------

def pack_corners_backward_reference(g, n: int):
    """The transpose of the pack's slices: the cotangent ``g`` [..., C,C,C,
    8|9] of a table packed from an [..., N,N,N] SDF (N = C + 1) into an f32
    [..., N,N,N] gradient, each corner channel added into its slice of a
    zeroed buffer, corner by corner from the last of ``isosurface.CORNERS``
    (autograd's order over the plain pack's slices); a 9th channel has no
    cotangent in the SDF."""
    from vrt_torch.march.isosurface import CORNERS

    c = n - 1
    out = torch.zeros(g.shape[:-4] + (n, n, n), dtype=torch.float32,
                      device=g.device)
    for j in reversed(range(len(CORNERS))):
        dx, dy, dz = CORNERS[j]
        out[..., dx:dx + c, dy:dy + c, dz:dz + c] += g[..., j].float()
    return out


# ---- wrappers ---------------------------------------------------------------

def _check(x, name, dtype, shape, device):
    _check_tensor(x, name, dtype, shape, device, who="pack")


def pack_corners_cuda(sdf, accel, dtype: torch.dtype):
    """Launch the pack on ``torch.cuda.current_stream()``: the [..., C,C,C,
    8] table of ``sdf`` in ``dtype`` (f32 or bf16), with ``accel`` (int32
    [..., C,C,C]) as a 9th channel where it is given.  Records no autograd
    graph (``PackCorners`` adds it).  Raises on any input the kernel does
    not take; never falls back."""
    if sdf.device.type != "cuda":
        raise ValueError(f"the pack runs on CUDA tensors, got {sdf.device}")
    dev = sdf.device
    if dtype not in _DTYPES:
        raise ValueError(f"pack: the table is f32 or bf16, got {dtype}")
    if sdf.ndim < 3 or not (sdf.shape[-1] == sdf.shape[-2] == sdf.shape[-3]
                            >= 2):
        raise ValueError(f"pack: sdf must be [..., N,N,N] with N >= 2, got "
                         f"{tuple(sdf.shape)}")
    _check(sdf, "sdf", torch.float32, sdf.shape, dev)
    lead, c = tuple(sdf.shape[:-3]), sdf.shape[-1] - 1
    if accel is not None:
        _check(accel, "accel", torch.int32, lead + (c, c, c), dev)
    ch = 8 if accel is None else 9
    table = torch.empty(lead + (c, c, c, ch), dtype=dtype, device=dev)
    volumes = sdf.numel() // (c + 1) ** 3
    if volumes == 0:
        return table
    build()
    err = _lib.vrt_pack_corners(
        sdf.data_ptr(), None if accel is None else accel.data_ptr(),
        table.data_ptr(), volumes, c, ch, int(dtype == torch.bfloat16),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"pack launch failed: cudaError {err}")
    LAUNCHES["pack"] += 1
    return table


def pack_corners_backward_cuda(g, _old_design: bool = False,
                               _tiled: bool = False):
    """Launch the pack's backward on ``torch.cuda.current_stream()``: the
    f32 [..., N,N,N] gradient of the SDF for the cotangent ``g`` [...,
    C,C,C, 8|9] (f32 or bf16, the table's dtype) of its table, on the
    design the kernel library picks, or with ``_old_design`` on the first
    design, or with ``_tiled`` on the tiled kernel where its words align.
    Raises on any input the kernel does not take; never falls back."""
    if g.device.type != "cuda":
        raise ValueError(f"the pack's backward runs on CUDA tensors, got "
                         f"{g.device}")
    if _old_design and _tiled:
        raise ValueError("pack backward: one design, not both")
    dev = g.device
    if g.dtype not in _DTYPES:
        raise ValueError(f"pack: the table's cotangent is f32 or bf16, got "
                         f"{g.dtype}")
    if g.ndim < 4 or g.shape[-1] not in (8, 9) or not (
            g.shape[-2] == g.shape[-3] == g.shape[-4] >= 1):
        raise ValueError(f"pack: the cotangent must be [..., C,C,C, 8|9], "
                         f"got {tuple(g.shape)}")
    _check(g, "g", g.dtype, g.shape, dev)
    lead, c, ch = tuple(g.shape[:-4]), g.shape[-2], g.shape[-1]
    g_sdf = torch.empty(lead + (c + 1,) * 3, dtype=torch.float32, device=dev)
    volumes = g.numel() // (c ** 3 * ch)
    if volumes == 0:
        return g_sdf
    build()
    design = 0 if _old_design else (1 if _tiled else 2)
    got = _lib.vrt_pack_corners_bwd(g.data_ptr(), g_sdf.data_ptr(), volumes,
                                    c, ch, int(g.dtype == torch.bfloat16),
                                    design, _stream(dev))
    if got < 0:
        raise RuntimeError(f"pack backward launch failed: cudaError {-got}")
    LAUNCHES["pack_bwd"] += 1
    BWD_LAUNCHES["tiled" if got == 1 else "first"] += 1
    return g_sdf


class PackCorners(torch.autograd.Function):
    """The corner table of ``sdf`` in ``dtype`` (with ``accel`` as a 9th
    channel where it is given), differentiable in ``sdf``: on CUDA tensors
    the pack kernel and its backward kernel, on CPU tensors the plain pack
    and ``pack_corners_backward_reference``."""

    @staticmethod
    def forward(ctx, sdf, accel, dtype):
        ctx.n = sdf.shape[-1]
        if sdf.device.type == "cuda":
            return pack_corners_cuda(sdf, accel, dtype)
        from vrt_torch.march.types import pack_cell_corners_reference

        return pack_cell_corners_reference(sdf, accel, dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if g.device.type == "cuda":
            return pack_corners_backward_cuda(g.contiguous()), None, None
        return pack_corners_backward_reference(g, ctx.n), None, None
