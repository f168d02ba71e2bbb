"""The fit step's accel rebuild: build, bind and launch
``vrt_torch/csrc/accel.cu``.

    accel_pyramid_cuda(sdf f32 [..., N,N,N], levels) -> pyramid u8, flat
    rebuild_accel_cuda(sdf, levels, dtype, channels, u8=True, pyramid=None)
        -> (table [..., C,C,C, channels] | None, accel i32 [..., C,C,C],
            accel_u8 u8 [..., C,C,C] | None)
    build_accel_cuda(sdf, resolution) -> accel i32 [..., C,C,C]
    RebuildAccel.apply(sdf, levels, dtype, channels)
        -> (table, accel, accel_u8), the table differentiable in sdf

C = N - 1 = 2^R >= 2.  The pyramid (one launch; its first design, behind
``_old_design=True``, one for every 3 levels) holds, for L = 1..levels, the
u8 occupancy of the aligned 2^L-cell blocks: level L is
the 2x2x2 OR of level L-1, level 0 the cells' surface flags
(``volume.accel.cell_corner_signs_differ``).  The rebuild (one launch)
walks it up from each cell: the skip is the largest level whose block is
free, as ``vrt``'s ``build_skip_level`` keeps it.  It writes the packed
accel ``(skip << 1) | flag``, its u8 view (``march.types._accel_u8``'s
clamp at 127) and, with ``channels`` 8 or 9, the corner table that
``march.types.pack_cell_corners_reference`` packs (the accel as the 9th
channel), each bit for bit as its plain version: ``rebuild_accel_reference``
(the eager ``volume.accel.build_accel_reference``, ``_accel_u8`` and the
plain pack), and for the pyramid ``occupancy_pyramid_reference``, whose walk
``skip_from_pyramid_reference`` gives ``vrt``'s skip levels.

``RebuildAccel`` joins them to the pack's backward (``kernels.pack``: the
tiled kernel on CUDA tensors, the slices' transpose on CPU tensors): on
CUDA tensors ``diff.fit.rebuild_accel`` takes it, and
``volume.accel.build_accel`` takes ``build_accel_cuda``.  The wrappers check
device, dtype, shape, contiguity and C = 2^R, raise on what the kernels do
not take, never fall back, and count their launches in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels.march import _check as _check_tensor
from vrt_torch.kernels.march import _stream

LAUNCHES = {"pyramid": 0, "rebuild": 0}
_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' grid: volumes times level-1 blocks a side at most 65,535
_MAX_GRID_Z = 65535
_MAX_LEVELS = 12

_lib = None
# the one-launch pyramid's ticket counters, one a (device, stream): the
# grid's last block resets its counter, so launches in turn on a stream
# share one, and launches on other streams (or ranks) never see it
_TICKETS = {}


def build() -> str:
    """Compile (when the library is missing) and load the two kernels.
    Returns the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("accel.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vrt_accel_pyramid.argtypes = [ptr, ptr, i64, i32, i32, ptr, i32, ptr]
    lib.vrt_accel_pyramid.restype = i32
    lib.vrt_accel_rebuild.argtypes = [ptr] * 5 + [i64] + [i32] * 4 + [ptr]
    lib.vrt_accel_rebuild.restype = i32
    _lib = lib
    return log


# ---- plain versions ---------------------------------------------------------

def pyramid_sides(c: int, levels: int):
    """The side of each pyramid level 1..levels over C = ``c`` cells."""
    return [c >> lvl for lvl in range(1, levels + 1)]


def _pyramid_cells(c: int, levels: int) -> int:
    """Entries of one volume's pyramid, levels 1..levels."""
    return sum(side ** 3 for side in pyramid_sides(c, levels))


def occupancy_pyramid_reference(has_surface, levels: int):
    """The u8 occupancy of levels 1..``levels`` over a bool [..., C,C,C]
    flag: level L [..., C>>L, C>>L, C>>L] is the 2x2x2 OR (max) of level
    L-1, level 0 the flag (the plain version of the pyramid kernel)."""
    lead, c = tuple(has_surface.shape[:-3]), has_surface.shape[-1]
    if c & (c - 1) or not 0 <= levels <= c.bit_length() - 1:
        raise ValueError(f"the pyramid takes C = 2^R cells a side and at "
                         f"most R levels, got C = {c}, {levels} levels")
    block = has_surface.to(torch.uint8)
    out = []
    for side in pyramid_sides(c, levels):
        block = block.reshape(*lead, side, 2, side, 2, side, 2).amax(
            dim=(-5, -3, -1))
        out.append(block)
    return out


def skip_from_pyramid_reference(has_surface, pyramid):
    """The rebuild kernel's walk: from each cell up the levels of
    ``pyramid`` while its block is free; the skip is the last free level
    (0 where the cell holds a surface or its level-1 block does).  Equal to
    ``vrt``'s ``build_skip_level``, which keeps the highest free level,
    because occupancy only grows up the pyramid.  int32 [..., C,C,C]."""
    c = has_surface.shape[-1]
    cells = torch.arange(c, device=has_surface.device)
    going = ~has_surface
    skip = torch.zeros(has_surface.shape, dtype=torch.int32,
                       device=has_surface.device)
    for lvl, occ in enumerate(pyramid, 1):
        i = cells >> lvl
        free = occ[..., i[:, None, None], i[None, :, None], i[None, None, :]]
        going = going & (free == 0)
        skip = torch.where(going, torch.full_like(skip, lvl), skip)
    return skip


def rebuild_accel_reference(sdf, levels: int, dtype=None, channels: int = 0):
    """The rebuild in eager PyTorch on any device (the plain version of the
    two kernels): ``(table | None, accel, accel_u8)`` from the eager
    ``build_accel_reference``, ``_accel_u8`` and, with ``channels`` 8 or 9,
    ``pack_cell_corners_reference`` (the accel as the 9th channel)."""
    from vrt_torch.march.types import _accel_u8, pack_cell_corners_reference
    from vrt_torch.volume.accel import build_accel_reference

    with torch.no_grad():
        accel = build_accel_reference(sdf.detach(), levels)
    table = None
    if channels:
        table = pack_cell_corners_reference(
            sdf, accel if channels == 9 else None, dtype)
    return table, accel, _accel_u8(accel)


# ---- wrappers ---------------------------------------------------------------

def _volume_shape(sdf, who: str):
    """(leading dims, C, R, volumes) of an SDF the kernels take; raises
    otherwise."""
    if sdf.device.type != "cuda":
        raise ValueError(f"{who} runs on CUDA tensors, got {sdf.device}")
    if sdf.ndim < 3 or not (sdf.shape[-1] == sdf.shape[-2] == sdf.shape[-3]
                            >= 3):
        raise ValueError(f"{who}: sdf must be [..., N,N,N] with N >= 3 (the "
                         f"kernels take 2x2x2 cells a thread), got "
                         f"{tuple(sdf.shape)}")
    c = sdf.shape[-1] - 1
    if c & (c - 1):
        raise ValueError(f"{who}: the cells a side must be a power of two "
                         f"(C = 2^R), got {c}")
    _check_tensor(sdf, "sdf", torch.float32, sdf.shape, sdf.device, who=who)
    lead = tuple(sdf.shape[:-3])
    r = c.bit_length() - 1
    volumes = sdf.numel() // (c + 1) ** 3
    if r > _MAX_LEVELS or volumes * (c // 2) > _MAX_GRID_Z:
        raise ValueError(f"{who}: {volumes} volumes of {c} cells a side are "
                         f"more than the kernels' grid takes")
    return lead, c, r, volumes


def _ticket(dev):
    """The zeroed i32 counter of the one-launch pyramid on the current
    stream of ``dev`` (made, with one fill, at its first use)."""
    key = (dev.index, _stream(dev))
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def accel_pyramid_cuda(sdf, levels: int, _old_design: bool = False):
    """Launch the pyramid on ``torch.cuda.current_stream()``: levels
    1..``levels`` (0 <= levels <= R) of ``sdf``'s occupancy, level after
    level in one flat u8 tensor (``pyramid_levels`` splits it), in one
    launch (``_old_design``: the first design's ceil(levels / 3)).  Raises
    on any input the kernel does not take; never falls back."""
    lead, c, r, volumes = _volume_shape(sdf, "the accel pyramid")
    if not 0 <= levels <= r:
        raise ValueError(f"the accel pyramid: levels {levels} outside 0..{r}")
    dev = sdf.device
    if volumes == 0 or levels == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev)
    build()
    pyramid = torch.empty(volumes * _pyramid_cells(c, levels),
                          dtype=torch.uint8, device=dev)
    ticket = None if _old_design or levels <= 3 else _ticket(dev).data_ptr()
    got = _lib.vrt_accel_pyramid(sdf.data_ptr(), pyramid.data_ptr(), volumes,
                                 r, levels, ticket, int(not _old_design),
                                 _stream(dev))
    if got < 0:
        raise RuntimeError(f"accel pyramid launch failed: cudaError {-got}")
    LAUNCHES["pyramid"] += got
    return pyramid


def pyramid_levels(pyramid, lead, c: int, levels: int):
    """The levels of a flat pyramid: [u8 lead + (C>>L,)*3 for L = 1..]."""
    out, at = [], 0
    for side in pyramid_sides(c, levels):
        count = side ** 3
        for d in lead:
            count *= d
        out.append(pyramid[at:at + count].view(*lead, side, side, side))
        at += count
    return out


def rebuild_accel_cuda(sdf, levels: int, dtype=None, channels: int = 0,
                       u8: bool = True, pyramid=None):
    """Launch the pyramid (unless ``pyramid``, its flat output, is given)
    and the rebuild on ``torch.cuda.current_stream()``: ``(table | None,
    accel, accel_u8 | None)`` of ``sdf`` over levels 1..``levels``, the
    table [..., C,C,C, channels] in ``dtype`` (f32 or bf16) where
    ``channels`` is 8 or 9 (0: none), the u8 view where ``u8``.  Records no
    autograd graph (``RebuildAccel`` adds it).  Raises on any input the
    kernels do not take; never falls back."""
    lead, c, r, volumes = _volume_shape(sdf, "the accel rebuild")
    if not 0 <= levels <= r:
        raise ValueError(f"the accel rebuild: levels {levels} outside "
                         f"0..{r}")
    if channels not in (0, 8, 9):
        raise ValueError(f"the accel rebuild: a table has 8 or 9 channels, "
                         f"got {channels}")
    if channels and dtype not in _DTYPES:
        raise ValueError(f"the accel rebuild: the table is f32 or bf16, got "
                         f"{dtype}")
    dev = sdf.device
    cells = lead + (c, c, c)
    accel = torch.empty(cells, dtype=torch.int32, device=dev)
    view = torch.empty(cells, dtype=torch.uint8, device=dev) if u8 else None
    table = (torch.empty(cells + (channels,), dtype=dtype, device=dev)
             if channels else None)
    if volumes == 0:
        return table, accel, view
    if pyramid is None:
        pyramid = accel_pyramid_cuda(sdf, levels)
    else:
        _check_tensor(pyramid, "pyramid", torch.uint8,
                      (volumes * _pyramid_cells(c, levels),), dev,
                      who="the accel rebuild")
    build()
    err = _lib.vrt_accel_rebuild(
        sdf.data_ptr(), pyramid.data_ptr() if levels else None,
        accel.data_ptr(), None if view is None else view.data_ptr(),
        None if table is None else table.data_ptr(), volumes, r, levels,
        channels, int(dtype == torch.bfloat16), _stream(dev))
    if err != 0:
        raise RuntimeError(f"accel rebuild launch failed: cudaError {err}")
    LAUNCHES["rebuild"] += 1
    return table, accel, view


def build_accel_cuda(sdf, resolution: int):
    """``volume.accel.build_accel`` on the card: the packed octree accel
    int32 [..., C,C,C] of ``sdf`` over min(resolution, R) levels (``vrt``'s
    loop stops where a level has no cell), from the pyramid and the rebuild
    without table or u8 view."""
    r = (sdf.shape[-1] - 1).bit_length() - 1 if sdf.ndim else 0
    levels = max(0, min(int(resolution), r))
    return rebuild_accel_cuda(sdf, levels, u8=False)[1]


class RebuildAccel(torch.autograd.Function):
    """``(table, accel, accel_u8)`` of ``sdf`` over ``levels`` pyramid
    levels, the table [..., C,C,C, ``channels``] (8 or 9, the accel as the
    9th) in ``dtype``, differentiable in ``sdf``; the accel and its view are
    not.  On CUDA tensors the pyramid and rebuild kernels forward and the
    pack's backward kernel; on CPU tensors ``rebuild_accel_reference`` and
    ``pack_corners_backward_reference``."""

    @staticmethod
    def forward(ctx, sdf, levels, dtype, channels):
        if channels not in (8, 9):
            raise ValueError(f"RebuildAccel packs 8 or 9 channels, got "
                             f"{channels}")
        ctx.n = sdf.shape[-1]
        if sdf.device.type == "cuda":
            out = rebuild_accel_cuda(sdf, levels, dtype, channels)
        else:
            out = rebuild_accel_reference(sdf, levels, dtype, channels)
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _accel, _view):
        from vrt_torch.kernels import pack as kp

        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if g.device.type == "cuda":
            return kp.pack_corners_backward_cuda(g.contiguous()), None, None, \
                None
        return kp.pack_corners_backward_reference(g, ctx.n), None, None, None
