"""Traversal acceleration fields (port of ``vrt.volume.accel``).

The collapsed octree as a dense per-cell skip level, or the chessboard
distance map, packed with the per-cell surface flag:

    accel[c] = (skip[c] << 1) | has_surface[c]

- octree: ``skip`` is the level L of the largest aligned 2^L-cell block
  around ``c`` that holds no surface; the node is ``(c >> L) << L``,
- chebyshev: ``skip`` is the L-inf distance in cells to the nearest surface
  cell, capped at 127; the node is the cube of half-extent ``skip - 1``
  centred on ``c``.

The host builds them from numpy arrays.  ``cell_corner_signs_differ``,
``build_skip_level`` and ``build_accel`` also take tensors of any leading
shape ([..., N,N,N]), bit for bit ``vrt``'s: on a CUDA tensor
``build_accel`` launches the accel kernels (``kernels.accel``: the
occupancy pyramid and the rebuild), elsewhere it is
``build_accel_reference`` (the max-pools a reshape and ``amax``), their
plain version.
"""

from __future__ import annotations

import numpy as np
import torch


def cell_corner_signs_differ(sdf):
    """Per-cell surface flag: the three-valued sign differs among the 8
    cell corners (an exactly-zero corner differs from both signs; a NaN
    corner, whose sign is NaN as in ``jnp.sign``, differs from every
    corner)."""
    if isinstance(sdf, torch.Tensor):
        # torch.sign(nan) is 0; vrt's jnp.sign keeps the NaN
        s = torch.where(torch.isnan(sdf), sdf, torch.sign(sdf))
        s000 = s[..., :-1, :-1, :-1]
        diff = torch.zeros(s000.shape, dtype=torch.bool, device=s.device)
    else:
        s = np.sign(sdf)
        s000 = s[..., :-1, :-1, :-1]
        diff = np.zeros(s000.shape, dtype=bool)
    c = s.shape[-1] - 1
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dx == dy == dz == 0:
                    continue
                corner = s[..., dx:dx + c, dy:dy + c, dz:dz + c]
                diff = diff | (corner != s000)
    return diff


def build_skip_level(has_surface, max_level: int):
    """Skip-level field from the per-cell surface flag: bool [..., C,C,C]
    with C = 2^max_level -> int32 [..., C,C,C] in [0, max_level]; a numpy
    flag gives a numpy field."""
    if not isinstance(has_surface, torch.Tensor):
        return build_skip_level(torch.from_numpy(np.asarray(has_surface)),
                                max_level).numpy()
    c = has_surface.shape[-1]
    lead = has_surface.shape[:-3]
    block = has_surface.to(torch.int32)
    level = torch.zeros_like(block)
    for lvl in range(1, max_level + 1):
        side = c >> lvl
        if side < 1:
            break
        # 2x2x2 max-pool of the previous level's block occupancy.
        block = block.reshape(*lead, side, 2, side, 2, side, 2).amax(
            dim=(-5, -3, -1))
        free_cells = block == 0
        for ax in (-3, -2, -1):
            free_cells = free_cells.repeat_interleave(1 << lvl, dim=ax)
        level = level.masked_fill(free_cells, lvl)
    return level


def build_accel(sdf, resolution: int):
    """Packed octree accel field: int32 [C,C,C] from a numpy [N,N,N] SDF,
    or [..., C,C,C] on the device from a tensor [..., N,N,N] (on a CUDA
    tensor the accel kernels, which take C = 2^R only)."""
    if isinstance(sdf, torch.Tensor) and sdf.device.type == "cuda":
        from vrt_torch.kernels.accel import build_accel_cuda

        return build_accel_cuda(sdf, resolution)
    return build_accel_reference(sdf, resolution)


def build_accel_reference(sdf, resolution: int):
    """``build_accel`` in numpy or eager PyTorch on any device: the cell
    flags, ``build_skip_level``'s max-pools and the pack."""
    has_surface = cell_corner_signs_differ(sdf)
    skip = build_skip_level(has_surface, resolution)
    if isinstance(has_surface, torch.Tensor):
        return (skip << 1) | has_surface.to(torch.int32)
    return (skip << 1) | has_surface.astype(np.int32)


def unpack_accel(accel):
    """-> (skip_level int32, has_surface bool), numpy or tensor."""
    if isinstance(accel, torch.Tensor):
        return accel >> 1, (accel & 1).to(torch.bool)
    return accel >> 1, (accel & 1).astype(bool)


def build_accel_chebyshev(sdf, resolution: int = 0):
    """Packed ``(chebyshev_distance << 1) | has_surface`` field; distances
    are capped at 127 so the packed value fits 8 bits."""
    has_surface = cell_corner_signs_differ(sdf)
    return (_chebyshev_dt(has_surface) << 1) | has_surface.astype(np.int32)


def _chebyshev_dt(mask: np.ndarray, cap: int = 127) -> np.ndarray:
    """Chessboard (L-inf) distance to the nearest True cell, capped, by
    iterated radius-1 cube dilations.  All-False masks return ``cap``."""
    covered = mask.astype(bool)
    dist = np.where(covered, 0, cap).astype(np.int32)

    def dilate1(m):
        for ax in range(3):
            lo = np.roll(m, 1, axis=ax)
            hi = np.roll(m, -1, axis=ax)
            # zero out the wrap-around planes
            sl_lo = [slice(None)] * 3
            sl_lo[ax] = slice(0, 1)
            sl_hi = [slice(None)] * 3
            sl_hi[ax] = slice(-1, None)
            lo[tuple(sl_lo)] = False
            hi[tuple(sl_hi)] = False
            m = m | lo | hi
        return m

    for k in range(1, cap):
        if covered.all():
            break
        grown = dilate1(covered)
        newly = grown & ~covered
        if not newly.any():
            break
        dist[newly] = k
        covered = grown
    return dist
