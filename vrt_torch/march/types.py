"""Device-side volume + march result dataclasses (port of
``vrt.march.types``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vrt_torch.volume.accel import build_accel, build_accel_chebyshev
from vrt_torch.volume.volume import VoxelVolume

# Hit kinds, one per ReportHit site of the intersection shaders.
KIND_NONE = 0         # ray left the volume without a hit
KIND_SURFACE = 1      # isosurface root inside a cell (interp modes)
KIND_SOLID_ENTRY = 2  # entry cell fully solid -> hit at volume entry face
KIND_EXHAUSTED = 3    # 255-iteration cap -> reference reports t=10, unlit red
KIND_CUBE = 4         # cube mode: entered a voxel with density <= 0
KIND_DEBUG = 5        # debug overlay: octree-node border (unlit red)

# Stacked tables whose 9-channel (accel-folded) corner table fits this many
# bytes per volume fold the accel into the table, exactly as ``vrt`` does,
# so both packages build the same table bytes.  The march reads the accel
# from its own u8 table either way (the folded channel holds equal values).
FUSE_BUDGET_BYTES = 24_000_000


def pack_cell_corners(sdf, accel=None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[..., N,N,N] SDF -> [..., N-1,N-1,N-1, 8|9] per-cell corner values
    in the reference corner order, with the packed accel appended as a 9th
    channel when given.  bf16 tables clamp skip distances to 127 so the
    accel channel stays exactly representable.  Rounds to ``dtype`` with
    round-to-nearest-even, as ``vrt`` does through ml_dtypes.

    A numpy ``sdf`` (host assembly; float32, as ``vrt`` casts it) gives a
    CPU tensor.  A tensor ``sdf`` (the fit's in-step repack) gives a tensor
    on its device, differentiable in ``sdf`` through the slices; ``accel``
    is then an integer tensor."""
    from vrt_torch.march.isosurface import CORNERS

    if not isinstance(sdf, torch.Tensor):
        return pack_cell_corners(
            torch.from_numpy(np.asarray(sdf, np.float32)),
            None if accel is None else torch.from_numpy(np.asarray(accel)),
            dtype)
    c = sdf.shape[-1] - 1
    chans = [sdf[..., dx:dx + c, dy:dy + c, dz:dz + c].to(dtype)
             for dx, dy, dz in CORNERS]
    if accel is not None:
        if torch.finfo(dtype).bits < 32:
            accel = (torch.clamp_max(accel >> 1, 127) << 1) | (accel & 1)
        chans.append(accel.to(dtype))
    return torch.stack(chans, dim=-1)


def _accel_u8(accel):
    """Packed accel as uint8 of the same shape: skip distances clamp to 127
    so the packed value fits 8 bits (a smaller skip is always
    traversal-safe)."""
    av = accel.to(torch.int32)
    return ((torch.clamp_max(av >> 1, 127) << 1) | (av & 1)).to(torch.uint8)


@dataclasses.dataclass
class DeviceVolume:
    """One voxel volume's device state, or a stack of them over a leading
    V axis (padded to a common N).

    ``sdf``/``materials`` are [N,N,N] indexed [x,y,z]; ``accel`` is the
    packed skip field [N-1,N-1,N-1]; ``n`` the actual voxels per axis
    (<= N); ``corners`` the per-cell 8 corner values (9 with the folded
    accel), f32 or bf16 — the table the march and resolve read.
    ``accel_mode`` is 'octree' or 'chebyshev'.

    ``accel_u8`` (not a field) is ``accel`` clamped to uint8, the table the
    march reads; it is derived once, when the volume is constructed.
    """

    sdf: torch.Tensor        # f32 [N,N,N]
    materials: torch.Tensor  # i32 [N,N,N]
    accel: torch.Tensor      # i32 [N-1,N-1,N-1]
    n: torch.Tensor          # i32 []
    cell_size: torch.Tensor  # f32 []
    extends: torch.Tensor    # f32 []
    corners: torch.Tensor    # f32|bf16 [N-1,N-1,N-1,8|9]
    accel_mode: str = "octree"

    def __post_init__(self):
        self.accel_u8 = _accel_u8(self.accel)

    @classmethod
    def from_volume(cls, vol: VoxelVolume, pad_to: int | None = None,
                    accel_mode: str = "octree",
                    march_dtype: torch.dtype | None = None,
                    fuse_budget_bytes: int | None = None,
                    device: torch.device | str = "cuda") -> "DeviceVolume":
        """Host-side (numpy) assembly, then one transfer per array."""
        n = vol.n_voxels
        pad_n = pad_to or n
        if pad_n < n:
            raise ValueError(f"pad_to={pad_n} < {n} voxels")
        dtype = march_dtype or torch.float32
        budget = (FUSE_BUDGET_BYTES if fuse_budget_bytes is None
                  else fuse_budget_bytes)
        itemsize = torch.finfo(dtype).bits // 8
        fold_accel = (pad_n - 1) ** 3 * 9 * itemsize <= budget
        sdf = np.asarray(vol.sdf, np.float32)
        mats = np.asarray(vol.voxel_materials, np.int32)
        if accel_mode == "chebyshev":
            accel = np.asarray(build_accel_chebyshev(sdf), np.int32)
        elif accel_mode == "octree":
            accel = np.asarray(build_accel(sdf, vol.resolution), np.int32)
        else:
            raise ValueError(f"unknown accel_mode {accel_mode!r}")
        corners = pack_cell_corners(sdf, accel if fold_accel else None,
                                    dtype=dtype)
        if pad_n > n:
            p = pad_n - n
            sdf = np.pad(sdf, ((0, p),) * 3)
            mats = np.pad(mats, ((0, p),) * 3)
            accel = np.pad(accel, ((0, p),) * 3)
            corners = torch.nn.functional.pad(
                corners, (0, 0, 0, p, 0, p, 0, p))

        def dev(x):
            return torch.as_tensor(x).to(device)

        return cls(sdf=dev(sdf), materials=dev(mats), accel=dev(accel),
                   n=dev(np.int32(n)),
                   cell_size=dev(np.float32(vol.cell_size)),
                   extends=dev(np.float32(vol.extends)),
                   corners=dev(corners), accel_mode=accel_mode)


_HIT_FIELDS = ("hit", "t", "kind", "cell", "t_in", "t_out", "face_normal")


@dataclasses.dataclass
class MarchHit:
    """Per-ray march result (batched [R])."""

    hit: torch.Tensor          # bool
    t: torch.Tensor            # f32, +inf when no hit
    kind: torch.Tensor         # i32, KIND_*
    cell: torch.Tensor         # i32 [R,3] hit cell (surface/cube kinds)
    t_in: torch.Tensor         # f32 bracket entry used for the cubic
    t_out: torch.Tensor        # f32 bracket exit used for the cubic
    face_normal: torch.Tensor  # f32 [R,3] (solid-entry / exhausted kinds)
    # march iterations this lane was active for; None where not counted
    steps: torch.Tensor | None = None

    @classmethod
    def none_like(cls, o) -> "MarchHit":
        """No-hit result derived arithmetically from the ray origins, as
        ``vrt`` derives it (so the zeros carry the origins' signs)."""
        zf = o[:, 0] * 0.0
        zi = zf.to(torch.int32)
        zf3 = o * 0.0
        return cls(hit=zi != 0, t=zf + float("inf"), kind=zi,
                   cell=zf3.to(torch.int32), t_in=zf, t_out=zf,
                   face_normal=zf3)

    def select(self, mask, other: "MarchHit") -> "MarchHit":
        """Lanewise: self where mask else other (``steps`` is dropped)."""
        def sel(a, b):
            m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
            return torch.where(m, a, b)
        return MarchHit(**{f: sel(getattr(self, f), getattr(other, f))
                           for f in _HIT_FIELDS})
