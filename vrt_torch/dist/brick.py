"""Slab-sharded voxel volumes with halo exchange: model parallelism (port
of ``vrt.dist.brick``).

A volume is split into x-slabs over the mesh's 'model' axis.  Shard s
stores its owned SDF voxel planes ``[cell_lo, cell_hi]`` plus ``HALO`` = 2
planes a side (the cell-corner stencil needs one more plane, the
central-difference normal two), and the accel field built over the FULL
grid, sliced to its owned cells, so that in-slab traversal takes the
replicated march's node steps.

Every shard marches every ray but reports hits only inside its owned
cells: out-of-slab space is one empty node from the slab boundary outward,
crossed in one step.  The closest hit across shards is an all-gather of t,
an argmin and a sum to which one shard contributes (``combine_hits``).
Halos refresh with the neighbour send/recv pair (``exchange_halos``),
differentiable: its backward sends each halo plane's cotangent back to the
plane's owner.

The host side (``shard_volume``) gives stacked [S, ...] CPU tensors, equal
to ``vrt``'s arrays bit for bit; ``SlabVolume.local`` gives one rank its
slab.  ``march_volume_slab`` is the slab march: K7
(``vrt_torch/csrc/march.cu`` through ``vrt_torch.kernels.march``) on CUDA
tensors, its plain twin ``march_volume_slab_reference`` (``vrt``'s
``_march_core`` with the slab's four hooks) on CPU tensors.
``resolve_slab_hits`` is the plain resolve; the slab tracer resolves on
the card through the fused resolve over the slab's planes
(``vrt_torch.kernels.resolve.ResolveSlab``: the forward and backward
kernels), whose backward's plain version is
``resolve_slab_backward_reference``.

``SlabVolume.table`` chooses what K7 and the slab resolve read: the planes
themselves (``"planes"``, the default, as ``vrt``'s voxel fetch reads them)
or the first design's slab-local packed corner table (``"packed"``,
[span-1, C, C, 8], 8x the planes' bytes, packed from them where the slab
first asks for its tables).  Both give the same hits, and the same t and
normal on every hit inside the volume.  ``"packed"`` is kept only as the
comparator of the timing runs and of the tests that hold the two designs
against each other: no entry point of the port sets it, and a caller has
no reason to (it costs 1.1 GB a rank at config5's 513^3, and its
gradient as much again in a fit step).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from vrt_torch.core.grid import DEFAULT_DENSITY
from vrt_torch.dist import mesh as _mesh
from vrt_torch.march import isosurface as iso
from vrt_torch.march.march import (march_core_reference, node_box_from_accel,
                                   ray_aabb)
from vrt_torch.march.resolve import resolve_hits
from vrt_torch.march.types import MarchHit, _accel_u8
from vrt_torch.volume.accel import build_accel, build_accel_chebyshev

HALO = 2  # voxel planes a side: corner stencil +1, normal stencil +2

_FIELDS = ("sdf", "accel", "x_voxel0", "cell_lo", "cell_hi", "n",
           "cell_size", "extends")
TABLES = ("planes", "packed")


@dataclasses.dataclass
class SlabVolume:
    """One volume split into x-slabs: stacked over a leading S axis (as
    ``shard_volume`` gives it), or one rank's slab without that axis (as
    ``local`` gives it)."""

    sdf: torch.Tensor        # f32 [S, span, N, N]; span = cps + 1 + 2*HALO
    accel: torch.Tensor      # i32 [S, cps, C, C]: global accel, owned cells
    x_voxel0: torch.Tensor   # i32 [S] global x of local sdf plane 0
    cell_lo: torch.Tensor    # i32 [S] first owned x-cell
    cell_hi: torch.Tensor    # i32 [S] end of the owned x-cells (exclusive)
    n: torch.Tensor          # i32 [S] voxels per axis of the full volume
    cell_size: torch.Tensor  # f32 [S]
    extends: torch.Tensor    # f32 [S]
    accel_mode: str = "octree"   # 'octree' | 'chebyshev'
    table: str = "planes"        # TABLES; "packed" is a comparator only

    def __post_init__(self):
        if self.table not in TABLES:
            raise ValueError(f"unknown slab table {self.table!r}")

    def local(self, rank: int, device: torch.device | str = "cuda"
              ) -> "SlabVolume":
        """Shard ``rank``'s slab on ``device``: every field without the
        leading axis."""
        return SlabVolume(**{f: getattr(self, f)[rank].to(device)
                             for f in _FIELDS}, accel_mode=self.accel_mode,
                          table=self.table)

    @functools.cached_property
    def march_tables(self) -> dict:
        """What K7 and the slab's fused resolve read, for a local slab:
        ``sdf`` f32 [span, N, N], the planes (plane x is global plane
        ``x_voxel0 + x``; a voxel outside the volume or the planes reads
        0), ``accel_u8`` u8 [cps, C, C] over the owned cells (skips clamped
        to 127, as K1 reads them), the slab's scalars as Python numbers,
        and as the fused resolve's ``volume`` tables; with ``table ==
        "packed"`` also ``corners`` f32 [span-1, C, C, 8], the first
        design's slab-local corner table (row x is global cell ``x_voxel0 +
        x``; a cell that is not inside the volume reads zeros).

        ``corners`` is packed with a graph wherever the planes require a
        gradient, even when first asked for under ``no_grad`` (the march
        asks first): ``ResolveSlab`` then takes it as its differentiable
        input, and its gradient reaches the planes through the pack's
        slices.  K7 reads data only."""
        if self.sdf.dim() != 3:
            raise ValueError("march_tables belong to one rank's slab")
        packed = {}
        if self.table == "packed":
            with torch.enable_grad():
                packed["corners"] = _pack_slab_corners(self.sdf)
        return dict(**packed,
                    accel_u8=_accel_u8(self.accel).contiguous(),
                    sdf=self.sdf.contiguous(),
                    x0=int(self.x_voxel0), cell_lo=int(self.cell_lo),
                    cell_hi=int(self.cell_hi), n=int(self.n),
                    h=float(self.cell_size), ext=float(self.extends),
                    # the slab as the fused resolve's one volume: n, cell
                    # size, extent [1], and instance -> volume 0
                    volume=(self.n.reshape(1), self.cell_size.reshape(1),
                            self.extends.reshape(1),
                            torch.zeros(1, dtype=torch.int32,
                                        device=self.sdf.device)))

    @property
    def resolve_table(self) -> torch.Tensor:
        """``ResolveSlab``'s differentiable input: the planes, or with
        ``table == "packed"`` the packed corner table."""
        if self.table == "packed":
            return self.march_tables["corners"]
        return self.sdf


def _pack_slab_corners(sdf):
    """[span, N, N] planes -> [span-1, N-1, N-1, 8] corner rows in the
    reference corner order (``types.pack_cell_corners`` for a slab)."""
    cx, c = sdf.shape[0] - 1, sdf.shape[-1] - 1
    return torch.stack([sdf[dx:dx + cx, dy:dy + c, dz:dz + c]
                        for dx, dy, dz in iso.CORNERS], dim=-1).contiguous()


def shard_volume(vol, n_shards: int, accel_mode: str = "octree"
                 ) -> SlabVolume:
    """Host-side slab split of a ``VoxelVolume``: stacked CPU tensors.
    The cells per axis must divide by ``n_shards``.  The accel field is
    built over the FULL grid first (its skip blocks are surface-free
    globally, so an owned cell's skip may jump past the slab), then sliced
    per shard; edge shards' halo planes outside the volume hold
    ``DEFAULT_DENSITY``."""
    n = vol.n_voxels
    cells = n - 1
    if cells % n_shards:
        raise ValueError(f"{cells} cells do not split into {n_shards} "
                         f"slabs")
    cps = cells // n_shards
    span = cps + 1 + 2 * HALO
    sdf_full = np.asarray(vol.sdf, np.float32)
    if accel_mode == "chebyshev":
        accel_full = np.asarray(build_accel_chebyshev(sdf_full), np.int32)
    elif accel_mode == "octree":
        accel_full = np.asarray(build_accel(sdf_full, vol.resolution),
                                np.int32)
    else:
        raise ValueError(f"unknown accel_mode {accel_mode!r}")

    sdf = np.full((n_shards, span, n, n), DEFAULT_DENSITY, np.float32)
    accel = np.zeros((n_shards, cps, cells, cells), np.int32)
    x0s = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        x0s[s] = s * cps - HALO
        lo, hi = max(0, x0s[s]), min(n, x0s[s] + span)
        sdf[s, lo - x0s[s]:hi - x0s[s]] = sdf_full[lo:hi]
        accel[s] = accel_full[s * cps:(s + 1) * cps]
    los = x0s + HALO
    return slab_from_numpy(dict(
        sdf=sdf, accel=accel, x_voxel0=x0s, cell_lo=los, cell_hi=los + cps,
        n=np.full(n_shards, n, np.int32),
        cell_size=np.full(n_shards, vol.cell_size, np.float32),
        extends=np.full(n_shards, vol.extends, np.float32)), accel_mode)


def slab_from_numpy(fields: dict, accel_mode: str = "octree",
                    table: str = "planes") -> SlabVolume:
    """The port's ``SlabVolume`` from arrays: ``vrt``'s ``SlabVolume``
    fields as numpy arrays (what ``scene_from_numpy`` is for a scene), on
    the CPU."""
    return SlabVolume(**{f: torch.from_numpy(np.array(fields[f]))
                         for f in _FIELDS}, accel_mode=accel_mode,
                      table=table)


def _slab_voxel_index(slab: SlabVolume, idx):
    """(flat index into a local slab's planes, valid) of GLOBAL voxel
    indices ``idx`` [..., 3]: valid where the voxel is inside the volume
    and among the stored planes; elsewhere the index is clamped."""
    span, nn = slab.sdf.shape[0], slab.sdf.shape[-1]
    lx = idx[..., 0] - slab.x_voxel0
    valid = (torch.all((idx >= 0) & (idx < slab.n), dim=-1)
             & (lx >= 0) & (lx < span))
    lxc = torch.clamp(lx, 0, span - 1)
    ic = torch.clamp(idx[..., 1:], 0, nn - 1)
    return (lxc.long() * nn + ic[..., 0]) * nn + ic[..., 1], valid


def _slab_fetch(slab: SlabVolume):
    """Voxel fetch in GLOBAL indices against a local slab's planes; voxels
    outside the volume or outside the stored planes read 0.0."""
    flat = slab.sdf.reshape(-1)

    def fetch(idx):
        lin, valid = _slab_voxel_index(slab, idx)
        return torch.where(valid, flat[lin], 0.0)

    return fetch


def _slab_accel_fetch(slab: SlabVolume):
    """Packed accel value of GLOBAL cells; 0 outside the owned cells."""
    cps, cc = slab.accel.shape[0], slab.accel.shape[-1]
    flat = slab.accel.reshape(-1)

    def fetch(cell):
        owned = ((cell[..., 0] >= slab.cell_lo) & (cell[..., 0] < slab.cell_hi)
                 & torch.all((cell[..., 1:] >= 0) & (cell[..., 1:] < cc),
                             dim=-1))
        lx = torch.clamp(cell[..., 0] - slab.cell_lo, 0, cps - 1)
        ic = torch.clamp(cell[..., 1:], 0, cc - 1)
        lin = (lx.long() * cc + ic[..., 0]) * cc + ic[..., 1]
        return torch.where(owned, flat[lin], 0)

    return fetch


class _SlabFetchers:
    """The slab's fetchers in the shape ``march_core_reference`` takes."""

    def __init__(self, slab: SlabVolume):
        self.voxel = _slab_fetch(slab)
        self.accel = _slab_accel_fetch(slab)

    def accel_at(self, cell, lanes=None):
        return self.accel(cell)

    def corners_at(self, cell, lanes=None):
        return iso.gather_corners(self.voxel, cell)

    def density_at(self, cell, lanes=None):
        return self.voxel(cell)


@torch.no_grad()
def march_volume_slab_reference(slab: SlabVolume, o, d, t_max,
                                interp: bool = True,
                                debug_overlay: bool = False) -> MarchHit:
    """K7's plain twin: rays (object space) against one local slab,
    ``vrt``'s ``march_volume_slab``.  The march loop of
    ``march_lanes_reference`` (``march_core_reference``) with the slab's
    global-index fetches and its four hooks:

    - ``node_geometry``: an owned cell keeps its skip box; the out-of-slab
      region on either side is one empty node, [-ext, lo_plane] or
      [hi_plane, ext] in x and the full extent in y and z,
    - ``lane_ok``: lanes whose chord misses the slab box retire before the
      loop,
    - ``t_exit_cap``: the traversal's exit clamps to the slab box's exit
      plus one cell,
    - ``voxel_owned`` (cube mode): a voxel x-plane must be owned; the last
      shard also owns plane n-1.

    Hits are reported only for owned cells; ``combine_hits`` joins them."""
    # as vrt does (a value-preserving zero, but -0.0 + 0.0 is +0.0)
    vz = slab.cell_size * 0.0
    o, d, t_max = o + vz, d + vz, t_max + vz
    lanes = o.shape[0]
    h, ext, n = slab.cell_size, slab.extends, slab.n
    f32 = torch.float32
    lo_plane = slab.cell_lo.to(f32) * h - ext
    hi_plane = slab.cell_hi.to(f32) * h - ext

    def node_geometry(cell, av):
        valid, has_surf, own_lo, own_hi = node_box_from_accel(
            cell, av, slab.accel_mode, n, h, h, ext)
        x = cell[..., 0]
        owned = (x >= slab.cell_lo) & (x < slab.cell_hi)
        left = x < slab.cell_lo
        neg = torch.broadcast_to(-ext, x.shape)
        pos = torch.broadcast_to(ext, x.shape)
        out_lo = torch.stack([torch.where(left, -ext, hi_plane), neg, neg],
                             dim=-1)
        out_hi = torch.stack([torch.where(left, lo_plane, ext), pos, pos],
                             dim=-1)
        m = owned[..., None]
        return (valid, has_surf & owned, torch.where(m, own_lo, out_lo),
                torch.where(m, own_hi, out_hi))

    slab_lo = torch.stack([lo_plane, -ext, -ext])
    slab_hi = torch.stack([hi_plane, ext, ext])
    slab_ok, _, slab_exit = ray_aabb(o, d, slab_lo, slab_hi, t_max)

    def voxel_owned(cell):
        x = cell[..., 0]
        return (((x >= slab.cell_lo) & (x < slab.cell_hi))
                | ((x == n - 1) & (slab.cell_hi == n - 1)))

    return march_core_reference(
        _SlabFetchers(slab), n.expand(lanes), h.expand(lanes),
        ext.expand(lanes), slab.accel_mode, o, d, t_max, interp,
        debug_overlay, node_geometry=node_geometry, lane_ok=slab_ok,
        t_exit_cap=slab_exit + h, voxel_owned=voxel_owned)


def march_volume_slab(slab: SlabVolume, o, d, t_max, interp: bool = True,
                      debug_overlay: bool = False) -> MarchHit:
    """March rays (object space, f32 [R,3]; t_max f32 [R]) against one
    local slab, reporting hits in owned cells only.  On CUDA tensors this
    launches K7; on CPU tensors it runs the twin."""
    if o.device.type == "cuda":
        from vrt_torch.kernels import march as k1

        return k1.march_slab_cuda(slab, o.contiguous(), d.contiguous(),
                                  t_max.contiguous(), interp, debug_overlay)
    if o.device.type != "cpu":
        raise ValueError(f"no slab march for device {o.device}")
    return march_volume_slab_reference(slab, o, d, t_max, interp,
                                       debug_overlay)


def combine_hits(hit: MarchHit, group) -> MarchHit:
    """The closest hit across ``group`` (``vrt``'s one-contributor sum):
    every rank all-gathers t (+inf where no hit), takes the argmin over the
    ranks (the first on a tie), and each field is the sum over the ranks of
    the winner's value and zeros elsewhere (booleans summed as int32).  So
    the bits are ``vrt``'s, with a -0.0 of the winner summed to +0.0."""
    t_key = torch.where(hit.hit, hit.t, float("inf"))
    all_t = _mesh.all_gather(t_key[None], group)              # [S, R]
    win = torch.argmin(all_t, dim=0) == torch.distributed.get_rank(group)

    def pick(x):
        if x is None:
            return None
        m = win.reshape(win.shape + (1,) * (x.dim() - 1))
        if x.dtype == torch.bool:
            return _mesh.all_reduce_sum(
                torch.where(m, x, False).to(torch.int32), group) > 0
        return _mesh.all_reduce_sum(torch.where(m, x, torch.zeros_like(x)),
                                    group)

    return MarchHit(**{f.name: pick(getattr(hit, f.name))
                       for f in dataclasses.fields(MarchHit)})


class _ExchangeHalos(torch.autograd.Function):
    """The neighbour pair on a local slab's planes, and its transpose."""

    @staticmethod
    def forward(ctx, sdf, group):
        ctx.group = group
        span, hl = sdf.shape[0], HALO
        from_left, from_right = _mesh.neighbour_exchange(
            sdf[span - 2 * hl - 1:span - hl - 1], sdf[hl + 1:2 * hl + 1],
            group)
        new = sdf.clone()
        if from_left is not None:
            new[:hl] = from_left
        if from_right is not None:
            new[span - hl:] = from_right
        return new

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # my left halo's cotangent goes to the left neighbour's owned slots
        # [span - 2*HALO - 1, span - HALO - 1), my right halo's to the right
        # neighbour's [HALO + 1, 2*HALO + 1); a halo slot that a neighbour
        # overwrote keeps none of its own, an edge rank's outer halo all
        span, hl = g.shape[0], HALO
        g = g.contiguous()
        from_left, from_right = _mesh.neighbour_exchange(
            g[span - hl:], g[:hl], ctx.group)
        out = g.clone()
        if from_left is not None:
            out[:hl] = 0.0
            out[hl + 1:2 * hl + 1] += from_left
        if from_right is not None:
            out[span - hl:] = 0.0
            out[span - 2 * hl - 1:span - hl - 1] += from_right
        return out, None


def exchange_halos(slab: SlabVolume, group) -> SlabVolume:
    """Refresh a local slab's halo planes from its neighbours in ``group``:
    my left-halo slots [0, HALO) are globals [cell_lo - HALO, cell_lo), the
    left neighbour's owned slots [span - 2*HALO - 1, span - HALO - 1); my
    right-halo slots [span - HALO, span) the right neighbour's owned slots
    [HALO + 1, 2*HALO + 1).  Edge shards keep their planes outside the
    volume.  Differentiable (``vrt``'s ``ppermute`` pair and its
    transpose): a halo plane's cotangent is added into the owner's plane,
    a halo slot that was overwritten keeps none, and an edge shard keeps
    the cotangent of its planes outside the volume.  The backward is the
    same neighbour pair in reverse, copies and one add a plane."""
    return dataclasses.replace(slab, sdf=_ExchangeHalos.apply(slab.sdf,
                                                              group))


def assemble_full_sdf(slabs: SlabVolume, group=None) -> torch.Tensor:
    """The full [N,N,N] SDF from the slabs' OWNED planes (shard s owns
    voxel planes [cell_lo, cell_hi); the last shard also the final plane):
    from stacked slabs, or, with ``group``, from each rank's local slab by
    an all-gather of the owned planes over ``group`` (every rank gets the
    grid)."""
    span = slabs.sdf.shape[-3]
    cps = span - 1 - 2 * HALO
    if group is None:
        owned = slabs.sdf[:, HALO:HALO + cps]
        last = slabs.sdf[-1, HALO + cps]
        return torch.cat([owned.reshape(-1, *owned.shape[2:]), last[None]])
    owned = _mesh.all_gather(slabs.sdf[HALO:HALO + cps], group)
    last = _mesh.all_gather(slabs.sdf[HALO + cps][None], group)[-1]
    return torch.cat([owned, last[None]])


def resync_slabs(slabs: SlabVolume, resolution: int,
                 group=None) -> SlabVolume:
    """Gather the slabs' owned planes into the full grid
    (``assemble_full_sdf``), rebuild the octree accel over the CURRENT
    geometry (``vrt`` rebuilds octree in every accel mode) and cut SDF and
    accel into the slab layout again: stacked slabs give stacked slabs
    equal to ``shard_volume`` of a volume holding the assembled SDF; a
    local slab with ``group`` gives this rank's slab of that split."""
    full = assemble_full_sdf(slabs, group)
    n = full.shape[0]
    n_shards = (slabs.sdf.shape[0] if group is None
                else torch.distributed.get_world_size(group))
    cps = (n - 1) // n_shards
    span = cps + 1 + 2 * HALO
    accel_full = build_accel(full, resolution)
    pad = torch.full((HALO,) + tuple(full.shape[1:]), DEFAULT_DENSITY,
                     dtype=full.dtype, device=full.device)
    padded = torch.cat([pad, full, pad])
    shards = (range(n_shards) if group is None
              else [torch.distributed.get_rank(group)])
    sdf = torch.stack([padded[s * cps:s * cps + span] for s in shards])
    accel = torch.stack([accel_full[s * cps:(s + 1) * cps] for s in shards])
    if group is not None:
        sdf, accel = sdf[0], accel[0]
    return dataclasses.replace(slabs, sdf=sdf, accel=accel)


def resolve_slab_hits(slab: SlabVolume, o, d, hit: MarchHit):
    """(t, object-space normal, unlit) for hits against one local slab
    (meaningful on owned-cell hits: the 2-voxel halo covers a boundary
    cell's stencil), from the slab's voxels by global index: ``resolve_hits``
    over ``corner_fetch_from_voxels(_slab_fetch(slab))``.  The plain
    version of the slab tracer's fused resolve on the card."""
    r = o.shape[0]
    return resolve_hits(iso.corner_fetch_from_voxels(_slab_fetch(slab)),
                        slab.cell_size.expand(r), slab.extends.expand(r),
                        o, d, hit)


def slab_corner_index(cell, n, x0, cx: int, cc: int):
    """Row index i32 into a local slab's [cx*C*C, 8] corner table
    (``march_tables``: row ``((x - x0) * C + y) * C + z`` holds cell
    (x, y, z)) for cells shaped [..., 3]; -1 where the cell is out of the
    volume (cell < 0 or cell + 1 >= n) or outside the table's rows, where
    the kernels read zeros and add nothing."""
    lx = cell[..., 0] - x0
    valid = (torch.all((cell >= 0) & (cell + 1 < n), dim=-1)
             & (lx >= 0) & (lx < cx))
    flat = (lx.long() * cc + cell[..., 1]) * cc + cell[..., 2]
    return torch.where(valid, flat, -1).to(torch.int32)


@torch.no_grad()
def resolve_slab_backward_reference(scene, slab: SlabVolume, o_w, d_w,
                                    hit: MarchHit, g_t, g_normal,
                                    acc_dtype=torch.float32):
    """The vector-Jacobian product of the slab's fused resolve in the world
    rays and the slab's ``resolve_table``, in closed form: -> (g_o_w f32
    [R,3], g_d_w f32 [R,3], g_table) for the cotangents ``g_t`` [R] and
    ``g_normal`` [R,3] of t and the object-space normal.  The plain version
    of the slab resolve's backward kernel, as
    ``renderer.resolve_scene_backward_reference`` is the scene's: world rays
    through ``scene``'s one instance, ``resolve_hits_backward`` over the
    seven rows of 8 corners, and an ``index_add_`` in ``acc_dtype`` in lane
    order (a masked corner adds an exact zero into index 0, as
    ``scatter_rows_reference`` does).  On the planes (``table ==
    "planes"``): the rows read by voxel as ``_slab_fetch`` reads them, each
    corner's cotangent added into its voxel, ``g_table`` [span, N, N]; a
    voxel outside the volume or the stored planes reads 0 and takes none.
    On the packed table: the rows of ``slab_corner_index``, ``g_table``
    [cx*C*C, 8], a row outside the volume or the table reading zeros and
    taking none.  Reads ``hit.kind``, ``hit.t`` and ``hit.cell`` only."""
    from vrt_torch.core import quat as vq
    from vrt_torch.kernels.rows import (gather_rows_reference,
                                        scatter_rows_reference)
    from vrt_torch.march.resolve import _OFFS7, resolve_hits_backward
    from vrt_torch.render.renderer import _world_to_object

    pos, rot, scale = scene.inst_pos[0], scene.inst_rot[0], scene.inst_scale[0]
    o, d = _world_to_object(pos, rot, scale, o_w, d_w)
    offs = torch.as_tensor(_OFFS7, device=o_w.device)
    cells = hit.cell[:, None, :] + offs                           # [R,7,3]
    r = o_w.shape[0]
    if slab.table == "packed":
        tb = slab.march_tables
        corners = tb["corners"].detach()
        cx, cc = corners.shape[0], corners.shape[1]
        flat = corners.reshape(-1, 8)
        idx = slab_corner_index(cells, slab.n, tb["x0"], cx, cc).reshape(-1)
        rows7 = gather_rows_reference(flat, idx, 8).reshape(-1, 7, 8)
    else:
        sdf = slab.sdf.detach()
        lin, valid = _slab_voxel_index(
            slab, cells[..., None, :]
            + torch.as_tensor(iso.CORNERS, device=o_w.device))    # [R,7,8]
        rows7 = torch.where(valid, sdf.reshape(-1)[lin], 0.0)
    g_o, g_d, g_rows7 = resolve_hits_backward(
        rows7, slab.cell_size.expand(r), slab.extends.expand(r), o, d, hit,
        g_t, g_normal)
    g_o_w = vq.rotate(rot.expand(r, 4), g_o) / scale
    g_d_w = vq.rotate(rot.expand(r, 4), g_d) / scale
    if slab.table == "packed":
        return g_o_w, g_d_w, scatter_rows_reference(
            g_rows7.reshape(-1, 8), idx, flat.shape[0], 8, acc_dtype)
    g_planes = torch.zeros(sdf.numel(), dtype=acc_dtype, device=o_w.device)
    g_planes.index_add_(0, torch.where(valid, lin, 0).reshape(-1),
                        torch.where(valid, g_rows7.to(acc_dtype),
                                    0.0).reshape(-1))
    return g_o_w, g_d_w, g_planes.reshape(sdf.shape)
