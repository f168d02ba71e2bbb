"""Batched DDA ray march through voxel SDF volumes (port of
``vrt.march.march``: interp and cube mode, and the debug overlay).

``march_lanes`` is the dispatcher the renderer calls: CUDA tensors go to
the hand-written kernel K1 (``vrt_torch/csrc/march.cu`` through
``vrt_torch.kernels.march``), CPU tensors to ``march_lanes_reference``, the
plain-torch twin of ``vrt``'s ``_march_begin`` -> ``_march_run`` ->
``_march_finish``.  Both reproduce ``vrt``'s semantics:

- slab tests with the ``(d>0) ? INF : -INF`` zero-direction handling,
- +0.01 bias on the volume-entry t, +0.1 bias on every node-exit t,
- the origin-inside-volume branch starts at the *negated forward* node
  exit + 0.01 (the reference's ReverseRay no-op),
- a fully solid entry cell reports a hit at the biased entry t with a
  box-face normal (NaN when the face sign triple is zero),
- hits are accepted iff t in [0, t_max], but any report stops the lane,
- 255-step cap: exhausted lanes report an unlit red hit at t = 10,
- cube mode (``interp=False``): a voxel is valid while ``cell < n`` (not
  ``cell + 1 < n``), there is no solid-entry check, a voxel of density
  <= 0 is hit at the node's entry t with the face normal of the last
  crossing, seeded with the volume-entry face,
- the debug overlay: a lane whose node-entry point lies on a skip node's
  border (``LINE_THICKNESS``) reports an unlit red hit there, before the
  node's exit is taken, in both modes.

The twin's loop is ``march_core_reference``, with ``vrt``'s four hooks
(``node_geometry``, ``lane_ok``, ``t_exit_cap``, ``voxel_owned``): the slab
march (``vrt_torch.dist.brick``) sets them, every other caller leaves them
off.  ``march_volume`` is the single-volume entry point.
"""

from __future__ import annotations

import torch

from vrt_torch.march import isosurface as iso
from vrt_torch.march.types import (DeviceVolume, MarchHit, KIND_CUBE,
                                   KIND_DEBUG, KIND_EXHAUSTED,
                                   KIND_SOLID_ENTRY, KIND_SURFACE)

LINE_THICKNESS = 0.5  # debug-overlay border of a skip node
MAX_ITERATIONS = 255
EXHAUSTED_T = 10.0


def _inv_dir(d):
    """1/d, or -inf where d == 0 (the HLSL ``(d > 0) ? INF : -INF``
    select, which d == 0 fails)."""
    nz = d != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, d, 1.0), -float("inf"))


def _max3(x):
    """NaN-propagating max over the last axis of size 3 (``jnp.max``)."""
    return torch.maximum(torch.maximum(x[..., 0], x[..., 1]), x[..., 2])


def _min3(x):
    return torch.minimum(torch.minimum(x[..., 0], x[..., 1]), x[..., 2])


def ray_aabb(o, d, lo, hi, t_max):
    """Slab test.  Returns (intersects, t_enter, t_exit)."""
    inv = _inv_dir(d)
    sel_min = torch.where(d > 0.0, lo, hi)
    sel_max = torch.where(d > 0.0, hi, lo)
    t_enter = _max3((sel_min - o) * inv)
    t_exit = _min3((sel_max - o) * inv)
    ok = (t_exit > t_enter) & (t_exit >= 0.0) & (t_enter <= t_max)
    return ok, t_enter, t_exit


def _exit_with_axis(o, d, node_lo, node_hi):
    """Node-exit t and exit axis with the reference's nested-if tie-break:
    ``if (x < y) { x < z ? x : z } else { y < z ? y : z }``."""
    inv = _inv_dir(d)
    sel = torch.where(d > 0.0, node_hi, node_lo)
    tm = torch.where(d != 0.0, (sel - o) * inv, 1e5)
    tx, ty, tz = tm[..., 0], tm[..., 1], tm[..., 2]
    first = tx < ty
    t_a = torch.where(tx < tz, tx, tz)
    t_b = torch.where(ty < tz, ty, tz)
    ax_a = torch.where(tx < tz, 0, 2)
    ax_b = torch.where(ty < tz, 1, 2)
    return torch.where(first, t_a, t_b), torch.where(first, ax_a, ax_b)


def node_box_from_accel(cell, av, accel_mode, n_v, h_l, h_v, ext_v):
    """Skip-node box for ``cell`` from its packed accel value: octree mode
    decodes an aligned power-of-two block, chebyshev mode a centred
    empty-ball cube.  Returns (valid, has_surface, node_lo, node_hi);
    invalid cells get the degenerate box at (-1,-1,-1) of size 0."""
    valid = torch.all((cell >= 0) & (cell + 1 < n_v), dim=-1)
    has_surface = (av & 1) == 1
    if accel_mode == "chebyshev":
        half = torch.clamp_min((av >> 1) - 1, 0)
        origin_idx = cell - half[..., None]
        node_size = (2.0 * half.to(torch.float32) + 1.0) * h_l
    else:
        level = av >> 1
        origin_idx = (cell >> level[..., None]) << level[..., None]
        node_size = (torch.ones_like(level) << level).to(torch.float32) * h_l
    node_lo = origin_idx.to(torch.float32) * h_v - ext_v
    node_lo = torch.where(valid[..., None], node_lo, -1.0)
    node_hi = node_lo + torch.where(valid, node_size, 0.0)[..., None]
    return valid, has_surface, node_lo, node_hi


def _hits_node_bounds(pos, node_lo, node_hi, thickness=LINE_THICKNESS):
    """Whether ``pos`` lies within ``thickness`` of two faces of the node
    box (on an edge of it), inside the box grown by ``thickness``."""
    inside = torch.all((pos >= node_lo - thickness)
                       & (pos <= node_hi + thickness), dim=-1)
    b = ((torch.abs(pos - node_lo) <= thickness)
         | (torch.abs(pos - node_hi) <= thickness))
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return inside & (((bx | by) & bz) | ((by | bz) & bx))


def _entry_face_normal(o, d, t_enter, ext_v):
    """Box-face normal at entry, evaluated at pos(t_enter - 0.1): +1 on
    axes beyond +ext, -1 beyond -ext, else 0; then HLSL-normalized (a zero
    vector gives NaN, as in the reference)."""
    rp = o + d * (t_enter - 0.1)[..., None]
    s = iso.sign(rp - ext_v)
    s = torch.where(s < 0.0, torch.where(rp < -ext_v, -1.0, 0.0), s)
    norm = torch.sqrt((s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1])
                      + s[..., 2] * s[..., 2])
    return s / norm[..., None]


class _Tables:
    """Per-lane fetchers over a stacked DeviceVolume: out-of-range cells
    read accel 0, zero corners and zero density.  ``lanes`` (an index
    tensor, or None for every lane) picks the lanes whose cells are
    passed."""

    def __init__(self, vols: DeviceVolume, vid, n_l):
        self.cc = vols.accel.shape[1]
        self.accel = vols.accel_u8.reshape(-1)
        ch = vols.corners.shape[-1]
        self.corners = vols.corners.reshape(-1, ch)
        self.sdf = vols.sdf
        self.vid, self.n_l = vid, n_l

    def _lanes(self, lanes):
        if lanes is None:
            return self.vid, self.n_l
        return self.vid[lanes], self.n_l[lanes]

    def _index(self, cell, vid):
        ic = torch.clamp(cell, 0, self.cc - 1)
        c = self.cc
        return (vid * (c * c * c) + (ic[..., 0] * c + ic[..., 1]) * c
                + ic[..., 2]).long()

    def accel_at(self, cell, lanes=None):
        vid, n = self._lanes(lanes)
        valid = torch.all((cell >= 0) & (cell < (n - 1)[..., None]), dim=-1)
        vals = self.accel[self._index(cell, vid)].to(torch.int32)
        return torch.where(valid, vals, 0)

    def corners_at(self, cell, lanes=None):
        vid, n = self._lanes(lanes)
        valid = torch.all((cell >= 0) & (cell + 1 < n[..., None]), dim=-1)
        rows = self.corners[self._index(cell, vid)][..., :8].float()
        return torch.where(valid[..., None], rows, 0.0)

    def density_at(self, cell, lanes=None):
        vid, n = self._lanes(lanes)
        return iso.make_stacked_fetch(self.sdf, n, vid)(cell)


def march_lanes_reference(vols: DeviceVolume, vol_ids, o, d, t_max,
                          interp: bool = True,
                          debug_overlay: bool = False) -> MarchHit:
    """Plain-torch march of lanes against per-lane volumes of a stacked
    DeviceVolume: a masked loop of at most 255 iterations over all lanes,
    ending early once no lane is active.  ``interp=False`` is cube mode;
    ``debug_overlay`` draws skip-node borders.  Returns a ``MarchHit`` with
    per-lane ``steps``.  This is K1's twin: the CPU path and the reference
    K1 is held against on the card."""
    vid = vol_ids.to(torch.int32)
    n_l = vols.n[vid.long()]
    return march_core_reference(
        _Tables(vols, vid, n_l), n_l, vols.cell_size[vid.long()],
        vols.extends[vid.long()], vols.accel_mode, o, d, t_max, interp,
        debug_overlay)


def march_core_reference(tab, n_l, h_l, ext_l, accel_mode: str, o, d,
                         t_max, interp: bool = True,
                         debug_overlay: bool = False, node_geometry=None,
                         lane_ok=None, t_exit_cap=None,
                         voxel_owned=None) -> MarchHit:
    """The twin's loop (``vrt``'s ``_march_core``) over lanes with per-lane
    geometry ``n_l``, ``h_l``, ``ext_l`` [L] and the fetchers of ``tab``
    (``accel_at``, ``corners_at``, ``density_at``, each of cells [L', 3]
    and the lanes they belong to).  The four hooks are ``vrt``'s:

    - ``node_geometry(cell, av) -> (valid, has_surf, node_lo, node_hi)``
      replaces the skip-node box (default ``node_box_from_accel``),
    - ``lane_ok`` [L] masks lanes off before the loop,
    - ``t_exit_cap`` [L] clamps the traversal's exit t,
    - ``voxel_owned(cell)`` gates cube mode's solid test.

    The slab march (``vrt_torch.dist.brick.march_volume_slab_reference``)
    supplies all four; with none given this is ``march_lanes_reference``."""
    n_v, h_v, ext_v = n_l[:, None], h_l[:, None], ext_l[:, None]
    mode = accel_mode

    if node_geometry is None:
        def node_geometry(cell, av):
            return node_box_from_accel(cell, av, mode, n_v, h_l, h_v, ext_v)

    def pos_to_cell(p):
        return torch.floor((p + ext_v) / h_v).to(torch.int32)

    # ---- _march_begin ---------------------------------------------------
    ok, t_enter, t_exit = ray_aabb(o, d, -ext_v, ext_v, t_max)
    if lane_ok is not None:
        ok = ok & lane_ok
    if t_exit_cap is not None:
        t_exit = torch.minimum(t_exit, t_exit_cap)
    pos_branch = t_enter >= 0.0
    t_enter_b = torch.where(pos_branch, t_enter + 0.01, t_enter)
    entry_pos = o + d * t_enter_b[:, None]
    cell = torch.where(pos_branch[:, None], pos_to_cell(entry_pos),
                       pos_to_cell(o))
    valid0, _, lo0, hi0 = node_geometry(cell, tab.accel_at(cell))
    fwd_exit, _ = _exit_with_axis(o, d, lo0, hi0)
    cell_exit = torch.where(pos_branch, t_enter_b, -fwd_exit + 0.01)

    res = MarchHit.none_like(o)
    # vrt seeds cube mode's face at where(pos_branch, t_enter_b, t_enter),
    # which is t_enter_b on both branches
    entry_norm = _entry_face_normal(o, d, t_enter_b, ext_v)
    if interp:
        solid0 = torch.all(tab.corners_at(cell) < 0.0, dim=-1)
        rep = ok & valid0 & solid0
        acc = rep & (t_enter_b >= 0.0) & (t_enter_b <= t_max)
        res.hit = res.hit | acc
        res.t = torch.where(acc, t_enter_b, res.t)
        res.kind = torch.where(acc, KIND_SOLID_ENTRY, res.kind)
        res.cell = torch.where(acc[:, None], cell, res.cell)
        res.face_normal = torch.where(acc[:, None], entry_norm,
                                      res.face_normal)
        active = ok & ~rep
    else:
        face = entry_norm
        active = ok
    steps = torch.zeros_like(cell[:, 0])
    eye = torch.eye(3, device=o.device)

    # ---- _march_run -----------------------------------------------------
    # Lane activity only decreases, so a lane active at iteration ``it``
    # has made exactly ``it`` steps: stopping once no lane is active gives
    # the same result as running all 255 iterations.
    for _ in range(MAX_ITERATIONS):
        if not bool(active.any()):
            break
        steps = steps + active.to(torch.int32)
        act2 = active & ~(cell_exit > t_exit)
        cell_enter = cell_exit
        valid, has_surf, node_lo, node_hi = node_geometry(
            cell, tab.accel_at(cell))
        if not interp:
            valid = torch.all((cell >= 0) & (cell < n_v), dim=-1)
        if debug_overlay:
            dbg = act2 & valid & _hits_node_bounds(
                o + d * cell_enter[:, None], node_lo, node_hi)
            dacc = dbg & (cell_enter >= 0.0) & (cell_enter <= t_max)
            res.hit = res.hit | dacc
            res.t = torch.where(dacc, cell_enter, res.t)
            res.kind = torch.where(dacc, KIND_DEBUG, res.kind)
            act2 = act2 & ~dbg

        exit_t, exit_ax = _exit_with_axis(o, d, node_lo, node_hi)
        new_exit = exit_t + 0.1
        next_cell = pos_to_cell(o + d * new_exit[:, None])

        if interp:
            cand = act2 & valid & has_surf
            root_hit = torch.zeros_like(cand)
            t_hit = torch.zeros_like(cell_enter)
            lanes = cand.nonzero().squeeze(1)
            if lanes.numel():
                # the root only matters on candidate lanes; elementwise
                # math on that subset gives the same values as on every
                # lane.  Surface nodes are single cells: their box is
                # cubic, so the x-extent is the cell-space normalization
                # (== h there)
                c_cell, c_o, c_d = cell[lanes], o[lanes], d[lanes]
                c_in, c_out = cell_enter[lanes], new_exit[lanes]
                size = (node_hi[lanes, 0] - node_lo[lanes, 0])[:, None]
                p_in = c_o + c_d * c_in[:, None]
                p_out = c_o + c_d * c_out[:, None]
                base = c_cell.to(torch.float32) * h_v[lanes] - ext_v[lanes]
                a1 = (p_in - base) / size
                b1 = (p_out - base) / size - a1
                v8 = tab.corners_at(c_cell, lanes)
                A, B, C, D = iso.cubic_coefficients(v8, a1, b1)
                rh, th = iso.surface_intersection(A, B, C, D, c_in, c_out)
                root_hit[lanes] = rh
                t_hit[lanes] = th
            rep = cand & root_hit
            acc = rep & (t_hit >= 0.0) & (t_hit <= t_max)
            res.hit = res.hit | acc
            res.t = torch.where(acc, t_hit, res.t)
            res.kind = torch.where(acc, KIND_SURFACE, res.kind)
            res.cell = torch.where(acc[:, None], cell, res.cell)
            res.t_in = torch.where(acc, cell_enter, res.t_in)
            res.t_out = torch.where(acc, new_exit, res.t_out)
        else:
            dens = tab.density_at(cell)
            rep = act2 & valid & (dens <= 0.0)
            if voxel_owned is not None:
                rep = rep & voxel_owned(cell)
            acc = rep & (cell_enter >= 0.0) & (cell_enter <= t_max)
            res.hit = res.hit | acc
            res.t = torch.where(acc, cell_enter, res.t)
            res.kind = torch.where(acc, KIND_CUBE, res.kind)
            res.cell = torch.where(acc[:, None], cell, res.cell)
            res.face_normal = torch.where(acc[:, None], face,
                                          res.face_normal)
            # the face normal of the crossing about to be taken
            step_norm = -iso.sign(d) * eye[exit_ax.long()]
            face = torch.where((act2 & ~rep)[:, None], step_norm, face)

        active = act2 & valid & ~rep
        cell = torch.where(active[:, None], next_cell, cell)
        cell_exit = torch.where(active, new_exit, cell_exit)

    # ---- _march_finish --------------------------------------------------
    acc = active & (EXHAUSTED_T <= t_max)
    res.hit = res.hit | acc
    res.t = torch.where(acc, EXHAUSTED_T, res.t)
    res.kind = torch.where(acc, KIND_EXHAUSTED, res.kind)
    red = torch.tensor([1.0, 0.0, 0.0], device=o.device)
    res.face_normal = torch.where(acc[:, None], red, res.face_normal)
    res.steps = steps
    return res


def march_lanes(vols: DeviceVolume, vol_ids, o, d, t_max,
                interp: bool = True,
                debug_overlay: bool = False) -> MarchHit:
    """March lanes against per-lane volumes of a stacked DeviceVolume.

    ``vols`` is stacked over a leading V axis; ``vol_ids`` i32 [L] picks a
    volume per lane; o, d f32 [L,3] in object space; t_max f32 [L].  On a
    CUDA device this launches K1; on the CPU it runs the plain twin."""
    if o.device.type == "cuda":
        from vrt_torch.kernels import march as k1

        return k1.march_lanes_cuda(vols, vol_ids, o, d, t_max, interp,
                                   debug_overlay)
    if o.device.type != "cpu":
        raise ValueError(f"no march for device {o.device}")
    return march_lanes_reference(vols, vol_ids, o, d, t_max, interp,
                                 debug_overlay)


def march_volume(vol: DeviceVolume, o, d, t_max, interp: bool = True,
                 debug_overlay: bool = False) -> MarchHit:
    """March rays (object space) through one volume: ``march_lanes`` over
    ``vol`` (a single, unstacked DeviceVolume) stacked to one, every lane on
    volume 0.  o, d f32 [R,3]; t_max f32 [R].  K1 on CUDA tensors, the twin
    on CPU tensors."""
    stacked = DeviceVolume(
        sdf=vol.sdf[None], materials=vol.materials[None],
        accel=vol.accel[None], n=vol.n.reshape(1),
        cell_size=vol.cell_size.reshape(1), extends=vol.extends.reshape(1),
        corners=vol.corners[None], accel_mode=vol.accel_mode)
    vol_ids = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    return march_lanes(stacked, vol_ids, o, d, t_max, interp, debug_overlay)
