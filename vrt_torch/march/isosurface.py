"""Trilinear-cubic isosurface intersection and normals (port of
``vrt.march.isosurface``).

The trilinear SDF interpolant restricted to a ray segment [t_in, t_out]
through a cell is a cubic A*tau^3 + B*tau^2 + C*tau + D in the normalized
segment parameter tau in [0,1].  Coefficients, bracket shrinking at the
cubic's extrema, 2x regula falsi and a final secant reproduce ``vrt``
branch for branch with lanewise selects.

Sums are written out term by term in one fixed order, which the CUDA march
(``vrt_torch/csrc/march.cu``) follows too: the 8-corner sums pair corner i
with corner i+4, then the pairs (0,2) and (1,3), then the two halves; the
3-axis sums run left to right.  The 8-corner order is the one XLA's CPU
backend uses for ``vrt``'s ``jnp.sum`` over the corner axis.
"""

from __future__ import annotations

import numpy as np
import torch

from vrt_torch.core import kinks
from vrt_torch.kernels.rows import gather_rows

# Cell corner order v1..v8 = (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),(1,0,1),
# (0,1,1),(1,1,1) — the reference's VOXEL_COORDS.
CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                    [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int32)

# offsets for the central-difference neighborhood, in the row order
# ``resolve_hits`` batches: +x, -x, +y, -y, +z, -z
NEIGHBOR_OFFSETS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                             [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.int32)


def sign(x):
    """``jnp.sign``: -1, 0 or 1, and NaN for NaN (``torch.sign`` gives 0
    there, which would turn a NaN coefficient into an immediate hit)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def sum8(p):
    """Sum of 8 terms ``p[0..7]`` in the fixed corner-pairing order."""
    return (((p[0] + p[4]) + (p[2] + p[6]))
            + ((p[1] + p[5]) + (p[3] + p[7])))


def _corner_weights(a1, b1):
    """Per corner the (a, b) factors of each axis: lists of 8 [R] triples."""
    a = [a1[..., k] for k in range(3)]
    b = [b1[..., k] for k in range(3)]
    na = [1.0 - x for x in a]
    nb = [-x for x in b]
    ax = [[a[k] if off[k] else na[k] for k in range(3)] for off in CORNERS]
    bx = [[b[k] if off[k] else nb[k] for k in range(3)] for off in CORNERS]
    return ax, bx


def cubic_coefficients(v, a1, b1):
    """Cubic coefficients (A,B,C,D) from 8 corner values ``v`` [R,8] and
    the cell-space entry point ``a1`` and segment vector ``b1`` [R,3]."""
    ax, bx = _corner_weights(a1, b1)
    pa, pb, wb, wc = [], [], [], []
    for i in range(8):
        x, y, z = ax[i]
        u, s, w = bx[i]
        pa.append((x * y) * z)
        pb.append((u * s) * w)
        # leave-one-out products: sum_j a_j prod_{k!=j} b_k and vice versa
        wb.append((x * (s * w) + y * (u * w)) + z * (u * s))
        wc.append((u * (y * z) + s * (x * z)) + w * (x * y))
    vi = [v[..., i] for i in range(8)]
    A = sum8([pb[i] * vi[i] for i in range(8)])
    B = sum8([wb[i] * vi[i] for i in range(8)])
    C = sum8([wc[i] * vi[i] for i in range(8)])
    D = sum8([pa[i] * vi[i] for i in range(8)])
    return A, B, C, D


def eval_cubic(t, A, B, C, D):
    return ((A * t + B) * t + C) * t + D


def surface_intersection(A, B, C, D, t_in, t_out):
    """Root isolation + refinement on the cubic; returns (hit, t_hit).

    Clamp the bracket start to the ray origin, immediate hit if the density
    there is <= 0, shrink the bracket at the cubic's extrema, reject when
    there is no sign change, then two regula-falsi steps and a final
    secant, mapped back through lerp(t_in, t_out, tau)."""
    zero = torch.zeros_like(t_in)
    inf = torch.full_like(t_in, float("inf"))
    t0 = torch.maximum(zero, -t_in / (t_out - t_in))
    t1 = torch.ones_like(t0)
    f0 = eval_cubic(t0, A, B, C, D)

    immediate = sign(f0) <= 0  # density at entry already inside

    f1 = eval_cubic(t1, A, B, C, D)

    dA = 3.0 * A
    dB = 2.0 * B
    disc = dB * dB - 4.0 * dA * C
    sq = torch.sqrt(torch.maximum(disc, zero))
    safe = (disc >= 0.0) & (dA != 0.0)
    denom = torch.where(dA != 0.0, 2.0 * dA, 1.0)
    ex1 = torch.where(safe, (-dB + sq) / denom, inf)
    ex2 = torch.where(safe, (-dB - sq) / denom, inf)
    lo = torch.minimum(ex1, ex2)
    hi = torch.maximum(ex1, ex2)

    def bracket_update(ex, t0, f0, t1, f1):
        inside = (ex >= t0) & (ex <= t1)
        fe = eval_cubic(ex, A, B, C, D)
        same = sign(fe) == sign(f0)
        new_t0 = torch.where(inside & same, ex, t0)
        new_f0 = torch.where(inside & same, fe, f0)
        new_t1 = torch.where(inside & ~same, ex, t1)
        new_f1 = torch.where(inside & ~same, fe, f1)
        return new_t0, new_f0, new_t1, new_f1

    t0, f0, t1, f1 = bracket_update(lo, t0, f0, t1, f1)
    t0, f0, t1, f1 = bracket_update(hi, t0, f0, t1, f1)

    no_hit = sign(f0) == sign(f1)

    for _ in range(2):  # regula falsi
        t = t0 + (t1 - t0) * (-f0 / (f1 - f0))
        f = eval_cubic(t, A, B, C, D)
        same = sign(f) == sign(f0)
        t0 = torch.where(same, t, t0)
        f0 = torch.where(same, f, f0)
        t1 = torch.where(~same, t, t1)
        f1 = torch.where(~same, f, f1)

    tau = t0 + (t1 - t0) * (-f0 / (f1 - f0))
    t_root = t_in + (t_out - t_in) * tau

    t_hit = torch.where(immediate, t_in, t_root)
    hit = immediate | ((~no_hit) & (t_hit > 0))
    return hit, t_hit


def trilinear_rows(v, p):
    """Trilinear interpolation from corner rows ``v`` [...,8] at cell-space
    position ``p`` [...,3], with the reference's ``abs((1-i) - p)`` weight
    form (extrapolates symmetrically outside [0,1])."""
    q = [p[..., k] for k in range(3)]
    terms = []
    for i, off in enumerate(CORNERS):
        w = [kinks.abs_((1.0 - float(off[k])) - q[k]) for k in range(3)]
        terms.append(((w[0] * w[1]) * w[2]) * v[..., i])
    return sum8(terms)


def central_difference_normal_rows(rows6, p):
    """Central-difference normal from neighbour corner rows ``rows6``
    [...,6,8] (``NEIGHBOR_OFFSETS`` order) at cell-space position ``p``;
    zero or non-finite gradients map to the zero vector."""
    g = [trilinear_rows(rows6[..., 2 * k, :], p)
         - trilinear_rows(rows6[..., 2 * k + 1, :], p) for k in range(3)]
    n2 = ((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2])[..., None]
    g = torch.stack(g, dim=-1)
    good = (n2 > 0) & torch.isfinite(n2)
    unit = g / torch.sqrt(torch.where(good, n2, 1.0))
    return torch.where(good, unit, 0.0)


def trilinear_density(cfetch, cell, p):
    """Trilinear SDF sample at cell-space position ``p`` [R,3] of ``cell``;
    ``cfetch(cell) -> [R,8]`` supplies the corner values."""
    return trilinear_rows(cfetch(cell), p)


def central_difference_normal(cfetch, cell, p):
    """Central-difference normal at cell-space position ``p`` of ``cell``:
    the trilinear field of the six neighbour cells at the same fractional
    position, each read through ``cfetch``; zero or non-finite gradients map
    to the zero vector."""
    rows = [cfetch(cell + torch.as_tensor(off, device=cell.device))
            for off in NEIGHBOR_OFFSETS]
    return central_difference_normal_rows(torch.stack(rows, dim=-2), p)


def make_fetch(sdf, n):
    """Voxel fetch for one volume: ``sdf`` [N,N,N] (padded), ``n`` the
    volume's voxels per axis; indices shaped [..., 3]; out-of-range voxels
    read 0."""
    nn = sdf.shape[0]
    flat_sdf = sdf.reshape(-1)

    def fetch(idx):
        valid = torch.all((idx >= 0) & (idx < n), dim=-1)
        ic = torch.clamp(idx, 0, nn - 1)
        flat = (ic[..., 0] * nn + ic[..., 1]) * nn + ic[..., 2]
        return torch.where(valid, flat_sdf[flat.long()], 0.0)

    return fetch


def gather_corners(fetch, cell):
    """The 8 corner values of cells ``cell`` [..., 3] -> [..., 8] through a
    voxel fetch."""
    idx = cell[..., None, :] + torch.as_tensor(CORNERS, device=cell.device)
    return fetch(idx)


def corner_fetch_from_voxels(fetch):
    """A per-cell 8-corner fetch from a voxel fetch."""
    return lambda cell: gather_corners(fetch, cell)


def _flat_index(v, ic, side):
    return (v * (side * side * side)
            + (ic[..., 0] * side + ic[..., 1]) * side + ic[..., 2])


def make_stacked_fetch(sdf_stacked, n_per_ray, vol_per_ray):
    """Voxel fetch with per-ray volume selection: sdf_stacked [V,N,N,N],
    n_per_ray / vol_per_ray i32 [R]; indices shaped [R, ..., 3];
    out-of-range voxels read 0."""
    nn = sdf_stacked.shape[1]
    flat_sdf = sdf_stacked.reshape(-1)

    def fetch(idx):
        extra = idx.ndim - 2
        n = n_per_ray.reshape(n_per_ray.shape + (1,) * extra)
        v = vol_per_ray.reshape(vol_per_ray.shape + (1,) * extra)
        valid = torch.all((idx >= 0) & (idx < n[..., None]), dim=-1)
        ic = torch.clamp(idx, 0, nn - 1)
        vals = flat_sdf[_flat_index(v, ic, nn).long()]
        return torch.where(valid, vals, 0.0)

    return fetch


def stacked_corner_index(cell, n_per_ray, vol_per_ray, cc: int):
    """Row index i32 into the packed [V*C^3, ch] corner table for cells
    shaped [R, ..., 3] with per-ray volume selection; -1 where the cell is
    out of range (cell < 0 or cell + 1 >= n)."""
    extra = cell.ndim - 2
    n = n_per_ray.reshape(n_per_ray.shape + (1,) * extra)
    v = vol_per_ray.reshape(vol_per_ray.shape + (1,) * extra)
    valid = torch.all((cell >= 0) & (cell + 1 < n[..., None]), dim=-1)
    ic = torch.clamp(cell, 0, cc - 1)
    return torch.where(valid, _flat_index(v, ic, cc), -1).to(torch.int32)


def make_stacked_corner_fetch(corners, n_per_ray, vol_per_ray):
    """Per-cell corner fetch from the packed [V,C,C,C,8|9] table with
    per-ray volume selection: one row gather per cell, the first 8
    channels as float32, differentiable in ``corners``.  Cells shaped
    [R, ..., 3]; out-of-range cells read zeros and get no gradient.  The
    gather is K3 on CUDA tensors and its plain version on CPU tensors
    (``vrt_torch.kernels.rows.gather_rows``)."""
    cc = corners.shape[1]
    ch = corners.shape[-1]
    flat = corners.reshape(-1, ch)

    def cfetch(cell):
        idx = stacked_corner_index(cell, n_per_ray, vol_per_ray, cc)
        rows = gather_rows(flat, idx.reshape(-1), 8)
        return rows.reshape(cell.shape[:-1] + (8,))

    return cfetch
