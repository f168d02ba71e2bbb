"""Differentiable hit resolution (port of ``vrt.march.resolve``).

The march decides which cell a ray hits, under ``torch.no_grad()``; resolve
recomputes the hit t and the surface normal from the corner table as
differentiable functions of the table and the ray:

- surface hits keep the march's root t as their value, with the
  implicit-function-theorem gradient dt = -dF / F'(t0) attached by a
  zero-valued Newton correction, F the trilinear field along the ray in
  the hit cell; the normal is the central difference of the trilinear
  field at the hit point,
- solid-entry hits take the biased slab entry t of the volume box,
  differentiable in the ray,
- exhausted / debug / cube hits keep their t, without gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from vrt_torch.march import isosurface as iso
from vrt_torch.march.types import (MarchHit, KIND_DEBUG, KIND_EXHAUSTED,
                                   KIND_SOLID_ENTRY, KIND_SURFACE)

_OFFS7 = np.concatenate([np.zeros((1, 3), np.int32), iso.NEIGHBOR_OFFSETS])


def _slab_enter(o, d, ext):
    """Slab-entry t, differentiable in ``o`` and through ``1/d``;
    degenerate axes contribute -inf as in the march."""
    finite = d != 0.0
    sel_min = torch.where(d > 0.0, -ext, ext)
    inv = torch.where(finite, 1.0 / torch.where(finite, d, 1.0), 0.0)
    tmin3 = torch.where(finite, (sel_min - o) * inv, -float("inf"))
    return tmin3.amax(dim=-1)


def _trilinear_rows_dt(v, p, dp):
    """Derivative of ``iso.trilinear_rows(v, p)`` along ``dp`` (the jvp of
    its ``abs((1-i) - p)`` weights; d|x| is sign(x), 0 at 0)."""
    q = [p[..., k] for k in range(3)]
    dq = [dp[..., k] for k in range(3)]
    terms = []
    for i, off in enumerate(iso.CORNERS):
        a = [(1.0 - float(off[k])) - q[k] for k in range(3)]
        w = [torch.abs(x) for x in a]
        dw = [-torch.sign(a[k]) * dq[k] for k in range(3)]
        terms.append(((dw[0] * w[1] + w[0] * dw[1]) * w[2]
                      + (w[0] * w[1]) * dw[2]) * v[..., i])
    return iso.sum8(terms)


def resolve_hits(cfetch, cell_size, extends, o, d, hit: MarchHit):
    """-> (t f32[R], normal_object_space f32[R,3], unlit bool[R]).

    ``cfetch(cell [R,7,3]) -> [R,7,8]`` reads corner rows (one gather for
    the hit cell and its 6 central-difference neighbours);
    ``cell_size``/``extends`` are per-ray [R].  Only meaningful on lanes
    with ``hit.hit``."""
    cell = hit.cell
    h = cell_size[..., None]
    ext = extends[..., None]
    cell_base = cell.to(torch.float32) * h - ext
    offs = torch.as_tensor(_OFFS7, device=cell.device)
    rows7 = cfetch(cell[:, None, :] + offs)                    # [R,7,8]

    v_c = rows7[:, 0]

    # t_surface = t0 - (F(t0) - stop(F(t0))) / stop(F'(t0)): its value is
    # exactly t0, its gradient the IFT one.  ``safe`` masks F' before the
    # division, so no inf or NaN reaches autograd.  A frame that records no
    # graph skips the correction: its value is t0 either way.
    t0 = hit.t.detach()
    t0_safe = torch.where(torch.isfinite(t0), t0, 0.0)
    t_surface = t0_safe
    if torch.is_grad_enabled() and (v_c.requires_grad or o.requires_grad
                                    or d.requires_grad):
        p0 = (o + d * t0_safe[..., None] - cell_base) / h
        f0 = iso.trilinear_rows(v_c, p0)
        with torch.no_grad():
            fp = _trilinear_rows_dt(v_c, p0, d / h)
            safe = torch.isfinite(fp) & (torch.abs(fp) > 1e-12)
        corr = (f0 - f0.detach()) / torch.where(safe, fp, 1.0)
        t_surface = t0_safe - torch.where(safe, corr, 0.0)

    p_hit = (o + d * t_surface[..., None] - cell_base) / h
    n_surface = iso.central_difference_normal_rows(rows7[:, 1:], p_hit)

    t_solid = _slab_enter(o, d, ext) + 0.01

    kind = hit.kind
    t = torch.where(kind == KIND_SURFACE, t_surface,
                    torch.where(kind == KIND_SOLID_ENTRY, t_solid, t0))
    unlit = (kind == KIND_EXHAUSTED) | (kind == KIND_DEBUG)
    red = torch.tensor([1.0, 0.0, 0.0], device=o.device)
    normal = torch.where((kind == KIND_SURFACE)[..., None], n_surface,
                         torch.where((kind == KIND_DEBUG)[..., None], red,
                                     hit.face_normal))
    return t, normal, unlit
