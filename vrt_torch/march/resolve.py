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

``resolve_hits_backward`` is the same gradient in closed form: what
autograd derives from ``resolve_hits``, written out per ray.  It is the
plain version of the fused resolve's backward kernel
(``vrt_torch/csrc/resolve.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from vrt_torch.core import kinks
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
    its ``abs((1-i) - p)`` weights; d|x|/dx is 1 where x >= 0, else -1,
    as ``vrt`` takes it)."""
    q = [p[..., k] for k in range(3)]
    dq = [dp[..., k] for k in range(3)]
    terms = []
    for i, off in enumerate(iso.CORNERS):
        a = [(1.0 - float(off[k])) - q[k] for k in range(3)]
        w = [kinks.abs_(x) for x in a]
        dw = [-kinks.dabs(a[k]) * dq[k] for k in range(3)]
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


def resolve_hits_backward(rows7, cell_size, extends, o, d, hit: MarchHit,
                          g_t, g_normal):
    """The vector-Jacobian product of ``resolve_hits`` in closed form:
    -> (g_o f32[R,3], g_d f32[R,3], g_rows7 f32[R,7,8]).

    ``rows7`` [R,7,8] are the corner rows ``cfetch`` would read (the hit
    cell and its 6 neighbours, zeros where out of range), ``g_t`` [R] and
    ``g_normal`` [R,3] the cotangents of t and the normal.  Surface lanes
    get the normal's gradient (unit vector, central differences, the
    trilinear weights in the rows and in the hit point) and the IFT term
    ``g_f0 = -(g_t + g_p.d/h) / F'(t0)`` on the hit cell's row and, through
    ``p0``, on the ray; solid-entry lanes the slab entry's, with ties of
    the maximum sharing its cotangent evenly (as ``torch.amax`` does);
    every other lane zeros.  The caller drops the gradient of out-of-range
    rows."""
    h = cell_size[..., None]
    ext = extends[..., None]
    surface = hit.kind == KIND_SURFACE
    solid = hit.kind == KIND_SOLID_ENTRY

    # ---- surface lanes ------------------------------------------------
    t0 = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    cell_base = hit.cell.to(torch.float32) * h - ext
    p = (o + d * t0[..., None] - cell_base) / h
    # per corner i and axis k: a = (1 - i_k) - p_k, weight |a|, d|a|/dp_k =
    # -(1 where a >= 0, else -1)
    w, dw = [], []
    for off in iso.CORNERS:
        a = [(1.0 - float(off[k])) - p[..., k] for k in range(3)]
        m = [kinks.abs_(x) for x in a]
        s = [-kinks.dabs(x) for x in a]
        w.append((m[0] * m[1]) * m[2])
        dw.append([s[0] * (m[1] * m[2]), s[1] * (m[0] * m[2]),
                   s[2] * (m[0] * m[1])])

    def field(rows):                      # trilinear_rows at p
        return iso.sum8([w[i] * rows[..., i] for i in range(8)])

    def field_dp(rows, k):                # its derivative in p_k
        return iso.sum8([dw[i][k] * rows[..., i] for i in range(8)])

    # the normal: unit vector of the central differences g
    diff = [rows7[:, 1 + 2 * k] - rows7[:, 2 + 2 * k] for k in range(3)]
    g = [field(diff[k]) for k in range(3)]
    n2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]
    good = (n2 > 0) & torch.isfinite(n2)
    n2s = torch.where(good, n2, 1.0)
    norm = torch.sqrt(n2s)
    gn = [g_normal[..., k] for k in range(3)]
    dot = (gn[0] * g[0] + gn[1] * g[1]) + gn[2] * g[2]
    g_g = [torch.where(good, gn[k] / norm - dot * g[k] / (norm * n2s), 0.0)
           for k in range(3)]
    # into the hit point: sum_k g_g[k] * d(g[k])/dp
    g_p = [(g_g[0] * field_dp(diff[0], k) + g_g[1] * field_dp(diff[1], k))
           + g_g[2] * field_dp(diff[2], k) for k in range(3)]

    # t_surface's cotangent, then the IFT term on the hit cell's row
    dh = d / h
    g_ts = g_t + ((g_p[0] * dh[..., 0] + g_p[1] * dh[..., 1])
                  + g_p[2] * dh[..., 2])
    v_c = rows7[:, 0]
    fp = _trilinear_rows_dt(v_c, p, dh)
    safe = torch.isfinite(fp) & (torch.abs(fp) > 1e-12)
    g_f0 = torch.where(safe, -g_ts / torch.where(safe, fp, 1.0), 0.0)
    g_p = torch.stack([g_p[k] + g_f0 * field_dp(v_c, k) for k in range(3)],
                      dim=-1)
    g_o_surface = g_p / h
    g_d_surface = g_o_surface * t0[..., None]

    wi = torch.stack(w, dim=-1)                                # [R,8]
    g_rows = [g_f0[..., None] * wi]
    for k in range(3):
        plus = g_g[k][..., None] * wi
        g_rows += [plus, -plus]
    g_rows7 = torch.where(surface[:, None, None],
                          torch.stack(g_rows, dim=1), 0.0)

    # ---- solid-entry lanes: _slab_enter ---------------------------------
    finite = d != 0.0
    sel_min = torch.where(d > 0.0, -ext, ext)
    inv = torch.where(finite, 1.0 / torch.where(finite, d, 1.0), 0.0)
    num = sel_min - o
    tmin3 = torch.where(finite, num * inv, -float("inf"))
    tie = tmin3 == tmin3.amax(dim=-1, keepdim=True)
    share = g_t[..., None] / tie.sum(dim=-1, keepdim=True).clamp_min(1)
    g_t3 = torch.where(tie & finite, share, 0.0)
    g_o_solid = -g_t3 * inv
    g_d_solid = g_o_solid * (num * inv)

    def pick(a, b):
        return torch.where(surface[..., None], a,
                           torch.where(solid[..., None], b, 0.0))

    return (pick(g_o_surface, g_o_solid), pick(g_d_surface, g_d_solid),
            g_rows7)


def resolve_volume_hits(vol, o, d, hit: MarchHit):
    """``resolve_hits`` for hits of ``march_volume`` against one volume
    (a single, unstacked DeviceVolume), from its voxels."""
    cfetch = iso.corner_fetch_from_voxels(iso.make_fetch(vol.sdf, vol.n))
    r = o.shape[0]
    return resolve_hits(cfetch, vol.cell_size.expand(r),
                        vol.extends.expand(r), o, d, hit)
