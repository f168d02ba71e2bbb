"""Texture sampling: bilinear-wrap 2D, triplanar projection, cube maps
(port of ``vrt.shade.texture``).

- geometry textures: linear filter + wrap addressing through the
  object-space triplanar projection,
- environment: cube map sampled with the direction swizzled ``.xzy``, D3D
  face/uv conventions, bilinear within the selected face (face seams clamp).

Textures live in one stacked tensor [T, TH, TW, 3] padded to the largest
resolution, with per-texture sizes.

Every sampler reads its taps through ``fetch(table, *index)`` (default
``fetch_rows``: the rows ``table[index]``): a seam for the plain backward
of the shading, which reads each tap as rows of its own to sum the table's
gradient in float64.
"""

from __future__ import annotations

import torch

from vrt_torch.core import kinks
from vrt_torch.core import quat as vq


def flat_index(index, shape):
    """The row of ``index`` (one index tensor per leading axis) in a table
    of ``shape`` viewed as [rows, last axis]."""
    flat = index[0].long()
    for i, n in zip(index[1:], shape[1:]):
        flat = flat * n + i.long()
    return flat


def fetch_rows(table, *index):
    """``table[index]``, read as ``index_select`` of the table's rows, whose
    backward is an ``index_add_``: advanced indexing's backward sorts the
    indices first, which takes seconds where millions of taps fall on a
    few hundred texels."""
    return table.reshape(-1, table.shape[-1]).index_select(
        0, flat_index(index, table.shape))


def sample_bilinear_wrap(textures, sizes, tex_id, uv, fetch=None):
    """textures [T,TH,TW,3], sizes i32 [T,2] (h,w), tex_id i32 [R], uv [R,2].

    D3D linear+wrap: texel centres at (i+0.5)/N; integer texel indices
    wrap with floor-mod (``torch.remainder``, as ``jnp.mod``)."""
    fetch = fetch or fetch_rows
    tex_id = tex_id.long()
    hw = sizes[tex_id].to(torch.float32)            # [R,2] (h, w)
    h, w = hw[..., 0], hw[..., 1]
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    wi = w.to(torch.int32)
    hi = h.to(torch.int32)

    def tap(ui, vi):
        uw = torch.remainder(ui.to(torch.int32), wi).long()
        vw = torch.remainder(vi.to(torch.int32), hi).long()
        return fetch(textures, tex_id, vw, uw)

    c00 = tap(u0, v0)
    c10 = tap(u0 + 1, v0)
    c01 = tap(u0, v0 + 1)
    c11 = tap(u0 + 1, v0 + 1)
    top = c00 * (1 - fu) + c10 * fu
    bot = c01 * (1 - fu) + c11 * fu
    return top * (1 - fv) + bot * fv


def _triplanar_uvs(obj_pos, scale):
    """uvX = zy/scale, uvY = xz/scale, uvZ = xy/scale."""
    s = scale
    uv_x = torch.stack([obj_pos[..., 2], obj_pos[..., 1]], -1) / s
    uv_y = torch.stack([obj_pos[..., 0], obj_pos[..., 2]], -1) / s
    uv_z = torch.stack([obj_pos[..., 0], obj_pos[..., 1]], -1) / s
    return uv_x, uv_y, uv_z


def _blend_weights(normal):
    b = kinks.abs_(normal)
    s = torch.sum(b, dim=-1, keepdim=True)
    ok = s > 0
    return torch.where(ok, b / torch.where(ok, s, 1.0), 0.0)


def tri_sample(textures, sizes, tex_id, scale, obj_pos, normal, fetch=None):
    """``TriSampleTexture``: triplanar blend of three axis projections."""
    uv_x, uv_y, uv_z = _triplanar_uvs(obj_pos, scale)
    tx = sample_bilinear_wrap(textures, sizes, tex_id, uv_x, fetch)
    ty = sample_bilinear_wrap(textures, sizes, tex_id, uv_y, fetch)
    tz = sample_bilinear_wrap(textures, sizes, tex_id, uv_z, fetch)
    b = _blend_weights(normal)
    return tx * b[..., 0:1] + ty * b[..., 1:2] + tz * b[..., 2:3]


def _quat_from_x(v):
    """Rotation from +X to v."""
    x = torch.tensor([1.0, 0.0, 0.0], device=v.device).expand_as(v)
    return vq.from_two_vectors(x, v)


def tri_sample_normal(textures, sizes, tex_id, scale, obj_pos, normal,
                      fetch=None):
    """``TriSampleNormal``: triplanar tangent normal, swizzled .zxy, rotated
    by the +X-to-surface-normal quaternion."""
    uv_x, uv_y, uv_z = _triplanar_uvs(obj_pos, scale)
    tx = sample_bilinear_wrap(textures, sizes, tex_id, uv_x, fetch) * 2.0 - 1.0
    ty = sample_bilinear_wrap(textures, sizes, tex_id, uv_y, fetch) * 2.0 - 1.0
    tz = sample_bilinear_wrap(textures, sizes, tex_id, uv_z, fetch) * 2.0 - 1.0
    b = _blend_weights(normal)
    t = tx * b[..., 0:1] + ty * b[..., 1:2] + tz * b[..., 2:3]
    n2 = torch.sum(t * t, dim=-1, keepdim=True)
    ok = n2 > 0
    t = torch.where(ok, t / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    t = t[..., [2, 0, 1]]  # .zxy
    return vq.rotate(_quat_from_x(normal), t)


def sample_cube(env, direction, fetch=None):
    """Sample a cube map [6,E,E,3] with D3D face conventions, bilinear.
    Face order +X,-X,+Y,-Y,+Z,-Z; the caller applies the ``.xzy`` swizzle."""
    fetch = fetch or fetch_rows
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = kinks.abs_(x), kinks.abs_(y), kinks.abs_(z)

    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)

    ma = torch.where(x_major, ax, torch.where(y_major, ay, az))
    face = torch.where(
        x_major, torch.where(x >= 0, 0, 1),
        torch.where(y_major, torch.where(y >= 0, 2, 3),
                    torch.where(z >= 0, 4, 5)))
    sc = torch.where(x_major, torch.where(x >= 0, -z, z),
                     torch.where(y_major, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(x_major, -y,
                     torch.where(y_major, torch.where(y >= 0, z, -z), -y))

    e = env.shape[1]
    u = ((sc / ma) + 1.0) * 0.5 * e - 0.5
    v = ((tc / ma) + 1.0) * 0.5 * e - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]

    def tap(ui, vi):
        uc = torch.clamp(ui.to(torch.int32), 0, e - 1).long()
        vc = torch.clamp(vi.to(torch.int32), 0, e - 1).long()
        return fetch(env, face, vc, uc)

    c00 = tap(u0, v0)
    c10 = tap(u0 + 1, v0)
    c01 = tap(u0, v0 + 1)
    c11 = tap(u0 + 1, v0 + 1)
    top = c00 * (1 - fu) + c10 * fu
    bot = c01 * (1 - fu) + c11 * fu
    return top * (1 - fv) + bot * fv


def sample_env(env, world_dir, fetch=None):
    """Miss-shader env lookup: direction swizzled .xzy."""
    return sample_cube(env, world_dir[..., [0, 2, 1]], fetch)
