"""Cook-Torrance GGX BRDF (port of ``vrt.shade.brdf``).

PI = 3.141592 (the reference's truncated value), SHADOW_BRIGHTNESS = 0,
F0_DIEL = 0.04; the geometry term's ``k`` is per-material (r+1)^2/8.
Elementwise over [R] lanes with [R,3] vectors.
"""

from __future__ import annotations

import torch

from vrt_torch.core import kinks

PI = 3.141592  # deliberately not math.pi
SHADOW_BRIGHTNESS = 0.0
F0_DIEL = 0.04


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def distribution_ggx(n, h, roughness):
    """D: a^2 / max(pi*c^2, 1e-3), c = (n.h)^2(a^2-1)+1."""
    a2 = roughness * roughness
    ndoth = kinks.maximum(_dot(n, h), 0.0)
    c = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / kinks.maximum(PI * c * c, 0.001)


def g_schlick(ndotw, k):
    return ndotw / (ndotw * (1.0 - k) + k)


def g_smith(n, wo, wi, k):
    dwo = kinks.maximum(_dot(n, wo), 0.0)
    dwi = kinks.maximum(_dot(n, wi), 0.0)
    return g_schlick(dwo, k) * g_schlick(dwi, k)


def fresnel_schlick(f0, wo, h):
    wdoth = kinks.maximum(_dot(wo, h), 0.0)
    return f0 + (1.0 - f0) * torch.pow(
        kinks.maximum(1.0 - wdoth, 0.0), 5.0)[..., None]


def brdf(wi, wo, n, albedo, roughness, metallic, k):
    """lambert*kd + cook*F; wi == -wo maps the half vector to zero."""
    h = wi + wo
    n2 = torch.sum(h * h, dim=-1, keepdim=True)
    ok = n2 > 0
    h = torch.where(ok, h / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)
    f0 = F0_DIEL * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    d = distribution_ggx(n, h, roughness)
    f = fresnel_schlick(f0, wo, h)
    g = g_smith(n, wo, wi, k)
    lambert = albedo / PI
    denom = kinks.maximum(4.0 * kinks.maximum(_dot(wo, n), 0.0)
                          * kinks.maximum(_dot(wi, n), 0.0), 0.0001)
    cook = (d * g / denom)[..., None] * f
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    return lambert * kd + cook * f


def radiance(li, wi, wo, n, albedo, roughness, metallic, k):
    """brdf * li * (n.wi), with n.wi unclamped as in the reference."""
    return (brdf(wi, wo, n, albedo, roughness, metallic, k) * li
            * _dot(n, wi)[..., None])
