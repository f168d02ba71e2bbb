"""Point/spot light attenuation (port of ``vrt.shade.lights``)."""

from __future__ import annotations

import torch

from vrt_torch.core import kinks


def point_light_intensity(intensity, distance, att_linear, att_exp):
    return intensity / (1.0 + att_linear * distance
                        + att_exp * distance * distance)


def cone_falloff(cos_surface, cos_angle, cos_falloff):
    delta = (cos_surface - cos_angle) / (cos_falloff - cos_angle)
    return kinks.minimum(delta, 1.0)


def spot_light_intensity(surface_point, distance, light_pos, light_dir,
                         intensity, att_linear, att_exp, cos_angle,
                         cos_falloff):
    sdir = surface_point - light_pos
    sdir = sdir / torch.linalg.vector_norm(sdir, dim=-1, keepdim=True)
    cos_surface = torch.sum(light_dir * sdir, dim=-1)
    inside = (cos_surface >= 0.0) & (cos_surface > cos_angle)
    i = intensity * cone_falloff(cos_surface, cos_angle, cos_falloff)
    i = point_light_intensity(i, distance, att_linear, att_exp)
    return torch.where(inside, i, 0.0)
