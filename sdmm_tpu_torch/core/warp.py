"""Sampling warps used by the ported BSDFs, mixtures, emitters and classic
integrators (port of sdmm_tpu/core/warp.py: concentric disk, cosine
hemisphere, uniform sphere and hemisphere, uniform triangle, Box-Muller)."""

from __future__ import annotations

import math

import torch

from .frame import safe_sqrt

INV_PI = 1.0 / math.pi


def square_to_uniform_disk_concentric(u: torch.Tensor) -> torch.Tensor:
    """Concentric (Shirley) disk mapping; u [..., 2] → [..., 2]."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    cond = ox.abs() > oy.abs()
    r = torch.where(cond, ox, oy)
    safe_div = torch.where(
        cond,
        torch.where(ox != 0.0, oy / torch.where(ox == 0.0, 1.0, ox), 0.0),
        torch.where(oy != 0.0, ox / torch.where(oy == 0.0, 1.0, oy), 0.0),
    )
    theta = torch.where(
        cond, (math.pi / 4.0) * safe_div,
        (math.pi / 2.0) - (math.pi / 4.0) * safe_div,
    )
    r = torch.where(zero, 0.0, r)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def square_to_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere (z up); pdf = cos(theta)/pi."""
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(w: torch.Tensor) -> torch.Tensor:
    return w[..., 2].clamp_min(0.0) * INV_PI


def square_to_uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere; pdf = 1/(4 pi)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the z-up hemisphere; pdf = 1/(2 pi)."""
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_triangle(u: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates (b0, b1) uniform over a triangle."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def square_to_std_normal(u: torch.Tensor) -> torch.Tensor:
    """Box-Muller: [..., 2] uniforms → [..., 2] standard normals."""
    r = safe_sqrt(-2.0 * torch.log1p(-u[..., 0].clamp_max(1.0 - 1e-7)))
    theta = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.sin(theta), r * torch.cos(theta)], dim=-1)
