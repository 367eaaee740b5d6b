"""GGX microfacet distribution with Smith shadowing and VNDF sampling
(port of sdmm_tpu/bsdf/microfacet.py). Local-frame direction batches."""

from __future__ import annotations

import math

import torch

from ..core.frame import safe_sqrt


def ggx_ndf(m: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Isotropic GGX D(m)."""
    cos_t = m[..., 2].clamp_min(0.0)
    a2 = alpha * alpha
    denom = cos_t * cos_t * (a2 - 1.0) + 1.0
    return torch.where(
        cos_t > 0.0, a2 / (math.pi * denom * denom).clamp_min(1e-20), 0.0)


def smith_g1(v: torch.Tensor, m: torch.Tensor, alpha: torch.Tensor):
    cos_v = v[..., 2]
    chi = (v * m).sum(-1) * cos_v > 0.0
    cos2 = cos_v * cos_v
    tan2 = (1.0 - cos2).clamp_min(0.0) / cos2.clamp_min(1e-12)
    lam = 0.5 * (torch.sqrt(1.0 + alpha * alpha * tan2) - 1.0)
    return torch.where(chi, 1.0 / (1.0 + lam), 0.0)


def sample_vndf(wi: torch.Tensor, alpha: torch.Tensor, u: torch.Tensor):
    """Sample the GGX distribution of visible normals (Heitz 2018)."""
    v = torch.stack([alpha * wi[..., 0], alpha * wi[..., 1], wi[..., 2]], -1)
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v = v / torch.where(vn > 1e-12, vn, 1.0)
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.where(lensq > 1e-12, lensq, 1.0))
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-v[..., 1] * inv_len, v[..., 0] * inv_len,
                     torch.zeros_like(inv_len)], -1),
        torch.tensor([1.0, 0.0, 0.0], device=wi.device).expand_as(v),
    )
    t2 = torch.linalg.cross(v, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    n = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    m = torch.stack([alpha * n[..., 0], alpha * n[..., 1],
                     n[..., 2].clamp_min(0.0)], -1)
    mn = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    return m / torch.where(mn > 1e-12, mn, 1.0)


def vndf_pdf(wi: torch.Tensor, m: torch.Tensor, alpha: torch.Tensor):
    """pdf of sample_vndf in the half-vector measure."""
    g1 = smith_g1(wi, m, alpha)
    d = ggx_ndf(m, alpha)
    return g1 * (wi * m).sum(-1).abs() * d / wi[..., 2].abs().clamp_min(1e-12)
