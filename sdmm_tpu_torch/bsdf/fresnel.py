"""Fresnel terms (port of sdmm_tpu/bsdf/fresnel.py)."""

from __future__ import annotations

import torch

from ..core.frame import safe_sqrt


def fresnel_dielectric(cos_i: torch.Tensor, eta: torch.Tensor):
    """Exact dielectric Fresnel. Returns (F, cos_t, eta_it, eta_ti);
    ``eta`` = int/ext IOR ratio, both directions via the sign of cos_i."""
    outside = cos_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)
    cos_t2 = 1.0 - eta_ti * eta_ti * (1.0 - cos_i * cos_i)
    abs_cos_i = cos_i.abs()
    cos_t = safe_sqrt(cos_t2)
    rs = (abs_cos_i - eta_it * cos_t) / (abs_cos_i + eta_it * cos_t).clamp_min(1e-12)
    rp = (eta_it * abs_cos_i - cos_t) / (eta_it * abs_cos_i + cos_t).clamp_min(1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    f = torch.where(cos_t2 <= 0.0, 1.0, f)  # total internal reflection
    cos_t = torch.where(cos_t2 <= 0.0, 0.0, -torch.sign(cos_i) * cos_t)
    return f, cos_t, eta_it, eta_ti


def fresnel_conductor(cos_i: torch.Tensor, eta: torch.Tensor, k: torch.Tensor):
    """Unpolarized conductor Fresnel; eta, k may be [..., 3] RGB."""
    c2 = (cos_i * cos_i)[..., None]
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cos_i.abs()[..., None]
    rs = (t1 - t2) / (t1 + t2).clamp_min(1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4).clamp_min(1e-12)
    return 0.5 * (rp + rs)
