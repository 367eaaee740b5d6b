"""Tangent-space (exp/log) maps on S² with analytic Jacobians (port of
sdmm_tpu/guiding/tangent.py).

A tangent frame at unit mean direction μ is the rotation R = [s t μ]
(columns) built deterministically from μ; ``rel`` denotes coordinates in
the north-pole frame (Rᵀ · world).
"""

from __future__ import annotations

import math

import torch

from ..core.frame import rotation_to_world

_SINC_EPS = 1e-4


def _sinc(x: torch.Tensor) -> torch.Tensor:
    small = x.abs() < _SINC_EPS
    safe = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small batched matrices, broadcast, as one elementwise
    product and sum: on the card, matmul of millions of 2×2 and 3×3
    matrices runs as batched GEMMs many times slower."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def exp_map(rot: torch.Tensor, tangent: torch.Tensor):
    """Tangent coords [..., 2] → unit direction [..., 3].
    Returns (dir, sinc_jacobian, valid); valid = |t| < π."""
    length = torch.sqrt((tangent * tangent).sum(-1).clamp_min(0.0))
    valid = length < math.pi
    s = _sinc(length)
    rel = torch.stack([tangent[..., 0] * s, tangent[..., 1] * s,
                       torch.cos(length)], dim=-1)
    d = (rot * rel[..., None, :]).sum(-1)
    return d, s, valid


def log_map(rot: torch.Tensor, d: torch.Tensor):
    """Unit direction [..., 3] → tangent coords [..., 2].
    Returns (tangent, angle_over_sin_jacobian, valid); valid excludes the
    antipode and zero directions."""
    rel = (rot * d[..., :, None]).sum(-2)
    cos_a = rel[..., 2].clamp(-1.0, 1.0)
    valid = (cos_a > -1.0 + 1e-7) & ((d * d).sum(-1) > 0.0)
    angle = torch.arccos(cos_a)
    sin_a = torch.sqrt((1.0 - cos_a * cos_a).clamp_min(0.0))
    aos = torch.where(sin_a < 1e-3, 1.0, angle / sin_a.clamp_min(1e-12))
    tangent = rel[..., :2] * aos[..., None]
    return tangent, aos, valid


def exp_jacobian(tangent: torch.Tensor) -> torch.Tensor:
    """d(rel)/d(tangent): [..., 3, 2] in the north-pole frame."""
    t0 = tangent[..., 0]
    t1 = tangent[..., 1]
    l2 = t0 * t0 + t1 * t1
    length = torch.sqrt(l2.clamp_min(0.0))
    zero = length < 1e-6
    c = torch.cos(length)
    s = _sinc(length)
    # (cos − sinc)/l² → −1/3 as l → 0.
    cms = torch.where(zero, -1.0 / 3.0, (c - s) / l2.clamp_min(1e-20))
    j00 = s + t0 * t0 * cms
    j11 = s + t1 * t1 * cms
    joff = t0 * t1 * cms
    row0 = torch.stack([j00, joff], -1)
    row1 = torch.stack([joff, j11], -1)
    row2 = torch.stack([-t0 * s, -t1 * s], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def log_jacobian(rot: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Chain d(tangent)/d(world) = J_log(rel) · Rᵀ: [..., 2, 3]."""
    rel = (rot * d[..., :, None]).sum(-2)
    cos_a = rel[..., 2].clamp(-1.0, 1.0)
    at_pole = cos_a > 1.0 - 1e-7
    angle = torch.arccos(torch.where(at_pole, 0.0, cos_a))
    sin_a = torch.sqrt((1.0 - cos_a * cos_a).clamp_min(0.0))
    aos = torch.where(at_pole, 1.0, angle / sin_a.clamp_min(1e-12))
    inv_sin2 = 1.0 / (1.0 - cos_a * cos_a).clamp_min(1e-12)
    off = (cos_a * aos - 1.0) * inv_sin2
    j02 = torch.where(at_pole, 0.0, rel[..., 0] * off)
    j12 = torch.where(at_pole, 0.0, rel[..., 1] * off)
    zeros = torch.zeros_like(aos)
    row0 = torch.stack([aos, zeros, j02], -1)
    row1 = torch.stack([zeros, aos, j12], -1)
    j_np = torch.stack([row0, row1], dim=-2)  # [..., 2, 3]
    return mm(j_np, rot.transpose(-1, -2))


def make_rotation(mu_dir: torch.Tensor) -> torch.Tensor:
    """Tangent-frame rotation at mean direction (columns s, t, μ)."""
    return rotation_to_world(mu_dir)
