"""Orthonormal frames and coordinate systems (port of sdmm_tpu/core/frame.py).

All functions are batched over leading dimensions: vectors are ``[..., 3]``.
"""

from __future__ import annotations

import torch


def coordinate_system(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis around unit normal ``n`` (Duff et al. 2017).

    Returns tangents ``(s, t)`` such that ``(s, t, n)`` is right-handed.
    """
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    s = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    t = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return s, t


def rotation_to_world(n: torch.Tensor) -> torch.Tensor:
    """3x3 rotation with columns (s, t, n): local (z-up) → world."""
    s, t = coordinate_system(n)
    return torch.stack([s, t, n], dim=-1)


def to_local(s, t, n, v: torch.Tensor) -> torch.Tensor:
    """World → local coordinates for frame (s, t, n)."""
    return torch.stack(
        [(v * s).sum(-1), (v * t).sum(-1), (v * n).sum(-1)], dim=-1
    )


def to_world(s, t, n, v: torch.Tensor) -> torch.Tensor:
    """Local → world coordinates for frame (s, t, n)."""
    return v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n


def cos_theta(v: torch.Tensor) -> torch.Tensor:
    """Cosine of the angle with the local frame normal (z axis)."""
    return v[..., 2]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)), NaN kept. Where autograd records ``x`` the
    derivative is 0 at x <= 0: a plain root's inf there times a zero
    cotangent (a branch that ``where`` leaves unselected) would be NaN."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.sqrt(x.clamp_min(0.0))
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)),
                       x.clamp(0.0, 0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalization of [..., 3] vectors."""
    return v * torch.rsqrt((v * v).sum(-1, keepdim=True).clamp_min(eps))


def reflect(wi: torch.Tensor) -> torch.Tensor:
    """Specular reflection in the local frame (z = normal)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
