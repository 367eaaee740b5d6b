"""Real spherical harmonics, batched (port of sdmm_tpu/core/sh.py).

Coefficients are flat vectors of length (L+1)^2, band by band, m from -l to
l within a band (the addressing ``(l, m)`` of Mitsuba's SHVector). The band
count is a Python int, so the associated-Legendre recurrences unroll into
closed-form elementwise terms over [N] batches.

Functions of tensors run on their inputs' device; ``project`` and
``lambda_l``, which make their own tensors, run on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from .device import resolve_device

__all__ = [
    "n_coeffs", "eval_basis", "eval_function", "project", "project_dirs",
    "dot", "convolve_cosine", "rotate_z", "lambda_l",
]


def n_coeffs(order: int) -> int:
    """Number of coefficients for bands 0..order inclusive."""
    return (order + 1) * (order + 1)


def _k(l: int, m: int) -> float:
    """SH normalization constant K_l^m."""
    am = abs(m)
    num = (2 * l + 1) * math.factorial(l - am)
    den = 4.0 * math.pi * math.factorial(l + am)
    return math.sqrt(num / den)


def eval_basis(d: torch.Tensor, order: int) -> torch.Tensor:
    """All real SH basis functions at unit directions d [..., 3]. Returns
    [..., (order+1)^2] (z = cos θ; the azimuth from +x toward +y)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    # cm[m] = sin(θ)^m cos(mφ), sm[m] = sin(θ)^m sin(mφ): the sin(θ)^m of
    # P_l^m folded into the azimuth terms, which then follow the Chebyshev
    # recurrence driven by (x, y) and stay finite at the poles.
    cm = [torch.ones_like(x), x]
    sm = [torch.zeros_like(x), y]
    for m in range(2, order + 1):
        cm.append(x * cm[m - 1] - y * sm[m - 1])
        sm.append(x * sm[m - 1] + y * cm[m - 1])

    # Q_l^m = P_l^m / sin(θ)^m, a polynomial in z:
    # Q_m^m = (2m-1)!!; Q_{m+1}^m = z (2m+1) Q_m^m;
    # (l-m) Q_l^m = z (2l-1) Q_{l-1}^m - (l+m-1) Q_{l-2}^m.
    q = {(0, 0): torch.ones_like(z)}
    for m in range(0, order + 1):
        if m > 0:
            q[(m, m)] = q[(m - 1, m - 1)] * (2 * m - 1)
        if m + 1 <= order:
            q[(m + 1, m)] = z * (2 * m + 1) * q[(m, m)]
        for l in range(m + 2, order + 1):
            q[(l, m)] = (z * (2 * l - 1) * q[(l - 1, m)]
                         - (l + m - 1) * q[(l - 2, m)]) / (l - m)

    out = []
    sqrt2 = math.sqrt(2.0)
    for l in range(order + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            base = q[(l, am)]
            if m == 0:
                out.append(_k(l, 0) * base)
            elif m > 0:
                out.append(sqrt2 * _k(l, m) * base * cm[am])
            else:
                out.append(sqrt2 * _k(l, am) * base * sm[am])
    return torch.stack(out, dim=-1)


def eval_function(coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sum_lm c_lm Y_lm(d); coeffs [..., C], d [N, 3]."""
    order = math.isqrt(coeffs.shape[-1]) - 1
    return eval_basis(d, order) @ coeffs


def project_dirs(values: torch.Tensor, d: torch.Tensor, order: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Monte Carlo SH projection of samples ``values`` [N] at unit
    directions d [N, 3] with ``weights`` [N] = 1/(pdf·N) (uniform on the
    sphere, 4π/N, when not given)."""
    n = d.shape[0]
    if weights is None:
        weights = torch.full((n,), 4.0 * math.pi / n, device=d.device)
    basis = eval_basis(d, order)
    return (basis * (values * weights)[:, None]).sum(0)


def project(fn, order: int, res: int = 64, device="cuda") -> torch.Tensor:
    """Projection of ``fn`` (directions [M, 3] → values [M]) on a θ/φ
    midpoint grid of res × res."""
    dev = resolve_device(device)
    it = (torch.arange(res, device=dev, dtype=torch.float32) + 0.5) / res
    theta = it * math.pi
    phi = it * 2.0 * math.pi
    tt, pp = torch.meshgrid(theta, phi, indexing="ij")
    st = torch.sin(tt)
    d = torch.stack([st * torch.cos(pp), st * torch.sin(pp), torch.cos(tt)],
                    dim=-1).reshape(-1, 3)
    vals = fn(d)
    w = (st * (math.pi / res) * (2.0 * math.pi / res)).reshape(-1)
    basis = eval_basis(d, order)
    return (basis * (vals * w)[:, None]).sum(0)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integral of the product of two SH-expanded functions."""
    return (a * b).sum(-1)


def lambda_l(order: int, device="cuda") -> torch.Tensor:
    """Per-coefficient convolution eigenvalues sqrt(4π/(2l+1))."""
    lam = []
    for l in range(order + 1):
        lam += [math.sqrt(4.0 * math.pi / (2 * l + 1))] * (2 * l + 1)
    return torch.tensor(lam, device=resolve_device(device))


def convolve_cosine(coeffs: torch.Tensor) -> torch.Tensor:
    """Convolution with the clamped cosine (irradiance from radiance,
    Ramamoorthi & Hanrahan 2001): band l scaled by lambda_l · a_l, a_l the
    zonal coefficients of max(cos, 0)."""
    order = math.isqrt(coeffs.shape[-1]) - 1
    a = []
    for l in range(order + 1):
        if l == 0:
            zl = math.sqrt(math.pi) / 2.0
        elif l == 1:
            zl = math.sqrt(math.pi / 3.0)
        elif l % 2 == 1:
            zl = 0.0
        else:
            h = l // 2
            zl = (math.sqrt((2 * l + 1) * math.pi) * (-1) ** (h + 1)
                  / (2**l * (l - 1) * (l + 2)) * math.factorial(l)
                  / (math.factorial(h) ** 2))
        a += [zl] * (2 * l + 1)
    return coeffs * lambda_l(order, coeffs.device) * torch.tensor(
        a, device=coeffs.device)


def rotate_z(coeffs: torch.Tensor, angle) -> torch.Tensor:
    """The expansion rotated about +z by ``angle`` (an exact phase shift per
    band); ``angle`` a float or a tensor broadcasting against
    coeffs[..., 0]."""
    order = math.isqrt(coeffs.shape[-1]) - 1
    angle = torch.as_tensor(angle, dtype=coeffs.dtype, device=coeffs.device)
    out = []
    i = 0
    for l in range(order + 1):
        for m in range(-l, l + 1):
            if m == 0:
                out.append(coeffs[..., i])
            elif m > 0:
                j = i - 2 * m  # (l, -m)
                out.append(coeffs[..., i] * torch.cos(m * angle)
                           - coeffs[..., j] * torch.sin(m * angle))
            else:
                j = i - 2 * m  # (l, +|m|)
                out.append(coeffs[..., i] * torch.cos(-m * angle)
                           + coeffs[..., j] * torch.sin(-m * angle))
            i += 1
    return torch.stack(out, dim=-1)
