"""Sample generators: independent, stratified and low-discrepancy (port of
sdmm_tpu/core/sampler.py).

A sampler maps (pixel, sample index, dimension) to uniforms. The
quasi-random ones take radical-inverse or Sobol points and rotate them per
pixel (Cranley-Patterson), so that pixels decorrelate while each keeps its
stratification; the rotations are a table drawn once per render
(``pixel_rotations``), where the reference folds the pixel into its key.
``sobol_nd`` evaluates Sobol points of any dimension from scipy's Joe-Kuo
direction numbers, as the reference loads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)
_MASK32 = 0xFFFFFFFF


def radical_inverse(idx: torch.Tensor, base: int,
                    n_digits: int = 20) -> torch.Tensor:
    """Van der Corput radical inverse of integer indices in ``base``
    (float32, digits accumulated in the reference's order)."""
    inv_base = 1.0 / base
    result = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    factor = inv_base
    x = idx.long()
    for _ in range(n_digits):
        result = result + (x % base).float() * factor
        x = x // base
        factor = factor * inv_base
    return result


def pixel_rotations(generator: torch.Generator, n_pix: int,
                    device=None) -> torch.Tensor:
    """The per-pixel Cranley-Patterson rotations [n_pix, 2] of one render,
    uniform in [0, 1)²."""
    return torch.rand((n_pix, 2), generator=generator, device=device)


def halton_2d(sample_idx: torch.Tensor, rot: torch.Tensor,
              dim_pair: int = 0) -> torch.Tensor:
    """2-D Halton points rotated by the lanes' ``rot`` [N, 2]."""
    b0 = PRIMES[(2 * dim_pair) % len(PRIMES)]
    b1 = PRIMES[(2 * dim_pair + 1) % len(PRIMES)]
    u = radical_inverse(sample_idx, b0)
    v = radical_inverse(sample_idx, b1)
    return torch.stack([(u + rot[..., 0]) % 1.0, (v + rot[..., 1]) % 1.0],
                       dim=-1)


def stratified_2d(sample_idx: torch.Tensor, n_samples: int,
                  rot: torch.Tensor) -> torch.Tensor:
    """Jitter over a ⌊√n⌋×⌊√n⌋ grid, the stratum's offset the lane's
    rotation."""
    res = max(1, int(math.isqrt(n_samples)))
    i = sample_idx.long()
    sx = (i % res).float()
    sy = ((i // res) % res).float()
    return torch.stack([((sx + rot[..., 0]) / res) % 1.0,
                        ((sy + rot[..., 1]) / res) % 1.0], dim=-1)


def _bit_reverse32(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return (((x & 0x0000FFFF) << 16) | ((x >> 16) & 0x0000FFFF)) & _MASK32


def _sobol_dim2_dirs() -> tuple:
    """Direction numbers of Sobol dimension 2 (Joe-Kuo: s=2, a=1, m=1,3)."""
    v = [0] * 32
    v[0] = 1 << 31
    v[1] = 3 << 30
    for k in range(2, 32):
        v[k] = v[k - 2] ^ (v[k - 2] >> 2) ^ v[k - 1]
    return tuple(v)


_SOBOL_DIRS = _sobol_dim2_dirs()


def _u32_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 → float32 in [0, 1], as the reference's
    ``u.astype(float32) * 2^-32``."""
    return x.float() * (2.0 ** -32)


def sobol_2d(sample_idx: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """The first two Sobol dimensions rotated by the lanes' ``rot``."""
    i = sample_idx.long() & _MASK32
    u = _bit_reverse32(i)
    v = torch.zeros_like(i)
    for k in range(32):
        v = v ^ (((i >> k) & 1) * _SOBOL_DIRS[k])
    return torch.stack([(_u32_to_unit(u) + rot[..., 0]) % 1.0,
                        (_u32_to_unit(v) + rot[..., 1]) % 1.0], dim=-1)


def camera_jitter(kind: str, rotations: torch.Tensor,
                  pixel_id: torch.Tensor, sample_idx: torch.Tensor,
                  n_samples: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """The pixel jitter [N, 2] of the camera dimension under sampler
    ``kind``: the quasi-random ones read each lane's pixel rotation from
    ``rotations`` ([n_pix, 2], ``pixel_rotations``); ``independent`` draws
    from ``generator``."""
    if kind == "independent":
        return torch.rand(pixel_id.shape + (2,), generator=generator,
                          device=pixel_id.device)
    rot = rotations[pixel_id.long()]
    if kind == "stratified":
        return stratified_2d(sample_idx, n_samples, rot)
    if kind == "halton":
        return halton_2d(sample_idx, rot)
    if kind == "sobol":
        return sobol_2d(sample_idx, rot)
    raise ValueError(f"unknown sampler {kind!r}")


def _load_sobol_directions(max_dims: int = 64) -> np.ndarray:
    """[max_dims, 32] Joe-Kuo direction numbers, from scipy."""
    from scipy.stats import qmc

    s = qmc.Sobol(d=max_dims, scramble=False, bits=32)
    return np.asarray(s._sv, dtype=np.uint32)


_SOBOL_SV = None


def sobol_nd(sample_idx: torch.Tensor, n_dims: int,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Sobol points [N, n_dims] at the sample indices, in scipy's gray-code
    order; with ``generator``, a random digital (XOR) shift per dimension,
    which keeps the (t, m, s)-net property."""
    global _SOBOL_SV
    if _SOBOL_SV is None:
        _SOBOL_SV = _load_sobol_directions()
    if n_dims > _SOBOL_SV.shape[0]:
        raise ValueError(f"sobol_nd supports up to {_SOBOL_SV.shape[0]} dims")
    dev = sample_idx.device
    sv = torch.as_tensor(_SOBOL_SV[:n_dims].astype(np.int64), device=dev)
    idx = sample_idx.long() & _MASK32
    gray = idx ^ (idx >> 1)
    x = torch.zeros(sample_idx.shape + (n_dims,), dtype=torch.int64,
                    device=dev)
    for b in range(32):
        x = x ^ (((gray >> b) & 1)[..., None] * sv[:, b])
    if generator is not None:
        shift = torch.randint(0, 1 << 32, (n_dims,), generator=generator,
                              device=dev, dtype=torch.int64)
        x = x ^ shift
    return (x >> 8).float() * (1.0 / (1 << 24))
