"""Film accumulation: splatting and development (port of
sdmm_tpu/render/film.py ``splat``, ``splat_gaussian``, ``develop``,
``variance``).

Keeps the squared-value accumulator used for variance estimation and
inverse-variance iterate combination.
"""

from __future__ import annotations

import torch


def splat(image: torch.Tensor, sqr_image: torch.Tensor, weight: torch.Tensor,
          pixel_idx: torch.Tensor, values: torch.Tensor, mask=None):
    """Scatter-add sample values (and squares) into flat [H*W, 3] buffers.
    Returns new buffers (inputs are not modified)."""
    if mask is not None:
        values = torch.where(mask[..., None], values, 0.0)
        w = torch.where(mask, 1.0, 0.0)
    else:
        w = torch.ones(values.shape[:-1], device=values.device)
    idx = pixel_idx.long()
    image = image.index_add(0, idx, values)
    sqr_image = sqr_image.index_add(0, idx, values * values)
    weight = weight.index_add(0, idx, w)
    return image, sqr_image, weight


def splat_gaussian(image, sqr_image, weight, pixel_idx, values, px, py,
                   width: int, height: int, stddev: float = 0.5):
    """3×3 Gaussian reconstruction splat, truncated at 1.5 px, the weights
    renormalised over the footprint (new buffers are returned)."""
    from .rfilters import _scatter, _taps

    inv2s2 = 1.0 / (2.0 * stddev * stddev)
    taps = _taps(pixel_idx, px, py, width, height, 1,
                 lambda dx, dy: torch.exp(-(dx ** 2 + dy ** 2) * inv2s2))
    total = sum(w for w, _ in taps).clamp_min(1e-12)
    return _scatter(image, sqr_image, weight, values, taps, total)


def develop(image, weight):
    return image / weight.clamp_min(1.0)[..., None]


def variance(image, sqr_image, weight):
    """Per-pixel sample variance of the mean estimate."""
    n = weight.clamp_min(1.0)[..., None]
    mean = image / n
    return (sqr_image / n - mean * mean).clamp_min(0.0) / (n - 1.0).clamp_min(1.0)
