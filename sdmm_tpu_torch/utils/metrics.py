"""Image quality metrics against a reference image (port of
sdmm_tpu/utils/metrics.py: L1, L2, MrSE, MrSE on [0, 1]-clipped images,
MAPE, SMAPE, SSIM, and the mean pixel variance). Host-side numpy."""

from __future__ import annotations

import numpy as np


def _prep(img, ref):
    return np.asarray(img, dtype=np.float64), np.asarray(ref, dtype=np.float64)


def l1(img, ref):
    img, ref = _prep(img, ref)
    return float(np.mean(np.abs(img - ref)))


def l2(img, ref):
    img, ref = _prep(img, ref)
    return float(np.mean((img - ref) ** 2))


def mrse(img, ref, eps=1e-2):
    """Mean relative squared error."""
    img, ref = _prep(img, ref)
    return float(np.mean((img - ref) ** 2 / (ref * ref + eps)))


def mrse01(img, ref, eps=1e-2):
    """MrSE of the images clipped to [0, 1], which bounds the weight of rare
    fireflies (the comparison protocol's MrSE)."""
    img, ref = _prep(img, ref)
    return mrse(np.clip(img, 0.0, 1.0), np.clip(ref, 0.0, 1.0), eps)


def mape(img, ref, eps=1e-2):
    img, ref = _prep(img, ref)
    return float(np.mean(np.abs(img - ref) / (ref + eps)))


def smape(img, ref, eps=1e-2):
    img, ref = _prep(img, ref)
    return float(np.mean(2.0 * np.abs(img - ref) / (img + ref + eps)))


def ssim(img, ref, c1=0.01**2, c2=0.03**2):
    """Structural similarity of the luminance, over 8x8 windows."""
    img, ref = _prep(img, ref)

    def lum(x):
        return 0.212671 * x[..., 0] + 0.715160 * x[..., 1] \
            + 0.072169 * x[..., 2]

    a = lum(img)
    b = lum(ref)
    scale = max(b.max(), 1e-9)
    a = a / scale
    b = b / scale
    h, w = a.shape
    bh, bw = h // 8, w // 8
    if bh == 0 or bw == 0:
        return 1.0
    a = a[: bh * 8, : bw * 8].reshape(bh, 8, bw, 8)
    b = b[: bh * 8, : bw * 8].reshape(bh, 8, bw, 8)
    mu_a = a.mean(axis=(1, 3))
    mu_b = b.mean(axis=(1, 3))
    var_a = a.var(axis=(1, 3))
    var_b = b.var(axis=(1, 3))
    cov = (a * b).mean(axis=(1, 3)) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def all_metrics(img, ref) -> dict:
    return {
        "l1": l1(img, ref),
        "l2": l2(img, ref),
        "mrse": mrse(img, ref),
        "mrse01": mrse01(img, ref),
        "mape": mape(img, ref),
        "smape": smape(img, ref),
        "ssim": ssim(img, ref),
    }


def mean_pixel_variance(image_sum, sqr_sum, weight):
    """Mean over pixels and channels of the variance of each pixel's mean,
    from its sum, sum of squares and sample count."""
    n = np.maximum(weight, 1.0)[..., None]
    mean = image_sum / n
    var = np.maximum(sqr_sum / n - mean * mean, 0.0) / np.maximum(n - 1.0, 1.0)
    return float(var.mean())
