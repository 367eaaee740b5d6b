"""Reconstruction filters for film splatting (port of
sdmm_tpu/render/rfilters.py).

Every filter is a stencil of fixed integer radius evaluated on the whole
wave: each of its (2r+1)² taps is one scatter-add. A sample's footprint
weights are renormalised so that it deposits total weight 1 (the signed sum
for the filters with negative lobes), the estimator of a develop-time
division by the accumulated filter weight.
"""

from __future__ import annotations

import math

import torch

from . import film


def _gaussian(r, stddev=0.5):
    return torch.exp(-r * r / (2.0 * stddev * stddev))


def _tent(r):
    return (1.0 - r.abs()).clamp_min(0.0)


def _mitchell_1d(x, b=1.0 / 3.0, c=1.0 / 3.0):
    """Mitchell-Netravali kernel over Mitsuba's radius of 2 pixels
    (|2x / radius|). The reference evaluates it at |2x|, half that
    support, where the taps of a sample near a pixel's edge can sum to
    almost 0 and its renormalised deposit explodes (ROADMAP §C)."""
    x = x.abs()
    x2 = x * x
    x3 = x2 * x
    near = ((12.0 - 9.0 * b - 6.0 * c) * x3
            + (-18.0 + 12.0 * b + 6.0 * c) * x2 + (6.0 - 2.0 * b)) \
        * (1.0 / 6.0)
    far = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2
           + (-12.0 * b - 48.0 * c) * x + (8.0 * b + 24.0 * c)) * (1.0 / 6.0)
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, 0.0))


def _lanczos_1d(x, tau=3.0):
    """Lanczos-windowed sinc."""
    x = x.abs()
    pix = math.pi * x.clamp_min(1e-6)
    val = (torch.sin(pix) / pix) * (torch.sin(pix / tau) / (pix / tau))
    return torch.where(x < 1e-6, 1.0, torch.where(x < tau, val, 0.0))


def filter_weight(name: str, dx, dy):
    """The 2-D filter weight at offset (dx, dy) pixels."""
    if name == "gaussian":
        return _gaussian(torch.sqrt(dx * dx + dy * dy))
    if name == "tent":
        return _tent(dx) * _tent(dy)
    if name == "mitchell":
        return _mitchell_1d(dx) * _mitchell_1d(dy)
    if name == "catmullrom":
        return _mitchell_1d(dx, 0.0, 0.5) * _mitchell_1d(dy, 0.0, 0.5)
    if name == "lanczos":
        return _lanczos_1d(dx) * _lanczos_1d(dy)
    raise ValueError(f"unknown rfilter {name!r}")


FILTER_RADIUS = {"box": 0, "tent": 1, "gaussian": 1, "mitchell": 2,
                 "catmullrom": 2, "lanczos": 3}


def _taps(pixel_idx, px, py, width, height, radius, weight_fn):
    """(weight, flat pixel) of every tap of the stencil around each
    sample's pixel; taps off the image weigh 0."""
    x = pixel_idx.long() % width
    y = pixel_idx.long() // width
    fx = px - (x.float() + 0.5)
    fy = py - (y.float() + 0.5)
    taps = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            xn, yn = x + dx, y + dy
            inside = (xn >= 0) & (xn < width) & (yn >= 0) & (yn < height)
            w = torch.where(inside, weight_fn(dx - fx, dy - fy), 0.0)
            taps.append((w, yn.clamp(0, height - 1) * width
                         + xn.clamp(0, width - 1)))
    return taps


def _scatter(image, sqr_image, weight, values, taps, total):
    for w, idx in taps:
        wn = w / total
        image = image.index_add(0, idx, values * wn[:, None])
        sqr_image = sqr_image.index_add(0, idx, values * values * wn[:, None])
        weight = weight.index_add(0, idx, wn)
    return image, sqr_image, weight


def splat_filtered(image, sqr_image, weight, pixel_idx, values, px, py,
                   width: int, height: int, name: str = "gaussian"):
    """Filtered scatter-add of a wave into flat [H*W, 3] buffers (new
    buffers are returned). px/py are continuous image positions,
    ``pixel_idx`` each sample's own pixel; ``box`` is the plain splat."""
    r = FILTER_RADIUS[name]
    if r == 0:
        return film.splat(image, sqr_image, weight, pixel_idx, values)
    taps = _taps(pixel_idx, px, py, width, height, r,
                 lambda dx, dy: filter_weight(name, dx, dy))
    total = sum(w for w, _ in taps)
    total = torch.where(total.abs() > 1e-8, total, 1.0)
    return _scatter(image, sqr_image, weight, values, taps, total)
