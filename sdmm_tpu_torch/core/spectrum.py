"""Load-time spectral → linear RGB conversion (port of
sdmm_tpu/core/spectrum.py).

The port computes in linear RGB. A scene file may give a spectrum as
``"400:0, 500:1600, ..."``; it is integrated against the CIE 1931
colour-matching functions (the analytic multi-Gaussian fits of Wyman, Sloan
& Shirley 2013) and mapped to linear sRGB at load time. Host-side numpy.
"""

from __future__ import annotations

import numpy as np


def _g(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * np.exp(-0.5 * t * t)


def cie_xyz_cmf(wavelengths: np.ndarray) -> np.ndarray:
    """CIE 1931 xbar/ybar/zbar at ``wavelengths`` (nm). Returns [N, 3]."""
    wl = np.asarray(wavelengths, dtype=np.float64)
    x = (
        _g(wl, 1.056, 599.8, 37.9, 31.0)
        + _g(wl, 0.362, 442.0, 16.0, 26.7)
        + _g(wl, -0.065, 501.1, 20.4, 26.2)
    )
    y = _g(wl, 0.821, 568.8, 46.9, 40.5) + _g(wl, 0.286, 530.9, 16.3, 31.1)
    z = _g(wl, 1.217, 437.0, 11.8, 36.0) + _g(wl, 0.681, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], axis=-1)


# XYZ → linear sRGB (D65).
XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)


def interpolated_spectrum_to_rgb(wavelengths: np.ndarray,
                                 values: np.ndarray) -> np.ndarray:
    """Piecewise-linear spectrum → linear RGB, normalised by the CIE Y
    integral so that a flat spectrum of 1 maps to about (1, 1, 1)."""
    wl_grid = np.arange(360.0, 831.0, 1.0)
    vals = np.interp(wl_grid, wavelengths, values, left=0.0, right=0.0)
    cmf = cie_xyz_cmf(wl_grid)
    xyz = (cmf * vals[:, None]).sum(axis=0)
    xyz = xyz / cmf[:, 1].sum()
    return np.maximum(XYZ_TO_SRGB @ xyz, 0.0)


def luminance(rgb):
    """Relative luminance of linear RGB (the reference's getLuminance)."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 \
        + rgb[..., 2] * 0.072169
