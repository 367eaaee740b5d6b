"""Chi-square goodness-of-fit harness for sampling routines (port of
sdmm_tpu/utils/chisquare.py, host-side numpy and scipy).

Samples are binned over the sphere in (cos θ, φ), the claimed pdf is
integrated numerically per bin, cells of low expected count are pooled,
and the chi-square statistic is tested at the reference's significance.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaincc


def sphere_bins(d: np.ndarray, n_cos: int = 10, n_phi: int = 16) -> np.ndarray:
    """Map directions [N,3] to bin indices over (cosθ, φ)."""
    cz = np.clip((d[..., 2] + 1.0) * 0.5 * n_cos, 0, n_cos - 1).astype(int)
    phi = np.arctan2(d[..., 1], d[..., 0])
    pz = np.clip((phi / np.pi + 1.0) * 0.5 * n_phi, 0, n_phi - 1).astype(int)
    return cz * n_phi + pz


def chi2_test(
    sample_dirs: np.ndarray,
    pdf_fn,
    n_cos: int = 10,
    n_phi: int = 16,
    n_integrate: int = 400_000,
    significance: float = 0.0025,
    min_exp: float = 5.0,
):
    """Chi-square test: sampled histogram vs numerically integrated pdf.

    pdf_fn: directions [M,3] → pdf values [M] (solid-angle measure).
    Returns (passed, p_value, stats dict); the significance is 0.0025 per
    test.
    """
    n = len(sample_dirs)
    n_bins = n_cos * n_phi
    obs = np.bincount(sphere_bins(sample_dirs, n_cos, n_phi), minlength=n_bins).astype(
        np.float64
    )

    # Integrate expected mass per bin with a dense Fibonacci sphere set.
    i = np.arange(n_integrate) + 0.5
    phi = np.pi * (1 + 5**0.5) * i
    z = 1 - 2 * i / n_integrate
    r = np.sqrt(np.maximum(0, 1 - z * z))
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    pdf = np.asarray(pdf_fn(dirs), dtype=np.float64)
    exp_mass = np.bincount(
        sphere_bins(dirs, n_cos, n_phi), weights=pdf, minlength=n_bins
    ) * (4 * np.pi / n_integrate)
    exp = exp_mass * n
    # Account for samples the pdf claims to reject (mass < 1): pool into a
    # virtual "rejected" cell only if the sampler also produced fewer than n.
    # Pool cells with low expected counts (reference pools < 5).
    order = np.argsort(-exp)
    obs_s, exp_s = obs[order], exp[order]
    pooled_obs, pooled_exp = [], []
    acc_o = acc_e = 0.0
    for o, e in zip(obs_s, exp_s):
        acc_o += o
        acc_e += e
        if acc_e >= min_exp:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0 and pooled_exp:
        pooled_obs[-1] += acc_o
        pooled_exp[-1] += acc_e
    pooled_obs = np.asarray(pooled_obs)
    pooled_exp = np.asarray(pooled_exp)
    # Normalize expectation to the observed total (conditional test).
    pooled_exp *= pooled_obs.sum() / max(pooled_exp.sum(), 1e-12)

    chi2 = float(np.sum((pooled_obs - pooled_exp) ** 2 / np.maximum(pooled_exp, 1e-12)))
    dof = max(len(pooled_obs) - 1, 1)
    p_value = float(gammaincc(dof / 2.0, chi2 / 2.0))
    return p_value >= significance, p_value, {
        "chi2": chi2, "dof": dof, "cells": len(pooled_obs),
    }
