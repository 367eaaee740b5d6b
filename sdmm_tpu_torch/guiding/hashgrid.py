"""Uniform grid over the guiding domain and density-based normalization of
sample weights (port of sdmm_tpu/guiding/hashgrid.py).

The domain is a dense R³ cell grid: a cell lookup is one floor-divide and
the sample density a histogram over the cells.
"""

from __future__ import annotations

import numpy as np
import torch


class UniformGrid:
    """Dense uniform grid over an AABB."""

    def __init__(self, lo, hi, resolution: int = 16):
        self.lo = np.asarray(lo, dtype=np.float32)
        self.hi = np.asarray(hi, dtype=np.float32)
        self.res = int(resolution)
        self.n_cells = self.res ** 3

    def device_tables(self, device: str | torch.device = "cuda") -> dict:
        ext = np.maximum(self.hi - self.lo, 1e-12)
        return {
            "lo": torch.as_tensor(self.lo, device=device),
            "inv_ext": torch.as_tensor((1.0 / ext).astype(np.float32),
                                       device=device),
            "res": self.res,
        }


def grid_cell(tables: dict, p: torch.Tensor) -> torch.Tensor:
    """Cell id of each point (points outside clamp to the boundary
    cells)."""
    res = tables["res"]
    q = (p - tables["lo"]) * tables["inv_ext"]
    ijk = (q * res).to(torch.int64).clamp(0, res - 1)
    return (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]


def cell_counts(tables: dict, p: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Per-cell sample histogram."""
    res = tables["res"]
    return torch.zeros(res ** 3, device=p.device).index_add_(
        0, grid_cell(tables, p), valid.float())


def density_at(tables: dict, counts: torch.Tensor,
               p: torch.Tensor) -> torch.Tensor:
    """Sample density (per unit normalized volume) at each point."""
    return counts[grid_cell(tables, p)] * float(tables["res"] ** 3)


def normalize_weights(weight: torch.Tensor, density: torch.Tensor,
                      valid: torch.Tensor, clip: float = 20.0):
    """Density-normalized sample weights: samples in densely sampled
    regions are scaled down by mean_density/density, the factor clipped to
    [1/clip, clip]."""
    n_valid = valid.float().sum().clamp_min(1.0)
    mean_density = torch.where(valid, density, 0.0).sum() / n_valid
    factor = (mean_density / density.clamp_min(1e-12)).clamp(1.0 / clip,
                                                             clip)
    return torch.where(valid, weight * factor, weight)
