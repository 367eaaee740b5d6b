"""Axis-aligned bounding boxes (port of sdmm_tpu/core/aabb.py): host-side
numpy, used at scene-build time for the guiding domain."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AABB:
    lo: np.ndarray
    hi: np.ndarray

    @staticmethod
    def empty() -> "AABB":
        return AABB(np.full(3, np.inf), np.full(3, -np.inf))

    def expand(self, pts: np.ndarray) -> "AABB":
        p = np.asarray(pts).reshape(-1, 3)
        return AABB(np.minimum(self.lo, p.min(axis=0)),
                    np.maximum(self.hi, p.max(axis=0)))
