"""Shading frame, spawn offset and MIS weight of the path tracers (port of
sdmm_tpu/render/volpath.py ``RAY_EPS``, ``mi_weight`` and
``shading_frame``)."""

from __future__ import annotations

import torch

from ..core.frame import coordinate_system
from ..scene.scene import (BSDF_DIELECTRIC, BSDF_HK, BSDF_NULL,
                           BSDF_ROUGHDIELECTRIC)

RAY_EPS = 1e-4  # spawn offset along the geometric normal


def mi_weight(pdf_a, pdf_b):
    """Power heuristic (beta = 2), as the reference's miWeight."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0.0, a2 / (a2 + pdf_b * pdf_b).clamp_min(1e-32),
                       0.0)


def shading_frame(params: dict, ns: torch.Tensor, wi_world: torch.Tensor):
    """Local frame; flips the normal to wi's side for reflective models
    (implicit two-sided) and keeps the true normal for the transmissive
    ones (dielectric, roughdielectric, null, hk)."""
    cos_i = (ns * wi_world).sum(-1)
    t = params["type"]
    transmissive = ((t == BSDF_DIELECTRIC) | (t == BSDF_ROUGHDIELECTRIC)
                    | (t == BSDF_NULL) | (t == BSDF_HK))
    flip = (cos_i < 0.0) & ~transmissive
    n = torch.where(flip[..., None], -ns, ns)
    s, t = coordinate_system(n)
    return s, t, n
