"""Emitter evaluation on the guided path (port of sdmm_tpu/scene/emitters.py
``eval_emitter``, the constant-environment branch of ``env_eval`` and
``tri_pdf_over_area``)."""

from __future__ import annotations

import torch


def env_eval(scene, d: torch.Tensor) -> torch.Tensor:
    """Constant environment radiance along directions d [N, 3]."""
    return scene.env_radiance.expand_as(d)


def eval_emitter(scene, interaction: dict, wi_world: torch.Tensor):
    """Radiance emitted toward wi_world from a hit (front side only)."""
    em = interaction["emitter"]
    rad = scene.emitter_radiance[em.clamp_min(0)]
    front = (interaction["ng"] * wi_world).sum(-1) > 0.0
    return torch.where(((em >= 0) & front)[..., None], rad, 0.0)


def tri_pdf_over_area(scene) -> torch.Tensor:
    """Dense [T] map: triangle → discrete-selection pdf / area (0 if not
    emissive)."""
    dense = torch.zeros(scene.tri_v0.shape[0], device=scene.tri_v0.device)
    if scene.em_tri_idx.shape[0]:
        dense[scene.em_tri_idx.long()] = \
            scene.em_tri_pdf / scene.em_tri_area.clamp_min(1e-20)
    return dense
