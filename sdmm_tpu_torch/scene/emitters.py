"""Emitter evaluation and next-event sampling (port of
sdmm_tpu/scene/emitters.py ``eval_emitter``, the constant-environment
branch of ``env_eval``, ``tri_pdf_over_area``, and the area-triangle branch
of ``sample_direct`` and ``pdf_direct_hit``)."""

from __future__ import annotations

import torch

from ..core import warp


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


def _only_area_lights(scene):
    """The port's scenes hold area triangles and a constant environment; a
    scene that brings point lights or an environment map asks for branches
    of the reference that are not ported."""
    pt = getattr(scene, "pt_pos", None)
    env_pdf = getattr(scene, "env_pdf", None)
    if (pt is not None and pt.shape[0] > 0) or (
            env_pdf is not None and env_pdf.shape[0] > 1):
        raise NotImplementedError(
            "point lights and environment maps are not ported")


def sample_direct(scene, p: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor):
    """Direct-illumination sample of the emissive triangles: one triangle by
    the power CDF (``u1`` [N]), a uniform point on it (``u2`` [N, 2]).

    Returns dict(d, dist, pdf, radiance, n, valid, delta); ``pdf`` is the
    solid-angle pdf at ``p`` [N, 3], 0 where the sample is invalid (back
    side, or at ``p``). A scene without emissive triangles gives the zero
    record."""
    _only_area_lights(scene)
    n_rays = p.shape[0]
    m = scene.em_tri_idx.shape[0]
    if m == 0:
        z = torch.zeros(n_rays, device=p.device)
        f = torch.zeros(n_rays, dtype=torch.bool, device=p.device)
        return {"d": torch.zeros_like(p), "dist": z, "pdf": z,
                "radiance": torch.zeros_like(p), "n": torch.zeros_like(p),
                "valid": f, "delta": f}
    sel = torch.searchsorted(scene.em_tri_cdf, u1.contiguous()).clamp(0, m - 1)
    tri = scene.em_tri_idx.long()[sel]
    b = warp.square_to_uniform_triangle(u2)
    y = (scene.tri_v0[tri] + b[..., 0:1] * scene.tri_e1[tri]
         + b[..., 1:2] * scene.tri_e2[tri])
    n = scene.tri_ng[tri]
    to_y = y - p
    dist2 = (to_y * to_y).sum(-1)
    dist = torch.sqrt(dist2.clamp_min(1e-20))
    d = to_y / dist[..., None]
    cos_l = -(n * d).sum(-1)
    pdf_area = scene.em_tri_pdf[sel] / scene.em_tri_area[sel].clamp_min(1e-20)
    pdf_sa = pdf_area * dist2 / cos_l.clamp_min(1e-12)
    valid = (cos_l > 1e-6) & (dist2 > 1e-12)
    return {"d": d, "dist": dist, "pdf": torch.where(valid, pdf_sa, 0.0),
            "radiance": scene.emitter_radiance[scene.tri_emitter[tri].long()],
            "n": n, "valid": valid,
            "delta": torch.zeros(n_rays, dtype=torch.bool, device=p.device)}


def pdf_direct_hit(scene, pdf_over_area_dense, tri, d, dist):
    """Solid-angle NEE pdf of hitting emissive triangle ``tri`` [N] (-1 for
    a miss) along d [N, 3] at distance ``dist`` [N]."""
    t = tri.long().clamp_min(0)
    cos_l = -(scene.tri_ng[t] * d).sum(-1)
    pdf = pdf_over_area_dense[t] * dist * dist / cos_l.clamp_min(1e-12)
    return torch.where((tri >= 0) & (cos_l > 1e-6), pdf, 0.0)
