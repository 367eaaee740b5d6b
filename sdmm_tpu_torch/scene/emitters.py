"""Emitter evaluation and next-event sampling (port of
sdmm_tpu/scene/emitters.py: area triangles, the delta lights, the constant
environment and the equirect env map with its luminance CDF)."""

from __future__ import annotations

import math

import torch

from ..core import warp


def _env_uv(scene, d: torch.Tensor):
    """World direction → env-map (u, v) in [0, 1]: u from the azimuth
    about +y (0.5 at −z), v from the polar angle."""
    dl = d @ scene.env_to_world  # world → local: R^T d
    u = 0.5 + torch.atan2(dl[..., 0], -dl[..., 2]) / (2.0 * math.pi)
    v = torch.arccos(dl[..., 1].clamp(-1.0, 1.0)) / math.pi
    return u, v


def sample_env(scene, u2: torch.Tensor):
    """Importance-sample the env map by luminance (the row marginal, then
    the row's column CDF). Returns (d_world [N, 3], radiance [N, 3],
    solid-angle pdf [N])."""
    he, we = scene.env_pdf.shape
    row = torch.searchsorted(scene.env_row_cdf,
                             u2[..., 0].contiguous()).clamp(0, he - 1)
    col = torch.searchsorted(scene.env_col_cdf[row],
                             u2[..., 1:2].contiguous())[..., 0].clamp(0, we - 1)
    theta = (row.float() + 0.5) * (math.pi / he)
    phi = ((col.float() + 0.5) / we - 0.5) * (2.0 * math.pi)
    st = torch.sin(theta)
    dl = torch.stack([st * torch.sin(phi), torch.cos(theta),
                      -st * torch.cos(phi)], -1)
    d = dl @ scene.env_to_world.T
    return (d, scene.env_map[row, col] * scene.env_radiance,
            scene.env_pdf[row, col])


def pdf_env_dir(scene, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of sample_env drawing direction ``d`` (0 without an
    env map): the MIS weight of BSDF-sampled escapes."""
    if scene.env_pdf.shape[0] <= 1:
        return torch.zeros(d.shape[:-1], device=d.device)
    he, we = scene.env_pdf.shape
    u, v = _env_uv(scene, d)
    x = (torch.remainder(u, 1.0) * we).long().clamp(0, we - 1)
    y = (v * he).long().clamp(0, he - 1)
    return scene.env_pdf[y, x]


def sample_direct(scene, p: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor):
    """Direct-illumination sample at ``p`` [N, 3]: ``env_select_prob`` of
    the samples go to the env map, of the rest ``pt_select_prob`` to the
    delta lights (one by the power CDF, with ``u2[:, 0]``) and the others
    to the emissive triangles (one by the power CDF, with ``u1``
    re-stretched, and a uniform point on it, with ``u2``).

    Returns dict(d, dist, pdf, radiance, n, valid, delta). ``pdf`` is the
    solid-angle pdf for area and env samples and 1 for delta lights, whose
    ``radiance`` folds the falloff and the selection probability in
    (``delta`` marks them: their MIS weight is 1); a collimated beam's
    sample always fails."""
    n_rays = p.shape[0]
    dev = p.device
    m = scene.em_tri_idx.shape[0]
    n_pt = scene.pt_pos.shape[0]
    has_env = scene.env_pdf.shape[0] > 1
    zf = torch.zeros(n_rays, device=dev)
    zb = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    zero = {"d": torch.zeros_like(p), "dist": zf, "pdf": zf,
            "radiance": torch.zeros_like(p), "n": torch.zeros_like(p),
            "valid": zb, "delta": zb}
    if m == 0 and n_pt == 0 and not has_env:
        return zero

    if has_env:
        env_prob = scene.env_select_prob
        pick_env = u1 < env_prob
        u1 = torch.where(pick_env, u1 / env_prob.clamp_min(1e-9),
                         (u1 - env_prob) / (1.0 - env_prob).clamp_min(1e-9))
        d_env, rad_env, pdf_env = sample_env(scene, u2)
        rec_env = {"d": d_env, "dist": torch.full((n_rays,), 1e7, device=dev),
                   "pdf": pdf_env * env_prob, "radiance": rad_env,
                   "n": -d_env, "valid": pdf_env > 0.0, "delta": zb}
    else:
        env_prob = torch.zeros((), device=dev)
        pick_env = zb
        rec_env = zero

    if n_pt:
        pt_prob = scene.pt_select_prob
        pick_pt = u1 < pt_prob
        u1 = torch.where(pick_pt, u1 / pt_prob.clamp_min(1e-9),
                         (u1 - pt_prob) / (1.0 - pt_prob).clamp_min(1e-9))
        sel = torch.searchsorted(scene.pt_cdf,
                                 u2[..., 0].contiguous()).clamp(0, n_pt - 1)
        pmf = scene.pt_cdf[sel] - torch.where(
            sel > 0, scene.pt_cdf[(sel - 1).clamp_min(0)], 0.0)
        kind = scene.pt_kind[sel]
        to_l = scene.pt_pos[sel] - p
        dist2 = (to_l * to_l).sum(-1)
        dist = torch.sqrt(dist2.clamp_min(1e-20))
        d_pt = to_l / dist[..., None]
        # Directional lights: the fixed direction toward the light, no
        # falloff.
        is_dir = kind == 2
        d_pt = torch.where(is_dir[..., None], scene.pt_pos[sel], d_pt)
        dist = torch.where(is_dir, 1e7, dist)
        inv_r2 = torch.where(is_dir, 1.0, 1.0 / dist2.clamp_min(1e-12))
        # Spot falloff: 1 inside the beam, linear in cos to the cutoff.
        cos_sp = -(scene.pt_dir[sel] * d_pt).sum(-1)
        co = scene.pt_cutoff_cos[sel]
        cb = scene.pt_beam_cos[sel]
        fall = ((cos_sp - co) / (cb - co).clamp_min(1e-6)).clamp(0.0, 1.0)
        fall = torch.where(kind == 1, fall, 1.0)
        rad_pt = scene.pt_intensity[sel] * (
            inv_r2 * fall
            / (pmf * (pt_prob * (1.0 - env_prob)).clamp_min(1e-9)))[..., None]
        rec_pt = {"d": d_pt, "dist": dist,
                  "pdf": torch.ones(n_rays, device=dev), "radiance": rad_pt,
                  "n": -d_pt,
                  # A collimated beam is delta in position and direction:
                  # its direct sample always fails.
                  "valid": (is_dir | (dist2 > 1e-12)) & (kind != 3),
                  "delta": torch.ones(n_rays, dtype=torch.bool, device=dev)}
    else:
        pick_pt = zb
        rec_pt = zero

    if m:
        sel = torch.searchsorted(scene.em_tri_cdf,
                                 u1.contiguous()).clamp(0, m - 1)
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
        pdf_area = scene.em_tri_pdf[sel] / scene.em_tri_area[sel].clamp_min(
            1e-20)
        pdf_sa = pdf_area * dist2 / cos_l.clamp_min(1e-12)
        if n_pt:
            pdf_sa = pdf_sa * (1.0 - scene.pt_select_prob)
        pdf_sa = pdf_sa * (1.0 - env_prob)
        valid = (cos_l > 1e-6) & (dist2 > 1e-12)
        rec_area = {"d": d, "dist": dist,
                    "pdf": torch.where(valid, pdf_sa, 0.0),
                    "radiance": scene.emitter_radiance[
                        scene.tri_emitter[tri].long()],
                    "n": n, "valid": valid, "delta": zb}
    else:
        rec_area = zero
        pick_pt = torch.ones(n_rays, dtype=torch.bool, device=dev)

    out = {}
    for k in zero:
        pt, env = pick_pt, pick_env
        if rec_pt[k].ndim > 1:
            pt, env = pt[..., None], env[..., None]
        out[k] = torch.where(env, rec_env[k],
                             torch.where(pt, rec_pt[k], rec_area[k]))
    return out


def tri_pdf_over_area(scene) -> torch.Tensor:
    """Dense [T] map: triangle → discrete-selection pdf / area (0 if not
    emissive)."""
    dense = torch.zeros(scene.tri_v0.shape[0], device=scene.tri_v0.device)
    if scene.em_tri_idx.shape[0]:
        dense[scene.em_tri_idx.long()] = \
            scene.em_tri_pdf / scene.em_tri_area.clamp_min(1e-20)
    return dense


def pdf_direct_hit(scene, pdf_over_area_dense, tri, d, dist):
    """Solid-angle NEE pdf of hitting emissive triangle ``tri`` [N] (-1 for
    a miss) along d [N, 3] at distance ``dist`` [N]."""
    t = tri.long().clamp_min(0)
    cos_l = -(scene.tri_ng[t] * d).sum(-1)
    pdf = pdf_over_area_dense[t] * dist * dist / cos_l.clamp_min(1e-12)
    return torch.where((tri >= 0) & (cos_l > 1e-6), pdf, 0.0)


def env_eval(scene, d: torch.Tensor) -> torch.Tensor:
    """Environment radiance along directions d [N, 3]: the constant, or the
    env map's bilinear value times ``env_radiance`` (its scale)."""
    if scene.env_map.shape[0] <= 1:
        return scene.env_radiance.expand_as(d)
    he, we = scene.env_map.shape[0], scene.env_map.shape[1]
    u, v = _env_uv(scene, d)
    x = (torch.remainder(u, 1.0) * we).clamp(0.0, we - 1e-3)
    y = (v * he).clamp(0.0, he - 1e-3)
    x0 = x.long()
    y0 = y.long()
    x1 = (x0 + 1).clamp_max(we - 1)
    y1 = (y0 + 1).clamp_max(he - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    em = scene.env_map
    c = (em[y0, x0] * (1 - fx) * (1 - fy) + em[y0, x1] * fx * (1 - fy)
         + em[y1, x0] * (1 - fx) * fy + em[y1, x1] * fx * fy)
    return c * scene.env_radiance


def eval_emitter(scene, interaction: dict, wi_world: torch.Tensor):
    """Radiance emitted toward wi_world from a hit (front side only)."""
    em = interaction["emitter"]
    rad = scene.emitter_radiance[em.clamp_min(0)]
    front = (interaction["ng"] * wi_world).sum(-1) > 0.0
    return torch.where(((em >= 0) & front)[..., None], rad, 0.0)
