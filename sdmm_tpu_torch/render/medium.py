"""Participating media: free-flight sampling, delta tracking through grid
densities, transmittance, medium switches at boundaries and the
Henyey-Greenstein phase function (port of sdmm_tpu/render/medium.py).

Media live in a table (row 0 vacuum, ``SceneData.med_*``); each ray carries
a medium id that switches where it crosses the boundary of a shape with an
interior medium. Homogeneous free flights sample the mean extinction and
reweight each channel; heterogeneous ones run delta tracking against the
majorant for at most a fixed number of steps, their uniforms drawn at once,
with a host check only every ``CHECK_EVERY`` steps.
"""

from __future__ import annotations

import math

import torch

from ..core import draws
from ..core.frame import coordinate_system, to_world

CHECK_EVERY = 16  # delta-tracking steps between host checks of the loop


def sample_distance(scene, med_id: torch.Tensor, u: torch.Tensor,
                    t_surf: torch.Tensor) -> dict:
    """A free-flight distance against the ray's mean extinction.

    Returns dict(t, scattered [bool], weight [N, 3]): weight is the
    per-channel transmittance over the pdf of the event taken (a medium
    scatter at t, or reaching the surface at t_surf). Vacuum rows never
    scatter and weigh 1."""
    mid = med_id.long()
    sigma_t = scene.med_sigma_t[mid]
    sigma_bar = sigma_t.mean(-1)
    in_medium = sigma_bar > 1e-12
    sb = sigma_bar.clamp_min(1e-8)
    t_med = -torch.log1p(-u.clamp_max(1.0 - 1e-7)) / sb
    scattered = in_medium & (t_med < t_surf)
    t = torch.where(scattered, t_med, t_surf)
    tr = torch.exp(-sigma_t * t[:, None])
    pdf_surf = torch.exp(-sb * t)
    pdf_med = sb * pdf_surf
    sigma_s = sigma_t * scene.med_albedo[mid]
    w_med = sigma_s * tr / pdf_med.clamp_min(1e-30)[:, None]
    w_surf = tr / pdf_surf.clamp_min(1e-30)[:, None]
    weight = torch.where(scattered[:, None], w_med, w_surf)
    weight = torch.where(in_medium[:, None], weight, 1.0)
    return {"t": t, "scattered": scattered, "weight": weight}


def density_at(scene, med_id: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The grid density at ``p`` (nearest cell): 1 on homogeneous rows, 0
    outside the grid's bounds."""
    mid = med_id.long()
    vol = scene.med_vol[mid]
    q = (p - scene.med_vol_lo[mid]) * scene.med_vol_inv_ext[mid]
    inside = ((q >= 0.0) & (q < 1.0)).all(-1)
    r = scene.volumes.shape[1]
    ijk = (q * r).to(torch.int32).clamp(0, r - 1).long()
    dens = scene.volumes[vol.clamp_min(0).long(), ijk[..., 2], ijk[..., 1],
                         ijk[..., 0]]
    return torch.where(vol >= 0, torch.where(inside, dens, 0.0), 1.0)


def sample_distance_hetero(scene, med_id: torch.Tensor,
                           generator: torch.Generator, ro: torch.Tensor,
                           rd: torch.Tensor, t_surf: torch.Tensor,
                           max_steps: int = 64) -> dict:
    """Delta (Woodcock) tracking through grid-density media: free flights
    against the majorant, null collisions where the local density lies
    below it, for ``max_steps`` steps whose uniforms (``generator``, on the
    rays' device, through ``core/draws.rand``) are drawn at once; the loop
    ends early once every ray is done. The gray extinction (the channels' mean) drives the tracking;
    the free-flight pdf cancels the transmittance, so a scatter weighs the
    albedo and an escape 1.

    Returns dict(t, scattered, weight) as ``sample_distance``."""
    n = ro.shape[0]
    mid = med_id.long()
    sigma_bar = scene.med_sigma_t[mid].mean(-1)
    maj = scene.med_majorant[mid] * sigma_bar
    in_medium = maj > 1e-12
    inv_maj = 1.0 / maj.clamp_min(1e-12)
    u = draws.rand((max_steps, 2, n), generator, ro.device, axis=2)
    t = torch.zeros(n, device=ro.device)
    done = ~in_medium
    scattered = torch.zeros(n, dtype=torch.bool, device=ro.device)
    for i in range(max_steps):
        # One host check every CHECK_EVERY steps ends the loop early once
        # every ray is done; the result is that of all max_steps steps.
        if i % CHECK_EVERY == 0 and bool(done.all()):
            break
        t_new = t - torch.log1p(-u[i, 0].clamp_max(1.0 - 1e-7)) * inv_maj
        escaped = t_new >= t_surf
        dens = density_at(scene, med_id, ro + t_new[:, None] * rd)
        real = u[i, 1] < dens * sigma_bar * inv_maj
        fresh = ~done
        t = torch.where(fresh, torch.minimum(t_new, t_surf), t)
        hit = fresh & ~escaped & real
        scattered = scattered | hit
        done = done | escaped | hit
    t = torch.where(in_medium & done, t, t_surf)
    albedo = scene.med_albedo[mid]
    w = torch.where((scattered & in_medium)[:, None], albedo, 1.0)
    return {"t": t, "scattered": scattered & in_medium, "weight": w}


def transmittance(scene, med_id: torch.Tensor,
                  dist: torch.Tensor) -> torch.Tensor:
    """e^{-sigma_t·d} per channel through the ray's current medium (the
    shadow segment is not marched across medium boundaries, as in the
    reference)."""
    return torch.exp(-scene.med_sigma_t[med_id.long()] * dist[:, None])


def transmittance_hetero(scene, med_id: torch.Tensor,
                         generator: torch.Generator, ro, rd,
                         dist: torch.Tensor,
                         max_steps: int = 64) -> torch.Tensor:
    """An unbiased binary transmittance estimate by delta tracking (1
    survives, 0 absorbed) on grid rows; the analytic curve on homogeneous
    ones."""
    hs = sample_distance_hetero(scene, med_id, generator, ro, rd, dist,
                                max_steps)
    binary = torch.where(hs["scattered"][:, None], 0.0, 1.0)
    return torch.where((scene.med_vol[med_id.long()] >= 0)[:, None], binary,
                       transmittance(scene, med_id, dist))


def update_medium(scene, med_id, tri, wi_dot_geo, wo_dot_geo, crossed_mask):
    """The medium id after a surface event: a transmission through a
    boundary takes the triangle's interior (entering, wo·ng < 0) or its
    exterior (leaving); a reflection keeps the current medium."""
    crossing = crossed_mask & (wi_dot_geo * wo_dot_geo < 0.0)
    tri_safe = tri.long().clamp_min(0)
    new_id = torch.where(wo_dot_geo < 0.0, scene.tri_medium[tri_safe],
                         scene.tri_medium_ext[tri_safe])
    return torch.where(crossing, new_id, med_id)


def hg_pdf(g, cos_theta):
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * math.pi
                            * torch.pow(denom.clamp_min(1e-8), 1.5))


def hg_sample(g, wi: torch.Tensor, u: torch.Tensor):
    """A direction about the propagation direction ``wi``; returns (d,
    pdf)."""
    g = torch.broadcast_to(torch.as_tensor(g, device=u.device),
                           u[..., 0].shape)
    iso = g.abs() < 1e-3
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u[..., 0] + 1e-12)
    two_g = torch.where(g.abs() > 1e-6, 2.0 * g, 1e-6)
    cos_t = torch.where(iso, 1.0 - 2.0 * u[..., 0],
                        (1.0 + g * g - sqr * sqr) / two_g)
    cos_t = cos_t.clamp(-1.0, 1.0)
    sin_t = (1.0 - cos_t * cos_t).clamp_min(0.0).sqrt()
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], dim=-1)
    s, t = coordinate_system(wi)
    return to_world(s, t, wi, local), hg_pdf(g, cos_t)
