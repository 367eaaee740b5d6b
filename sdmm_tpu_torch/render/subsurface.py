"""Dipole subsurface scattering (port of sdmm_tpu/render/subsurface.py).

A preprocess bakes each subsurface instance: a blue-noise-like point set
on its triangles (area-weighted uniform candidates thinned to one per voxel
of side r/√3), the irradiance at each point from cosine-sampled rays
through ``volpath.trace_wave`` (E = π · mean Li), and the dipole diffusion
kernel ``dmo`` convolved against every point at every triangle corner, in
chunks of at most 4,096 corners. At render time a hit's exitance is the
barycentric interpolation of its corners, and the integrators add

    Lo(p, d) = 1/π · (1 − Fr(cos(ns, d), η)) · M(p)

like emitted radiance, without MIS.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.frame import coordinate_system
from ..scene.scene import scene_to

INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)

# Material presets (Jensen et al. 2001; Narasimhan et al. 2006): sigma_s,
# sigma_a in 1/mm, scaled by 100 at lookup, and the IOR.
MATERIALS = {
    "skimmilk": ([0.70, 1.22, 1.90], [0.0014, 0.0025, 0.0142], 1.3),
    "wholemilk": ([2.55, 3.21, 3.77], [0.0011, 0.0024, 0.014], 1.3),
    "cream": ([7.38, 5.47, 3.15], [0.0002, 0.0028, 0.0163], 1.3),
    "ketchup": ([0.18, 0.07, 0.03], [0.061, 0.97, 1.45], 1.3),
    "marble": ([2.19, 2.62, 3.00], [0.0021, 0.0041, 0.0071], 1.5),
    "potato": ([0.68, 0.70, 0.55], [0.0024, 0.0090, 0.12], 1.3),
    "skin1": ([0.74, 0.88, 1.01], [0.032, 0.17, 0.48], 1.3),
    "skin2": ([1.09, 1.59, 1.79], [0.013, 0.070, 0.145], 1.3),
}


def lookup_material(name: str):
    """Preset → (sigma_s, sigma_a, eta), the sigmas ×100."""
    s, a, eta = MATERIALS[name.lower()]
    return np.asarray(s) * 100.0, np.asarray(a) * 100.0, eta


def _fresnel_diffuse_reflectance(eta: float) -> float:
    """Fdr by the polynomial fits of Egan & Hilgeman and d'Eon."""
    if eta < 1.0:
        return float(-0.4399 + 0.7099 / eta - 0.3319 / eta ** 2
                     + 0.0636 / eta ** 3)
    inv = 1.0 / eta
    return float(-1.4399 * inv * inv + 0.7099 * inv + 0.6681 + 0.0636 * eta)


def dipole_coeffs(params: dict) -> dict:
    """The dipole's reduced coefficients: zr, zv, sigma_tr [3], the
    smallest mean free path (radius) and eta."""
    sigma_s = np.asarray(params["sigma_s"], np.float64).reshape(3)
    sigma_a = np.asarray(params["sigma_a"], np.float64).reshape(3)
    g = np.asarray(params.get("g", 0.0), np.float64).reshape(-1)
    g = g if g.size == 3 else np.full(3, g[0] if g.size else 0.0)
    eta = float(params.get("eta", 1.3))
    sigma_tp = sigma_s * (1.0 - g) + sigma_a
    mfp = 1.0 / np.maximum(sigma_tp, 1e-12)
    fdr = _fresnel_diffuse_reflectance(1.0 / eta)
    a_const = (1.0 + fdr) / (1.0 - fdr)
    return {"zr": mfp, "zv": mfp * (1.0 + 4.0 / 3.0 * a_const),
            "sigma_tr": np.sqrt(sigma_a * sigma_tp * 3.0),
            "radius": float(mfp.min()), "eta": eta}


def dmo(r_sqr, zr, zv, sigma_tr):
    """Diffuse exitance of one dipole at squared distance ``r_sqr``;
    broadcasts over leading axes, zr/zv/sigma_tr are [3]."""
    r_sqr = r_sqr[..., None]
    dr = torch.sqrt(r_sqr + zr * zr)
    dv = torch.sqrt(r_sqr + zv * zv)
    c1 = zr * (sigma_tr + 1.0 / dr)
    c2 = zv * (sigma_tr + 1.0 / dv)
    return INV_FOURPI * (c1 * torch.exp(-sigma_tr * dr) / (dr * dr)
                         + c2 * torch.exp(-sigma_tr * dv) / (dv * dv))


def sample_surface_points(v0, e1, e2, ng, radius, rng, max_points=262144):
    """A point set over the triangles (numpy): area-weighted uniform
    candidates, about four times the Poisson-disk capacity of the surface,
    thinned to the first in each voxel of side radius/√3. Returns (points
    [P, 3], normals [P, 3], total area)."""
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    sa = float(areas.sum())
    if sa <= 0.0:
        return np.zeros((0, 3)), np.zeros((0, 3)), 0.0
    target = sa / max(np.pi * radius * radius, 1e-20)
    n_cand = int(np.clip(4.0 * target, 64, 4 * max_points))
    tri = rng.choice(len(v0), size=n_cand, p=areas / sa)
    su = np.sqrt(rng.random(n_cand))
    b0 = 1.0 - su
    b1 = rng.random(n_cand) * su
    pts = v0[tri] + b0[:, None] * e1[tri] + b1[:, None] * e2[tri]
    cell = max(radius / np.sqrt(3.0), 1e-9)
    keys = np.floor(pts / cell).astype(np.int64)
    _, keep = np.unique(keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663
                        ^ keys[:, 2] * 83492791, return_index=True)
    keep = np.sort(keep)[:max_points]
    return pts[keep], ng[tri][keep], sa


def _cosine_dirs(n, u):
    """Cosine-distributed directions about normals n [P, 3], u [P, 2]."""
    s, t = coordinate_system(n)
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    z = (1.0 - u[:, 0]).clamp_min(0.0).sqrt()
    return (s * (r * torch.cos(phi))[:, None]
            + t * (r * torch.sin(phi))[:, None] + n * z[:, None])


def gather_irradiance(scene, cfg, points, normals, irr_samples: int,
                      generator: torch.Generator, max_depth: int = 6):
    """The irradiance [P, 3] (numpy) at each point from ``irr_samples``
    cosine-sampled radiance rays a point, indirect light included."""
    from .volpath import RAY_EPS, trace_wave

    dev = scene.tri_v0.device
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    nrm = torch.as_tensor(normals, dtype=torch.float32, device=dev)
    e_total = torch.zeros((pts.shape[0], 3), device=dev)
    for _ in range(irr_samples):
        u = torch.rand((pts.shape[0], 2), generator=generator, device=dev)
        e_total = e_total + trace_wave(
            scene, generator, pts + nrm * RAY_EPS, _cosine_dirs(nrm, u),
            max_depth=max_depth, rr_depth=max_depth, nee=True,
            bsdf_types=cfg.bsdf_types or None, has_medium=cfg.has_medium,
            has_hetero=cfg.has_hetero, has_bump=cfg.has_bump)
    return np.pi * e_total.cpu().numpy() / max(irr_samples, 1)


def bake_subsurface(scene, cfg, seed: int = 1234,
                    device: str | torch.device = "cuda"):
    """The scene on ``device`` with ``sss_M`` baked for every subsurface
    instance: the point set (numpy's generator seeded by ``seed``, as the
    reference's), the irradiance at each point, then the dipole
    convolution at the corners of the instance's triangles."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    if not cfg.sss:
        return scene
    tri_sss = scene.tri_sss.cpu().numpy()
    v0, e1, e2, ng = (x.cpu().numpy().astype(np.float64) for x in (
        scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_ng))
    sss_m = torch.zeros((len(tri_sss), 3, 3), device=dev)
    rng = np.random.default_rng(seed)
    for s_id, params in enumerate(cfg.sss):
        mask = tri_sss == s_id
        if not mask.any():
            continue
        co = dipole_coeffs(params)
        mult = float(params.get("sample_multiplier", 1.0))
        actual_r = co["radius"] / np.sqrt(max(mult, 1e-6) * 20.0)
        pts, nrm, sa = sample_surface_points(v0[mask], e1[mask], e2[mask],
                                             ng[mask], actual_r, rng)
        if len(pts) == 0:
            continue
        e_irr = gather_irradiance(
            scene, cfg, pts, nrm, int(params.get("irr_samples", 16)),
            torch.Generator(device=dev).manual_seed(seed + 7 * s_id),
            max_depth=min(cfg.max_depth, 6))
        idx = np.nonzero(mask)[0]
        corners = np.stack([v0[idx], v0[idx] + e1[idx], v0[idx] + e2[idx]],
                           axis=1).reshape(-1, 3)

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev)

        zr, zv, s_tr, pts_t = (f32(co["zr"]), f32(co["zv"]),
                               f32(co["sigma_tr"]), f32(pts))
        ew = f32(e_irr * (sa / len(pts)))  # [P, 3]
        # Corners a chunk: 4,096, or fewer where [chunk, P] floats would
        # pass 2^26.
        step = max(1, min(4096, (1 << 26) // len(pts)))
        out = []
        for c0 in range(0, len(corners), step):
            c = f32(corners[c0:c0 + step])
            d2 = ((c[:, None, :] - pts_t[None, :, :]) ** 2).sum(-1)
            out.append((dmo(d2, zr, zv, s_tr) * ew[None]).sum(1))
        sss_m[torch.as_tensor(idx, device=dev)] = \
            torch.cat(out).reshape(len(idx), 3, 3)
    return scene._replace(sss_M=sss_m)


def sss_lo_factor(scene, it: dict, wo: torch.Tensor) -> torch.Tensor:
    """The exitance toward ``wo`` (away from the surface) at the hits of
    ``it``, [N, 3]: 1/π · (1 − Fr) · the barycentric M; zero where the
    triangle has no subsurface instance or ``wo`` lies below it."""
    from ..bsdf.fresnel import fresnel_dielectric

    tri = it["tri"].long()
    sid = scene.tri_sss[tri]
    m_flat = scene.sss_M.reshape(-1, 9)[tri]
    u, v = it["u_bary"][:, None], it["v_bary"][:, None]
    m = m_flat[:, 0:3] * (1.0 - u - v) + m_flat[:, 3:6] * u \
        + m_flat[:, 6:9] * v
    cos_d = (it["ns"] * wo).sum(-1)
    fr, _, _, _ = fresnel_dielectric(cos_d,
                                     scene.sss_eta[sid.clamp_min(0).long()])
    valid = (sid >= 0) & (cos_d > 0.0) & it["valid"]
    return torch.where(valid[:, None], INV_PI * (1.0 - fr)[:, None] * m, 0.0)
