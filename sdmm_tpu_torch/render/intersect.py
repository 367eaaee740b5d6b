"""Ray–scene intersection: the dense Möller–Trumbore sweep (port of
sdmm_tpu/render/intersect.py ``intersect``'s and ``occluded``'s XLA
branches and ``surface_interaction``).

Scenes above ``BRUTE_FORCE_MAX`` triangles take the cluster sweep in the
reference package; that path is not ported yet.
"""

from __future__ import annotations

import torch

INF = 3.4e38
EPS = 1e-6
BRUTE_FORCE_MAX = 1024


def _mt_chunk(ro, rd, v0, e1, e2, t_max):
    """Möller–Trumbore for [N] rays × [C] tris → per-pair (t, u, v, hit)."""
    rox, roy, roz = (ro[:, i:i + 1] for i in range(3))
    rdx, rdy, rdz = (rd[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))

    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det.abs() > 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
           & (t < t_max[:, None]))
    return t, u, v, hit


def intersect(scene, ro: torch.Tensor, rd: torch.Tensor, t_max=None,
              chunk: int = 512):
    """Closest hit. Returns dict with t, tri [int32, -1 = miss], u, v, valid."""
    n_tris = scene.tri_v0.shape[0]
    if n_tris > BRUTE_FORCE_MAX:
        raise NotImplementedError(
            f"{n_tris} triangles > {BRUTE_FORCE_MAX}: the cluster sweep for "
            "large scenes is not ported")
    n = ro.shape[0]
    dev = ro.device
    if t_max is None:
        t_max = torch.full((n,), INF, device=dev)
    best_t = torch.full((n,), INF, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    for sl in range(0, n_tris, chunk):
        v0 = scene.tri_v0[sl:sl + chunk]
        t, u, v, hit = _mt_chunk(ro, rd, v0, scene.tri_e1[sl:sl + chunk],
                                 scene.tri_e2[sl:sl + chunk], t_max)
        t = torch.where(hit, t, INF)
        cand_t, arg = t.min(dim=-1)
        cand_u = u.gather(1, arg[:, None])[:, 0]
        cand_v = v.gather(1, arg[:, None])[:, 0]
        better = cand_t < best_t
        best_t = torch.where(better, cand_t, best_t)
        best_i = torch.where(better, (arg + sl).to(torch.int32), best_i)
        best_u = torch.where(better, cand_u, best_u)
        best_v = torch.where(better, cand_v, best_v)
    return {"t": best_t, "tri": best_i, "u": best_u, "v": best_v,
            "valid": best_i >= 0}


def occluded(scene, ro: torch.Tensor, rd: torch.Tensor, t_max: torch.Tensor,
             chunk: int = 512) -> torch.Tensor:
    """Any hit within (EPS, t_max) [N]. Returns bool [N]."""
    n_tris = scene.tri_v0.shape[0]
    if n_tris > BRUTE_FORCE_MAX:
        raise NotImplementedError(
            f"{n_tris} triangles > {BRUTE_FORCE_MAX}: the cluster sweep for "
            "large scenes is not ported")
    occ = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    for sl in range(0, n_tris, chunk):
        _, _, _, hit = _mt_chunk(ro, rd, scene.tri_v0[sl:sl + chunk],
                                 scene.tri_e1[sl:sl + chunk],
                                 scene.tri_e2[sl:sl + chunk], t_max)
        occ = occ | hit.any(-1)
    return occ


def surface_interaction(scene, ro, rd, hit):
    """Hit-point attributes (position, normals, uv, ids) from intersect()."""
    tri = hit["tri"].clamp_min(0).long()
    t_safe = torch.where(hit["valid"], hit["t"], 0.0)
    p = ro + t_safe[:, None] * rd
    ng = scene.tri_ng[tri]
    ns_flat = scene.tri_ns.reshape(-1, 9)[tri]
    u = hit["u"][:, None]
    v = hit["v"][:, None]
    ns = (ns_flat[:, 0:3] * (1.0 - u - v) + ns_flat[:, 3:6] * u
          + ns_flat[:, 6:9] * v)
    ns = ns / torch.linalg.vector_norm(ns, dim=-1, keepdim=True).clamp_min(1e-20)
    uv_flat = scene.tri_uv.reshape(-1, 6)[tri]
    uv = (uv_flat[:, 0:2] * (1.0 - u - v) + uv_flat[:, 2:4] * u
          + uv_flat[:, 4:6] * v)
    emitter = scene.tri_emitter[tri]
    return {
        "p": p, "ng": ng, "ns": ns, "uv": uv, "tri": tri,
        "bsdf": scene.tri_bsdf[tri],
        "emitter": torch.where(hit["valid"], emitter, -1),
        "valid": hit["valid"], "t": hit["t"],
    }
