"""Ray–scene intersection (port of sdmm_tpu/render/intersect.py
``intersect``, ``occluded`` and ``surface_interaction``).

The route depends on the triangle count alone:

- at most ``BRUTE_FORCE_MAX`` triangles: the dense Möller–Trumbore sweep
  ``ops/intersect_sweep.mt_sweep`` (the kernel ``csrc/mt_sweep.cu`` on the
  card, its plain twin on the CPU);
- above it: the cluster cull ``ops/clas_cull`` over the scene's cluster
  tree and Woop rows (``clas_tree``, ``clas_woop_slot``, ``clas_ids``): on
  the card the kernel ``csrc/clas_cull.cu``, whose any-hit form answers
  ``occluded``; on the CPU its plain twin.
"""

from __future__ import annotations

import torch

from ..ops import clas_cull
from ..ops.intersect_sweep import INF, mt_sweep

BRUTE_FORCE_MAX = 1024


def intersect(scene, ro: torch.Tensor, rd: torch.Tensor, t_max=None):
    """Closest hit. Returns dict with t, tri [int32, -1 = miss], u, v, valid."""
    if scene.tri_v0.shape[0] > BRUTE_FORCE_MAX:
        return clas_cull.intersect(scene, ro, rd, t_max)
    if t_max is None:
        t_max = torch.full((ro.shape[0],), INF, device=ro.device)
    return mt_sweep(ro, rd, t_max, scene.tri_v0, scene.tri_e1, scene.tri_e2)


def occluded(scene, ro: torch.Tensor, rd: torch.Tensor,
             t_max: torch.Tensor) -> torch.Tensor:
    """Any hit within (EPS, t_max) [N]. Returns bool [N]."""
    if scene.tri_v0.shape[0] > BRUTE_FORCE_MAX:
        return clas_cull.occluded(scene, ro, rd, t_max)
    return mt_sweep(ro, rd, t_max, scene.tri_v0, scene.tri_e1,
                    scene.tri_e2)["valid"]


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
