"""Ray–scene intersection (port of sdmm_tpu/render/intersect.py
``intersect``, ``occluded``, ``surface_interaction`` and
``apply_bumpmap``).

The route depends on the triangle count alone:

- at most ``BRUTE_FORCE_MAX`` triangles: the dense Möller–Trumbore sweep
  ``ops/intersect_sweep.mt_sweep`` (the kernel ``csrc/mt_sweep.cu`` on the
  card, its plain twin on the CPU);
- above it: the cluster cull ``ops/clas_cull`` over the scene's cluster
  tree and Woop rows (``clas_tree``, ``clas_woop_slot``, ``clas_ids``): on
  the card the kernel ``csrc/clas_cull.cu``, whose any-hit form answers
  ``occluded``; on the CPU its plain twin (where the reference takes its
  round loop, ``render/clas.intersect``: the twin gives the same hits and
  keeps the CPU tests' time);
- above it with SDMM_TPU_BVH set (any non-empty value), as in the
  reference: the threaded BVH ``render/bvh.traverse`` on either device.

The reference's SDMM_TPU_PALLAS_ISECT picks a TPU route that has no
counterpart: the port takes its kernels on the card without it.

Every route's hit is a constant to autograd. Where autograd records the
rays (inverse rendering, ``diff/inverse.py``), ``intersect`` re-attaches
``t``, ``u`` and ``v`` by Möller–Trumbore on the winning triangle alone, as
the reference's XLA sweep differentiates its argmin's pick: the forward
values stay the route's, only the gradient is added.
"""

from __future__ import annotations

import os

import torch

from ..core.spectrum import luminance
from ..ops import clas_cull
from ..ops.intersect_sweep import INF, mt_sweep

BRUTE_FORCE_MAX = 1024


def use_bvh() -> bool:
    """SDMM_TPU_BVH (any non-empty value): scenes above BRUTE_FORCE_MAX
    triangles take the threaded BVH."""
    return bool(os.environ.get("SDMM_TPU_BVH"))


def _records_grad(scene, ro, rd) -> bool:
    return torch.is_grad_enabled() and (
        ro.requires_grad or rd.requires_grad or scene.tri_v0.requires_grad
        or scene.tri_e1.requires_grad or scene.tri_e2.requires_grad)


def _reattach(scene, ro, rd, hit: dict) -> dict:
    """``hit`` with t, u and v carrying the gradient of Möller–Trumbore on
    each valid ray's winning triangle; their values stay ``hit``'s."""
    tri = hit["tri"].clamp_min(0).long()
    v0, e1, e2 = scene.tri_v0[tri], scene.tri_e1[tri], scene.tri_e2[tri]
    p = torch.linalg.cross(rd, e2)
    det = (e1 * p).sum(-1)
    ok = hit["valid"] & (det.abs() > 1e-12)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    s = ro - v0
    q = torch.linalg.cross(s, e1)
    out = dict(hit)
    for k, val in (("u", (s * p).sum(-1) * inv_det),
                   ("v", (rd * q).sum(-1) * inv_det),
                   ("t", (e2 * q).sum(-1) * inv_det)):
        val = torch.where(ok, val, 0.0)
        out[k] = hit[k] + (val - val.detach())
    return out


def intersect(scene, ro: torch.Tensor, rd: torch.Tensor, t_max=None):
    """Closest hit. Returns dict with t, tri [int32, -1 = miss], u, v, valid.
    The kernels take contiguous rows: a camera wave's origins are one
    expanded row."""
    if _records_grad(scene, ro, rd):
        with torch.no_grad():
            hit = _route(scene, ro, rd, t_max)
        return _reattach(scene, ro, rd, hit)
    return _route(scene, ro, rd, t_max)


def _route(scene, ro, rd, t_max):
    """The closest hit by the triangle count's route (module docstring)."""
    ro, rd = ro.contiguous(), rd.contiguous()
    if scene.tri_v0.shape[0] > BRUTE_FORCE_MAX:
        if use_bvh():
            from . import bvh

            return bvh.traverse(scene, ro, rd, t_max)
        return clas_cull.intersect(scene, ro, rd, t_max)
    if t_max is None:
        t_max = torch.full((ro.shape[0],), INF, device=ro.device)
    return mt_sweep(ro, rd, t_max, scene.tri_v0, scene.tri_e1, scene.tri_e2)


@torch.no_grad()
def occluded(scene, ro: torch.Tensor, rd: torch.Tensor,
             t_max: torch.Tensor) -> torch.Tensor:
    """Any hit within (EPS, t_max) [N]. Returns bool [N], which carries no
    gradient."""
    ro, rd = ro.contiguous(), rd.contiguous()
    if scene.tri_v0.shape[0] > BRUTE_FORCE_MAX:
        if use_bvh():
            from . import bvh

            return bvh.traverse(scene, ro, rd, t_max, any_hit=True)
        return clas_cull.occluded(scene, ro, rd, t_max)
    return mt_sweep(ro, rd, t_max, scene.tri_v0, scene.tri_e1,
                    scene.tri_e2)["valid"]


def surface_interaction(scene, ro, rd, hit):
    """Hit-point attributes (position, normals, uv, ids) from intersect().
    Where the scene has mesh-attribute tables, ``uv`` widens to [N, 6]:
    (u, v, the interpolated vertex colour, the distance to the nearest
    edge line), which the procedural textures read."""
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
    if scene.tri_vc.shape[0] > 0 or scene.tri_eh.shape[0] > 0:
        u1, v1 = hit["u"], hit["v"]
        b0 = 1.0 - u1 - v1
        if scene.tri_vc.shape[0] > 0:
            vc_flat = scene.tri_vc[tri]
            vc = (vc_flat[:, 0:3] * b0[:, None] + vc_flat[:, 3:6] * u1[:, None]
                  + vc_flat[:, 6:9] * v1[:, None])
        else:
            vc = torch.zeros(uv.shape[:-1] + (3,), device=uv.device)
        if scene.tri_eh.shape[0] > 0:
            # The distance to the nearest edge line, min_i bary_i · h_i.
            eh = scene.tri_eh[tri]
            ed = torch.minimum(torch.minimum(b0 * eh[:, 0], u1 * eh[:, 1]),
                               v1 * eh[:, 2])
        else:
            ed = torch.zeros(uv.shape[:-1], device=uv.device)
        uv = torch.cat([uv, vc, ed[:, None]], dim=-1)
    emitter = scene.tri_emitter[tri]
    return {
        "p": p, "ng": ng, "ns": ns, "uv": uv, "tri": tri,
        "bsdf": scene.tri_bsdf[tri],
        "emitter": torch.where(hit["valid"], emitter, -1),
        "valid": hit["valid"], "t": hit["t"],
        "u_bary": hit["u"], "v_bary": hit["v"],
    }


def apply_bumpmap(scene, it: dict) -> torch.Tensor:
    """Shading normals perturbed by the BSDF's bump or normal map; returns
    the new ns [N, 3]. ``bsdf_bump`` >= 0 names a height texture, whose uv
    gradient (central differences one texel apart) offsets the tangent
    frame of the triangle's uv parameterization; <= -2 names a tangent-space
    normal texture -(id + 2) (rgb → 2c − 1). Rays without either keep
    their normals."""
    from ..bsdf.bsdf import sample_texture

    bsdf = it["bsdf"].long()
    raw = scene.bsdf_bump[bsdf]
    scale = scene.bsdf_bump_scale[bsdf]
    is_normalmap = raw <= -2
    tid = torch.where(is_normalmap, -raw - 2, raw).clamp_min(0)
    eps = 1.0 / scene.textures.shape[1]
    uv = it["uv"][:, 0:2]

    def h(uv_):
        return luminance(sample_texture(scene.textures, tid, uv_))

    du = torch.zeros_like(uv)
    du[:, 0] = eps
    dv = torch.zeros_like(uv)
    dv[:, 1] = eps
    gu = (h(uv + du) - h(uv - du)) / (2.0 * eps)
    gv = (h(uv + dv) - h(uv - dv)) / (2.0 * eps)

    # Tangents from the triangle's uv parameterization.
    tri = it["tri"].long()
    e1 = scene.tri_e1[tri]
    e2 = scene.tri_e2[tri]
    uv_flat = scene.tri_uv.reshape(-1, 6)[tri]
    duv1 = uv_flat[:, 2:4] - uv_flat[:, 0:2]
    duv2 = uv_flat[:, 4:6] - uv_flat[:, 0:2]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    det_ok = det.abs() > 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0),
                          0.0)[:, None]
    dpdu = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_det
    dpdv = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) * inv_det

    ns = it["ns"]
    n_new = torch.linalg.cross(dpdu + (scale * gu)[:, None] * ns,
                               dpdv + (scale * gv)[:, None] * ns)
    n_new = n_new * torch.sign((n_new * ns).sum(-1, keepdim=True))
    n_norm = torch.linalg.vector_norm(n_new, dim=-1, keepdim=True)
    ok = (raw >= 0) & det_ok & (n_norm[..., 0] > 1e-12)
    out = torch.where(ok[:, None], n_new / n_norm.clamp_min(1e-20), ns)

    # Normal map: the texture is the tangent-space normal, rotated into the
    # (dpdu⊥, ·, ns) frame.
    n_tan = 2.0 * sample_texture(scene.textures, tid, uv) - 1.0
    tang = dpdu - ns * (dpdu * ns).sum(-1, keepdim=True)
    t_norm = torch.linalg.vector_norm(tang, dim=-1, keepdim=True)
    tang = tang / t_norm.clamp_min(1e-20)
    bit = torch.linalg.cross(ns, tang)
    n_nm = (tang * n_tan[..., 0:1] + bit * n_tan[..., 1:2]
            + ns * n_tan[..., 2:3].clamp_min(1e-3))
    n_nm = n_nm / torch.linalg.vector_norm(n_nm, dim=-1,
                                           keepdim=True).clamp_min(1e-20)
    ok_nm = is_normalmap & (t_norm[..., 0] > 1e-12)
    return torch.where(ok_nm[:, None], n_nm, out)
