"""Wavefront BSDF dispatch over ray batches (port of sdmm_tpu/bsdf/bsdf.py
for the four types the guided path supports: diffuse, conductor,
dielectric, roughconductor).

Every present model is evaluated on the whole batch in the local shading
frame and the result is selected by type mask. Conventions as in the
reference package: wi points away from the surface, the evaluation returns
f·|cos θo|, delta lobes contribute nothing to eval/pdf. No container BSDFs
(mask/blend/coating) are ported, so ``eval_pdf_full``/``sample_full`` have
nothing to resolve and ``sample_full``'s branch uniform ``u0`` is unused.
"""

from __future__ import annotations

import math

import torch

from ..core import warp
from ..core.frame import normalize, reflect
from ..scene.scene import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                           BSDF_ROUGHCONDUCTOR, SUPPORTED_BSDFS)
from . import microfacet as mf
from .fresnel import fresnel_conductor, fresnel_dielectric

INV_PI = 1.0 / math.pi


def _types(types) -> tuple:
    if types is None:
        return SUPPORTED_BSDFS
    bad = [t for t in types if t not in SUPPORTED_BSDFS]
    if bad:
        raise NotImplementedError(f"BSDF types {bad} are not ported")
    return tuple(types)


def gather_params(scene, bsdf_idx: torch.Tensor, uv=None,
                  types: tuple | None = None) -> dict:
    """Per-ray BSDF parameters from the scene table (``uv`` is unused: no
    textures are ported)."""
    _types(types)
    idx = bsdf_idx.long()
    return {
        "type": scene.bsdf_type[idx],
        "albedo": scene.bsdf_albedo[idx],
        "specular": scene.bsdf_specular[idx],
        "alpha": scene.bsdf_alpha[idx],
        "eta": scene.bsdf_eta[idx],
        "k": scene.bsdf_k[idx],
    }


def is_delta_only(params: dict) -> torch.Tensor:
    """True where the BSDF has only delta lobes."""
    t = params["type"]
    return (t == BSDF_CONDUCTOR) | (t == BSDF_DIELECTRIC)


def has_smooth(params: dict) -> torch.Tensor:
    """True where the BSDF has a non-delta lobe (the lanes NEE targets)."""
    return ~is_delta_only(params)


def eval_pdf_full(params: dict, wi: torch.Tensor, wo: torch.Tensor,
                  types: tuple | None = None):
    """Smooth-lobe (f·cosθo, pdf); delta lobes contribute zero."""
    types = _types(types)
    t = params["type"]
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    front = (cos_i > 1e-6) & (cos_o > 1e-6)
    f = torch.zeros(wi.shape[:-1] + (3,), device=wi.device)
    pdf = torch.zeros(wi.shape[:-1], device=wi.device)

    if BSDF_DIFFUSE in types:
        f_diff = params["albedo"] * (INV_PI * cos_o.clamp_min(0.0))[..., None]
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
        is_d = t == BSDF_DIFFUSE
        f = torch.where(is_d[..., None], f_diff, f)
        pdf = torch.where(is_d, pdf_diff, pdf)

    if BSDF_ROUGHCONDUCTOR in types:
        h = normalize(wi + wo)
        alpha = params["alpha"]
        d = mf.ggx_ndf(h, alpha)
        g = mf.smith_g1(wi, h, alpha) * mf.smith_g1(wo, h, alpha)
        pdf_rc = mf.vndf_pdf(wi, h, alpha) / (
            4.0 * (wo * h).sum(-1).abs()).clamp_min(1e-12)
        f_cond = fresnel_conductor(
            (wi * h).sum(-1), params["eta"][..., None], params["k"])
        f_rc = (params["specular"] * f_cond) * (
            d * g / (4.0 * cos_i).clamp_min(1e-12))[..., None]
        is_rc = t == BSDF_ROUGHCONDUCTOR
        f = torch.where(is_rc[..., None], f_rc, f)
        pdf = torch.where(is_rc, pdf_rc, pdf)

    f = torch.where(front[..., None], f, 0.0)
    pdf = torch.where(front, pdf, 0.0)
    return f, pdf


def sample_full(params: dict, wi: torch.Tensor, u0: torch.Tensor,
                u1: torch.Tensor, u2: torch.Tensor,
                types: tuple | None = None):
    """Sample an outgoing direction. Returns dict(wo, weight=f·cos/pdf, pdf,
    delta, eta); for delta lobes pdf is the discrete branch probability."""
    types = _types(types)
    t = params["type"]
    cos_i = wi[..., 2]
    shp = wi.shape[:-1]
    dev = wi.device
    wo = torch.zeros_like(wi)
    wo[..., 2] = 1.0
    weight = torch.zeros(shp + (3,), device=dev)
    pdf = torch.zeros(shp, device=dev)
    eta = torch.ones(shp, device=dev)
    delta = torch.zeros(shp, dtype=torch.bool, device=dev)

    def put(code, wo_c, w_c, pdf_c, eta_c=None):
        nonlocal wo, weight, pdf, eta
        sel = t == code
        wo = torch.where(sel[..., None], wo_c, wo)
        weight = torch.where(sel[..., None], w_c, weight)
        pdf = torch.where(sel, pdf_c, pdf)
        if eta_c is not None:
            eta = torch.where(sel, eta_c, eta)

    if BSDF_DIFFUSE in types:
        wo_diff = warp.square_to_cosine_hemisphere(u2)
        put(BSDF_DIFFUSE, wo_diff, params["albedo"],
            warp.square_to_cosine_hemisphere_pdf(wo_diff))

    if BSDF_CONDUCTOR in types:
        f_cond = fresnel_conductor(cos_i, params["eta"][..., None], params["k"])
        put(BSDF_CONDUCTOR, reflect(wi), params["specular"] * f_cond,
            torch.ones_like(cos_i))
        delta = delta | (t == BSDF_CONDUCTOR)

    if BSDF_DIELECTRIC in types:
        fr, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_i, params["eta"])
        refl_choice = u1 < fr
        wo_refr = torch.stack(
            [-wi[..., 0] * eta_ti, -wi[..., 1] * eta_ti, cos_t], -1)
        wo_diel = torch.where(refl_choice[..., None], reflect(wi), wo_refr)
        # Radiance transport: scale transmitted radiance by eta_ti^2.
        w_diel = torch.where(refl_choice[..., None], params["specular"],
                             params["albedo"] * (eta_ti * eta_ti)[..., None])
        put(BSDF_DIELECTRIC, wo_diel, w_diel,
            torch.where(refl_choice, fr, 1.0 - fr),
            torch.where(refl_choice, 1.0, eta_it))
        delta = delta | (t == BSDF_DIELECTRIC)

    if BSDF_ROUGHCONDUCTOR in types:
        alpha = params["alpha"]
        m = mf.sample_vndf(wi, alpha, u2)
        wo_rc = 2.0 * (wi * m).sum(-1, keepdim=True) * m - wi
        f_m = fresnel_conductor((wi * m).sum(-1), params["eta"][..., None],
                                params["k"])
        g1o = mf.smith_g1(wo_rc, m, alpha)
        w_rc = params["specular"] * f_m * g1o[..., None]
        pdf_rc = mf.vndf_pdf(wi, m, alpha) / (
            4.0 * (wo_rc * m).sum(-1).abs()).clamp_min(1e-12)
        valid_rc = wo_rc[..., 2] > 1e-6
        put(BSDF_ROUGHCONDUCTOR, wo_rc,
            torch.where(valid_rc[..., None], w_rc, 0.0),
            torch.where(valid_rc, pdf_rc, 0.0))

    # Reflective models need wi on the front side.
    ok = torch.where(t != BSDF_DIELECTRIC, cos_i > 1e-6, True)
    weight = torch.where(ok[..., None], weight, 0.0)
    pdf = torch.where(ok, pdf, 0.0)
    return {"wo": wo, "weight": weight, "pdf": pdf, "delta": delta,
            "eta": eta}
