"""Wavefront BSDF dispatch over ray batches (port of sdmm_tpu/bsdf/bsdf.py:
every BSDF type, Irawan's woven cloth through ``bsdf/irawan.py``, bitmap
and procedural textures, and the mask, blend and coating containers).

Every present model is evaluated on the whole batch in the local shading
frame and the result is selected by type mask; ``types`` (the codes a scene
holds) leaves the absent models out. Conventions as in the reference
package: wi points away from the surface, wi.z > 0 for reflective models
(callers flip the frame; transmissive models see both signs), the
evaluation returns f·|cos θo|, delta lobes contribute nothing to eval/pdf.
"""

from __future__ import annotations

import math

import torch

from ..core import warp
from ..core.frame import coordinate_system, normalize, reflect, to_world
from ..core.spectrum import luminance
from ..scene.scene import (
    BSDF_BLEND, BSDF_COATING, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
    BSDF_DIFFTRANS, BSDF_DIFFUSE, BSDF_HK, BSDF_IRAWAN, BSDF_MASK, BSDF_NULL,
    BSDF_PHONG, BSDF_PLASTIC, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHDIFFUSE, BSDF_ROUGHPLASTIC, BSDF_THINDIELECTRIC, BSDF_WARD,
    SUPPORTED_BSDFS,
)
from . import irawan
from . import microfacet as mf
from .fresnel import fresnel_conductor, fresnel_dielectric

INV_PI = 1.0 / math.pi

_CONTAINER_KEYS = ("is_mask", "opacity", "is_blend", "blend_b", "blend_w",
                   "is_coat", "coat_eta", "coat_sa", "coat_spec",
                   "coat_alpha")


def _types(types) -> tuple | None:
    """``types`` checked against the known codes (None: every one)."""
    if types is None:
        return None
    bad = [t for t in types if t not in SUPPORTED_BSDFS]
    if bad:
        raise ValueError(f"unknown BSDF types {bad}")
    return tuple(types)


def _has(types, code) -> bool:
    return types is None or code in types


def _fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance of diffuse internal scattering
    (polynomial fit; used by plastic and roughplastic)."""
    inv_eta = 1.0 / eta
    return torch.where(
        eta > 1.0,
        -1.4399 * inv_eta * inv_eta + 0.7099 * inv_eta + 0.6681
        + 0.0636 * eta,
        0.0636 * inv_eta + 0.6681 + 0.7099 * eta - 1.4399 * eta * eta)


def _gather_raw(scene, idx: torch.Tensor, uv: torch.Tensor | None) -> dict:
    """One row of per-ray BSDF parameters (no child resolution); with
    ``uv`` a textured row's albedo is its texture's value."""
    albedo = scene.bsdf_albedo[idx]
    if uv is not None and scene.textures.shape[1] > 1:
        tex_id = scene.bsdf_tex[idx]
        albedo = torch.where(
            (tex_id >= 0)[..., None],
            sample_texture(scene.textures, tex_id.clamp_min(0), uv), albedo)
    if uv is not None and scene.proc_tex.shape[0] > 0:
        tex_id = scene.bsdf_tex[idx]
        is_proc = tex_id <= -2
        albedo = torch.where(
            is_proc[..., None],
            eval_proc_texture(scene, torch.where(is_proc, -tex_id - 2, 0),
                              uv),
            albedo)
    return {
        "type": scene.bsdf_type[idx],
        "albedo": albedo,
        "specular": scene.bsdf_specular[idx],
        "alpha": scene.bsdf_alpha[idx],
        "alpha_v": scene.bsdf_alpha_v[idx],
        "eta": scene.bsdf_eta[idx],
        "k": scene.bsdf_k[idx],
        "exponent": scene.bsdf_exponent[idx],
    }


def _where_params(mask, a: dict, b: dict) -> dict:
    """Per-field select between two parameter dicts (keys missing from
    ``a`` pass through from ``b``)."""
    out = {}
    for k, bv in b.items():
        if k not in a or not isinstance(bv, torch.Tensor):
            out[k] = bv
            continue
        m = mask[..., None] if bv.ndim > mask.ndim else mask
        out[k] = torch.where(m, a[k], bv)
    return out


def gather_params(scene, bsdf_idx: torch.Tensor, uv=None,
                  types: tuple | None = None) -> dict:
    """Per-ray BSDF parameters from the scene table, the albedo from the
    row's texture where ``uv`` is given. Containers are resolved here: a
    mask row takes its child's parameters and records the opacity, a
    coating row its child's and the layer's, a blend row child0's with
    child1's attached and the blend factor. Children are plain BSDFs."""
    types = _types(types)
    idx = bsdf_idx.long()
    p = _gather_raw(scene, idx, uv)
    if _has(types, BSDF_MASK):
        is_mask = p["type"] == BSDF_MASK
        child = torch.where(is_mask, scene.bsdf_child0[idx].long(), idx)
        c = _gather_raw(scene, child.clamp_min(0), uv)
        opacity = p["albedo"].clamp(0.0, 1.0)  # the opacity is the albedo
        p = _where_params(is_mask, c, p)
        p["is_mask"] = is_mask
        p["opacity"] = torch.where(is_mask[..., None], opacity, 1.0)
    if _has(types, BSDF_COATING):
        # The layer row: eta the IOR ratio, alpha the thickness, albedo
        # sigmaA, specular the specular reflectance, alpha_v the GGX
        # roughness of the boundary (0 = smooth).
        is_coat = p["type"] == BSDF_COATING
        child = torch.where(is_coat, scene.bsdf_child0[idx].long(), idx)
        c = _gather_raw(scene, child.clamp_min(0), uv)
        coat_eta = p["eta"]
        coat_sa = p["albedo"] * p["alpha"][..., None]
        coat_spec = p["specular"]
        coat_alpha = p["alpha_v"]
        p = _where_params(is_coat, c, p)
        p["is_coat"] = is_coat
        p["coat_eta"] = torch.where(is_coat, coat_eta, 1.5)
        p["coat_alpha"] = torch.where(is_coat, coat_alpha, 0.0)
        p["coat_sa"] = torch.where(is_coat[..., None], coat_sa, 0.0)
        p["coat_spec"] = torch.where(is_coat[..., None], coat_spec, 1.0)
    if _has(types, BSDF_BLEND):
        is_blend = p["type"] == BSDF_BLEND
        c0 = torch.where(is_blend, scene.bsdf_child0[idx].long(), idx)
        c1 = torch.where(is_blend, scene.bsdf_child1[idx].long(), idx)
        pa = _gather_raw(scene, c0.clamp_min(0), uv)
        pb = _gather_raw(scene, c1.clamp_min(0), uv)
        p = _where_params(is_blend, pa, p)
        p["is_blend"] = is_blend
        p["blend_b"] = pb
        p["blend_w"] = torch.where(is_blend, scene.bsdf_weight[idx], 0.0)
    if _has(types, BSDF_IRAWAN):
        # Woven cloth reads the hit's uv and the scene's weave tables, also
        # as a blend's second child.
        uv_iw = uv if uv is not None else torch.zeros(idx.shape + (2,),
                                                      device=idx.device)
        for q in (p, p.get("blend_b", {})):
            q["iw"] = irawan.device_tables(scene)
            q["uv"] = uv_iw
    return p


def eval_proc_texture(scene, pidx: torch.Tensor, uv: torch.Tensor):
    """Every procedural kind evaluated on the batch and selected by the
    row's kind. ``uv`` may be the widened [N, 6] row of
    surface_interaction (channels 2:5 the interpolated vertex colours, 5
    the distance to the nearest triangle edge); a plain [N, 2] row gives
    the mesh-attribute kinds black."""
    rows = scene.proc_tex[pidx.long()]  # [N, 13]
    kind = rows[..., 0]
    c0 = rows[..., 1:4]
    c1 = rows[..., 4:7]
    uu = uv[..., 0] * rows[..., 7] + rows[..., 9]
    vv = uv[..., 1] * rows[..., 8] + rows[..., 10]
    lw = rows[..., 11]
    sw = rows[..., 12]

    # Checkerboard: the integer cast truncates toward zero; the parity is
    # taken as the reference takes it, a floored modulo.
    cx = torch.remainder(torch.trunc(uu * 2.0).int(), 2)
    cy = torch.remainder(torch.trunc(vv * 2.0).int(), 2)
    checker = torch.where(((2 * cx - 1) * (2 * cy - 1) == 1)[..., None],
                          c0, c1)

    # Grid: lines of width lw at the integer uv lines.
    gx = uu - torch.floor(uu)
    gy = vv - torch.floor(vv)
    gx = torch.where(gx > 0.5, gx - 1.0, gx)
    gy = torch.where(gy > 0.5, gy - 1.0, gy)
    on_line = (gx.abs() < lw) | (gy.abs() < lw)
    grid = torch.where(on_line[..., None], c1, c0)

    if uv.shape[-1] >= 6:
        meshattr = uv[..., 2:5]
        # Wireframe: a smoothstep between the edge and interior colours.
        t = ((uv[..., 5] - lw * (1.0 - sw))
             / (lw * sw).clamp_min(1e-20)).clamp(0.0, 1.0)
        a = (t * t * (3.0 - 2.0 * t))[..., None]
        wire = c0 * (1.0 - a) + c1 * a
    else:
        meshattr = torch.zeros_like(c0)
        wire = c1

    out = torch.where((kind == 0)[..., None], checker, grid)
    out = torch.where((kind == 2)[..., None], meshattr, out)
    return torch.where((kind == 3)[..., None], wire, out)


def sample_texture(textures: torch.Tensor, tex_id: torch.Tensor,
                   uv: torch.Tensor):
    """Bilinear sample from the [NT, R, R, 3] texture stack (uv wraps; the
    v axis points up, image rows down)."""
    r = textures.shape[1]
    u = torch.remainder(uv[..., 0], 1.0) * r - 0.5
    v = torch.remainder(1.0 - uv[..., 1], 1.0) * r - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = x0.long().clamp(0, r - 1)
    y0i = y0.long().clamp(0, r - 1)
    x1i = (x0i + 1).clamp(0, r - 1)
    y1i = (y0i + 1).clamp(0, r - 1)
    t = tex_id.long()
    return (textures[t, y0i, x0i] * (1 - fx) * (1 - fy)
            + textures[t, y0i, x1i] * fx * (1 - fy)
            + textures[t, y1i, x0i] * (1 - fx) * fy
            + textures[t, y1i, x1i] * fx * fy)


def _delta(t):
    return ((t == BSDF_CONDUCTOR) | (t == BSDF_DIELECTRIC)
            | (t == BSDF_NULL) | (t == BSDF_THINDIELECTRIC))


def is_delta_only(params: dict) -> torch.Tensor:
    """True where the BSDF has only delta lobes (a blend is smooth if either
    child is)."""
    d = _delta(params["type"])
    if "blend_b" in params:
        d = torch.where(params["is_blend"],
                        d & _delta(params["blend_b"]["type"]), d)
    return d


def has_smooth(params: dict) -> torch.Tensor:
    """True where the BSDF has a non-delta lobe (the lanes NEE targets)."""
    return ~is_delta_only(params)


def _lobe_probs(params):
    """Diffuse and specular lobe selection of phong and ward, by
    luminance."""
    kd = luminance(params["albedo"])
    ks = luminance(params["specular"])
    total = (kd + ks).clamp_min(1e-12)
    return kd / total, ks / total


def _plastic_probs(params, cos_i):
    """Specular-lobe selection probability of (rough)plastic, and F(cos_i)."""
    f_i = fresnel_dielectric(cos_i, params["eta"])[0]
    w_s = luminance(params["specular"])
    w_d = luminance(params["albedo"])
    p = (f_i * w_s) / (f_i * w_s + (1.0 - f_i) * w_d).clamp_min(1e-12)
    return p.clamp(0.05, 0.95), f_i


def _plastic_diffuse(params, cos_i, cos_o):
    """Internal-scattering-corrected diffuse term of plastic and
    roughplastic."""
    eta = params["eta"]
    f_i = fresnel_dielectric(cos_i, eta)[0]
    f_o = fresnel_dielectric(cos_o, eta)[0]
    fdr = _fresnel_diffuse_reflectance(eta)
    albedo = params["albedo"]
    denom = 1.0 - albedo * fdr[..., None]
    return (albedo * ((1.0 - f_i) * (1.0 - f_o) / (eta * eta) * INV_PI
                      * cos_o.clamp_min(0.0))[..., None]
            / denom.clamp_min(1e-6))


def _ward_half_pdf(params, h):
    """Normalized Ward half-vector density exp(-tan²θ_h (cos²φ/αu² +
    sin²φ/αv²)) / (π αu αv cos³θ_h)."""
    au = params["alpha"]
    av = params["alpha_v"]
    hz2 = (h[..., 2] * h[..., 2]).clamp_min(1e-12)
    expo = -((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) / hz2
    cos3 = h[..., 2].clamp_min(1e-6) ** 3
    return torch.exp(expo) / (math.pi * au * av * cos3)


def _eval_pdf_ward(params, wi, wo, pdf_diff):
    """Anisotropic Ward: f_spec = ks·exp(·) / (4π αu αv sqrt(cos_i cos_o))."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    h = normalize(wi + wo)
    au = params["alpha"]
    av = params["alpha_v"]
    hz2 = (h[..., 2] * h[..., 2]).clamp_min(1e-12)
    expo = -((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) / hz2
    denom = 4.0 * math.pi * au * av * torch.sqrt(
        (cos_i * cos_o).clamp_min(1e-12))
    spec = torch.exp(expo) / denom
    co = cos_o.clamp_min(0.0)
    f = (params["albedo"] * (INV_PI * co)[..., None]
         + params["specular"] * (spec * co)[..., None])
    p_d, p_s = _lobe_probs(params)
    pdf_spec = _ward_half_pdf(params, h) / (
        4.0 * (h * wo).sum(-1).abs()).clamp_min(1e-12)
    return f, p_d * pdf_diff + p_s * pdf_spec


def _eval_pdf_roughdielectric(params, wi, wo):
    """Walter et al. 2007 rough dielectric with the VNDF pdf; two-sided."""
    eta = params["eta"]
    alpha = params["alpha"]
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    reflecting = cos_i * cos_o > 0.0
    eta_it = torch.where(cos_i >= 0.0, eta, 1.0 / eta)

    # Half vector: normalize(wi + wo) in reflection, -normalize(wi +
    # eta_it·wo) in refraction, oriented to the upper hemisphere.
    h = torch.where(reflecting[..., None], wi + wo,
                    wi + wo * eta_it[..., None])
    h = normalize(h)
    h = h * torch.sign(h[..., 2:3])

    d = mf.ggx_ndf(h, alpha)
    wi_u = wi * torch.sign(cos_i)[..., None]
    wo_u = wo * torch.sign(cos_o)[..., None]
    g = mf.smith_g1(wi_u, h, alpha) * mf.smith_g1(wo_u, h, alpha)
    idoth = (wi * h).sum(-1)
    odoth = (wo * h).sum(-1)
    f = fresnel_dielectric(idoth, eta)[0]

    f_refl = params["specular"] * (
        f * d * g / (4.0 * cos_i.abs()).clamp_min(1e-12))[..., None]
    # Refraction, radiance transport: × 1/eta_it².
    sqrt_den = idoth + eta_it * odoth
    refr_fac = ((idoth * odoth).abs() * (1.0 - f) * d * g
                / (cos_i.abs() * sqrt_den * sqrt_den).clamp_min(1e-12)) \
        / (eta_it * eta_it)
    f_refr = params["albedo"] * refr_fac[..., None]
    fval = torch.where(reflecting[..., None], f_refl, f_refr)

    # The facet must see wi, and refraction needs wi and wo on opposite
    # sides of it (Walter's χ⁺ factors).
    sees_wi = idoth * cos_i > 0.0
    side_ok = torch.where(reflecting, idoth * odoth > 0.0,
                          idoth * odoth < 0.0)

    pdf_h = mf.vndf_pdf(wi_u, h, alpha)
    jac_refl = 1.0 / (4.0 * odoth.abs()).clamp_min(1e-12)
    jac_refr = (eta_it * eta_it) * odoth.abs() / (
        sqrt_den * sqrt_den).clamp_min(1e-12)
    pdf = pdf_h * torch.where(reflecting, f * jac_refl, (1.0 - f) * jac_refr)
    ok = (cos_i.abs() > 1e-6) & sees_wi & side_ok
    return (torch.where(ok[..., None], fval, 0.0),
            torch.where(ok, pdf, 0.0))


def _hg_phase(g, wi, wo):
    """HG phase of the away-facing pair (wi, wo)."""
    denom = 1.0 + g * g + 2.0 * g * (wi * wo).sum(-1)
    return (1.0 - g * g) / (4.0 * math.pi * denom.clamp_min(1e-8) ** 1.5)


def _hg_sample(g, wi, u):
    """A direction from the HG lobe about the propagation direction ``wi``
    (reference: render/medium.py hg_sample)."""
    g = g.expand(u[..., 0].shape)
    iso = g.abs() < 1e-3
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u[..., 0] + 1e-12)
    two_g = torch.where(g.abs() > 1e-6, 2.0 * g, 1e-6)
    cos_t = torch.where(iso, 1.0 - 2.0 * u[..., 0],
                        (1.0 + g * g - sqr * sqr) / two_g).clamp(-1.0, 1.0)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], -1)
    s, t = coordinate_system(wi)
    return to_world(s, t, wi, local)


def _hk_quantities(params, cos_i):
    sig_t = params["albedo"] + params["specular"]
    tau_d = sig_t * params["alpha"][..., None]
    alb = torch.where(sig_t > 0.0, params["albedo"] / sig_t.clamp_min(1e-20),
                      0.0)
    aci = cos_i.abs().clamp_min(1e-6)
    # The unscattered-transmission probability: the channels' mean of
    # exp(-tauD/|cos_i|).
    p_spec = torch.exp(-tau_d / aci[..., None]).mean(-1)
    return tau_d, alb, aci, p_spec


def _eval_pdf_hk(params, wi, wo, cos_i, cos_o):
    """Hanrahan-Krueger single scattering (albedo = sigmaS, specular =
    sigmaA, alpha = thickness, eta = the HG g); the delta transmission
    lives in sample()."""
    tau_d, alb, aci, p_spec = _hk_quantities(params, cos_i)
    aco = cos_o.abs().clamp_min(1e-6)
    phase = _hg_phase(params["eta"], wi, wo)
    dp = cos_i * cos_o
    refl = dp > 1e-9
    trans = dp < -1e-9
    f_r = alb * (phase * cos_i / torch.where(
        (cos_i + cos_o).abs() > 1e-6, cos_i + cos_o, 1e-6))[..., None] * (
        1.0 - torch.exp((-1.0 / aci - 1.0 / aco)[..., None] * tau_d))
    near = (aci - aco).abs() < 1e-5
    den = torch.where(near, 1.0, aci - aco)
    f_t = alb * (phase * aci / den)[..., None] * (
        torch.exp(-tau_d / aci[..., None]) - torch.exp(-tau_d / aco[..., None]))
    f_t_lim = alb * phase[..., None] * (tau_d / aco[..., None]) * torch.exp(
        -tau_d / aco[..., None])
    f_t = torch.where(near[..., None], f_t_lim, f_t)
    f = torch.where(refl[..., None], f_r,
                    torch.where(trans[..., None], f_t, 0.0)) * aco[..., None]
    pdf = torch.where(refl | trans, phase * (1.0 - p_spec), 0.0)
    return f.clamp_min(0.0), pdf.clamp_min(0.0)


def _select(t, pairs, init):
    """``init`` overwritten, lane by lane, by the value of the lane's type."""
    out = init
    for code, val in pairs:
        m = t == code
        out = torch.where(m[..., None] if val.ndim > m.ndim else m, val, out)
    return out


def eval_pdf(params: dict, wi: torch.Tensor, wo: torch.Tensor,
             types: tuple | None = None):
    """Smooth-lobe (f·cosθo, pdf) of plain BSDF rows; delta lobes
    contribute zero."""
    t = params["type"]
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    front = (cos_i > 1e-6) & (cos_o > 1e-6)
    has = lambda code: _has(types, code)  # noqa: E731
    sels_f: list = []
    sels_p: list = []

    if any(has(c) for c in (BSDF_DIFFUSE, BSDF_PHONG, BSDF_ROUGHPLASTIC,
                            BSDF_PLASTIC, BSDF_WARD, BSDF_ROUGHDIFFUSE,
                            BSDF_IRAWAN)):
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)

    if has(BSDF_IRAWAN):
        # Woven cloth, with the cosine pdf of its cosine sampling.
        sels_f.append((BSDF_IRAWAN, irawan.eval_irawan(
            params["iw"], params["uv"], wi, wo)))
        sels_p.append((BSDF_IRAWAN, pdf_diff))

    if has(BSDF_WARD):
        f_w, pdf_w = _eval_pdf_ward(params, wi, wo, pdf_diff)
        sels_f.append((BSDF_WARD, f_w))
        sels_p.append((BSDF_WARD, pdf_w))

    if has(BSDF_DIFFUSE):
        sels_f.append((BSDF_DIFFUSE, params["albedo"] * (
            INV_PI * cos_o.clamp_min(0.0))[..., None]))
        sels_p.append((BSDF_DIFFUSE, pdf_diff))

    if has(BSDF_ROUGHDIFFUSE):
        # Oren-Nayar, the qualitative model; sigma (radians) in alpha.
        sig2 = params["alpha"] * params["alpha"]
        a_on = 1.0 - sig2 / (2.0 * (sig2 + 0.33))
        b_on = 0.45 * sig2 / (sig2 + 0.66)
        s_i = torch.sqrt((1.0 - cos_i * cos_i).clamp_min(0.0))
        s_o = torch.sqrt((1.0 - cos_o * cos_o).clamp_min(0.0))
        sin_prod = s_i * s_o
        cos_phi_d = torch.where(
            sin_prod > 1e-8,
            (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
            / sin_prod.clamp_min(1e-8), 0.0)
        term = sin_prod / torch.maximum(cos_i, cos_o).clamp_min(1e-6)
        sels_f.append((BSDF_ROUGHDIFFUSE, params["albedo"] * (
            INV_PI * cos_o.clamp_min(0.0)
            * (a_on + b_on * cos_phi_d.clamp_min(0.0) * term))[..., None]))
        sels_p.append((BSDF_ROUGHDIFFUSE, pdf_diff))

    if has(BSDF_ROUGHCONDUCTOR) or has(BSDF_ROUGHPLASTIC):
        h = normalize(wi + wo)
        alpha = params["alpha"]
        d = mf.ggx_ndf(h, alpha)
        g = mf.smith_g1(wi, h, alpha) * mf.smith_g1(wo, h, alpha)
        pdf_rc = mf.vndf_pdf(wi, h, alpha) / (
            4.0 * (wo * h).sum(-1).abs()).clamp_min(1e-12)

    if has(BSDF_ROUGHCONDUCTOR):
        f_cond = fresnel_conductor((wi * h).sum(-1), params["eta"][..., None],
                                   params["k"])
        sels_f.append((BSDF_ROUGHCONDUCTOR, (params["specular"] * f_cond) * (
            d * g / (4.0 * cos_i).clamp_min(1e-12))[..., None]))
        sels_p.append((BSDF_ROUGHCONDUCTOR, pdf_rc))

    if has(BSDF_PHONG):
        cos_a = (reflect(wi) * wo).sum(-1).clamp_min(0.0)
        n_exp = params["exponent"]
        lobe = torch.pow(cos_a, n_exp)
        co = cos_o.clamp_min(0.0)
        f_ph = (params["albedo"] * (INV_PI * co)[..., None]
                + params["specular"] * (
                    (n_exp + 2.0) * (0.5 * INV_PI) * lobe * co)[..., None])
        p_d, p_s = _lobe_probs(params)
        sels_f.append((BSDF_PHONG, f_ph))
        sels_p.append((BSDF_PHONG, p_d * pdf_diff
                       + p_s * (n_exp + 1.0) * (0.5 * INV_PI) * lobe))

    if has(BSDF_ROUGHPLASTIC):
        f_h = fresnel_dielectric((wi * h).sum(-1), params["eta"])[0]
        f_rp = (params["specular"] * (f_h * d * g / (
            4.0 * cos_i).clamp_min(1e-12))[..., None]
            + _plastic_diffuse(params, cos_i, cos_o))
        p_spec_rp = _plastic_probs(params, cos_i)[0]
        sels_f.append((BSDF_ROUGHPLASTIC, f_rp))
        sels_p.append((BSDF_ROUGHPLASTIC,
                       p_spec_rp * pdf_rc + (1.0 - p_spec_rp) * pdf_diff))

    if has(BSDF_PLASTIC):
        # Smooth plastic: only the diffuse lobe is smooth.
        p_spec_pl = _plastic_probs(params, cos_i)[0]
        sels_f.append((BSDF_PLASTIC, _plastic_diffuse(params, cos_i, cos_o)))
        sels_p.append((BSDF_PLASTIC, (1.0 - p_spec_pl) * pdf_diff))

    f = _select(t, sels_f, torch.zeros(wi.shape[:-1] + (3,),
                                       device=wi.device))
    pdf = _select(t, sels_p, torch.zeros(wi.shape[:-1], device=wi.device))
    f = torch.where(front[..., None], f, 0.0)
    pdf = torch.where(front, pdf, 0.0)

    # The two-sided and transmissive models, after the front gate.
    if has(BSDF_ROUGHDIELECTRIC):
        f_rd, pdf_rd = _eval_pdf_roughdielectric(params, wi, wo)
        is_rd = t == BSDF_ROUGHDIELECTRIC
        f = torch.where(is_rd[..., None], f_rd, f)
        pdf = torch.where(is_rd, pdf_rd, pdf)

    if has(BSDF_DIFFTRANS):
        # wo in the hemisphere opposite wi, Lambertian in |cos|.
        trans = (cos_i > 1e-6) & (cos_o < -1e-6)
        f_dt = params["albedo"] * (INV_PI * (-cos_o).clamp_min(0.0))[..., None]
        pdf_dt = INV_PI * (-cos_o).clamp_min(0.0)
        is_dt = t == BSDF_DIFFTRANS
        f = torch.where((is_dt & trans)[..., None], f_dt,
                        torch.where(is_dt[..., None], 0.0, f))
        pdf = torch.where(is_dt & trans, pdf_dt, torch.where(is_dt, 0.0, pdf))

    if has(BSDF_HK):
        f_hk, pdf_hk = _eval_pdf_hk(params, wi, wo, cos_i, cos_o)
        is_hk = t == BSDF_HK
        f = torch.where(is_hk[..., None], f_hk, f)
        pdf = torch.where(is_hk, pdf_hk, pdf)
    return f, pdf


def _as_type(params, code):
    """``params`` with every lane's type set to ``code``."""
    return {**params, "type": torch.full_like(params["type"], code)}


def _ratio(f, pdf):
    """f / pdf where pdf > 0, else 0."""
    return torch.where((pdf > 0.0)[..., None],
                       f / pdf.clamp_min(1e-20)[..., None], 0.0)


def sample(params: dict, wi: torch.Tensor, u1: torch.Tensor,
           u2: torch.Tensor, types: tuple | None = None):
    """Sample an outgoing direction of plain BSDF rows. Returns dict(wo,
    weight=f·cos/pdf, pdf, delta, eta, pass); for delta lobes the pdf is
    the discrete branch probability and the weight folds it in; ``pass``
    marks samples that go straight through the surface."""
    t = params["type"]
    cos_i = wi[..., 2]
    dev = wi.device
    has = lambda code: _has(types, code)  # noqa: E731
    wo_sel: list = []
    w_sel: list = []
    pdf_sel: list = []
    eta_sel: list = []
    delta = torch.zeros(cos_i.shape, dtype=torch.bool, device=dev)
    passthrough = torch.zeros(cos_i.shape, dtype=torch.bool, device=dev)

    def put(code, wo_c, w_c, pdf_c):
        wo_sel.append((code, wo_c))
        w_sel.append((code, w_c))
        pdf_sel.append((code, pdf_c))

    if any(has(c) for c in (BSDF_DIFFUSE, BSDF_PHONG, BSDF_PLASTIC,
                            BSDF_ROUGHPLASTIC, BSDF_WARD, BSDF_ROUGHDIFFUSE,
                            BSDF_DIFFTRANS, BSDF_IRAWAN)):
        wo_diff = warp.square_to_cosine_hemisphere(u2)
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_diff)

    if has(BSDF_IRAWAN):
        # Cosine-sampled, weight f / pdf.
        f_iw, pdf_iw = eval_pdf(_as_type(params, BSDF_IRAWAN), wi, wo_diff,
                                types=(BSDF_IRAWAN,))
        put(BSDF_IRAWAN, wo_diff, _ratio(f_iw, pdf_iw), pdf_iw)

    if has(BSDF_ROUGHDIFFUSE):
        f_on, pdf_on = eval_pdf(_as_type(params, BSDF_ROUGHDIFFUSE), wi,
                                wo_diff, types=(BSDF_ROUGHDIFFUSE,))
        put(BSDF_ROUGHDIFFUSE, wo_diff, _ratio(f_on, pdf_on), pdf_on)

    if has(BSDF_DIFFTRANS):
        wo_dt = torch.stack([wo_diff[..., 0], wo_diff[..., 1],
                             -wo_diff[..., 2]], -1)
        put(BSDF_DIFFTRANS, wo_dt, params["albedo"], pdf_diff)

    if has(BSDF_DIFFUSE):
        put(BSDF_DIFFUSE, wo_diff, params["albedo"], pdf_diff)

    if has(BSDF_NULL):
        # A null boundary passes straight through.
        put(BSDF_NULL, -wi, torch.ones(wi.shape[:-1] + (3,), device=dev),
            torch.ones_like(cos_i))
        delta = delta | (t == BSDF_NULL)
        passthrough = t == BSDF_NULL

    if has(BSDF_CONDUCTOR):
        f_cond = fresnel_conductor(cos_i, params["eta"][..., None],
                                   params["k"])
        put(BSDF_CONDUCTOR, reflect(wi), params["specular"] * f_cond,
            torch.ones_like(cos_i))
        delta = delta | (t == BSDF_CONDUCTOR)

    if has(BSDF_DIELECTRIC):
        fr, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_i, params["eta"])
        refl_choice = u1 < fr
        wo_refr = torch.stack(
            [-wi[..., 0] * eta_ti, -wi[..., 1] * eta_ti, cos_t], -1)
        # Radiance transport: transmitted radiance scales by eta_ti².
        put(BSDF_DIELECTRIC,
            torch.where(refl_choice[..., None], reflect(wi), wo_refr),
            torch.where(refl_choice[..., None], params["specular"],
                        params["albedo"] * (eta_ti * eta_ti)[..., None]),
            torch.where(refl_choice, fr, 1.0 - fr))
        eta_sel.append((BSDF_DIELECTRIC,
                        torch.where(refl_choice, 1.0, eta_it)))
        delta = delta | (t == BSDF_DIELECTRIC)

    if has(BSDF_THINDIELECTRIC):
        # Total reflectance with the internal bounces, R' = R + T²R/(1−R²);
        # transmission passes straight through, unbent and unscaled.
        fr0 = fresnel_dielectric(cos_i.abs(), params["eta"])[0]
        tr0 = 1.0 - fr0
        fr_thin = torch.where(
            fr0 < 1.0,
            fr0 + tr0 * tr0 * fr0 / (1.0 - fr0 * fr0).clamp_min(1e-12), 1.0)
        refl_thin = u1 < fr_thin
        put(BSDF_THINDIELECTRIC,
            torch.where(refl_thin[..., None], reflect(wi), -wi),
            torch.where(refl_thin[..., None], params["specular"],
                        params["albedo"]),
            torch.where(refl_thin, fr_thin, 1.0 - fr_thin))
        delta = delta | (t == BSDF_THINDIELECTRIC)
        passthrough = passthrough | ((t == BSDF_THINDIELECTRIC) & ~refl_thin)

    alpha = params["alpha"]
    if has(BSDF_ROUGHCONDUCTOR):
        m = mf.sample_vndf(wi, alpha, u2)
        wo_rc = 2.0 * (wi * m).sum(-1, keepdim=True) * m - wi
        f_m = fresnel_conductor((wi * m).sum(-1), params["eta"][..., None],
                                params["k"])
        w_rc = params["specular"] * f_m * mf.smith_g1(wo_rc, m,
                                                      alpha)[..., None]
        pdf_rc = mf.vndf_pdf(wi, m, alpha) / (
            4.0 * (wo_rc * m).sum(-1).abs()).clamp_min(1e-12)
        valid_rc = wo_rc[..., 2] > 1e-6
        put(BSDF_ROUGHCONDUCTOR, wo_rc,
            torch.where(valid_rc[..., None], w_rc, 0.0),
            torch.where(valid_rc, pdf_rc, 0.0))

    if has(BSDF_PHONG):
        p_d = _lobe_probs(params)[0]
        n_exp = params["exponent"]
        cos_a = torch.pow(u2[..., 0].clamp_min(1e-12), 1.0 / (n_exp + 1.0))
        sin_a = torch.sqrt((1.0 - cos_a * cos_a).clamp_min(0.0))
        phi = 2.0 * math.pi * u2[..., 1]
        lobe_local = torch.stack([sin_a * torch.cos(phi),
                                  sin_a * torch.sin(phi), cos_a], -1)
        refl = reflect(wi)
        s_ax, t_ax = coordinate_system(refl)
        wo_spec = to_world(s_ax, t_ax, refl, lobe_local)
        wo_ph = torch.where((u1 >= p_d)[..., None], wo_spec, wo_diff)
        f_ph, pdf_ph = eval_pdf(_as_type(params, BSDF_PHONG), wi, wo_ph,
                                types=(BSDF_PHONG,))
        put(BSDF_PHONG, wo_ph, _ratio(f_ph, pdf_ph), pdf_ph)

    if has(BSDF_WARD):
        # Half-vector sampling: φ_h from the anisotropic azimuth warp,
        # tan²θ_h ~ Exp(k(φ)).
        p_d_w = _lobe_probs(params)[0]
        au = params["alpha"]
        av = params["alpha_v"]
        phi = torch.atan2(av * torch.sin(2.0 * math.pi * u2[..., 1]),
                          au * torch.cos(2.0 * math.pi * u2[..., 1]))
        cp = torch.cos(phi)
        sp = torch.sin(phi)
        kphi = cp * cp / (au * au) + sp * sp / (av * av)
        tan2t = -torch.log(u2[..., 0].clamp_min(1e-9)) / kphi.clamp_min(1e-12)
        cos_t = 1.0 / torch.sqrt(1.0 + tan2t)
        sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
        h_w = torch.stack([sin_t * cp, sin_t * sp, cos_t], -1)
        wo_w_spec = 2.0 * (wi * h_w).sum(-1, keepdim=True) * h_w - wi
        wo_w = torch.where((u1 >= p_d_w)[..., None], wo_w_spec, wo_diff)
        f_w, pdf_w = eval_pdf(_as_type(params, BSDF_WARD), wi, wo_w,
                              types=(BSDF_WARD,))
        put(BSDF_WARD, wo_w, _ratio(f_w, pdf_w), pdf_w)

    if has(BSDF_ROUGHDIELECTRIC):
        # Walter + VNDF; signed cosines are against the upper facet normal.
        wi_u = wi * torch.sign(cos_i)[..., None]
        m_rd = mf.sample_vndf(wi_u, alpha, u2)
        idotm = (wi * m_rd).sum(-1)  # negative when inside
        f_m, _, eta_it_rd, eta_ti_rd = fresnel_dielectric(idotm,
                                                          params["eta"])
        pick_refl = u1 < f_m
        wo_refl = 2.0 * idotm[..., None] * m_rd - wi
        wo_refr = ((eta_ti_rd * idotm - torch.sign(idotm) * torch.sqrt(
            (1.0 + eta_ti_rd * eta_ti_rd * (idotm * idotm - 1.0))
            .clamp_min(0.0)))[..., None] * m_rd
            - eta_ti_rd[..., None] * wi)
        wo_rd = normalize(torch.where(pick_refl[..., None], wo_refl,
                                      wo_refr))
        g1o = mf.smith_g1(wo_rd * torch.sign(wo_rd[..., 2:3]), m_rd, alpha)
        w_rd = torch.where(
            pick_refl[..., None], params["specular"] * g1o[..., None],
            params["albedo"] * (g1o / (eta_it_rd * eta_it_rd))[..., None])
        good_side = torch.where(pick_refl, wo_rd[..., 2] * cos_i > 0.0,
                                wo_rd[..., 2] * cos_i < 0.0)
        put(BSDF_ROUGHDIELECTRIC, wo_rd,
            torch.where(good_side[..., None], w_rd, 0.0),
            _eval_pdf_roughdielectric(params, wi, wo_rd)[1])
        eta_sel.append((BSDF_ROUGHDIELECTRIC,
                        torch.where(pick_refl, 1.0, eta_it_rd)))

    if has(BSDF_PLASTIC):
        p_spec_pl, f_i_pl = _plastic_probs(params, cos_i)
        pick_spec = u1 < p_spec_pl
        wo_pl = torch.where(pick_spec[..., None], reflect(wi), wo_diff)
        w_spec = params["specular"] * (
            f_i_pl / p_spec_pl.clamp_min(1e-6))[..., None]
        f_pl_d = _plastic_diffuse(params, cos_i, wo_pl[..., 2])
        pdf_pl_d = (1.0 - p_spec_pl) * warp.square_to_cosine_hemisphere_pdf(
            wo_pl)
        put(BSDF_PLASTIC, wo_pl,
            torch.where(pick_spec[..., None], w_spec,
                        _ratio(f_pl_d, pdf_pl_d)),
            torch.where(pick_spec, p_spec_pl, pdf_pl_d))
        delta = delta | ((t == BSDF_PLASTIC) & pick_spec)

    if has(BSDF_ROUGHPLASTIC):
        p_spec_rp = _plastic_probs(params, cos_i)[0]
        m_rp = mf.sample_vndf(wi, alpha, u2)
        wo_rp_spec = 2.0 * (wi * m_rp).sum(-1, keepdim=True) * m_rp - wi
        wo_rp = torch.where((u1 < p_spec_rp)[..., None], wo_rp_spec, wo_diff)
        f_rp, pdf_rp = eval_pdf(_as_type(params, BSDF_ROUGHPLASTIC), wi,
                                wo_rp, types=(BSDF_ROUGHPLASTIC,))
        put(BSDF_ROUGHPLASTIC, wo_rp, _ratio(f_rp, pdf_rp), pdf_rp)

    if has(BSDF_HK):
        # The delta transmission with the mean unscattered probability,
        # else the HG lobe weighted by eval/pdf.
        tau_d, _, aci_hk, p_spec = _hk_quantities(params, cos_i)
        pick_spec = u1 < p_spec
        w_spec = torch.exp(-tau_d / aci_hk[..., None]) / p_spec.clamp_min(
            1e-9)[..., None]
        wo_hg = _hg_sample(params["eta"], -wi, u2)
        f_hg, pdf_hg = eval_pdf(_as_type(params, BSDF_HK), wi, wo_hg,
                                types=(BSDF_HK,))
        put(BSDF_HK, torch.where(pick_spec[..., None], -wi, wo_hg),
            torch.where(pick_spec[..., None], w_spec, _ratio(f_hg, pdf_hg)),
            torch.where(pick_spec, p_spec, pdf_hg))
        delta = delta | ((t == BSDF_HK) & pick_spec)
        passthrough = passthrough | ((t == BSDF_HK) & pick_spec)

    wo0 = torch.zeros_like(wi)
    wo0[..., 2] = 1.0
    wo = _select(t, wo_sel, wo0)
    weight = _select(t, w_sel, torch.zeros(wi.shape[:-1] + (3,), device=dev))
    pdf = _select(t, pdf_sel, torch.zeros(wi.shape[:-1], device=dev))
    eta = _select(t, eta_sel, torch.ones(wi.shape[:-1], device=dev))

    # Reflective models need wi on the front side.
    needs_front = ((t != BSDF_DIELECTRIC) & (t != BSDF_ROUGHDIELECTRIC)
                   & (t != BSDF_NULL) & (t != BSDF_HK))
    ok = torch.where(needs_front, cos_i > 1e-6, True)
    return {"wo": wo, "weight": torch.where(ok[..., None], weight, 0.0),
            "pdf": torch.where(ok, pdf, 0.0), "delta": delta, "eta": eta,
            "pass": passthrough}


def _strip_container(params: dict) -> dict:
    return {k: v for k, v in params.items() if k not in _CONTAINER_KEYS}


def _refract_in(w, eta):
    """Refract into the coating layer, keeping the z sign; returns (w', R)."""
    cos_i = w[..., 2].abs()
    inv_eta = 1.0 / eta
    cos_t_sqr = 1.0 - (1.0 - cos_i * cos_i) * (inv_eta * inv_eta)
    cos_t = torch.sqrt(cos_t_sqr.clamp_min(0.0))
    rs = (cos_i - eta * cos_t) / (cos_i + eta * cos_t).clamp_min(1e-12)
    rp = (eta * cos_i - cos_t) / (eta * cos_i + cos_t).clamp_min(1e-12)
    r = torch.where(cos_t_sqr <= 0.0, 1.0, 0.5 * (rs * rs + rp * rp))
    return torch.stack([inv_eta * w[..., 0], inv_eta * w[..., 1],
                        torch.sign(w[..., 2]) * cos_t], -1), r


def _refract_out(w, eta):
    """Refract out of the coating layer; returns (w', R)."""
    cos_i = w[..., 2].abs()
    cos_t_sqr = 1.0 - (1.0 - cos_i * cos_i) * (eta * eta)
    cos_t = torch.sqrt(cos_t_sqr.clamp_min(0.0))
    inv_eta = 1.0 / eta
    rs = (cos_i - inv_eta * cos_t) / (cos_i + inv_eta * cos_t).clamp_min(
        1e-12)
    rp = (inv_eta * cos_i - cos_t) / (inv_eta * cos_i + cos_t).clamp_min(
        1e-12)
    r = torch.where(cos_t_sqr <= 0.0, 1.0, 0.5 * (rs * rs + rp * rp))
    return torch.stack([eta * w[..., 0], eta * w[..., 1],
                        torch.sign(w[..., 2]) * cos_t], -1), r


def _coat_prob_specular(params, r12):
    """The coating's specular selection probability from its sampling
    weight 1/(mean absorption + 1)."""
    w_spec = 1.0 / (torch.exp(-2.0 * params["coat_sa"]).mean(-1) + 1.0)
    return (r12 * w_spec) / (r12 * w_spec
                             + (1.0 - r12) * (1.0 - w_spec)).clamp_min(1e-12)


def _coat_absorb(params, wi_p, wo_p):
    return torch.exp(-params["coat_sa"] * (
        1.0 / wi_p[..., 2].abs().clamp_min(1e-6)
        + 1.0 / wo_p[..., 2].abs().clamp_min(1e-6))[..., None])


def eval_pdf_full(params: dict, wi: torch.Tensor, wo: torch.Tensor,
                  types: tuple | None = None):
    """eval_pdf with the containers resolved: a coating evaluates its child
    on the refracted directions (plus the GGX lobe of a rough boundary), a
    blend is (1-w)·f0 + w·f1 with the matching pdf, a mask scales the
    smooth part by its opacity and the pdf by the child's selection
    probability."""
    types = _types(types)
    core = _strip_container(params)
    f, pdf = eval_pdf(core, wi, wo, types=types)
    if "coat_eta" in params:
        eta_c = params["coat_eta"]
        wi_p, r12 = _refract_in(wi, eta_c)
        wo_p, r21 = _refract_in(wo, eta_c)
        f_n, pdf_n = eval_pdf(core, wi_p, wo_p, types=types)
        jac = (1.0 / (eta_c * eta_c)) * wo[..., 2] / wo_p[..., 2].clamp_min(
            1e-6)
        f_c = f_n * ((1.0 - r12) * (1.0 - r21) * jac)[..., None] \
            * _coat_absorb(params, wi_p, wo_p)
        prob_spec = _coat_prob_specular(params, r12)
        pdf_c = pdf_n * jac * (1.0 - prob_spec)
        # A rough boundary adds a GGX reflection lobe (its transmission
        # keeps the smooth boundary's Fresnel).
        a_c = params["coat_alpha"]
        h_r = wi + wo
        h_r = h_r / torch.linalg.vector_norm(h_r, dim=-1,
                                             keepdim=True).clamp_min(1e-12)
        h_r = h_r * torch.sign(wo[..., 2])[..., None]
        f_h = fresnel_dielectric((wi * h_r).sum(-1).abs(), eta_c)[0]
        g_h = mf.smith_g1(wi, h_r, a_c) * mf.smith_g1(wo, h_r, a_c)
        spec_val = f_h * mf.ggx_ndf(h_r, a_c) * g_h / (
            4.0 * wi[..., 2].abs()).clamp_min(1e-12)
        pdf_spec = mf.vndf_pdf(wi, h_r, a_c) / (
            4.0 * (wo * h_r).sum(-1).abs()).clamp_min(1e-12)
        add = (a_c > 1e-4) & (wi[..., 2] * wo[..., 2] > 0.0)
        f_c = f_c + torch.where(
            add[..., None], params["coat_spec"] * spec_val[..., None], 0.0)
        pdf_c = pdf_c + torch.where(add, prob_spec * pdf_spec, 0.0)
        no_tir = (r12 < 1.0) & (r21 < 1.0)
        is_c = params["is_coat"]
        f = torch.where((is_c & no_tir)[..., None], f_c,
                        torch.where(is_c[..., None], 0.0, f))
        pdf = torch.where(is_c & no_tir, pdf_c, torch.where(is_c, 0.0, pdf))
    if "blend_b" in params:
        f1, p1 = eval_pdf(params["blend_b"], wi, wo, types=types)
        w = params["blend_w"]
        is_b = params["is_blend"]
        f = torch.where(is_b[..., None],
                        (1.0 - w)[..., None] * f + w[..., None] * f1, f)
        pdf = torch.where(is_b, (1.0 - w) * pdf + w * p1, pdf)
    if "opacity" in params:
        op = params["opacity"]
        is_m = params["is_mask"]
        f = torch.where(is_m[..., None], op * f, f)
        pdf = torch.where(is_m, luminance(op).clamp(1e-3, 1.0) * pdf, pdf)
    return f, pdf


def sample_full(params: dict, wi: torch.Tensor, u0: torch.Tensor,
                u1: torch.Tensor, u2: torch.Tensor,
                types: tuple | None = None):
    """sample with the containers resolved; ``u0`` picks the container
    branch: the coating's specular lobe, the blend's child (probability =
    the blend factor) or the mask's pass-through (probability = 1 − the
    opacity's luminance). Smooth blend samples are weighted by the whole
    mixture (one-sample MIS over the children); a delta child's sample
    keeps its weight with the selection pmf folded into the pdf."""
    types = _types(types)
    core = _strip_container(params)
    has_blend = "blend_b" in params
    has_mask = "opacity" in params
    if "coat_eta" in params:
        eta_c = params["coat_eta"]
        wi_p, r12 = _refract_in(wi, eta_c)
        prob_spec = _coat_prob_specular(params, r12)
        pick_spec = u0 < prob_spec
        bs_n = sample(core, wi_p, u1, u2, types=types)
        wo_out, r21 = _refract_out(bs_n["wo"], eta_c)
        no_tir = (r12 < 1.0) & (r21 < 1.0)
        w_nested = bs_n["weight"] * _coat_absorb(params, wi_p, bs_n["wo"]) \
            * ((1.0 - r12) * (1.0 - r21)
               / (1.0 - prob_spec).clamp_min(1e-6))[..., None]
        w_nested = torch.where(no_tir[..., None], w_nested, 0.0)
        jac = (1.0 / (eta_c * eta_c)) * wo_out[..., 2] / bs_n["wo"][
            ..., 2].clamp_min(1e-6)
        pdf_nested = bs_n["pdf"] * jac.abs() * (1.0 - prob_spec)
        # The specular lobe: a delta reflection off a smooth boundary, a
        # GGX VNDF reflection off a rough one (f cos / pdf_vndf = F G1).
        a_c = params["coat_alpha"]
        rough_c = a_c > 1e-4
        m_c = mf.sample_vndf(wi, a_c.clamp_min(1e-4), u2)
        wo_rough = 2.0 * (wi * m_c).sum(-1, keepdim=True) * m_c - wi
        f_m = fresnel_dielectric((wi * m_c).sum(-1).abs(), eta_c)[0]
        g1o = mf.smith_g1(wo_rough, m_c, a_c)
        ok_rough = wo_rough[..., 2] * wi[..., 2] > 1e-7
        w_rough = params["coat_spec"] * torch.where(
            ok_rough, f_m * g1o / prob_spec.clamp_min(1e-6), 0.0)[..., None]
        pdf_rough = prob_spec * mf.vndf_pdf(wi, m_c, a_c) / (
            4.0 * (wo_rough * m_c).sum(-1).abs()).clamp_min(1e-12)
        r3 = rough_c[..., None]
        ps3 = pick_spec[..., None]
        coat = {
            "wo": torch.where(ps3, torch.where(r3, wo_rough, reflect(wi)),
                              wo_out),
            "weight": torch.where(ps3, torch.where(
                r3, w_rough, params["coat_spec"] * (
                    r12 / prob_spec.clamp_min(1e-6))[..., None]), w_nested),
            "pdf": torch.where(pick_spec,
                               torch.where(rough_c, pdf_rough, prob_spec),
                               pdf_nested),
            "delta": (pick_spec & ~rough_c) | (~pick_spec & bs_n["delta"]),
            "eta": torch.ones_like(r12),
            "pass": torch.zeros_like(pick_spec),
        }
        rest = sample_full(
            {k: v for k, v in params.items()
             if k not in ("is_coat", "coat_eta", "coat_sa", "coat_spec")},
            wi, u0, u1, u2, types=types)
        is_c = params["is_coat"]
        return {k: torch.where(is_c[..., None] if rest[k].ndim > is_c.ndim
                               else is_c, coat[k], rest[k])
                for k in rest}
    if not has_blend and not has_mask:
        return sample(core, wi, u1, u2, types=types)

    if has_blend:
        w = params["blend_w"]
        is_b = params["is_blend"]
        pick1 = is_b & (u0 < w)
        core = _where_params(pick1, params["blend_b"], core)
    bs = sample(core, wi, u1, u2, types=types)

    if has_blend:
        # Smooth samples: re-evaluated against the whole mixture.
        f_mix, pdf_mix = eval_pdf_full(params, wi, bs["wo"], types=types)
        smooth_b = is_b & ~bs["delta"]
        bs["weight"] = torch.where(smooth_b[..., None], _ratio(f_mix, pdf_mix),
                                   bs["weight"])
        bs["pdf"] = torch.where(smooth_b, pdf_mix, bs["pdf"])
        # A delta child: the selection pmf folds into the pdf; the weight
        # already cancels it.
        sel_p = torch.where(pick1, w, 1.0 - w)
        bs["pdf"] = torch.where(is_b & bs["delta"], sel_p * bs["pdf"],
                                bs["pdf"])

    if has_mask:
        op = params["opacity"]
        p_op = luminance(op).clamp(1e-3, 1.0)
        is_m = params["is_mask"]
        pass_thru = is_m & (u0 >= p_op)
        child = is_m & ~pass_thru
        bs["weight"] = torch.where(child[..., None],
                                   bs["weight"] * (op / p_op[..., None]),
                                   bs["weight"])
        bs["pdf"] = torch.where(child, p_op * bs["pdf"], bs["pdf"])
        # Pass-through: straight on through the surface.
        bs["wo"] = torch.where(pass_thru[..., None], -wi, bs["wo"])
        bs["weight"] = torch.where(
            pass_thru[..., None],
            (1.0 - op) / (1.0 - p_op).clamp_min(1e-3)[..., None],
            bs["weight"])
        bs["pdf"] = torch.where(pass_thru, 1.0 - p_op, bs["pdf"])
        bs["delta"] = bs["delta"] | pass_thru
        bs["pass"] = bs["pass"] | pass_thru
        bs["eta"] = torch.where(pass_thru, 1.0, bs["eta"])
    return bs
