"""The volumetric path tracer with optional NEE (port of
sdmm_tpu/render/volpath.py ``trace_wave``, ``mi_weight``,
``shading_frame``, ``_clean_cotangent`` and ``RAY_EPS``).

``trace_wave`` traces a wave of rays for a fixed number of bounces: closest
hit, free-flight sampling through the ray's medium (delta tracking where a
medium has a density grid), emission with MIS against NEE, the environment,
the dipole subsurface exitance, NEE at surface and medium vertices (shadow
rays attenuated through the current medium), Henyey-Greenstein scattering
in a medium, BSDF sampling, the medium switch at a crossed boundary, and
Russian roulette. Uniforms come from a ``torch.Generator`` or a mesh rank's
``core/draws.WaveBlock``. The radiance is differentiable in the scene's
parameters under autograd (``diff/inverse.py``): the roulette probability
is detached, and the next ray's origin and direction pass through
``_clean_cotangent``.
"""

from __future__ import annotations

import torch

from ..core import draws
from ..core.frame import coordinate_system, to_local, to_world
from ..scene.scene import (BSDF_DIELECTRIC, BSDF_HK, BSDF_NULL,
                           BSDF_ROUGHDIELECTRIC)

RAY_EPS = 1e-4  # spawn offset along the geometric normal


def spawn(p, ng, d):
    """A ray origin off the surface point ``p`` (geometric normal ``ng``) on
    the side of ``d``."""
    return p + ng * torch.where((ng * d).sum(-1) > 0, RAY_EPS,
                                -RAY_EPS)[:, None]


class _CleanCotangent(torch.autograd.Function):
    """Identity whose backward zeroes non-finite cotangents: a sampled
    direction's gradient flows back through the next bounce's hit, where
    an edge-on graze gives an isolated inf (a boundary term the interior
    estimator does not model) that would poison the shared parameter
    gradient. Forward values and finite cotangents are untouched."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)


def _clean_cotangent(x: torch.Tensor) -> torch.Tensor:
    """``_CleanCotangent`` where autograd records ``x``; else ``x``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CleanCotangent.apply(x)
    return x


def mi_weight(pdf_a, pdf_b):
    """Power heuristic (beta = 2), as the reference's miWeight."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0.0, a2 / (a2 + pdf_b * pdf_b).clamp_min(1e-32),
                       0.0)


def shading_frame(params: dict, ns: torch.Tensor, wi_world: torch.Tensor):
    """Local frame; flips the normal to wi's side for reflective models
    (implicit two-sided) and keeps the true normal for the transmissive
    ones (dielectric, roughdielectric, null, hk)."""
    cos_i = (ns * wi_world).sum(-1)
    t = params["type"]
    transmissive = ((t == BSDF_DIELECTRIC) | (t == BSDF_ROUGHDIELECTRIC)
                    | (t == BSDF_NULL) | (t == BSDF_HK))
    flip = (cos_i < 0.0) & ~transmissive
    n = torch.where(flip[..., None], -ns, ns)
    s, t = coordinate_system(n)
    return s, t, n


def trace_wave(scene, generator: torch.Generator, ro: torch.Tensor,
               rd: torch.Tensor, max_depth: int = 10, rr_depth: int = 10,
               nee: bool = True, bsdf_types: tuple | None = None,
               has_medium: bool = False, has_hetero: bool = False,
               has_bump: bool = False, has_sss: bool = False) -> torch.Tensor:
    """Trace a wave of rays for ``max_depth`` bounces (the reference's
    convention: depth counts path vertices, and NEE's light vertex must lie
    within it); returns the radiance [N, 3]. Rays start in the scene's
    ambient medium."""
    # Imported here: these modules reach this one through render.intersect.
    from ..bsdf import bsdf as bsdf_mod
    from ..scene import emitters
    from . import intersect as isect
    from . import medium as med

    n = ro.shape[0]
    dev = ro.device
    pdf_over_area = emitters.tri_pdf_over_area(scene)
    env_nee = nee and scene.env_pdf.shape[0] > 1
    thr = torch.ones((n, 3), device=dev)
    eta_sq = torch.ones(n, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    li = torch.zeros((n, 3), device=dev)
    prev_pdf = torch.ones(n, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    med_id = scene.ambient_med.to(torch.int32).expand(n).clone()
    for depth in range(max_depth):
        rnd = draws.rand((n, 15), generator, dev)
        u_m, u1n, u2n = rnd[:, 0], rnd[:, 1], rnd[:, 2:4]
        u1m, u2m, u_ph = rnd[:, 4], rnd[:, 5:7], rnd[:, 7:9]
        u0, u1, u2, u_rr = rnd[:, 9], rnd[:, 10], rnd[:, 11:13], rnd[:, 13]

        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        if has_bump:
            it["ns"] = isect.apply_bumpmap(scene, it)

        # --- Free flight through the ray's medium ---
        if has_medium:
            if has_hetero:
                # Delta tracking serves homogeneous rows too (density 1,
                # majorant 1).
                ms = med.sample_distance_hetero(scene, med_id, generator,
                                                ro, rd, hit["t"])
            else:
                ms = med.sample_distance(scene, med_id, u_m, hit["t"])
            scattered = active & ms["scattered"]
            thr = thr * torch.where(active[:, None], ms["weight"], 1.0)
        else:
            scattered = torch.zeros(n, dtype=torch.bool, device=dev)

        # Emission, MIS-weighted against NEE of the previous vertex.
        le = emitters.eval_emitter(scene, it, -rd)
        w_hit = torch.ones(n, device=dev)
        if nee:
            pdf_nee = emitters.pdf_direct_hit(scene, pdf_over_area,
                                              hit["tri"], rd, hit["t"])
            w_hit = torch.where(prev_delta | (depth == 0), 1.0,
                                mi_weight(prev_pdf, pdf_nee))
        reach = active & ~scattered
        li = li + torch.where(reach[:, None], thr * le * w_hit[:, None], 0.0)
        # The environment on a miss, weighted against the env map's NEE.
        w_env = torch.ones(n, device=dev)
        if env_nee:
            pdf_env = emitters.pdf_env_dir(scene, rd) * scene.env_select_prob
            w_env = torch.where(prev_delta | (depth == 0), 1.0,
                                mi_weight(prev_pdf, pdf_env))
        li = li + torch.where(
            (reach & ~hit["valid"])[:, None],
            thr * emitters.env_eval(scene, rd) * w_env[:, None], 0.0)
        # The dipole exitance, added like emission and never MIS-weighted.
        if has_sss:
            from .subsurface import sss_lo_factor

            li = li + torch.where(reach[:, None],
                                  thr * sss_lo_factor(scene, it, -rd), 0.0)

        on_surface = active & hit["valid"] & ~scattered
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        wi_dot_geo = (it["ng"] * -rd).sum(-1)
        # Strict normals; null boundaries and masks see both sides.
        cullable = params["type"] != BSDF_NULL
        if "is_mask" in params:
            cullable = cullable & ~params["is_mask"]
        on_surface = on_surface & ~(cullable
                                    & (wi_dot_geo * wi_local[..., 2] < 0.0))
        # NEE's light vertex sits one segment past this one.
        in_reach = depth + 2 <= max_depth

        # --- NEE at a surface vertex ---
        if nee:
            ls = emitters.sample_direct(scene, it["p"], u1n, u2n)
            wo_l = to_local(s_ax, t_ax, n_ax, ls["d"])
            f, pdf_b = bsdf_mod.eval_pdf_full(params, wi_local, wo_l,
                                              types=bsdf_types)
            cand = (on_surface & ls["valid"] & bsdf_mod.has_smooth(params)
                    & (ls["pdf"] > 0.0) & in_reach)
            shadow_o = it["p"] + it["ng"] * torch.where(
                (it["ng"] * ls["d"]).sum(-1) > 0, RAY_EPS, -RAY_EPS)[:, None]
            occ = isect.occluded(scene, shadow_o, ls["d"],
                                 ls["dist"] * (1.0 - 1e-3))
            w = torch.where(ls["delta"], 1.0, mi_weight(ls["pdf"], pdf_b))
            contrib = thr * f * ls["radiance"] * (
                w / ls["pdf"].clamp_min(1e-20))[:, None]
            if has_medium:
                contrib = contrib * (
                    med.transmittance_hetero(scene, med_id, generator,
                                             it["p"], ls["d"], ls["dist"])
                    if has_hetero
                    else med.transmittance(scene, med_id, ls["dist"]))
            li = li + torch.where((cand & ~occ)[:, None], contrib, 0.0)

        # --- A medium vertex: NEE through the phase function, then an HG
        # scatter ---
        if has_medium:
            g_ray = scene.med_g[med_id.long()]
            p_med = ro + ms["t"][:, None] * rd
            if nee:
                lsm = emitters.sample_direct(scene, p_med, u1m, u2m)
                f_ph = med.hg_pdf(g_ray, (rd * lsm["d"]).sum(-1))
                occ_m = isect.occluded(scene, p_med, lsm["d"],
                                       lsm["dist"] * (1.0 - 1e-3))
                w_m = torch.where(lsm["delta"], 1.0,
                                  mi_weight(lsm["pdf"], f_ph))
                tr_m = (med.transmittance_hetero(scene, med_id, generator,
                                                 p_med, lsm["d"],
                                                 lsm["dist"])
                        if has_hetero
                        else med.transmittance(scene, med_id, lsm["dist"]))
                contrib_m = thr * lsm["radiance"] * tr_m * (
                    f_ph * w_m / lsm["pdf"].clamp_min(1e-20))[:, None]
                cand_m = (scattered & lsm["valid"] & (lsm["pdf"] > 0.0)
                          & in_reach)
                li = li + torch.where((cand_m & ~occ_m)[:, None], contrib_m,
                                      0.0)
            d_med, pdf_med_dir = med.hg_sample(g_ray, rd, u_ph)

        # --- BSDF sampling ---
        bs = bsdf_mod.sample_full(params, wi_local, u0, u1, u2,
                                  types=bsdf_types)
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        wo_dot_geo = (it["ng"] * wo_world).sum(-1)
        good = (bs["weight"] > 0.0).any(-1) & (
            bs["pass"] | ~(wo_dot_geo * bs["wo"][..., 2] <= 0.0))
        active = (on_surface & good) | scattered
        thr = thr * torch.where(scattered[:, None], 1.0, bs["weight"])
        eta_sq = eta_sq * torch.where(scattered, 1.0, bs["eta"] * bs["eta"])

        # Russian roulette after rr_depth bounces, its probability detached
        # (an unbiased gradient estimator).
        q = (thr.max(-1).values * eta_sq).clamp_max(0.95).detach()
        do_rr = depth + 1 >= rr_depth
        if do_rr:
            active = active & (u_rr < q)
            thr = torch.where(active[:, None],
                              thr / q.clamp_min(1e-6)[:, None], thr)

        wo_world = _clean_cotangent(wo_world)
        ro_next = _clean_cotangent(it["p"] + it["ng"] * torch.where(
            wo_dot_geo > 0, RAY_EPS, -RAY_EPS)[:, None])
        prev_pdf = bs["pdf"]
        prev_delta = bs["delta"]
        if has_medium:
            # A crossed boundary switches the ray's medium.
            med_id = med.update_medium(scene, med_id, hit["tri"], wi_dot_geo,
                                       wo_dot_geo, on_surface & active)
            ro_next = torch.where(scattered[:, None], p_med, ro_next)
            wo_world = torch.where(scattered[:, None], d_med, wo_world)
            prev_pdf = torch.where(scattered, pdf_med_dir, prev_pdf)
            prev_delta = prev_delta & ~scattered
        ro, rd = ro_next, wo_world
    return li
