"""The irradiance caching integrator (port of sdmm_tpu/render/irrcache.py).

Records are placed in one batched pass: camera-visible shading points
(followed through up to two non-diffuse bounces) are hashed into a table of
(cell, normal bin) slots, one record a slot, and every record's stratified
cosine-weighted final gather of 2·res² rays runs as one wave through the
path tracer (``volpath.trace_wave``). Interpolation probes the 27
neighbouring cells of a point with Ward weights 1/(d/R_i + sqrt(1 -
n·n_i)), the 1/kappa cutoff and a nearest-record fallback. The render
path-traces through delta and glossy vertices and shades the first diffuse
vertex with exact NEE plus the cached indirect irradiance.

As in the reference: no irradiance gradients and no screen-space radius
clamp; a record's radius is its gather's harmonic mean distance clamped
into [0.75, 3] cells. The slot hash is the reference's uint32 arithmetic,
done in int64 with explicit 32-bit masks. A slot's record is its candidate
of highest index (``scatter_reduce`` amax), the same on every device.

Functions that sample take their uniforms (``rand``) or draw them from a
``torch.Generator``; every entry point runs on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from ..bsdf import bsdf as bsdf_mod
from ..core import warp
from ..core.device import resolve_device
from ..core.frame import coordinate_system, to_local, to_world
from ..scene import emitters
from ..scene.scene import BSDF_DIFFUSE, BSDF_ROUGHDIFFUSE, scene_to
from ..scene.sensor import generate_rays
from . import intersect as isect
from .ptracer import uniforms
from .volpath import RAY_EPS, mi_weight, shading_frame, spawn, trace_wave

TABLE = 4096  # record table size (a power of two)
_H1 = 0x9E3779B1  # Fibonacci hashing multiplier
_MASK32 = 0xFFFFFFFF


def _is_diffuse(params):
    t = params["type"]
    return (t == BSDF_DIFFUSE) | (t == BSDF_ROUGHDIFFUSE)


def _cell_of(scene, p, grid_res: int):
    """The integer cell [..., 3] of points p (clipped into [0, 4·grid_res])
    and the cell size."""
    lo = scene.aabb_lo
    cell = (scene.aabb_hi - lo).clamp_min(1e-6).max() / grid_res
    c = ((p - lo) / cell).to(torch.int32).clamp(0, 4 * grid_res)
    return c, cell


def _nbin(n):
    """The dominant-axis normal bin (6 bins)."""
    axis = n.abs().argmax(-1)
    sign = torch.gather(n, -1, axis[..., None])[..., 0] < 0.0
    return (axis * 2 + sign.long()).to(torch.int32)


def _slot(c, nb):
    """The table slot of cells c [..., 3] and normal bins nb: the
    reference's key in int32 arithmetic, bit-cast to uint32, times _H1
    modulo 2^32, shifted right by 8, modulo TABLE. Computed in int64: the
    key masked to 32 bits, the product split at 16 bits of _H1 so that no
    partial product overflows."""
    c = c.long()
    key = (((c[..., 0] * 731 + c[..., 1]) * 2683 + c[..., 2]) * 6
           + nb.long()) & _MASK32
    h = (key * (_H1 & 0xFFFF)
         + (((key * (_H1 >> 16)) & 0xFFFF) << 16)) & _MASK32
    return ((h >> 8) % TABLE).to(torch.int32)


def cache_shapes(n_candidates: int, gather_res: int) -> dict:
    """The uniforms build_cache draws: each candidate's pixel jitter, its
    two bounces' u0, u1, u2 of ``sample_full``, and each record's
    stratified gather jitter."""
    g = 2 * gather_res * gather_res
    return {"pix": (n_candidates, 2), "bounce": (2, n_candidates, 4),
            "gather": (TABLE, g, 2)}


def build_cache(scene, generator, width: int, height: int,
                grid_res: int = 48, gather_res: int = 14,
                bsdf_types: tuple | None = None, max_depth: int = 10,
                n_candidates: int = 1 << 16, fov_axis: str = "x",
                rand: dict | None = None, device="cuda") -> dict:
    """The overture pass: place records at camera-visible diffuse points,
    then final-gather each with 2·gather_res² stratified cosine rays through
    ``trace_wave`` (which draws from ``generator``). ``rand``: the dict of
    cache_shapes(n_candidates, gather_res). Returns the cache: pos, n, E, R,
    valid, cell_idx a slot, cell and grid_res."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    u = uniforms(rand, generator, cache_shapes(n_candidates, gather_res),
                 dev)
    # Candidates: strided pixels, followed through up to two non-diffuse
    # bounces (surfaces seen in mirrors and through glass get records).
    n_pix = width * height
    pix = (torch.arange(n_candidates, device=dev) * 9973) % n_pix
    px = (pix % width).float() + u["pix"][:, 0]
    py = (pix // width).float() + u["pix"][:, 1]
    ro, rd = generate_rays(scene, torch.stack([px, py], -1), width, height,
                           fov_axis)
    pos = torch.zeros((n_candidates, 3), device=dev)
    nrm = torch.zeros((n_candidates, 3), device=dev)
    found = torch.zeros(n_candidates, dtype=torch.bool, device=dev)
    for b in range(3):
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        new = ~found & hit["valid"] & _is_diffuse(params)
        pos = torch.where(new[:, None], it["p"], pos)
        nrm = torch.where(new[:, None], it["ns"], nrm)
        found = found | new
        if b == 2:
            break
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        ub = u["bounce"][b]
        bs = bsdf_mod.sample_full(params, to_local(s_ax, t_ax, n_ax, -rd),
                                  ub[:, 0], ub[:, 1], ub[:, 2:4],
                                  types=bsdf_types)
        wo_w = to_world(s_ax, t_ax, n_ax, bs["wo"])
        ro = spawn(it["p"], it["ng"], wo_w)
        rd = wo_w

    cand_cell, cell = _cell_of(scene, pos, grid_res)
    cand_slot = _slot(cand_cell, _nbin(nrm))
    # One record a slot: its candidate of highest index; candidates that
    # found no diffuse point go to the extra row TABLE.
    table = torch.full((TABLE + 1,), -1, dtype=torch.long, device=dev)
    table = table.scatter_reduce(
        0, torch.where(found, cand_slot.long(), TABLE),
        torch.arange(n_candidates, device=dev), reduce="amax")[:TABLE]
    rec_valid = table >= 0
    rec_idx = table.clamp_min(0)
    rec_pos = torch.where(rec_valid[:, None], pos[rec_idx], 0.0)
    rec_n = torch.where(rec_valid[:, None], nrm[rec_idx], 0.0)
    rec_cell, _ = _cell_of(scene, rec_pos, grid_res)

    # The final gather: 2·res² stratified cosine-weighted rays a record.
    n_el = gather_res
    n_az = 2 * gather_res
    g = n_el * n_az
    ii = torch.arange(g, device=dev)
    su = u["gather"]
    u1 = ((ii // n_az).float()[None] + su[..., 0]) / n_el
    u2 = ((ii % n_az).float()[None] + su[..., 1]) / n_az
    d_local = warp.square_to_cosine_hemisphere(torch.stack([u1, u2], -1))
    s_ax, t_ax = coordinate_system(rec_n)
    d = (s_ax[:, None] * d_local[..., 0:1] + t_ax[:, None] * d_local[..., 1:2]
         + rec_n[:, None] * d_local[..., 2:3]).reshape(-1, 3)
    o = (rec_pos[:, None] + rec_n[:, None] * RAY_EPS).expand(
        TABLE, g, 3).reshape(-1, 3)
    # The first hit's distance sets R; its emission is subtracted (direct
    # light is rendered separately).
    ghit = isect.intersect(scene, o, d)
    le = emitters.eval_emitter(scene, isect.surface_interaction(
        scene, o, d, ghit), -d)
    li = trace_wave(scene, generator, o, d, max_depth=max_depth,
                    rr_depth=max_depth, nee=True, bsdf_types=bsdf_types)
    li_ind = (li - le).clamp_min(0.0).reshape(TABLE, g, 3)
    rec_e = math.pi * li_ind.mean(1)  # cosine-weighted: E = π·mean(Li)
    inv_d = torch.where(ghit["valid"], 1.0 / ghit["t"].clamp_min(1e-6),
                        0.0).reshape(TABLE, g)
    n_hit = (inv_d > 0).sum(1)
    r_harm = torch.where(n_hit > 0,
                         n_hit / inv_d.sum(1).clamp_min(1e-9), 1e6)
    rec_r = torch.minimum(torch.maximum(r_harm, 0.75 * cell), 3.0 * cell)
    return {"pos": rec_pos, "n": rec_n, "E": rec_e, "R": rec_r,
            "valid": rec_valid, "cell_idx": rec_cell, "cell": cell,
            "grid_res": torch.tensor(grid_res, dtype=torch.int32,
                                     device=dev)}


def interpolate(cache: dict, scene, p: torch.Tensor, n: torch.Tensor,
                grid_res: int, kappa: float = 1.0):
    """Ward-weighted irradiance at points p with normals n over the records
    of the 27 neighbouring cells; the nearest record where no weight clears
    the 1/kappa cutoff. Returns (E [N, 3], covered [N])."""
    c, _ = _cell_of(scene, p, grid_res)
    nb = _nbin(n)
    lead = p.shape[:-1]
    e_acc = torch.zeros(lead + (3,), device=p.device)
    w_acc = torch.zeros(lead, device=p.device)
    best_d = torch.full(lead, 1e30, device=p.device)
    best_e = torch.zeros(lead + (3,), device=p.device)
    any_rec = torch.zeros(lead, dtype=torch.bool, device=p.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cc = c + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                      device=p.device)
                s = _slot(cc, nb).long()
                ok = cache["valid"][s] & (cache["cell_idx"][s] == cc).all(-1)
                re_ = cache["E"][s]
                diff = p - cache["pos"][s]
                d = torch.sqrt((diff * diff).sum(-1))
                ndot = (n * cache["n"][s]).sum(-1).clamp(-1.0, 1.0)
                w = 1.0 / (d / cache["R"][s].clamp_min(1e-6) + torch.sqrt(
                    (1.0 - ndot).clamp_min(0.0))).clamp_min(1e-4)
                use = ok & (w > 1.0 / kappa) & (ndot > 0.2)
                w = torch.where(use, w, 0.0)
                e_acc = e_acc + w[..., None] * re_
                w_acc = w_acc + w
                near = ok & (d < best_d) & (ndot > 0.2)
                best_d = torch.where(near, d, best_d)
                best_e = torch.where(near[..., None], re_, best_e)
                any_rec = any_rec | ok & (ndot > 0.2)
    covered = w_acc > 0.0
    e = torch.where(covered[..., None],
                    e_acc / w_acc.clamp_min(1e-9)[..., None],
                    torch.where(any_rec[..., None], best_e, 0.0))
    return e, covered | any_rec


def make_trace_fn(cache: dict, cfg, grid_res: int, kappa: float = 1.0,
                  indirect_only: bool = False):
    """A ``trace_fn`` for ``renderer.render``: path-trace through delta and
    glossy vertices (three bounces at most); at a diffuse vertex exact NEE
    (unless ``indirect_only``) plus the cached indirect irradiance times
    albedo/π. Each call draws its uniforms at its top."""
    bsdf_types = cfg.bsdf_types or None

    def trace(scene, generator, ro, rd):
        n = ro.shape[0]
        dev = ro.device
        rnd = torch.rand((3, n, 7), generator=generator, device=dev)
        li = torch.zeros((n, 3), device=dev)
        thr = torch.ones((n, 3), device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        pdf_over_area = emitters.tri_pdf_over_area(scene)
        prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
        prev_pdf = torch.ones(n, device=dev)
        for b in range(3):
            r = rnd[b]
            hit = isect.intersect(scene, ro, rd)
            it = isect.surface_interaction(scene, ro, rd, hit)
            if not indirect_only:
                le = emitters.eval_emitter(scene, it, -rd)
                pdf_nee = emitters.pdf_direct_hit(scene, pdf_over_area,
                                                  hit["tri"], rd, hit["t"])
                w_hit = torch.where(prev_delta, 1.0,
                                    mi_weight(prev_pdf, pdf_nee))
                li = li + torch.where(active[:, None],
                                      thr * le * w_hit[:, None], 0.0)
                li = li + torch.where((active & ~hit["valid"])[:, None],
                                      thr * emitters.env_eval(scene, rd),
                                      0.0)
            on_surf = active & hit["valid"]
            params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                            types=bsdf_types)
            s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
            wi_l = to_local(s_ax, t_ax, n_ax, -rd)
            diffuse = _is_diffuse(params)

            # Exact direct light at the vertex: one NEE sample, MIS against
            # the BSDF through the emitter-hit term above.
            if not indirect_only:
                ls = emitters.sample_direct(scene, it["p"], r[:, 0],
                                            r[:, 1:3])
                f, pdf_b = bsdf_mod.eval_pdf_full(
                    params, wi_l, to_local(s_ax, t_ax, n_ax, ls["d"]),
                    types=bsdf_types)
                cand = (on_surf & bsdf_mod.has_smooth(params) & ls["valid"]
                        & (ls["pdf"] > 0.0))
                occ = isect.occluded(scene, spawn(it["p"], it["ng"],
                                                  ls["d"]),
                                     ls["d"], ls["dist"] * (1.0 - 1e-3))
                wmis = torch.where(ls["delta"], 1.0,
                                   mi_weight(ls["pdf"], pdf_b))
                li = li + torch.where(
                    (cand & ~occ)[:, None],
                    thr * f * ls["radiance"]
                    * (wmis / ls["pdf"].clamp_min(1e-20))[:, None], 0.0)

            # The cached indirect diffuse light: E · albedo / π.
            e, _ = interpolate(cache, scene, it["p"], it["ns"], grid_res,
                               kappa)
            li = li + torch.where((on_surf & diffuse)[:, None],
                                  thr * params["albedo"] * e
                                  * (1.0 / math.pi), 0.0)

            # Non-diffuse vertices (delta and glossy) continue the path.
            bs = bsdf_mod.sample_full(params, wi_l, r[:, 3], r[:, 4],
                                      r[:, 5:7], types=bsdf_types)
            wo_w = to_world(s_ax, t_ax, n_ax, bs["wo"])
            active = on_surf & ~diffuse & (bs["weight"] > 0.0).any(-1)
            thr = thr * torch.where(active[:, None], bs["weight"], 1.0)
            ro = spawn(it["p"], it["ng"], wo_w)
            rd = wo_w
            prev_delta = bs["delta"]
            prev_pdf = bs["pdf"]
        return li

    return trace


def render_irrcache(scene, cfg, spp: int = 16, seed: int = 1234,
                    grid_res: int = 48, gather_res: int = 14,
                    kappa: float = 1.0, indirect_only: bool = False,
                    device="cuda") -> dict:
    """The overture pass (seeded seed ^ 0x5CACE), then the cached render
    through the wave renderer. Returns renderer.render's dict."""
    from .renderer import render

    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    cache = build_cache(
        scene, torch.Generator(device=dev).manual_seed(seed ^ 0x5CACE),
        cfg.width, cfg.height, grid_res=grid_res, gather_res=gather_res,
        bsdf_types=cfg.bsdf_types or None, max_depth=cfg.max_depth,
        fov_axis=cfg.fov_axis, device=dev)
    trace = make_trace_fn(cache, cfg, grid_res, kappa, indirect_only)
    return render(scene, cfg, spp=spp, seed=seed, trace_fn=trace, device=dev)
