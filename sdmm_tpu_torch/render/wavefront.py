"""The unguided path tracer with next-event estimation: the regenerating
lane pools and their router (port of sdmm_tpu/render/wavefront.py
``render_pool``, ``fused_supported``, ``render_pool_fused``,
``render_pool_fused_blocked``, ``render_pool_fused_sorted``,
``render_pool_fused_sorted2``, ``render_pool_fused_shuffled``,
``render_pool_fused_striped`` and ``render_wavefront``).

``render_pool`` is the eager pool: every lane restarts on the next camera
sample of a global counter, and each step is one bounce in plain PyTorch
(closest hit, emitter hit with MIS, NEE with an occlusion sweep, BSDF
sample, Russian roulette, film scatter). It is the oracle of the fused
pools. ``render_pool_fused_sorted2`` runs a pilot pass pixel-stationary,
sorts the pixels by the path vertices the pilot measured, and runs the
rest of the samples on equal-cost tiles; each step is one launch of
``ops.bounce.step`` (regeneration, camera ray, Philox uniforms, bounce,
film add in place). ``render_pool_fused_striped`` binds lane i to pixel i
and runs ``ops.bounce.bounce`` with the regeneration in PyTorch.
``render_wavefront`` routes as the reference does on its accelerator.
The other four pools, which no entry point reaches (as in the reference),
run ``ops.bounce.bounce`` around their own layouts: ``render_pool_fused``
regenerates from a global counter and scatters the film a step,
``render_pool_fused_blocked`` maps each lane tile to a 2-D image block and
skips drained tiles, ``render_pool_fused_sorted`` runs sorted2's pilot and
cost-sorted schedule on the bounce kernel, ``render_pool_fused_shuffled``
gives each lane ``groups`` pixels of a random permutation. Their uniforms
come from a ``torch.Generator`` seeded by ``seed``. SDMM_TPU_NO_FUSED=1
shuts ``fused_supported``, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..bsdf import bsdf as bsdf_mod
from ..core.device import resolve_device
from ..core.frame import to_local, to_world
from ..ops import bounce as bo
from ..scene import emitters
from ..scene.scene import BSDF_NULL, scene_to
from ..scene.sensor import generate_rays
from .guided import INNER
from .intersect import (apply_bumpmap, intersect, occluded,
                        surface_interaction)
from .volpath import RAY_EPS, mi_weight, shading_frame

# f32 state rows of the fused pools' [16, N] lane state.
_RO = slice(0, 3)
_RD = slice(3, 6)
_THR = slice(6, 9)
_LI = slice(9, 12)
_ETA2 = 12
_PPDF = 13
_NCOLS = 14

# i32 meta bit layout: pix or sample count (bits 0..19), depth (20..23),
# alive (24), exhausted (25), prev_delta (26).
_DEPTH_SHIFT = bo._DEPTH_SHIFT
_ALIVE = bo._ALIVE
_EXH = bo._EXH
_PDELTA = bo._PDELTA
_PIX_MASK = bo._PIX_MASK
_DEPTH_MASK = bo._DEPTH_MASK


def _check_size(n_pix: int, max_depth: int):
    if n_pix > _PIX_MASK:
        raise ValueError(f"{n_pix} pixels do not fit the lane meta word")
    if max_depth > _DEPTH_MASK + 1:
        raise ValueError(f"max_depth {max_depth} > {_DEPTH_MASK + 1}")


def render_pool(
    scene,
    generator: torch.Generator,
    n_lanes: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    nee: bool = True,
    bsdf_types: tuple | None = None,
    fov_axis: str = "x",
    has_bump: bool = False,
    has_sss: bool = False,
    device: str | torch.device = "cuda",
):
    """Render width×height at ``spp`` with a regenerating lane pool and
    NEE (``nee``: area triangles, delta lights and the env map, each with
    the reference's MIS weights); uniforms come from ``generator`` (on
    ``device``). ``has_bump`` applies the scene's bump and normal maps,
    ``has_sss`` adds the baked dipole exitance (``scene.sss_M``) at every
    hit.

    Returns dict(image, sqr [n_pix, 3], weight [n_pix], n_vertices, steps,
    pool="eager"). ``n_vertices`` counts the alive lanes that hit a
    surface, before the back-face cull."""
    if n_lanes <= 0:
        raise ValueError("n_lanes must be positive")
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    n_pix = width * height
    _check_size(n_pix, max_depth)
    total = n_pix * spp
    N = n_lanes
    pdf_over_area = emitters.tri_pdf_over_area(scene)
    has_env_nee = nee and scene.env_pdf.shape[0] > 1

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    film = zeros(n_pix, 7)
    cursor = zeros(1, dtype=torch.int64)
    ro = zeros(N, 3)
    rd = zeros(N, 3)
    rd[:, 2] = 1.0
    thr = torch.ones((N, 3), device=dev)
    li = zeros(N, 3)
    eta2 = torch.ones(N, device=dev)
    ppdf = torch.ones(N, device=dev)
    pix = zeros(N, dtype=torch.int64)
    depth0 = zeros(N, dtype=torch.int64)
    alive = zeros(N, dtype=torch.bool)
    exhausted = zeros(N, dtype=torch.bool)
    prev_delta = torch.ones(N, dtype=torch.bool, device=dev)
    n_vert = zeros(dtype=torch.float64)

    steps = 0
    while bool((alive | ~exhausted).any()):
        rnd = torch.rand((N, 10), generator=generator, device=dev)
        u_regen, u1n, u2n = rnd[:, 0:2], rnd[:, 2], rnd[:, 3:5]
        u0, u1, u2, u_rr = rnd[:, 5], rnd[:, 6], rnd[:, 7:9], rnd[:, 9]

        # --- Regenerate dead lanes from the global sample counter ---
        need = ~alive & ~exhausted
        rank = torch.cumsum(need.long(), 0) - 1
        g = cursor + rank
        start = need & (g < total)
        pix_n = torch.where(start, g % n_pix, 0)
        px = (pix_n % width).float() + u_regen[:, 0]
        py = (pix_n // width).float() + u_regen[:, 1]
        ro_n, rd_n = generate_rays(scene, torch.stack([px, py], -1), width,
                                   height, fov_axis)
        exhausted = exhausted | (need & ~start)
        cursor = cursor + start.sum()
        s1 = start[:, None]
        pix = torch.where(start, pix_n, pix)
        ro = torch.where(s1, ro_n, ro)
        rd = torch.where(s1, rd_n, rd)
        thr = torch.where(s1, 1.0, thr)
        li = torch.where(s1, 0.0, li)
        eta2 = torch.where(start, 1.0, eta2)
        ppdf = torch.where(start, 1.0, ppdf)
        prev_delta = prev_delta | start
        depth0 = torch.where(start, 0, depth0)
        alive = alive | start

        # --- One bounce ---
        hit = intersect(scene, ro, rd)
        it = surface_interaction(scene, ro, rd, hit)
        if has_bump:
            it["ns"] = apply_bumpmap(scene, it)
        le = emitters.eval_emitter(scene, it, -rd)
        w_hit = torch.ones(N, device=dev)
        if nee:
            pdf_nee = emitters.pdf_direct_hit(scene, pdf_over_area, hit["tri"],
                                              rd, hit["t"])
            w_hit = torch.where(prev_delta, 1.0, mi_weight(ppdf, pdf_nee))
        li = li + torch.where(alive[:, None], thr * le * w_hit[:, None], 0.0)
        # Escaped rays: the environment, weighted against the env map's
        # NEE (weight 1 for a constant environment).
        w_env = torch.ones(N, device=dev)
        if has_env_nee:
            pdf_env = emitters.pdf_env_dir(scene, rd) * scene.env_select_prob
            w_env = torch.where(prev_delta, 1.0, mi_weight(ppdf, pdf_env))
        escaped = alive & ~hit["valid"]
        li = li + torch.where(
            escaped[:, None],
            thr * emitters.env_eval(scene, rd) * w_env[:, None], 0.0)
        on_surface = alive & hit["valid"]
        n_vert = n_vert + on_surface.sum()
        if has_sss:
            from .subsurface import sss_lo_factor

            li = li + torch.where(alive[:, None],
                                  thr * sss_lo_factor(scene, it, -rd), 0.0)

        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        wi_dot_geo = (it["ng"] * -rd).sum(-1)
        # Null boundaries and masks stay out of the back-face cull.
        cullable = params["type"] != BSDF_NULL
        if "is_mask" in params:
            cullable = cullable & ~params["is_mask"]
        on_surface = on_surface & ~(cullable
                                    & (wi_dot_geo * wi_local[..., 2] < 0.0))

        if nee:
            ls = emitters.sample_direct(scene, it["p"], u1n, u2n)
            wo_l = to_local(s_ax, t_ax, n_ax, ls["d"])
            f, pdf_b = bsdf_mod.eval_pdf_full(params, wi_local, wo_l,
                                              types=bsdf_types)
            # The NEE light vertex sits at depth0 + 2: gate it by
            # max_depth, as the reference's volpath breaks before NEE.
            cand = (on_surface & ls["valid"] & bsdf_mod.has_smooth(params)
                    & (ls["pdf"] > 0.0) & (depth0 + 2 <= max_depth))
            shadow_o = it["p"] + it["ng"] * torch.where(
                (it["ng"] * ls["d"]).sum(-1) > 0, RAY_EPS, -RAY_EPS)[:, None]
            occ = occluded(scene, shadow_o, ls["d"], ls["dist"] * (1.0 - 1e-3))
            w = torch.where(ls["delta"], 1.0, mi_weight(ls["pdf"], pdf_b))
            contrib = thr * f * ls["radiance"] * (
                w / ls["pdf"].clamp_min(1e-20))[:, None]
            li = li + torch.where((cand & ~occ)[:, None], contrib, 0.0)

        bs = bsdf_mod.sample_full(params, wi_local, u0, u1, u2,
                                  types=bsdf_types)
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        wo_dot_geo = (it["ng"] * wo_world).sum(-1)
        good = (bs["weight"] > 0.0).any(-1) & (
            bs["pass"] | ~(wo_dot_geo * bs["wo"][..., 2] <= 0.0))

        depth = depth0 + 1
        survive = on_surface & good & (depth < max_depth)
        thr_next = thr * torch.where(survive[:, None], bs["weight"], 1.0)
        eta_sq = eta2 * torch.where(survive, bs["eta"] * bs["eta"], 1.0)
        # Russian roulette (reference: sdmm_proc.cpp:858).
        q = (thr_next.max(-1).values * eta_sq).clamp_max(0.95)
        do_rr = depth + 1 >= rr_depth
        survive = survive & ~(do_rr & (u_rr >= q))
        thr_next = torch.where((do_rr & survive)[:, None],
                               thr_next / q.clamp_min(1e-6)[:, None], thr_next)

        # --- Terminate finished paths: one film scatter ---
        done = alive & ~survive
        val = torch.where(done[:, None], torch.nan_to_num(
            li, nan=0.0, posinf=0.0, neginf=0.0), 0.0)
        film.index_add_(0, pix, torch.cat(
            [val, val * val, done.float()[:, None]], dim=-1))

        ro = it["p"] + it["ng"] * torch.where(
            wo_dot_geo > 0, RAY_EPS, -RAY_EPS)[:, None]
        rd = wo_world
        thr = thr_next
        eta2 = eta_sq
        ppdf = bs["pdf"]
        prev_delta = bs["delta"]
        # Dead lanes would otherwise count depth up into the flag bits.
        depth0 = torch.where(survive, depth, 0) & _DEPTH_MASK
        alive = survive
        steps += 1

    return {"image": film[:, 0:3], "sqr": film[:, 3:6], "weight": film[:, 6],
            "n_vertices": n_vert, "steps": steps, "pool": "eager"}


def fused_supported(scene, cfg, nee: bool = True) -> bool:
    """Whether the fused pools can render ``scene``: NEE on, in-kernel BSDF
    types only, no bump map, no medium, no subsurface scattering, a
    triangle table within MAX_TRIS, 1 to
    MAX_EMITTERS emissive triangles, no env map, no delta light, no texture
    and a pixel index that fits the meta word. The kernels read none of the
    textures; the reference's gate lets procedural ones through, this one
    does not (ROADMAP §C). SDMM_TPU_NO_FUSED=1 shuts it."""
    return bool(
        os.environ.get("SDMM_TPU_NO_FUSED") != "1"
        and nee
        and len(cfg.bsdf_types) > 0
        and all(t in bo.SUPPORTED_TYPES for t in cfg.bsdf_types)
        and not cfg.has_bump
        and not cfg.has_medium
        and not cfg.has_sss
        and scene.tri_v0.shape[0] <= bo.MAX_TRIS
        and 1 <= scene.em_tri_idx.shape[0] <= bo.MAX_EMITTERS
        and scene.env_pdf.shape[0] <= 1
        and scene.pt_pos.shape[0] == 0
        and scene.textures.shape[1] <= 1
        and scene.proc_tex.shape[0] == 0
        and cfg.width * cfg.height <= _PIX_MASK
    )


def _fresh_state(n: int, dev) -> torch.Tensor:
    """The pools' initial lane state: direction +z, throughput 1, eta² 1,
    previous pdf 1."""
    state = torch.zeros((16, n), device=dev)
    state[5] = 1.0
    state[_THR] = 1.0
    state[_ETA2] = 1.0
    state[_PPDF] = 1.0
    return state


def _tables(scene):
    tri_rows, em_rows, env_row = bo.build_tables(scene)
    n_em = scene.em_tri_idx.shape[0]
    if n_em > bo.MAX_EMITTERS:
        raise ValueError(f"{n_em} emissive triangles > {bo.MAX_EMITTERS}")
    return tri_rows, em_rows, env_row, n_em


def _regen(meta, count, budget, rnd, px_base, py_base, scene, width, height,
           fov_axis, state, fresh_tail, pdelta: bool = True):
    """Regenerate the dead lanes of a pixel-stationary pool on their own
    pixel (px_base, py_base) while their sample ``count`` is below
    ``budget``; returns (state, meta). ``pdelta``: a fresh path sets the
    meta word's previous-bounce-delta bit (the bounce kernel's; the guided
    kernels keep no such bit)."""
    alive = (meta & _ALIVE) != 0
    exh = (meta & _EXH) != 0
    need = ~alive & ~exh
    start = need & (count < budget)
    exh = exh | (need & ~start)
    ro_n, rd_n = generate_rays(
        scene, torch.stack([px_base + rnd[0], py_base + rnd[1]], -1),
        width, height, fov_axis)
    count = torch.where(start, count + 1, count)
    state = torch.where(start, torch.cat([ro_n.T, rd_n.T, fresh_tail]),
                        state)
    new = (count
           | torch.where(alive | start, _ALIVE, 0)
           | torch.where(exh, _EXH, 0)
           | torch.where(start, 0, meta & (_DEPTH_MASK << _DEPTH_SHIFT)))
    if pdelta:
        new = new | torch.where(start, _PDELTA, meta & _PDELTA)
    return state, new.to(torch.int32)


def _runnable(meta):
    return ((meta & _ALIVE) != 0) | ((meta & _EXH) == 0)


def _fused_setup(scene, width, height, max_depth, spp, device):
    """The fused pools' start: the device, the scene on it, the pixel
    count and ``_tables``; raises where the image, ``max_depth`` or the
    count ``spp`` the meta word holds does not fit."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    n_pix = width * height
    _check_size(n_pix, max_depth)
    if spp > _PIX_MASK:
        raise ValueError(f"spp {spp} does not fit the lane meta word")
    return dev, scene, n_pix, _tables(scene)


def render_pool_fused_sorted2(
    scene,
    seed: int,
    spp: int,
    width: int,
    height: int,
    spp_pilot: int = 8,
    max_depth: int = 10,
    rr_depth: int = 10,
    fov_axis: str = "x",
    bsdf_types: tuple = (0,),
    device: str | torch.device = "cuda",
):
    """Cost-sorted pool over the fused step kernel. A pilot pass renders
    ``spp_pilot`` samples with lane i on pixel i and counts each pixel's
    path vertices; the other ``spp - spp_pilot`` samples run with the
    pixels sorted by that cost, so each tile holds equal-cost pixels and
    cheap tiles drain and skip early. Every step is one ``ops.bounce.step``
    launch with the Philox key (seed + phase, step); the host reads the
    tiles' alive flags every INNER steps. Callers pass ``fused_supported``
    scenes.

    Returns dict(image, sqr, weight, n_vertices, steps, alive_tile_steps
    (tiles that ran a bounce), total_tile_steps, pool="sorted2")."""
    if not 0 < spp_pilot < spp:
        raise ValueError(f"spp_pilot {spp_pilot} must lie in (0, {spp})")
    dev, scene, n_pix, (tri_rows, em_rows, env_row, n_em) = _fused_setup(
        scene, width, height, max_depth, spp, device)
    types = tuple(bsdf_types)
    tile = bo.lane_tile(tri_rows.shape[1])
    n_tiles = -(-n_pix // tile)
    N = n_tiles * tile
    cam = bo.build_cam_params(scene, width, height, fov_axis)
    lane = torch.arange(N, device=dev)

    def run_phase(pix_of_lane, budget, phase_id):
        pxpy = torch.stack([(pix_of_lane % width).float(),
                            (pix_of_lane // width).float(),
                            budget.float()]).contiguous()
        state = _fresh_state(N, dev)
        meta = torch.full((N,), _PDELTA, dtype=torch.int32, device=dev)
        film = torch.zeros((8, N), device=dev)
        tile_alive = torch.ones(n_tiles, dtype=torch.int32, device=dev)
        ats = torch.zeros((), dtype=torch.int64, device=dev)
        steps = 0
        while True:
            for _ in range(INNER):
                ats = ats + tile_alive.sum()
                bo.step(state, meta, film, tile_alive, cam,
                        (seed + phase_id, steps), pxpy, tri_rows, em_rows,
                        env_row, n_em, max_depth, rr_depth, types, width,
                        height)
                runnable = ((meta & _ALIVE) != 0) | ((meta & _EXH) == 0)
                tile_alive = runnable.view(n_tiles, tile).any(1).to(
                    torch.int32)
                steps += 1
            if not bool(tile_alive.any()):
                return film, steps, ats

    in_image = lane < n_pix
    pix_a = torch.where(in_image, lane, 0)
    film_a, steps_a, ats_a = run_phase(
        pix_a, torch.where(in_image, spp_pilot, 0), 0)

    # Measured cost per pixel → equal-cost tiles for the main pass. Lanes
    # past the image carry cost -1: they sort to the front, budget 0.
    cost = torch.where(in_image, film_a[7], -1.0)
    order = torch.argsort(cost, stable=True)
    valid_b = cost[order] >= 0.0
    film_b, steps_b, ats_b = run_phase(
        torch.where(valid_b, order, 0),
        torch.where(valid_b, spp - spp_pilot, 0), 1)

    film = torch.zeros((n_pix + 1, 8), device=dev)
    film.index_add_(0, torch.where(in_image, pix_a, n_pix), film_a.T)
    film.index_add_(0, torch.where(valid_b, order, n_pix), film_b.T)
    film = film[:n_pix]
    steps = steps_a + steps_b
    return {"image": film[:, 0:3], "sqr": film[:, 3:6], "weight": film[:, 6],
            "n_vertices": film[:, 7].sum(), "steps": steps,
            "alive_tile_steps": int(ats_a + ats_b),
            "total_tile_steps": steps * n_tiles, "pool": "sorted2"}


def render_pool_fused_striped(
    scene,
    seed: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    fov_axis: str = "x",
    bsdf_types: tuple = (0,),
    device: str | torch.device = "cuda",
):
    """Pixel-stationary pool on the bounce kernel: lane i owns pixel i for
    ``spp`` samples, so the film update is a dense per-lane add. The
    regeneration and the uniforms (a ``torch.Generator`` seeded by
    ``seed``) are PyTorch. Callers pass ``fused_supported`` scenes.

    Returns dict(image, sqr, weight, n_vertices, steps, pool="striped")."""
    dev, scene, n_pix, (tri_rows, em_rows, env_row, n_em) = _fused_setup(
        scene, width, height, max_depth, spp, device)
    types = tuple(bsdf_types)
    tile = bo.RT * 128
    N = -(-n_pix // tile) * tile
    gen = torch.Generator(device=dev).manual_seed(seed)
    lane = torch.arange(N, device=dev)
    budget = torch.where(lane < n_pix, spp, 0)
    px_base = (lane % width).float()
    py_base = (lane // width).float()
    # Rows 6-15 of a fresh lane: throughput 1, radiance 0, eta² 1, pdf 1.
    fresh_tail = _fresh_state(N, dev)[6:]

    state = _fresh_state(N, dev)
    meta = torch.full((N,), _PDELTA, dtype=torch.int32, device=dev)
    film = torch.zeros((7, N), device=dev)
    n_vert = torch.zeros((), dtype=torch.float64, device=dev)
    steps = 0
    while bool(_runnable(meta).any()):
        for _ in range(INNER):
            rnd = torch.rand((2 + bo.RAND_ROWS, N), generator=gen,
                             device=dev)
            state, meta = _regen(meta, meta & _PIX_MASK, budget, rnd,
                                 px_base, py_base, scene, width, height,
                                 fov_axis, state, fresh_tail)
            state, meta, splat = bo.bounce(
                state, meta, rnd[2:].contiguous(), tri_rows, em_rows, env_row,
                n_em, max_depth, rr_depth, types)
            film += splat[0:7]
            n_vert = n_vert + splat[7].sum(dtype=torch.float64)
            steps += 1

    film = film[:, :n_pix]
    return {"image": film[0:3].T, "sqr": film[3:6].T, "weight": film[6],
            "n_vertices": n_vert, "steps": steps, "pool": "striped"}


def render_pool_fused(
    scene,
    seed: int,
    n_lanes: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    fov_axis: str = "x",
    bsdf_types: tuple = (0,),
    device: str | torch.device = "cuda",
):
    """The regenerating pool on the bounce kernel: dead lanes restart on
    the next camera sample of a global counter, one ``ops.bounce.bounce``
    launch a step, the film scattered by pixel. ``n_lanes`` is a multiple
    of ``RT`` x 128. Callers pass ``fused_supported`` scenes.

    Returns dict(image, sqr, weight, n_vertices, steps, pool="fused")."""
    dev, scene, n_pix, (tri_rows, em_rows, env_row, n_em) = _fused_setup(
        scene, width, height, max_depth, 0, device)
    if n_lanes <= 0 or n_lanes % (bo.RT * 128):
        raise ValueError(f"n_lanes {n_lanes} is no positive multiple of "
                         f"{bo.RT * 128}")
    types = tuple(bsdf_types)
    total = n_pix * spp
    N = n_lanes
    gen = torch.Generator(device=dev).manual_seed(seed)
    fresh_tail = _fresh_state(N, dev)[6:]
    depth_bits = _DEPTH_MASK << _DEPTH_SHIFT
    film = torch.zeros((n_pix, 7), device=dev)
    cursor = torch.zeros((), dtype=torch.int64, device=dev)
    state = _fresh_state(N, dev)
    meta = torch.full((N,), _PDELTA, dtype=torch.int32, device=dev)
    n_vert = torch.zeros((), dtype=torch.float64, device=dev)
    steps = 0
    while bool(_runnable(meta).any()):
        pix_list, row_list = [], []
        for _ in range(INNER):
            rnd = torch.rand((2 + bo.RAND_ROWS, N), generator=gen, device=dev)
            alive = (meta & _ALIVE) != 0
            exh = (meta & _EXH) != 0
            pix = (meta & _PIX_MASK).long()
            need = ~alive & ~exh
            g = cursor + torch.cumsum(need.long(), 0) - 1
            start = need & (g < total)
            pix_n = torch.where(start, g % n_pix, 0)
            ro_n, rd_n = generate_rays(
                scene, torch.stack([(pix_n % width).float() + rnd[0],
                                    (pix_n // width).float() + rnd[1]], -1),
                width, height, fov_axis)
            exh = exh | (need & ~start)
            cursor = cursor + start.sum()
            pix = torch.where(start, pix_n, pix)
            state = torch.where(start, torch.cat([ro_n.T, rd_n.T,
                                                  fresh_tail]), state)
            meta = (pix.to(torch.int32)
                    | torch.where(alive | start, _ALIVE, 0)
                    | torch.where(exh, _EXH, 0)
                    | torch.where(start, _PDELTA, meta & _PDELTA)
                    | torch.where(start, 0, meta & depth_bits)
                    ).to(torch.int32)
            state, meta, splat = bo.bounce(
                state, meta, rnd[2:].contiguous(), tri_rows, em_rows,
                env_row, n_em, max_depth, rr_depth, types)
            n_vert = n_vert + splat[7].sum(dtype=torch.float64)
            pix_list.append(pix)
            row_list.append(splat[0:7])
            steps += 1
        film.index_add_(0, torch.cat(pix_list), torch.cat(row_list, 1).T)
    return {"image": film[:, 0:3], "sqr": film[:, 3:6], "weight": film[:, 6],
            "n_vertices": n_vert, "steps": steps, "pool": "fused"}


def blocked_layout(width: int, height: int, tile: int):
    """The blocked pool's lane layout: lane tiles of ``tile`` lanes cover
    image blocks 128 wide and tile // 128 high. Returns (pix_of_lane,
    in_image [N] bool, x, y [N] int64, n_tiles) as numpy, lanes past the
    image on pixel 0."""
    bw, bh = 128, tile // 128
    gx = -(-width // bw)
    gy = -(-height // bh)
    n_tiles = gx * gy
    lane = np.arange(n_tiles * tile, dtype=np.int64)
    t_idx = lane // tile
    o = lane % tile
    x = (t_idx % gx) * bw + o % 128
    y = (t_idx // gx) * bh + o // 128
    in_image = (x < width) & (y < height)
    return np.where(in_image, y * width + x, 0), in_image, x, y, n_tiles


def render_pool_fused_blocked(
    scene,
    seed: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    fov_axis: str = "x",
    bsdf_types: tuple = (0,),
    device: str | torch.device = "cuda",
):
    """Pixel-stationary pool on 2-D blocks: each lane tile (``lane_tile``
    lanes) covers an image block 128 wide, so slow pixels share tiles;
    the bounce kernel skips a tile none of whose lanes is alive
    (``tile_alive``). The film is a dense per-lane add, scattered to the
    pixels once. Callers pass ``fused_supported`` scenes.

    Returns dict(image, sqr, weight, n_vertices, steps, pool="blocked")."""
    dev, scene, n_pix, (tri_rows, em_rows, env_row, n_em) = _fused_setup(
        scene, width, height, max_depth, spp, device)
    types = tuple(bsdf_types)
    tile = bo.lane_tile(tri_rows.shape[1])
    pix_np, in_np, x, y, n_tiles = blocked_layout(width, height, tile)
    N = n_tiles * tile
    in_image = torch.as_tensor(in_np, device=dev)
    pix_of_lane = torch.as_tensor(pix_np, device=dev)
    px_base = torch.as_tensor(x, dtype=torch.float32, device=dev)
    py_base = torch.as_tensor(y, dtype=torch.float32, device=dev)
    budget = torch.where(in_image, spp, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fresh_tail = _fresh_state(N, dev)[6:]
    state = _fresh_state(N, dev)
    meta = torch.full((N,), _PDELTA, dtype=torch.int32, device=dev)
    film = torch.zeros((7, N), device=dev)
    n_vert = torch.zeros((), dtype=torch.float64, device=dev)
    steps = 0
    while bool(_runnable(meta).any()):
        for _ in range(INNER):
            rnd = torch.rand((2 + bo.RAND_ROWS, N), generator=gen, device=dev)
            state, meta = _regen(meta, meta & _PIX_MASK, budget, rnd, px_base,
                                 py_base, scene, width, height, fov_axis,
                                 state, fresh_tail)
            tile_alive = ((meta & _ALIVE) != 0).view(n_tiles, tile).any(1)
            state, meta, splat = bo.bounce(
                state, meta, rnd[2:].contiguous(), tri_rows, em_rows,
                env_row, n_em, max_depth, rr_depth, types,
                tile_alive=tile_alive.to(torch.int32))
            film += splat[0:7]
            n_vert = n_vert + splat[7].sum(dtype=torch.float64)
            steps += 1
    out = torch.zeros((n_pix + 1, 7), device=dev)
    out[torch.where(in_image, pix_of_lane, n_pix)] = film.T
    out = out[:n_pix]
    return {"image": out[:, 0:3], "sqr": out[:, 3:6], "weight": out[:, 6],
            "n_vertices": n_vert, "steps": steps, "pool": "blocked"}


def render_pool_fused_sorted(
    scene,
    seed: int,
    spp: int,
    width: int,
    height: int,
    spp_pilot: int = 8,
    max_depth: int = 10,
    rr_depth: int = 10,
    fov_axis: str = "x",
    bsdf_types: tuple = (0,),
    device: str | torch.device = "cuda",
):
    """sorted2's schedule on the bounce kernel: a pilot pass of
    ``spp_pilot`` spp with lane i on pixel i counts each pixel's path
    vertices, the other samples run with the pixels sorted by that cost;
    regeneration and uniforms are PyTorch, and a tile with no runnable
    lane is skipped (``tile_alive``). Callers pass ``fused_supported``
    scenes.

    Returns dict(image, sqr, weight, n_vertices, steps, alive_tile_steps,
    total_tile_steps, pool="sorted")."""
    if not 0 < spp_pilot < spp:
        raise ValueError(f"spp_pilot {spp_pilot} must lie in (0, {spp})")
    dev, scene, n_pix, (tri_rows, em_rows, env_row, n_em) = _fused_setup(
        scene, width, height, max_depth, spp, device)
    types = tuple(bsdf_types)
    tile = bo.lane_tile(tri_rows.shape[1])
    n_tiles = -(-n_pix // tile)
    N = n_tiles * tile
    lane = torch.arange(N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fresh_tail = _fresh_state(N, dev)[6:]

    def run_phase(pix_of_lane, budget):
        px_base = (pix_of_lane % width).float()
        py_base = (pix_of_lane // width).float()
        state = _fresh_state(N, dev)
        meta = torch.full((N,), _PDELTA, dtype=torch.int32, device=dev)
        film = torch.zeros((8, N), device=dev)
        ats = torch.zeros((), dtype=torch.int64, device=dev)
        steps = 0
        while bool(_runnable(meta).any()):
            for _ in range(INNER):
                rnd = torch.rand((2 + bo.RAND_ROWS, N), generator=gen,
                                 device=dev)
                state, meta = _regen(meta, meta & _PIX_MASK, budget, rnd,
                                     px_base, py_base, scene, width, height,
                                     fov_axis, state, fresh_tail)
                tile_alive = ((meta & _ALIVE) != 0).view(n_tiles, tile).any(1)
                ats = ats + tile_alive.sum()
                state, meta, splat = bo.bounce(
                    state, meta, rnd[2:].contiguous(), tri_rows, em_rows,
                    env_row, n_em, max_depth, rr_depth, types,
                    tile_alive=tile_alive.to(torch.int32))
                film += splat
                steps += 1
        return film, steps, ats

    in_image = lane < n_pix
    pix_a = torch.where(in_image, lane, 0)
    film_a, steps_a, ats_a = run_phase(pix_a,
                                       torch.where(in_image, spp_pilot, 0))
    cost = torch.where(in_image, film_a[7], -1.0)
    order = torch.argsort(cost, stable=True)
    valid_b = cost[order] >= 0.0
    film_b, steps_b, ats_b = run_phase(
        torch.where(valid_b, order, 0),
        torch.where(valid_b, spp - spp_pilot, 0))
    film = torch.zeros((n_pix + 1, 8), device=dev)
    film.index_add_(0, torch.where(in_image, pix_a, n_pix), film_a.T)
    film.index_add_(0, torch.where(valid_b, order, n_pix), film_b.T)
    film = film[:n_pix]
    steps = steps_a + steps_b
    return {"image": film[:, 0:3], "sqr": film[:, 3:6], "weight": film[:, 6],
            "n_vertices": film[:, 7].sum(), "steps": steps,
            "alive_tile_steps": int(ats_a + ats_b),
            "total_tile_steps": steps * n_tiles, "pool": "sorted"}


def shuffled_layout(n_pix: int, spp: int, groups: int, tile: int):
    """The shuffled pool's lane count and per-lane sample budgets: lane i
    owns the pixels perm[c * N + i] of the slots c < groups that fall in
    the image, ``spp`` samples each. Returns (N, budget [N]) as numpy."""
    n_lanes = -(-n_pix // (groups * tile)) * tile
    lane = np.arange(n_lanes, dtype=np.int64)
    budget = spp * np.maximum(0, (n_pix - 1 - lane) // n_lanes + 1)
    return n_lanes, budget


def render_pool_fused_shuffled(
    scene,
    seed: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    fov_axis: str = "x",
    bsdf_types: tuple = (0,),
    groups: int = 8,
    device: str | torch.device = "cuda",
):
    """Pool with shuffled multi-pixel lanes: lane i renders, one slot at a
    time, the ``groups`` pixels perm[c * N + i] of a random permutation of
    the image (``torch.randperm`` of a generator seeded by ``seed``), spp
    samples each, so a lane's work averages over its pixels. The film is
    a dense [groups, N, 7] accumulator, un-permuted once. Callers pass
    ``fused_supported`` scenes.

    Returns dict(image, sqr, weight, n_vertices, steps, pool="shuffled")."""
    dev, scene, n_pix, (tri_rows, em_rows, env_row, n_em) = _fused_setup(
        scene, width, height, max_depth, spp * groups, device)
    types = tuple(bsdf_types)
    tile = bo.lane_tile(tri_rows.shape[1])
    N, budget_np = shuffled_layout(n_pix, spp, groups, tile)
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(n_pix, generator=gen, device=dev)
    perm_padded = torch.cat([perm, torch.zeros(groups * N - n_pix,
                                               dtype=perm.dtype, device=dev)])
    lane = torch.arange(N, device=dev)
    budget = torch.as_tensor(budget_np, device=dev)
    fresh_tail = _fresh_state(N, dev)[6:]
    state = _fresh_state(N, dev)
    meta = torch.full((N,), _PDELTA, dtype=torch.int32, device=dev)
    film = torch.zeros((groups, N, 7), device=dev)
    n_vert = torch.zeros((), dtype=torch.float64, device=dev)
    slots = torch.arange(groups, device=dev)[:, None]
    steps = 0
    while bool(_runnable(meta).any()):
        for _ in range(INNER):
            rnd = torch.rand((2 + bo.RAND_ROWS, N), generator=gen, device=dev)
            # A drained lane's slot is past the last: it reads the last
            # slot's pixel (the reference's gather clamps) and stays idle.
            slot = ((meta & _PIX_MASK).long() // spp).clamp_max(groups - 1)
            pix_n = perm_padded[slot * N + lane]
            state, meta = _regen(meta, meta & _PIX_MASK, budget, rnd,
                                 (pix_n % width).float(),
                                 (pix_n // width).float(), scene, width,
                                 height, fov_axis, state, fresh_tail)
            s = (meta & _PIX_MASK).long()
            state, meta, splat = bo.bounce(
                state, meta, rnd[2:].contiguous(), tri_rows, em_rows,
                env_row, n_em, max_depth, rr_depth, types)
            n_vert = n_vert + splat[7].sum(dtype=torch.float64)
            # A path's slot is (s - 1) // spp: s counts its own sample.
            cur = (s - 1).clamp_min(0) // spp
            film += (slots == cur[None, :]).float()[:, :, None] \
                * splat[0:7].T[None]
            steps += 1
    flat = film.reshape(groups * N, 7)[:n_pix]
    out = torch.zeros((n_pix, 7), device=dev)
    out[perm] = flat
    return {"image": out[:, 0:3], "sqr": out[:, 3:6], "weight": out[:, 6],
            "n_vertices": n_vert, "steps": steps, "pool": "shuffled"}


def render_wavefront(scene, cfg, spp: int = 16, seed: int = 1234,
                     n_lanes: int = 1 << 18, nee: bool = True,
                     device: str | torch.device = "cuda"):
    """Render ``scene`` at ``cfg``'s size and depth: a scene with a medium
    takes the wave renderer ``renderer.render`` (the pools carry no medium
    state); on the card, a ``fused_supported`` scene takes
    ``render_pool_fused_sorted2`` at ``spp`` >= 4 and
    ``render_pool_fused_striped`` below; every other scene (textures, bump
    maps, delta lights, env maps, BSDFs the kernels lack, subsurface
    scattering, baked first), and every CPU render, the eager
    ``render_pool``, with the scene's bump maps where ``cfg.has_bump``.

    Returns dict(image [H, W, 3] (the mean), sqr [H, W, 3], weight [H, W],
    raw [H, W, 3] (the sum), as numpy; n_vertices, steps, and pool, the
    name of the pool that ran: "scan" for the wave renderer)."""
    dev = resolve_device(device)
    w, h = cfg.width, cfg.height
    if cfg.has_medium:
        from .renderer import render

        return render(scene, cfg, spp=spp, seed=seed, nee=nee, device=dev)
    if cfg.has_sss and not cfg.sss_baked:
        from .subsurface import bake_subsurface

        scene = bake_subsurface(scene, cfg, seed=seed, device=dev)
    if dev.type == "cuda" and fused_supported(scene, cfg, nee):
        kw = dict(spp=spp, width=w, height=h, max_depth=cfg.max_depth,
                  rr_depth=cfg.rr_depth, fov_axis=cfg.fov_axis,
                  bsdf_types=tuple(cfg.bsdf_types), device=dev)
        if spp >= 4:
            out = render_pool_fused_sorted2(
                scene, seed, spp_pilot=max(1, min(8, spp // 4)), **kw)
        else:
            out = render_pool_fused_striped(scene, seed, **kw)
    else:
        out = render_pool(
            scene, torch.Generator(device=dev).manual_seed(seed),
            n_lanes=min(n_lanes, w * h * spp), spp=spp, width=w, height=h,
            max_depth=cfg.max_depth, rr_depth=cfg.rr_depth, nee=nee,
            bsdf_types=cfg.bsdf_types or None, fov_axis=cfg.fov_axis,
            has_bump=cfg.has_bump, has_sss=cfg.has_sss, device=dev)
    image, weight = out["image"], out["weight"]
    return {
        "image": (image / weight.clamp_min(1.0)[:, None]).reshape(h, w, 3)
        .cpu().numpy(),
        "sqr": out["sqr"].reshape(h, w, 3).cpu().numpy(),
        "weight": weight.reshape(h, w).cpu().numpy(),
        "raw": image.reshape(h, w, 3).cpu().numpy(),
        "n_vertices": int(out["n_vertices"]),
        "steps": int(out["steps"]),
        "pool": out["pool"],
    }
