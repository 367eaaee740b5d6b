"""Primary-sample-space Metropolis light transport (PSSMLT) and energy
redistribution path tracing (ERPT) (port of sdmm_tpu/render/pssmlt.py).

Many short independent chains advance in lockstep, one Python loop step a
mutation, with expected-value splats added to the film by ``index_add_``
(whose atomic adds on the card sum a pixel's splats in no fixed order). A
path is a deterministic function of its primary-sample vector (one slot a
random decision, ``pss_dims``), so a mutation perturbs that vector:
``_small_step`` (Kelemen's exponential kick with wrap-around), and for
``mutations="veach"`` also ``_lens_step`` (only the two image-plane dims, an
exponentially distributed pixel radius) and ``_tail_step`` (only the last
bounce's dims).

The mutation steps take their uniforms; the renderers draw theirs from a
``torch.Generator`` at the top of each step, and seed the chains from the
bootstrap with numpy's ``default_rng(seed).choice``, as the reference does.
Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bsdf import bsdf as bsdf_mod
from ..core.device import resolve_device
from ..core.frame import to_local, to_world
from ..core.spectrum import luminance
from ..scene import emitters
from ..scene.scene import scene_to
from ..scene.sensor import generate_rays
from . import intersect as isect
from .volpath import mi_weight, shading_frame, spawn


def pss_dims(max_depth: int) -> int:
    """2 pixel dims + 7 a bounce (3 NEE; 4 BSDF: container, lobe, 2D)."""
    return 2 + 7 * max_depth


def eval_path(scene, u: torch.Tensor, width: int, height: int,
              max_depth: int = 6, bsdf_types: tuple | None = None,
              fov_axis: str = "x", nee: bool = True, device="cuda") -> dict:
    """The path contribution of PSS vectors u [N, pss_dims]: the NEE path
    tracer of ``volpath.trace_wave`` without Russian roulette (a fixed
    dimension), every decision read from ``u``. Returns dict(pix [N] int32,
    value [N, 3], lum [N])."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    u = u.to(dev, torch.float32)
    n = u.shape[0]
    pdf_over_area = emitters.tri_pdf_over_area(scene)
    px = u[:, 0] * width
    py = u[:, 1] * height
    pix = (py.to(torch.int32).clamp(0, height - 1) * width
           + px.to(torch.int32).clamp(0, width - 1))
    ro, rd = generate_rays(scene, torch.stack([px, py], -1), width, height,
                           fov_axis)

    li = torch.zeros((n, 3), device=dev)
    thr = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(n, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(max_depth):
        base = 2 + 7 * depth
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)

        le = emitters.eval_emitter(scene, it, -rd)
        if nee:
            pdf_nee = emitters.pdf_direct_hit(scene, pdf_over_area,
                                              hit["tri"], rd, hit["t"])
            w_hit = torch.where(prev_delta | (depth == 0), 1.0,
                                mi_weight(prev_pdf, pdf_nee))
        else:
            w_hit = torch.ones(n, device=dev)
        li = li + torch.where(active[:, None], thr * le * w_hit[:, None], 0.0)
        li = li + torch.where((active & ~hit["valid"])[:, None],
                              thr * emitters.env_eval(scene, rd), 0.0)
        active = active & hit["valid"]

        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)

        if nee:
            ls = emitters.sample_direct(scene, it["p"], u[:, base],
                                        u[:, base + 1:base + 3])
            wo_l = to_local(s_ax, t_ax, n_ax, ls["d"])
            f, pdf_b = bsdf_mod.eval_pdf_full(params, wi_local, wo_l,
                                              types=bsdf_types)
            cand = (active & ls["valid"] & bsdf_mod.has_smooth(params)
                    & (ls["pdf"] > 0.0))
            occ = isect.occluded(scene, spawn(it["p"], it["ng"], ls["d"]),
                                 ls["d"], ls["dist"] * (1.0 - 1e-3))
            w = torch.where(ls["delta"], 1.0, mi_weight(ls["pdf"], pdf_b))
            contrib = (thr * f * ls["radiance"]
                       * (w / ls["pdf"].clamp_min(1e-20))[:, None])
            li = li + torch.where((cand & ~occ)[:, None], contrib, 0.0)

        bs = bsdf_mod.sample_full(params, wi_local, u[:, base + 3],
                                  u[:, base + 4], u[:, base + 5:base + 7],
                                  types=bsdf_types)
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        active = active & (bs["weight"] > 0.0).any(-1)
        thr = thr * bs["weight"]
        ro = spawn(it["p"], it["ng"], wo_world)
        rd = wo_world
        prev_pdf = bs["pdf"]
        prev_delta = bs["delta"]

    li = torch.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)
    return {"pix": pix, "value": li, "lum": luminance(li)}


def _small_step(u: torch.Tensor, r: torch.Tensor, r_sign: torch.Tensor,
                s1: float = 1.0 / 1024.0, s2: float = 1.0 / 64.0):
    """Kelemen's exponential perturbation with wrap-around: each dim moves
    by s2·(s1/s2)^r, up when r_sign ≥ 0.5 (r, r_sign: uniforms of u's
    shape)."""
    sign = torch.where(r_sign < 0.5, -1.0, 1.0)
    mag = s2 * torch.exp(-math.log(s2 / s1) * r)
    v = u + sign * mag
    return v - torch.floor(v)


def _lens_step(u: torch.Tensor, r: torch.Tensor, r_phi: torch.Tensor,
               width: int, height: int, r1: float = 0.1,
               r2_frac: float = 0.05):
    """Veach's lens perturbation in PSS: only the image-plane dims move, by
    an exponentially distributed pixel radius between r1 and r2_frac·width
    (r, r_phi: [N] uniforms)."""
    r2 = r2_frac * width
    rad = r2 * torch.exp(-math.log(r2 / r1) * r)
    phi = 2.0 * math.pi * r_phi
    v = u.clone()
    v[:, 0] = v[:, 0] + rad * torch.cos(phi) / width
    v[:, 1] = v[:, 1] + rad * torch.sin(phi) / height
    return v - torch.floor(v)


def _tail_step(u: torch.Tensor, r: torch.Tensor, r_sign: torch.Tensor,
               n_bounce_dims: int = 7, s1: float = 1.0 / 256.0,
               s2: float = 1.0 / 16.0):
    """The caustic perturbation in PSS: only the last bounce's decision dims
    move (a small step on them), everything earlier replays (r, r_sign:
    [N, n_bounce_dims] uniforms)."""
    v = u.clone()
    v[:, -n_bounce_dims:] = _small_step(u[:, -n_bounce_dims:], r, r_sign,
                                        s1, s2)
    return v


def seed_chains(lum: np.ndarray, n_chains: int, seed: int) -> np.ndarray:
    """Chain seeds among the bootstrap samples, drawn ∝ their luminance by
    numpy's ``default_rng(seed).choice`` (so equal luminances give equal
    indices in both packages)."""
    probs = np.asarray(lum, dtype=np.float64)
    probs = probs / probs.sum()
    return np.random.default_rng(seed).choice(probs.shape[0], size=n_chains,
                                              p=probs)


def _splat(film, cur_pix, cur_val, cur_lum, prop, a, scale=None):
    """Expected-value splats: the current state with 1 - a, the proposal
    with a, each normalised by its own luminance."""
    w_cur = ((1.0 - a) / cur_lum.clamp_min(1e-12))[:, None] * cur_val
    w_prop = (a / prop["lum"].clamp_min(1e-12))[:, None] * prop["value"]
    if scale is not None:
        w_cur = w_cur * scale
        w_prop = w_prop * scale
    film.index_add_(0, cur_pix.long(),
                    torch.where((cur_lum > 0)[:, None], w_cur, 0.0))
    film.index_add_(0, prop["pix"].long(),
                    torch.where((prop["lum"] > 0)[:, None], w_prop, 0.0))


def _accept(accept, u_cur, u_prop, cur_pix, cur_val, cur_lum, prop):
    return (torch.where(accept[:, None], u_prop, u_cur),
            torch.where(accept, prop["pix"], cur_pix),
            torch.where(accept[:, None], prop["value"], cur_val),
            torch.where(accept, prop["lum"], cur_lum))


def render_pssmlt(scene, cfg, spp: int = 16, seed: int = 1234,
                  n_chains: int = 1 << 14, p_large: float = 0.3,
                  n_bootstrap: int = 1 << 16, max_depth: int | None = None,
                  mutations: str = "kelemen", device="cuda") -> dict:
    """Kelemen PSSMLT with expected-value splats (``mutations="veach"``: 30%
    large steps, 30% lens, 20% tail, 20% small). ``spp`` sets the budget to
    spp · W · H mutations. The normalisation b = E[f] comes from the
    bootstrap, whose samples also seed the chains ∝ f. Returns dict(image
    [H, W, 3] as numpy, b, acceptance)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    depth = max_depth or min(cfg.max_depth, 6)
    dims = pss_dims(depth)
    types = cfg.bsdf_types or None
    gen = torch.Generator(device=dev).manual_seed(seed)

    def measure(u):
        return eval_path(scene, u, w, h, max_depth=depth, bsdf_types=types,
                         fov_axis=cfg.fov_axis, device=dev)

    u0 = torch.rand((n_bootstrap, dims), generator=gen, device=dev)
    boot = measure(u0)
    b = float(boot["lum"].mean())
    if b <= 0:
        return {"image": np.zeros((h, w, 3)), "b": 0.0}
    idx = seed_chains(boot["lum"].cpu().numpy(), n_chains, seed)
    u_cur = u0[torch.as_tensor(idx, device=dev)]
    cur = measure(u_cur)
    cur_pix, cur_val, cur_lum = cur["pix"], cur["value"], cur["lum"]
    del boot

    n_steps = max(1, spp * n_pix // n_chains)
    film = torch.zeros((n_pix, 3), device=dev)
    acc_sum = torch.zeros((), device=dev)
    for _ in range(n_steps):
        sel = torch.rand(n_chains, generator=gen, device=dev)
        u_large = torch.rand((n_chains, dims), generator=gen, device=dev)
        kick = torch.rand((2, n_chains, dims), generator=gen, device=dev)
        u_acc = torch.rand(n_chains, generator=gen, device=dev)
        u_small = _small_step(u_cur, kick[0], kick[1])
        if mutations == "veach":
            lens = torch.rand((2, n_chains), generator=gen, device=dev)
            tail = torch.rand((2, n_chains, 7), generator=gen, device=dev)
            u_lens = _lens_step(u_cur, lens[0], lens[1], w, h)
            u_tail = _tail_step(u_cur, tail[0], tail[1])
            u_prop = torch.where(
                (sel < 0.3)[:, None], u_large,
                torch.where((sel < 0.6)[:, None], u_lens,
                            torch.where((sel < 0.8)[:, None], u_tail,
                                        u_small)))
        else:
            u_prop = torch.where((sel < p_large)[:, None], u_large, u_small)
        prop = measure(u_prop)
        a = (prop["lum"] / cur_lum.clamp_min(1e-12)).clamp(0.0, 1.0)
        a = torch.where(cur_lum <= 0, 1.0, a)
        _splat(film, cur_pix, cur_val, cur_lum, prop, a)
        u_cur, cur_pix, cur_val, cur_lum = _accept(
            u_acc < a, u_cur, u_prop, cur_pix, cur_val, cur_lum, prop)
        acc_sum = acc_sum + a.mean()

    # I_j = n_pix · b · E[1_j · C/f] (the pixel's mean radiance).
    img = film * (n_pix * b / (n_steps * n_chains))
    return {"image": img.reshape(h, w, 3).cpu().numpy(), "b": b,
            "acceptance": float(acc_sum) / n_steps}


def render_erpt(scene, cfg, spp: int = 8, seed: int = 1234,
                chains_per_seed_lum: float = 1.0, chain_length: int = 32,
                n_seeds: int = 1 << 14, max_depth: int | None = None,
                device="cuda") -> dict:
    """Energy redistribution path tracing: path-traced seeds spawn
    equal-energy Metropolis chains of small steps; a seed of luminance f
    starts one with probability min(f/e, 1) and energy max(f/e, 1)·e (e =
    b · chains_per_seed_lum), which deposits e/chain_length a mutation. As
    in the reference, ``spp`` does not set the budget: n_seeds chains of
    chain_length steps. Returns dict(image [H, W, 3] as numpy, b)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    depth = max_depth or min(cfg.max_depth, 6)
    dims = pss_dims(depth)
    types = cfg.bsdf_types or None
    gen = torch.Generator(device=dev).manual_seed(seed)

    def measure(u):
        return eval_path(scene, u, w, h, max_depth=depth, bsdf_types=types,
                         fov_axis=cfg.fov_axis, device=dev)

    u_cur = torch.rand((n_seeds, dims), generator=gen, device=dev)
    seeds = measure(u_cur)
    b = float(seeds["lum"].mean())
    if b <= 0:
        return {"image": np.zeros((h, w, 3)), "b": 0.0}
    e_chain = b * chains_per_seed_lum
    ratio = seeds["lum"] / e_chain
    spawn_u = torch.rand(n_seeds, generator=gen, device=dev)
    chain_e = torch.where(spawn_u < ratio.clamp_max(1.0),
                          ratio.clamp_min(1.0) * e_chain, 0.0)
    deposit = (chain_e / chain_length)[:, None]

    cur_pix, cur_val, cur_lum = seeds["pix"], seeds["value"], seeds["lum"]
    film = torch.zeros((n_pix, 3), device=dev)
    for _ in range(chain_length):
        kick = torch.rand((2, n_seeds, dims), generator=gen, device=dev)
        u_acc = torch.rand(n_seeds, generator=gen, device=dev)
        u_prop = _small_step(u_cur, kick[0], kick[1])
        prop = measure(u_prop)
        a = (prop["lum"] / cur_lum.clamp_min(1e-12)).clamp(0.0, 1.0)
        _splat(film, cur_pix, cur_val, cur_lum, prop, a, scale=deposit)
        u_cur, cur_pix, cur_val, cur_lum = _accept(
            u_acc < a, u_cur, u_prop, cur_pix, cur_val, cur_lum, prop)

    img = film * (n_pix / n_seeds)
    return {"image": img.reshape(h, w, 3).cpu().numpy(), "b": b}
