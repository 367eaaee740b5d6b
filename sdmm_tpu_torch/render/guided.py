"""Guided path tracer with SDMM directional sampling and training-vertex
collection: the regenerating lane pool (port of sdmm_tpu/render/guided.py
``GuideState``, ``canonical``, ``trace_wave_guided``,
``render_pool_guided``, ``_finalize_collect``, ``guided_fused_supported``
and ``render_pool_guided_fused``).

Every pool step traces one bounce for all lanes; dead lanes restart on the
next camera sample of a global counter until ``spp`` samples per pixel are
spent. ``render_pool_guided`` is the eager pool: guided sampling
(conditioning + sample + pdf) runs through ``ops.guided_sample``, the CUDA
kernel for tensors on the card and its plain twin on the CPU, on the packed
float32 leaf table of ``ops.guided_sample.pack_sample_table``, built once
per render.
The eager pool shades every ported BSDF type, reads the scene's textures
and its environment (a constant or an env map), and carries each lane's
medium: free flights against the surface hit, Henyey-Greenstein scatters
that are never recorded for training, and medium switches at crossed
boundaries. It adds the baked dipole exitance where the scene has
subsurface instances, which the reference's guided pool omits (ROADMAP
§C); like the reference's, it applies no bump map, and without NEE the
delta lights add nothing.
``trace_wave_guided`` is the scan tracer of a fixed wave of camera rays,
one step per bounce, whose training vertices' incident radiance comes from
a backward recursion over the steps; the trainer takes it for
``pooled_training=False`` and above 2^20 pixels. It samples through the
same kernel and carries media and the dipole exitance as the pool does.
With a learned-BSDF table in the guide state (``GuideState.learned``), or
mixtures of K != 16 components (``GuideState.kernel_table`` None: the
kernel is specialised to 16, as the reference's is), both take the
reference's mixture route instead of the kernel: every lane conditions its
leaf's mixture (``create_conditional``) and draws from it with explicit
uniforms; with a learned table, lanes whose BSDF has a learned mixture
draw from the product of the two (``mixture.product``, h = 0.3), with the
product's pdf in the MIS.
``render_pool_guided_fused`` is the frozen-model pool on the fused
``ops.guided_step`` kernels (trace + shade). NEE is compiled out (MIS weight
1 on emitter hits), as in the reference package's guided path.
``render_pool_guided_sorted2`` and ``render_pool_guided_striped`` run the
same kernels pixel-stationary: the first sorts the pixels by the path
vertices a pilot pass measured, the second binds lane i to pixel i.
SDMM_TPU_NO_FUSED=1 shuts ``guided_fused_supported``, as in the reference.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..bsdf import bsdf as bsdf_mod
from ..core import draws
from ..core.device import resolve_device
from ..core.frame import to_local, to_world
from ..guiding import mixture as mix
from ..guiding import stree
from ..guiding.learned_bsdf import PRODUCT_TOP_K, to_world_conditional
from ..ops import bounce as bo
from ..ops import guided_sample as gso
from ..ops import guided_step as gst
from ..scene import emitters
from ..scene.scene import scene_to
from ..scene.sensor import generate_rays
from . import medium as med
from .intersect import intersect, surface_interaction
from .volpath import shading_frame

RAY_EPS = 1e-4
PDF_CLAMP = 0.1  # one-sample MIS pdf clamp of the recorded training weights


class GuideState(NamedTuple):
    """Device-side guiding cache: mixtures, leaf tables, the packed
    [L, 353] conditioning table the guided-sampling kernel reads (None for
    mixtures of K != 16 components, which take the mixture route) and the
    learned-BSDF table of product sampling (None: no product)."""

    sdmm: mix.SDMM  # [L, K]
    prep: mix.Prepared
    initialized: torch.Tensor  # [L] bool — leaf has a trained mixture
    tables: dict  # STree device tables
    aabb_lo: torch.Tensor  # [3] world-space scene AABB min
    inv_norm: float  # 1 / spatial normalization
    kernel_table: torch.Tensor | None  # [L, 353] (pack_guided_rows(...).T)
    learned: dict | None = None  # learned_bsdf.build_learned_table

    def to(self, device) -> "GuideState":
        def mv(x):
            return x.to(device) if isinstance(x, torch.Tensor) else x

        return GuideState(
            sdmm=mix.SDMM(*(mv(x) for x in self.sdmm)),
            prep=mix.Prepared(*(mv(x) for x in self.prep)),
            initialized=mv(self.initialized),
            tables={k: mv(v) for k, v in self.tables.items()},
            aabb_lo=mv(self.aabb_lo), inv_norm=self.inv_norm,
            kernel_table=mv(self.kernel_table),
            learned=None if self.learned is None
            else {k: mv(v) for k, v in self.learned.items()},
        )


def canonical(gs: GuideState, p: torch.Tensor) -> torch.Tensor:
    """World position → canonical guiding coordinates."""
    return (p - gs.aabb_lo) * gs.inv_norm


def mixture_route(gs: GuideState) -> bool:
    """Whether guided lanes take the mixture route instead of the
    ``guided_sample`` kernel: a learned-BSDF table, or mixtures of
    K != 16 components (no kernel table)."""
    return gs.learned is not None or gs.kernel_table is None


def _mixture_sampler(gs: GuideState, packed, leaf, c_pos, it, frame,
                     wi_local, delta_only, ug, up, bsdf_fraction):
    """Guided sampling on the mixture route (the reference's, no kernel):
    condition the leaf mixtures on ``c_pos`` and draw from them with the
    uniforms ``ug`` [N, 3]; with a learned-BSDF table, lanes whose BSDF
    has a learned mixture draw from the product with its top-2 pruned
    conditional with ``up`` [N, 3] (None without a table). Returns
    (d_guide, g_ok, guide_ok, guide_valid, h, use_product, pdf) where
    pdf(wo_world) is the guided pdf of the MIS."""
    weight_g, prep_g, use_guide = mix.unpack_conditioning(
        packed[leaf.long()], gs.sdmm.weight.shape[-1])
    cond = mix.create_conditional(prep_g, weight_g, c_pos)
    guide_valid = use_guide & cond.valid
    guide_ok = guide_valid & ~delta_only
    h = torch.where(guide_ok, bsdf_fraction, 1.0)
    d_guide, g_ok = mix.conditional_sample_from_uniforms(cond, ug[:, 0],
                                                         ug[:, 1:3])
    if gs.learned is None:
        use_product = torch.zeros_like(guide_ok)

        def pdf(wo_world):
            return torch.where(guide_ok, mix.conditional_pdf(cond, wo_world),
                               0.0)

        return d_guide, g_ok, guide_ok, guide_valid, h, use_product, pdf
    learned_cond, has_dmm = to_world_conditional(
        gs.learned, it["bsdf"], *frame, wi_local)
    prod = mix.product(cond, mix.prune_conditional(learned_cond,
                                                   PRODUCT_TOP_K))
    use_product = guide_ok & has_dmm & prod.valid
    h = torch.where(use_product, 0.3, h)
    d_prod, p_ok = mix.conditional_sample_from_uniforms(prod, up[:, 0],
                                                        up[:, 1:3])
    d_guide = torch.where(use_product[:, None], d_prod, d_guide)
    g_ok = torch.where(use_product, p_ok, g_ok)

    def pdf(wo_world):
        return torch.where(guide_ok, torch.where(
            use_product, mix.conditional_pdf(prod, wo_world),
            mix.conditional_pdf(cond, wo_world)), 0.0)

    return d_guide, g_ok, guide_ok, guide_valid, h, use_product, pdf


def trace_wave_guided(
    scene,
    gs: GuideState,
    generator: torch.Generator,
    ro: torch.Tensor,
    rd: torch.Tensor,
    max_depth: int = 10,
    rr_depth: int = 10,
    bsdf_fraction: float = 0.5,
    bsdf_types: tuple | None = None,
    saved_samples_per_path: int = 8,
    has_medium: bool = False,
    has_hetero: bool = False,
    has_sss: bool = False,
    sample_table: torch.Tensor | None = None,
):
    """Trace one guided wave for ``max_depth`` + 1 steps (the last only as
    the radiance target of the last vertex; it never reaches the image).
    ``sample_table`` is ``pack_sample_table(gs.kernel_table)``, packed here
    when not given. ``generator``: a ``torch.Generator``, or a mesh rank's
    ``core/draws.WaveBlock`` of the wave.

    Returns (li [N, 3], samples): flat [(max_depth)·N] pos, dir, weight
    (-1 where invalid), valid, terminal (the path's last valid vertex), and
    n_cond_try, n_cond_ok, n_vertices. Each vertex's incident radiance is
    I_d = le_{d+1} + w_{d+1}·I_{d+1} (the RR 1/q compensation left out, as
    in the reference's scan); only a path's last
    ``saved_samples_per_path`` valid vertices are kept."""
    n = ro.shape[0]
    dev = ro.device
    learned = gs.learned is not None
    mixture = mixture_route(gs)
    if mixture:
        packed = mix.pack_conditioning(gs.prep, gs.sdmm.weight,
                                       gs.initialized)
    elif sample_table is None:
        sample_table = gso.pack_sample_table(gs.kernel_table)
    thr = torch.ones((n, 3), device=dev)
    eta_sq = torch.ones(n, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    li = torch.zeros((n, 3), device=dev)
    med_id = scene.ambient_med.to(torch.int32).expand(n).clone()
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    outs = {k: [] for k in ("le", "bweight", "pdf", "cacheable", "pos",
                            "dir")}
    for depth in range(max_depth + 1):
        rnd = draws.rand((n, 14), generator, dev)
        u_sel, u1, u2, u0 = rnd[:, 0], rnd[:, 1], rnd[:, 2:4], rnd[:, 4]
        ug, u_rr, u_m, u_ph = rnd[:, 5:8], rnd[:, 8], rnd[:, 9], rnd[:, 10:12]
        if learned:
            up = draws.rand((n, 3), generator, dev)

        hit = intersect(scene, ro, rd)
        it = surface_interaction(scene, ro, rd, hit)
        if has_medium:
            ms = (med.sample_distance_hetero(scene, med_id, generator, ro,
                                             rd, hit["t"]) if has_hetero
                  else med.sample_distance(scene, med_id, u_m, hit["t"]))
            scattered = active & ms["scattered"]
            med_w = torch.where(active[:, None], ms["weight"], 1.0)
            thr = thr * med_w
        else:
            scattered = torch.zeros(n, dtype=torch.bool, device=dev)
            med_w = torch.ones((n, 3), device=dev)

        in_depth = depth < max_depth
        counts[2] += (active & in_depth).sum()
        le_eff = emitters.eval_emitter(scene, it, -rd) + torch.where(
            hit["valid"][:, None], 0.0, emitters.env_eval(scene, rd))
        if has_sss:
            from .subsurface import sss_lo_factor

            le_eff = le_eff + sss_lo_factor(scene, it, -rd)
        le_eff = torch.where(scattered[:, None], 0.0, le_eff)
        if in_depth:
            li = li + torch.where(active[:, None], thr * le_eff, 0.0)
        le_out = torch.where(active[:, None], le_eff, 0.0)
        active = active & (hit["valid"] | scattered)
        on_surface = active & ~scattered

        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        wi_dot_geo = (it["ng"] * -rd).sum(-1)
        on_surface = on_surface & ~(wi_dot_geo * wi_local[..., 2] < 0.0)

        c_pos = canonical(gs, it["p"])
        leaf = stree.find_leaf(gs.tables, c_pos)
        delta_only = bsdf_mod.is_delta_only(params)
        bs = bsdf_mod.sample_full(params, wi_local, u0, u1, u2,
                                  types=bsdf_types)
        wo_bsdf_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        if mixture:
            d_guide, g_ok, guide_ok, guide_valid, h, _, pdf_fn = \
                _mixture_sampler(gs, packed, leaf, c_pos, it,
                                 (s_ax, t_ax, n_ax), wi_local, delta_only,
                                 ug, up if learned else None, bsdf_fraction)
            take_bsdf = (u_sel < h) | ~guide_ok
        else:
            d_guide, g_ok, pdf_g, pdf_b, guide_valid = gso.guided_sample(
                sample_table, leaf, c_pos.contiguous(),
                wo_bsdf_world.contiguous(), ug.contiguous())
            guide_ok = guide_valid & ~delta_only
            h = torch.where(guide_ok, bsdf_fraction, 1.0)
            take_bsdf = (u_sel < h) | ~guide_ok
            gmm_pdf = torch.where(guide_ok, torch.where(take_bsdf, pdf_b,
                                                        pdf_g), 0.0)
        tb = take_bsdf[:, None]
        wo_local = torch.where(tb, bs["wo"], to_local(s_ax, t_ax, n_ax,
                                                      d_guide))
        wo_world = torch.where(tb, wo_bsdf_world, d_guide)
        if mixture:
            gmm_pdf = pdf_fn(wo_world)
        sampled_delta = take_bsdf & bs["delta"]
        f_eval, bsdf_pdf_eval = bsdf_mod.eval_pdf_full(
            params, wi_local, wo_local, types=bsdf_types)
        mis_pdf = h * bsdf_pdf_eval + (1.0 - h) * gmm_pdf
        bweight = torch.where(
            sampled_delta[:, None], bs["weight"] / h.clamp_min(1e-6)[:, None],
            f_eval / mis_pdf.clamp_min(1e-20)[:, None])
        ok_sample = torch.where(
            sampled_delta, (bs["weight"] > 0.0).any(-1),
            (mis_pdf > 0.0) & (f_eval > 0.0).any(-1) & (take_bsdf | g_ok))
        wo_dot_geo = (it["ng"] * wo_world).sum(-1)
        ok_sample = ok_sample & ~(wo_dot_geo * wo_local[..., 2] <= 0.0)
        surf_cont = on_surface & ok_sample
        active_next = surf_cont | scattered

        cond_try = on_surface & gs.initialized[leaf.long()] & ~delta_only
        counts[0] += cond_try.sum()
        counts[1] += (cond_try & guide_valid).sum()
        outs["pdf"].append(mis_pdf.clamp_min(PDF_CLAMP))
        outs["cacheable"].append(surf_cont & ~sampled_delta)
        outs["pos"].append(c_pos)

        thr = thr * torch.where(surf_cont[:, None], bweight, 1.0)
        thr = torch.where(active_next[:, None], thr, 0.0)
        eta_sq = eta_sq * torch.where(surf_cont, bs["eta"] * bs["eta"], 1.0)
        q = (thr.max(-1).values * eta_sq).clamp_max(0.95).detach()
        if depth + 1 >= rr_depth:
            active_next = active_next & (u_rr < q)
            thr = torch.where(active_next[:, None],
                              thr / q.clamp_min(1e-6)[:, None], thr)

        ro_next = it["p"] + it["ng"] * torch.where(
            wo_dot_geo > 0, RAY_EPS, -RAY_EPS)[:, None]
        if has_medium:
            d_med, _ = med.hg_sample(scene.med_g[med_id.long()], rd, u_ph)
            p_med = ro + ms["t"][:, None] * rd
            med_id = med.update_medium(scene, med_id, hit["tri"], wi_dot_geo,
                                       wo_dot_geo, surf_cont & active_next)
            ro_next = torch.where(scattered[:, None], p_med, ro_next)
            wo_world = torch.where(scattered[:, None], d_med, wo_world)
        # The backward recursion sees the whole step's factor: the
        # segment's medium weight times the bounce weight.
        step_w = med_w * torch.where(surf_cont[:, None], bweight, 1.0)
        outs["le"].append(med_w * le_out)
        outs["bweight"].append(torch.where(active_next[:, None], step_w, 0.0))
        outs["dir"].append(wo_world)
        ro, rd, active = ro_next, wo_world, active_next

    d_slots = max_depth
    incident = [None] * d_slots
    acc = torch.zeros((n, 3), device=dev)
    for d in range(d_slots - 1, -1, -1):
        acc = outs["le"][d + 1] + outs["bweight"][d + 1] * acc
        incident[d] = acc
    incident = torch.stack(incident)  # [D, N, 3]
    pdf = torch.stack(outs["pdf"][:d_slots])
    sample_weight = (incident / pdf[..., None]).mean(-1)
    valid = torch.stack(outs["cacheable"][:d_slots]) \
        & torch.isfinite(sample_weight) & (sample_weight >= 0.0)
    rev_rank = valid.flip(0).long().cumsum(0).flip(0)
    terminal = valid & (rev_rank == 1)
    valid = valid & (rev_rank <= saved_samples_per_path)
    pos = torch.stack(outs["pos"][:d_slots])
    dirs = torch.stack(outs["dir"][:d_slots])
    samples = {
        "n_cond_try": counts[0], "n_cond_ok": counts[1],
        "n_vertices": counts[2],
        "pos": torch.nan_to_num(torch.where(valid[..., None], pos, 0.5),
                                nan=0.5, posinf=0.5, neginf=0.5)
        .reshape(-1, 3),
        "dir": torch.where(valid[..., None], dirs,
                           torch.tensor([0.0, 0.0, 1.0], device=dev))
        .reshape(-1, 3),
        "weight": torch.where(valid, sample_weight, -1.0).reshape(-1),
        "valid": valid.reshape(-1),
        "terminal": terminal.reshape(-1),
    }
    return li, samples


def render_pool_guided(
    scene,
    gs: GuideState,
    generator: torch.Generator,
    n_lanes: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    bsdf_fraction: float = 0.5,
    bsdf_types: tuple | None = None,
    fov_axis: str = "x",
    collect_cap: int = 0,
    saved_samples_per_path: int = 8,
    has_medium: bool = False,
    has_hetero: bool = False,
    has_sss: bool = False,
    device: str | torch.device = "cuda",
):
    """Guided render of width×height at ``spp`` with a regenerating lane
    pool; uniforms come from ``generator`` (on ``device``). ``has_medium``
    carries each lane's medium (``has_hetero``: delta tracking through
    grid densities); ``has_sss`` adds the baked dipole exitance.

    Returns dict(image, sqr [n_pix, 3], weight [n_pix], n_vertices, steps,
    n_cond_try, n_cond_ok, n_product: the image vertices that sampled by
    the learned-BSDF product). With ``collect_cap`` > 0 it also records
    training vertices: each recorded vertex is emitted at once with its
    canonical position, direction, clamped pdf, post-vertex throughput and a
    snapshot of the path radiance so far; each path logs its final training
    radiance at death; the vertex incident radiance is then reconstructed by
    the telescoping identity I_d = (L_path − L_snap_d) / thr_d (RR 1/q
    included). Paths then run one extra bounce past ``max_depth`` as the
    radiance target of their last vertex; it never reaches the image. The
    result gains ``samples`` (pos/dir/weight/valid/terminal, [collect_cap])
    and ``n_emitted``.
    """
    if n_lanes <= 0:
        raise ValueError("n_lanes must be positive")
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    gs = gs.to(dev)
    learned = gs.learned is not None
    mixture = mixture_route(gs)
    if mixture:
        packed = mix.pack_conditioning(gs.prep, gs.sdmm.weight,
                                       gs.initialized)
    else:
        sample_table = gso.pack_sample_table(gs.kernel_table)
    collect = collect_cap > 0
    extra = 1 if collect else 0
    n_pix = width * height
    total = n_pix * spp
    N = n_lanes

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
    pix = zeros(N, dtype=torch.int64)
    depth0 = zeros(N, dtype=torch.int64)
    alive = zeros(N, dtype=torch.bool)
    exhausted = zeros(N, dtype=torch.bool)
    med_id = zeros(N, dtype=torch.int32)
    n_vert = zeros(dtype=torch.int64)
    n_cond_try = zeros(dtype=torch.int64)
    n_cond_ok = zeros(dtype=torch.int64)
    n_product = zeros(dtype=torch.int64)
    if collect:
        lt = zeros(N, 3)
        path_id = zeros(N, dtype=torch.int64)
        seq = zeros(N, dtype=torch.int64)
        # One spare row each: emissions past the cap and lanes that are not
        # done write there (the reference's scatter mode="drop").
        samp = zeros(collect_cap + 1, 16)
        samp_cursor = zeros(1, dtype=torch.int64)
        path_rad = zeros(total + 1, 3)

    steps = 0
    while bool((alive | ~exhausted).any()):
        rnd = torch.rand((N, 11), generator=generator, device=dev)
        u_regen, u_sel, u1 = rnd[:, 0:2], rnd[:, 2], rnd[:, 3]
        u2, u0, ug, u_rr = rnd[:, 4:6], rnd[:, 6], rnd[:, 7:10], rnd[:, 10]
        if has_medium:
            rnd_m = torch.rand((N, 3), generator=generator, device=dev)
        if learned:
            up = torch.rand((N, 3), generator=generator, device=dev)

        # --- Regenerate dead lanes from the global sample counter ---
        need = ~alive & ~exhausted
        rank = torch.cumsum(need.long(), 0) - 1
        g = cursor + rank
        in_budget = need & (g < total)
        pix_n = torch.where(in_budget, g % n_pix, 0)
        px = (pix_n % width).float() + u_regen[:, 0]
        py = (pix_n // width).float() + u_regen[:, 1]
        ro_n, rd_n = generate_rays(scene, torch.stack([px, py], -1), width,
                                   height, fov_axis)
        start = in_budget
        exhausted = exhausted | (need & ~in_budget)
        cursor = cursor + start.sum()
        s1 = start[:, None]
        pix = torch.where(start, pix_n, pix)
        ro = torch.where(s1, ro_n, ro)
        rd = torch.where(s1, rd_n, rd)
        thr = torch.where(s1, 1.0, thr)
        li = torch.where(s1, 0.0, li)
        eta2 = torch.where(start, 1.0, eta2)
        depth0 = torch.where(start, 0, depth0)
        alive = alive | start
        if has_medium:
            med_id = torch.where(start, scene.ambient_med, med_id)
        if collect:
            lt = torch.where(s1, 0.0, lt)
            path_id = torch.where(start, g, path_id)
            seq = torch.where(start, 0, seq)

        # --- One guided bounce ---
        hit = intersect(scene, ro, rd)
        it = surface_interaction(scene, ro, rd, hit)
        if has_medium:
            # A free flight against the surface hit; a lane that scatters
            # bounces by the phase function and is never recorded.
            ms = (med.sample_distance_hetero(scene, med_id, generator, ro,
                                             rd, hit["t"]) if has_hetero
                  else med.sample_distance(scene, med_id, rnd_m[:, 0],
                                           hit["t"]))
            scattered = alive & ms["scattered"]
            thr = thr * torch.where(alive[:, None], ms["weight"], 1.0)
        else:
            scattered = torch.zeros(N, dtype=torch.bool, device=dev)
        in_img = depth0 < max_depth
        le = emitters.eval_emitter(scene, it, -rd)
        env = emitters.env_eval(scene, rd)
        le_eff0 = le + torch.where(hit["valid"][:, None], 0.0, env)
        if has_sss:
            from .subsurface import sss_lo_factor

            le_eff0 = le_eff0 + sss_lo_factor(scene, it, -rd)
        # A scatter comes before the surface: its emitter is not reached.
        le_eff0 = torch.where(scattered[:, None], 0.0, le_eff0)
        li = li + torch.where((alive & in_img)[:, None], thr * le_eff0, 0.0)
        if collect:
            lt = lt + torch.where(alive[:, None], thr * le_eff0, 0.0)
        on_surface = alive & hit["valid"] & ~scattered
        n_vert = n_vert + (alive & in_img).sum()

        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        wi_dot_geo = (it["ng"] * -rd).sum(-1)
        on_surface = on_surface & ~(wi_dot_geo * wi_local[..., 2] < 0.0)

        c_pos = canonical(gs, it["p"])
        leaf = stree.find_leaf(gs.tables, c_pos)
        delta_only = bsdf_mod.is_delta_only(params)
        bs = bsdf_mod.sample_full(params, wi_local, u0, u1, u2,
                                  types=bsdf_types)
        wo_bsdf_world = to_world(s_ax, t_ax, n_ax, bs["wo"])

        if mixture:
            d_guide, g_ok, guide_ok, guide_valid, h, use_product, pdf_fn = \
                _mixture_sampler(gs, packed, leaf, c_pos, it,
                                 (s_ax, t_ax, n_ax), wi_local, delta_only,
                                 ug, up if learned else None, bsdf_fraction)
            take_bsdf = (u_sel < h) | ~guide_ok
            n_product = n_product + (on_surface & in_img & use_product).sum()
        else:
            d_guide, g_ok, pdf_g, pdf_b, guide_valid = gso.guided_sample(
                sample_table, leaf, c_pos.contiguous(),
                wo_bsdf_world.contiguous(), ug.contiguous())
            guide_ok = guide_valid & ~delta_only
            h = torch.where(guide_ok, bsdf_fraction, 1.0)
            take_bsdf = (u_sel < h) | ~guide_ok
            gmm_pdf = torch.where(guide_ok, torch.where(take_bsdf, pdf_b,
                                                        pdf_g), 0.0)
        # Valid-conditional counter as the reference's mixture path counts
        # it: tries are lanes on an initialized leaf, successes those with a
        # valid conditional (guide_valid folds in the initialized flag).
        cond_try = on_surface & in_img & gs.initialized[leaf.long()] \
            & ~delta_only
        n_cond_try = n_cond_try + cond_try.sum()
        n_cond_ok = n_cond_ok + (cond_try & guide_valid).sum()

        wo_guide_local = to_local(s_ax, t_ax, n_ax, d_guide)
        tb = take_bsdf[:, None]
        wo_local = torch.where(tb, bs["wo"], wo_guide_local)
        wo_world = torch.where(tb, wo_bsdf_world, d_guide)
        if mixture:
            gmm_pdf = pdf_fn(wo_world)
        sampled_delta = take_bsdf & bs["delta"]

        f_eval, bsdf_pdf_eval = bsdf_mod.eval_pdf_full(
            params, wi_local, wo_local, types=bsdf_types)
        mis_pdf = h * bsdf_pdf_eval + (1.0 - h) * gmm_pdf

        w_smooth = f_eval / mis_pdf.clamp_min(1e-20)[:, None]
        w_delta = bs["weight"] / h.clamp_min(1e-6)[:, None]
        bweight = torch.where(sampled_delta[:, None], w_delta, w_smooth)
        ok_sample = torch.where(
            sampled_delta,
            (bs["weight"] > 0.0).any(-1),
            (mis_pdf > 0.0) & (f_eval > 0.0).any(-1) & (take_bsdf | g_ok),
        )
        wo_dot_geo = (it["ng"] * wo_world).sum(-1)
        ok_sample = ok_sample & ~(wo_dot_geo * wo_local[..., 2] <= 0.0)

        depth = depth0 + 1
        surf_cont = on_surface & ok_sample
        survive = (surf_cont | scattered) & (depth < max_depth + extra)
        cont = surf_cont & survive
        thr_next = thr * torch.where(cont[:, None], bweight, 1.0)
        eta_sq = eta2 * torch.where(cont, bs["eta"] * bs["eta"], 1.0)

        q = (thr_next.max(-1).values * eta_sq).clamp_max(0.95).detach()
        do_rr = depth + 1 >= rr_depth
        survive = survive & ~(do_rr & (u_rr >= q))
        thr_next = torch.where((do_rr & survive)[:, None],
                               thr_next / q.clamp_min(1e-6)[:, None], thr_next)

        # --- Terminate finished paths: fused film scatter ---
        done = alive & ~survive
        val = torch.where(done[:, None], torch.nan_to_num(
            li, nan=0.0, posinf=0.0, neginf=0.0), 0.0)
        film.index_add_(0, pix, torch.cat(
            [val, val * val, done.float()[:, None]], dim=-1))
        if collect:
            rec = on_surface & ok_sample & ~sampled_delta & in_img
            rrank = torch.cumsum(rec.long(), 0) - 1
            sidx = samp_cursor + rrank
            ok_emit = rec & (sidx < collect_cap)
            srow = torch.cat([
                c_pos, wo_world, mis_pdf.clamp_min(PDF_CLAMP)[:, None],
                thr_next, lt, path_id.float()[:, None], seq.float()[:, None],
                torch.zeros((N, 1), device=dev),
            ], dim=-1)
            samp.index_copy_(0, torch.where(ok_emit, sidx, collect_cap), srow)
            samp_cursor = samp_cursor + rec.sum()
            seq = torch.where(rec, seq + 1, seq)
            path_rad.index_copy_(
                0, torch.where(done, path_id, total),
                torch.nan_to_num(lt, nan=0.0, posinf=0.0, neginf=0.0))

        ro_next = it["p"] + it["ng"] * torch.where(
            wo_dot_geo > 0, RAY_EPS, -RAY_EPS)[:, None]
        if has_medium:
            # Henyey-Greenstein scatters (importance-sampled exactly: the
            # albedo is in the free-flight weight) and medium switches at
            # crossed boundaries.
            d_med, _ = med.hg_sample(scene.med_g[med_id.long()], rd,
                                     rnd_m[:, 1:3])
            p_med = ro + ms["t"][:, None] * rd
            med_id = med.update_medium(scene, med_id, hit["tri"], wi_dot_geo,
                                       wo_dot_geo, surf_cont & survive)
            ro_next = torch.where(scattered[:, None], p_med, ro_next)
            wo_world = torch.where(scattered[:, None], d_med, wo_world)
        ro = ro_next
        rd = wo_world
        thr = thr_next
        eta2 = eta_sq
        depth0 = torch.where(survive, depth, 0) & 0xF
        alive = survive
        steps += 1

    out = {
        "image": film[:, 0:3],
        "sqr": film[:, 3:6],
        "weight": film[:, 6],
        "n_vertices": n_vert,
        "steps": steps,
        "n_cond_try": n_cond_try,
        "n_cond_ok": n_cond_ok,
        "n_product": n_product,
    }
    if collect:
        out["samples"] = _finalize_collect(
            samp[:collect_cap], path_rad[:total], samp_cursor[0],
            saved_samples_per_path)
        out["samples"].update(n_cond_try=n_cond_try, n_cond_ok=n_cond_ok,
                              n_vertices=n_vert)
        out["n_emitted"] = samp_cursor[0]
    return out


def _finalize_collect(samp, path_rad, cursor, S: int) -> dict:
    """Per-vertex training weights from the emitted records and the
    per-path final radiance; keeps the last ``S`` recorded vertices of each
    path and marks its last valid vertex ``terminal``."""
    cap = samp.shape[0]
    total = path_rad.shape[0]
    dev = samp.device
    filled = torch.arange(cap, device=dev) < torch.clamp(cursor, max=cap)
    pos = samp[:, 0:3]
    dirs = samp[:, 3:6]
    pdf = samp[:, 6]
    thr = samp[:, 7:10]
    lsnap = samp[:, 10:13]
    pid = samp[:, 13].long()
    seq = samp[:, 14]

    diff = path_rad[pid] - lsnap
    inc = torch.where(thr > 0.0, diff / torch.where(thr > 0.0, thr, 1.0), 0.0)
    w = inc.mean(-1) / pdf.clamp_min(PDF_CLAMP)

    def seg_max(mask):
        out = torch.full((total + 1,), -1.0, device=dev)
        out.scatter_reduce_(0, torch.where(mask, pid, total),
                            torch.where(mask, seq, -1.0), "amax",
                            include_self=True)
        return out[pid]

    keep = filled & (seq >= seg_max(filled) + 1.0 - S)
    valid = keep & torch.isfinite(w) & (w >= 0.0)
    terminal = valid & (seq == seg_max(valid))
    safe_pos = torch.where(valid[:, None], pos, 0.5)
    safe_dir = torch.where(valid[:, None], dirs,
                           torch.tensor([0.0, 0.0, 1.0], device=dev))
    return {
        "pos": torch.nan_to_num(safe_pos, nan=0.5, posinf=0.5, neginf=0.5),
        "dir": safe_dir,
        "weight": torch.where(valid, w, -1.0),
        "valid": valid,
        "terminal": terminal,
    }


def guided_fused_supported(scene, cfg, gs: GuideState) -> bool:
    """Whether ``render_pool_guided_fused`` can render ``scene``: in-kernel
    BSDF types only, no bump map, a triangle table within MAX_TRIS, no env
    map, no delta light, no texture, no medium, no subsurface scattering
    and a pixel index that fits the meta word (the terms of
    ``render.wavefront.fused_supported`` but NEE's), a kernel table (K =
    16) and no learned-BSDF table (product sampling takes the eager pool).
    SDMM_TPU_NO_FUSED=1 shuts it."""
    return bool(
        os.environ.get("SDMM_TPU_NO_FUSED") != "1"
        and gs.kernel_table is not None
        and gs.learned is None
        and len(cfg.bsdf_types) > 0
        and all(t in bo.SUPPORTED_TYPES for t in cfg.bsdf_types)
        and not cfg.has_bump
        and not cfg.has_medium
        and not cfg.has_sss
        and scene.tri_v0.shape[0] <= bo.MAX_TRIS
        and scene.env_pdf.shape[0] <= 1
        and scene.pt_pos.shape[0] == 0
        and scene.textures.shape[1] <= 1
        and scene.proc_tex.shape[0] == 0
        and cfg.width * cfg.height <= bo._PIX_MASK
    )


INNER = 4  # pool steps per host check of the loop condition and film add


def render_pool_guided_fused(
    scene,
    gs: GuideState,
    generator: torch.Generator,
    n_lanes: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    bsdf_fraction: float = 0.5,
    bsdf_types: tuple = (0,),
    fov_axis: str = "x",
    device: str | torch.device = "cuda",
):
    """Frozen-model guided render on the fused kernels: per pool step,
    regenerate dead lanes, ``trace``, leaf lookup, ``shade`` on the bf16
    conditioning table (packed for the kernel once, here). The same
    estimator as ``render_pool_guided``
    (the pdf in the MIS weight comes from the same rounded rows the sample
    was drawn from, so it stays unbiased); callers pass
    ``guided_fused_supported`` scenes. Returns the same dict (without
    training vertices)."""
    if n_lanes <= 0:
        raise ValueError("n_lanes must be positive")
    dev, scene, gs, n_pix, tri_rows, env_row, shade_table = _guided_setup(
        scene, gs, width, height, max_depth, device)
    total = n_pix * spp
    N = n_lanes
    types = tuple(bsdf_types)

    film = torch.zeros((n_pix, 7), device=dev)
    cursor = torch.zeros((), dtype=torch.int64, device=dev)
    state = torch.zeros((16, N), device=dev)
    state[5] = 1.0
    state[6:9] = 1.0
    state[12] = 1.0
    meta = torch.zeros(N, dtype=torch.int32, device=dev)
    # Rows 6-15 of a fresh lane's state: throughput 1, radiance 0, eta² 1,
    # rows 13-15 zero.
    fresh_tail = torch.zeros((10, N), device=dev)
    fresh_tail[0:3] = 1.0
    fresh_tail[6] = 1.0
    # n_vert, n_cond_try, n_cond_ok: float64, exact past 2^24.
    sums = torch.zeros(3, dtype=torch.float64, device=dev)
    depth_bits = bo._DEPTH_MASK << bo._DEPTH_SHIFT
    steps = 0
    while bool((((meta & bo._ALIVE) != 0) | ((meta & bo._EXH) == 0)).any()):
        pix_list, row_list = [], []
        for _ in range(INNER):
            rnd = torch.rand((2 + gst.RAND_ROWS, N), generator=generator,
                             device=dev)
            alive = (meta & bo._ALIVE) != 0
            exhausted = (meta & bo._EXH) != 0
            pix = (meta & bo._PIX_MASK).long()

            # --- Regenerate dead lanes from the global sample counter ---
            need = ~alive & ~exhausted
            rank = torch.cumsum(need.long(), 0) - 1
            g = cursor + rank
            start = need & (g < total)
            pix_n = torch.where(start, g % n_pix, 0)
            px = (pix_n % width).float() + rnd[0]
            py = (pix_n // width).float() + rnd[1]
            ro_n, rd_n = generate_rays(scene, torch.stack([px, py], -1),
                                       width, height, fov_axis)
            exhausted = exhausted | (need & ~start)
            cursor = cursor + start.sum()
            pix = torch.where(start, pix_n, pix)
            fresh = torch.cat([ro_n.T, rd_n.T, fresh_tail], dim=0)
            state = torch.where(start[None, :], fresh, state)
            meta = (pix.to(torch.int32)
                    | torch.where(alive | start, bo._ALIVE, 0)
                    | torch.where(exhausted, bo._EXH, 0)
                    | torch.where(start, 0, meta & depth_bits)
                    ).to(torch.int32)

            # --- trace, leaf lookup, shade ---
            state, hit = gst.trace(state, meta, tri_rows, env_row, types)
            c_pos = canonical(gs, hit[0:3].T)
            leaf = stree.find_leaf(gs.tables, c_pos).to(torch.int32)
            state, meta, splat = gst.shade(
                state, meta, hit, c_pos.T.contiguous(), leaf, shade_table,
                rnd[2:].contiguous(), types, max_depth, rr_depth,
                bsdf_fraction)
            sums = sums + splat[7:10].sum(dim=1, dtype=torch.float64)
            pix_list.append(pix)
            row_list.append(splat[0:7])
        film.index_add_(0, torch.cat(pix_list),
                        torch.cat(row_list, dim=1).T)
        steps += 1

    return {
        "image": film[:, 0:3],
        "sqr": film[:, 3:6],
        "weight": film[:, 6],
        "n_vertices": sums[0],
        "steps": steps,
        "n_cond_try": sums[1],
        "n_cond_ok": sums[2],
    }


RT_SHADE = 16  # the reference's shade lane tile, in rows of 128 lanes
RT_TRACE = 64  # its trace lane tile (16 past MAX_UNROLL_TRIS triangles)


def guided_sorted2_layout(n_pix: int, n_tris: int):
    """The guided sorted2 pool's lanes: (tile, n_lanes), tile the larger
    of the reference's trace and shade lane tiles at this size."""
    r0 = -(-n_pix // 128)
    r = -(-r0 // RT_SHADE) * RT_SHADE
    rt = RT_SHADE if n_tris > bo.MAX_UNROLL_TRIS else RT_TRACE
    while r % rt:
        rt //= 2
    tile = max(rt, RT_SHADE) * 128
    return tile, -(-n_pix // tile) * tile


class _PixelPool(NamedTuple):
    """What a pixel-stationary guided pool's phases share."""

    scene: object
    gs: GuideState
    generator: torch.Generator
    width: int
    height: int
    fov_axis: str
    tile: int  # lanes a tile
    tri_rows: torch.Tensor
    env_row: torch.Tensor
    shade_table: torch.Tensor
    types: tuple
    max_depth: int
    rr_depth: int
    bsdf_fraction: float


def _run_pixel_phase(p: _PixelPool, pix_of_lane, budget):
    """One phase of a pixel-stationary guided pool on trace + shade: lane
    i renders pixel ``pix_of_lane[i]`` for ``budget[i]`` samples (the meta
    word's pixel field counts them). Between host checks it runs INNER
    steps on the lanes of the tiles that still have a runnable lane,
    gathered into one wave: the reference skips a drained tile inside its
    kernels, the port's kernels take no tile flags, so the host leaves
    such tiles out. Returns (film [N, SPLAT_ROWS], the per-lane sums of
    the splats, and steps)."""
    from .wavefront import _regen  # wavefront imports this module

    dev = pix_of_lane.device
    n = pix_of_lane.shape[0]
    px = (pix_of_lane % p.width).float()
    py = (pix_of_lane // p.width).float()
    state = torch.zeros((16, n), device=dev)
    state[5] = 1.0
    state[6:9] = 1.0
    state[12] = 1.0
    meta = torch.where(budget > 0, 0, bo._EXH).to(torch.int32)
    film = torch.zeros((n, gst.SPLAT_ROWS), device=dev)
    # Rows 6-15 of a fresh lane: throughput 1, radiance 0, eta² 1.
    fresh_tail = torch.zeros((10, n), device=dev)
    fresh_tail[0:3] = 1.0
    fresh_tail[6] = 1.0
    n_tiles = n // p.tile
    steps = 0
    while True:
        runnable = ((meta & bo._ALIVE) != 0) | ((meta & bo._EXH) == 0)
        live = runnable.view(n_tiles, p.tile).any(1)
        if not bool(live.any()):
            return film, steps
        lanes = (live.nonzero()[:, 0, None] * p.tile + torch.arange(
            p.tile, device=dev)[None]).reshape(-1)
        m = lanes.shape[0]
        st, mt, sub_film = state[:, lanes], meta[lanes], film[lanes]
        spx, spy, sb = px[lanes], py[lanes], budget[lanes]
        for _ in range(INNER):
            rnd = torch.rand((2 + gst.RAND_ROWS, m), generator=p.generator,
                             device=dev)
            st, mt = _regen(mt, mt & bo._PIX_MASK, sb, rnd, spx, spy,
                            p.scene, p.width, p.height, p.fov_axis, st,
                            fresh_tail[:, :m], pdelta=False)
            st, hit = gst.trace(st, mt, p.tri_rows, p.env_row, p.types)
            c_pos = canonical(p.gs, hit[0:3].T)
            leaf = stree.find_leaf(p.gs.tables, c_pos).to(torch.int32)
            st, mt, splat = gst.shade(
                st, mt, hit, c_pos.T.contiguous(), leaf, p.shade_table,
                rnd[2:].contiguous(), p.types, p.max_depth, p.rr_depth,
                p.bsdf_fraction)
            sub_film += splat.T
            steps += 1
        state[:, lanes], meta[lanes], film[lanes] = st, mt, sub_film


def _guided_setup(scene, gs, width, height, max_depth, device):
    """The fused guided pools' start: the device, the scene and guide
    state on it, the pixel count, the triangle and env rows and the bf16
    shade table; raises where the guide state has no K = 16 table or the
    image or ``max_depth`` does not fit the meta word."""
    if gs.kernel_table is None:
        raise ValueError("the fused guided pools need a K = 16 kernel table")
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    gs = gs.to(dev)
    n_pix = width * height
    if n_pix > bo._PIX_MASK:
        raise ValueError(f"{n_pix} pixels do not fit the lane meta word")
    if max_depth > bo._DEPTH_MASK + 1:
        raise ValueError(f"max_depth {max_depth} > {bo._DEPTH_MASK + 1}")
    tri_rows, _, env_row = bo.build_tables(scene)
    return dev, scene, gs, n_pix, tri_rows, env_row, gst.pack_shade_table(
        gs.kernel_table)


def _guided_out(film, steps):
    return {"image": film[:, 0:3], "sqr": film[:, 3:6], "weight": film[:, 6],
            "n_vertices": film[:, 7].sum(), "steps": steps,
            "n_cond_try": film[:, 8].sum(), "n_cond_ok": film[:, 9].sum()}


def render_pool_guided_sorted2(
    scene,
    gs: GuideState,
    generator: torch.Generator,
    spp: int,
    width: int,
    height: int,
    spp_pilot: int = 8,
    max_depth: int = 10,
    rr_depth: int = 10,
    bsdf_fraction: float = 0.5,
    bsdf_types: tuple = (0,),
    fov_axis: str = "x",
    device: str | torch.device = "cuda",
):
    """Cost-sorted pixel-stationary guided pool on trace + shade: a pilot
    pass of ``spp_pilot`` spp with lane i on pixel i counts each pixel's
    path vertices, and the other samples run with the pixels sorted by
    that cost, so each tile (``guided_sorted2_layout``) holds equal-cost
    pixels and drains as a unit; drained tiles are left out. The film is a
    dense per-lane sum, scattered to the pixels once a phase. The same
    estimator as ``render_pool_guided``; callers pass
    ``guided_fused_supported`` scenes. Returns its dict (without training
    vertices)."""
    if not 0 < spp_pilot < spp:
        raise ValueError(f"spp_pilot {spp_pilot} must lie in (0, {spp})")
    dev, scene, gs, n_pix, tri_rows, env_row, table = _guided_setup(
        scene, gs, width, height, max_depth, device)
    tile, N = guided_sorted2_layout(n_pix, scene.tri_v0.shape[0])
    pool = _PixelPool(scene, gs, generator, width, height, fov_axis, tile,
                      tri_rows, env_row, table, tuple(bsdf_types), max_depth,
                      rr_depth, bsdf_fraction)
    lane = torch.arange(N, device=dev)
    in_image = lane < n_pix
    pix_a = torch.where(in_image, lane, 0)
    film_a, steps_a = _run_pixel_phase(pool, pix_a,
                                       torch.where(in_image, spp_pilot, 0))
    cost = torch.where(in_image, film_a[:, 7], -1.0)
    order = torch.argsort(cost, stable=True)
    valid_b = cost[order] >= 0.0
    film_b, steps_b = _run_pixel_phase(
        pool, torch.where(valid_b, order, 0),
        torch.where(valid_b, spp - spp_pilot, 0))
    film = torch.zeros((n_pix + 1, gst.SPLAT_ROWS), device=dev)
    film.index_add_(0, torch.where(in_image, pix_a, n_pix), film_a)
    film.index_add_(0, torch.where(valid_b, order, n_pix), film_b)
    return _guided_out(film[:n_pix], steps_a + steps_b)


def render_pool_guided_striped(
    scene,
    gs: GuideState,
    generator: torch.Generator,
    spp: int,
    width: int,
    height: int,
    max_depth: int = 10,
    rr_depth: int = 10,
    bsdf_fraction: float = 0.5,
    bsdf_types: tuple = (0,),
    fov_axis: str = "x",
    device: str | torch.device = "cuda",
):
    """Pixel-stationary guided pool on trace + shade: lane i owns pixel i
    for ``spp`` samples (tiles of the reference's RT_TRACE x 128 lanes),
    so the film update is a dense per-lane add. Callers pass
    ``guided_fused_supported`` scenes. Returns ``render_pool_guided``'s
    dict (without training vertices)."""
    dev, scene, gs, n_pix, tri_rows, env_row, table = _guided_setup(
        scene, gs, width, height, max_depth, device)
    tile = RT_TRACE * 128
    N = -(-n_pix // tile) * tile
    pool = _PixelPool(scene, gs, generator, width, height, fov_axis, tile,
                      tri_rows, env_row, table, tuple(bsdf_types), max_depth,
                      rr_depth, bsdf_fraction)
    lane = torch.arange(N, device=dev)
    in_image = lane < n_pix
    film, steps = _run_pixel_phase(pool, lane,
                                   torch.where(in_image, spp, 0))
    return _guided_out(film[:n_pix], steps)
