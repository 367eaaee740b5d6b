"""Practical Path Guiding (Müller et al. 2017), the comparison integrator
(port of sdmm_tpu/guiding/ppg.py).

- The per-leaf directional quadtree over the cylindrical (cosθ, φ) square is
  a dense [leaves, RES²] histogram (RES = 64, a complete depth-6 quadtree).
  Once per iteration the adaptive structure is projected onto the finest
  level (``project_adaptive``): a node whose flux is at most rho·total stops
  subdividing and spreads its flux uniformly over its finest cells.
  Sampling the projected histogram uniformly within a cell has the
  distribution of a hierarchical descent of the adaptive tree.
- Records splat bilinearly over the 4 nearest finest cells (directional box
  filter); the record position is jittered by ±half the leaf diagonal
  before the leaf lookup (spatial stochastic filter).
- The learned bsdfSamplingFraction (``bsdf_fraction_loss`` "kl" or "var"):
  a per-leaf logit θ stepped by Adam once per chunk of samples
  (``adam_fraction_steps``); "none" keeps the fixed fraction.
- Iterations double their spp (1, 2, 4, …); the spatial split threshold
  grows as sqrt(spp/4)·stree_threshold; each iteration's histograms
  replace the previous ones in every leaf with ≥ 64 records.

Every random draw comes from a ``torch.Generator`` seeded from (seed,
iteration, spp pass, wave). Intersection goes through
``render.intersect`` (the mt_sweep kernel up to 1,024 triangles, clas_cull
above, on the card).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..bsdf import bsdf as bsdf_mod
from ..core.device import resolve_device
from ..core.frame import to_local, to_world
from ..render import film as film_mod
from ..render.intersect import intersect, surface_interaction
from ..render.volpath import shading_frame
from ..scene import emitters
from ..scene.scene import scene_to
from ..scene.sensor import generate_rays
from .stree import STree, find_leaf
from .trainer import _seeded

RES = 64
LEVELS = 6  # log2(RES): depth of the complete quadtree
FOUR_PI = 4.0 * math.pi


def dir_to_uv(d: torch.Tensor):
    """Direction → (y = (cosθ + 1)/2, x = φ/2π) unit-square coords."""
    ct = ((d[..., 2] + 1.0) * 0.5).clamp(0.0, 1.0 - 1e-7)
    phi = torch.atan2(d[..., 1], d[..., 0])
    u = torch.remainder(phi / (2.0 * math.pi), 1.0)
    return ct, u


def dir_to_cell(d: torch.Tensor) -> torch.Tensor:
    ct, u = dir_to_uv(d)
    xi = (u * RES).to(torch.int32).clamp(0, RES - 1)
    yi = (ct * RES).to(torch.int32).clamp(0, RES - 1)
    return yi * RES + xi


def cell_to_dir(cell: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Cell + in-cell jitter [..., 2] → direction (uniform within the cell
    in the cylindrical measure)."""
    yi = torch.div(cell, RES, rounding_mode="floor").float()
    xi = torch.remainder(cell, RES).float()
    return _uv_to_dir(yi + jitter[..., 0], xi + jitter[..., 1])


def _uv_to_dir(fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    ct = (fy / RES) * 2.0 - 1.0
    phi = (fx / RES) * 2.0 * math.pi
    st = torch.sqrt((1.0 - ct * ct).clamp_min(0.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def project_adaptive(hist: torch.Tensor, rho: float = 0.01):
    """[L, RES²] raw flux → (eff [L, RES²], eff_row [L, RES], total [L]):
    descend the mip pyramid; a node with flux ≤ rho·total stops
    subdividing and spreads its flux uniformly (÷4 a level) over its
    descendants."""
    L = hist.shape[0]
    mips = [hist.reshape(L, RES, RES)]
    for _ in range(LEVELS):
        m = mips[-1]
        r = m.shape[1] // 2
        mips.append(m.reshape(L, r, 2, r, 2).sum(dim=(2, 4)))
    mips = mips[::-1]  # level 0 = [L, 1, 1], the root
    total = mips[0][:, 0, 0]
    thresh = (rho * total)[:, None, None]
    val = mips[0]
    stopped = mips[0] <= thresh
    for lvl in range(1, LEVELS + 1):
        val_up = val.repeat_interleave(2, 1).repeat_interleave(2, 2)
        stop_up = stopped.repeat_interleave(2, 1).repeat_interleave(2, 2)
        val = torch.where(stop_up, val_up * 0.25, mips[lvl])
        stopped = stop_up | (mips[lvl] <= thresh)
    return val.reshape(L, RES * RES), val.sum(dim=2), total


def grid_pdf(eff2d_g: torch.Tensor, total_g: torch.Tensor,
             d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of directions ``d`` under the gathered projected
    rows ``eff2d_g`` [N, RES] (the row holding d's cosθ band) and the leaf
    totals ``total_g`` [N]."""
    _, u = dir_to_uv(d)
    xi = (u * RES).to(torch.int64).clamp(0, RES - 1)
    mass = eff2d_g.gather(-1, xi[..., None])[..., 0]
    frac = torch.where(total_g > 0, mass / total_g.clamp_min(1e-20), 0.0)
    return frac * (RES * RES) / FOUR_PI


def _cdf_pick(w: torch.Tensor, u: torch.Tensor):
    """Index ∝ the rows w [N, R] at uniforms u [N]; returns (idx, mass)."""
    cdf = torch.cumsum(w, dim=-1)
    uu = u[..., None] * cdf[..., -1:]
    idx = (uu >= cdf).sum(-1).clamp(0, w.shape[-1] - 1)
    return idx, w.gather(-1, idx[..., None])[..., 0]


def grid_sample(eff2d: torch.Tensor, eff_row_g: torch.Tensor,
                leaf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Two-stage (cosθ row, then φ column) CDF sampling of the projected
    histogram with uniform jitter in the finest cell. eff2d: [L·RES, RES];
    eff_row_g: [N, RES] the gathered row sums; u: [N, 4] uniforms (row,
    column, 2 jitter)."""
    yi, _ = _cdf_pick(eff_row_g, u[:, 0])
    row = eff2d[leaf.long() * RES + yi]
    xi, _ = _cdf_pick(row, u[:, 1])
    return _uv_to_dir(yi.float() + u[:, 2], xi.float() + u[:, 3])


def trace_wave_ppg(scene, eff2d, eff_row, total, theta, initialized, tables,
                   aabb_lo, inv_norm, generator: torch.Generator, ro, rd,
                   max_depth: int = 10, rr_depth: int = 10,
                   bsdf_fraction: float = 0.5,
                   bsdf_types: tuple | None = None,
                   learn_fraction: bool = False):
    """A PPG-guided wave of ``max_depth`` + 1 steps, one Python step per
    bounce (every step adds its emission to the image, as the reference's
    scan does); returns (li [N, 3], samples: flat [max_depth·N] records for
    training, their incident radiance from a backward pass over the steps).

    eff2d: [L·RES, RES] projected flux; eff_row: [L, RES] row sums;
    total: [L]; theta: [L] logit of the learned bsdfSamplingFraction."""
    n = ro.shape[0]
    dev = ro.device
    thr = torch.ones((n, 3), device=dev)
    eta_sq = torch.ones(n, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    li = torch.zeros((n, 3), device=dev)
    outs = {k: [] for k in ("le", "bweight", "wo_pdf", "bsdf_pdf", "g_pdf",
                            "fcos", "cacheable", "pos", "leaf", "dir")}
    n_vert = torch.zeros((), device=dev)
    for depth in range(max_depth + 1):
        rnd = torch.rand((n, 10), generator=generator, device=dev)
        u_sel, u1, u2, u0 = rnd[:, 0], rnd[:, 1], rnd[:, 2:4], rnd[:, 4]
        ug, u_rr = rnd[:, 5:9], rnd[:, 9]

        hit = intersect(scene, ro, rd)
        it = surface_interaction(scene, ro, rd, hit)
        le_eff = emitters.eval_emitter(scene, it, -rd) + torch.where(
            hit["valid"][:, None], 0.0, emitters.env_eval(scene, rd))
        li = li + torch.where(active[:, None], thr * le_eff, 0.0)
        outs["le"].append(torch.where(active[:, None], le_eff, 0.0))
        active = active & hit["valid"]

        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        wi_dot_geo = (it["ng"] * -rd).sum(-1)
        active = active & ~(wi_dot_geo * wi_local[..., 2] < 0.0)

        c_pos = (it["p"] - aabb_lo) * inv_norm
        leaf = find_leaf(tables, c_pos).long()
        row_g = eff_row[leaf]
        total_g = total[leaf]
        guide_ok = initialized[leaf] & ~bsdf_mod.is_delta_only(params) \
            & (total_g > 0)
        frac = torch.sigmoid(theta[leaf]) if learn_fraction \
            else torch.full((n,), bsdf_fraction, device=dev)
        h = torch.where(guide_ok, frac, 1.0)

        take_bsdf = (u_sel < h) | ~guide_ok
        bs = bsdf_mod.sample_full(params, wi_local, u0, u1, u2,
                                  types=bsdf_types)
        d_guide = grid_sample(eff2d, row_g, leaf, ug)
        tb = take_bsdf[:, None]
        wo_world = torch.where(tb, to_world(s_ax, t_ax, n_ax, bs["wo"]),
                               d_guide)
        wo_local = torch.where(tb, bs["wo"],
                               to_local(s_ax, t_ax, n_ax, d_guide))
        sampled_delta = take_bsdf & bs["delta"]

        f_eval, bsdf_pdf = bsdf_mod.eval_pdf_full(params, wi_local, wo_local,
                                                  types=bsdf_types)
        # The pdf row of wo (not the sampled row when the BSDF sampled).
        ct_wo, _ = dir_to_uv(wo_world)
        y_wo = (ct_wo * RES).to(torch.int64).clamp(0, RES - 1)
        g_pdf = torch.where(guide_ok, grid_pdf(eff2d[leaf * RES + y_wo],
                                               total_g, wo_world), 0.0)
        mis_pdf = h * bsdf_pdf + (1.0 - h) * g_pdf
        bweight = torch.where(
            sampled_delta[:, None], bs["weight"] / h.clamp_min(1e-6)[:, None],
            f_eval / mis_pdf.clamp_min(1e-20)[:, None])
        ok = torch.where(sampled_delta, (bs["weight"] > 0).any(-1),
                         (mis_pdf > 0) & (f_eval > 0).any(-1))
        wo_dot_geo = (it["ng"] * wo_world).sum(-1)
        ok = ok & ~(wo_dot_geo * wo_local[..., 2] <= 0.0)
        active_next = active & ok
        cacheable = active_next & ~sampled_delta

        thr = thr * torch.where(active_next[:, None], bweight, 0.0)
        eta_sq = eta_sq * torch.where(active_next, bs["eta"] ** 2, 1.0)
        if depth + 1 >= rr_depth:
            q = (thr.max(-1).values * eta_sq).clamp_max(0.95)
            active_next = active_next & ~(u_rr >= q)
            thr = torch.where(active_next[:, None],
                              thr / q.clamp_min(1e-6)[:, None], thr)
        if depth < max_depth:
            n_vert = n_vert + active.sum()
        outs["bweight"].append(torch.where(active_next[:, None], bweight,
                                           0.0))
        # The unclamped combined pdf: PPG records woPdf as it is.
        outs["wo_pdf"].append(mis_pdf)
        outs["bsdf_pdf"].append(bsdf_pdf)
        outs["g_pdf"].append(g_pdf)
        outs["fcos"].append(f_eval.mean(-1))
        outs["cacheable"].append(cacheable)
        outs["pos"].append(c_pos)
        outs["leaf"].append(leaf)
        outs["dir"].append(wo_world)
        ro = it["p"] + it["ng"] * torch.where(wo_dot_geo > 0, 1e-4,
                                              -1e-4)[:, None]
        rd = wo_world
        active = active_next

    # Incident radiance of each vertex: I_d = le_{d+1} + w_{d+1}·I_{d+1}.
    incident = [None] * max_depth
    acc = torch.zeros((n, 3), device=dev)
    for d in range(max_depth - 1, -1, -1):
        acc = outs["le"][d + 1] + outs["bweight"][d + 1] * acc
        incident[d] = acc
    rad = torch.stack(incident).mean(-1)  # [D, N]

    def st(k):
        return torch.stack(outs[k][:max_depth])

    wo_pdf = st("wo_pdf")
    valid = st("cacheable") & torch.isfinite(rad) & (rad >= 0) & (wo_pdf > 0)
    samples = {
        "pos": torch.nan_to_num(torch.where(valid[..., None], st("pos"), 0.5),
                                nan=0.5).reshape(-1, 3),
        "leaf": st("leaf").reshape(-1),
        "dir": torch.where(valid[..., None], st("dir"),
                           torch.tensor([0.0, 0.0, 1.0], device=dev))
        .reshape(-1, 3),
        # The flux deposit: radiance / woPdf.
        "weight": torch.where(valid, rad / wo_pdf.clamp_min(1e-20), 0.0)
        .reshape(-1),
        "radiance": torch.where(valid, rad, 0.0).reshape(-1),
        "product": torch.where(valid, rad * st("fcos"), 0.0).reshape(-1),
        "wo_pdf": wo_pdf.reshape(-1),
        "bsdf_pdf": st("bsdf_pdf").reshape(-1),
        "g_pdf": st("g_pdf").reshape(-1),
        "valid": valid.reshape(-1),
        "n_vertices": n_vert,
    }
    return li, samples


def adam_fraction_steps(theta, m1, m2, t, grads_w, stat_w, leaf, valid,
                        n_chunks: int = 16, ratio_power: float = 1.0):
    """Mini-batched per-leaf Adam on the bsdfSamplingFraction logit (lr
    0.01, β 0.9/0.999, θ clamped to ±20, L2 0.01·θ). ``grads_w`` rows are
    the per-sample (product, woPdf, bsdfPdf, dTreePdf); the θ-dependent
    part of the gradient is recomputed per chunk at the current θ, summed
    per leaf and stepped once a chunk. Returns (theta, m1, m2, t)."""
    L = theta.shape[0]
    n = leaf.shape[0]
    dev = theta.device
    csz = -(-n // n_chunks)
    leaf = leaf.long()
    for ci in range(n_chunks):
        sl = slice(ci * csz, min((ci + 1) * csz, n))
        g, sw, lf, vd = grads_w[sl], stat_w[sl], leaf[sl], valid[sl]
        product, wo_pdf, bsdf_pdf, g_pdf = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        th = theta[lf]
        frac = torch.sigmoid(th)
        mixp = frac * bsdf_pdf + (1.0 - frac) * g_pdf
        ratio = torch.where(mixp > 0, product / mixp.clamp_min(1e-20),
                            0.0) ** ratio_power
        dl_df = -ratio / wo_pdf.clamp_min(1e-20) * (bsdf_pdf - g_pdf)
        grad = 0.01 * th + dl_df * frac * (1.0 - frac)
        grad = torch.where(vd & torch.isfinite(grad), grad, 0.0)
        w = torch.where(vd, sw, 0.0)
        gsum = torch.zeros(L, device=dev).index_add_(0, lf, grad * w)
        wsum = torch.zeros(L, device=dev).index_add_(0, lf, w)
        gbar = torch.where(wsum > 0, gsum / wsum.clamp_min(1e-20), 0.0)
        step = wsum > 0
        t = t + step.to(t.dtype)
        tf = t.float().clamp_min(1.0)
        lr = 0.01 * torch.sqrt(1.0 - 0.999 ** tf) / (1.0 - 0.9 ** tf)
        m1 = torch.where(step, 0.9 * m1 + 0.1 * gbar, m1)
        m2 = torch.where(step, 0.999 * m2 + 0.001 * gbar * gbar, m2)
        upd = lr * m1 / (torch.sqrt(m2) + 1e-8)
        theta = torch.where(step, theta - upd, theta).clamp(-20.0, 20.0)
    return theta, m1, m2, t


def splat(add_w, counts, pos, dirs, weight, valid, leaf, tables, u,
          stochastic: bool = True, box: bool = True):
    """The training deposit into the flat histograms ``add_w`` [L, RES²]
    and the per-leaf record counts (both updated in place): with
    ``stochastic`` the record position is jittered by (u - 0.5)·the leaf
    diagonal (u [N, 3] uniforms) before the leaf lookup; with ``box`` the
    flux splats bilinearly over the 4 nearest finest cells (φ wraps).
    Returns (add_w, counts, the leaf each record went to)."""
    if stochastic:
        lo = tables["leaf_lo"][leaf.long()]
        hi = tables["leaf_hi"][leaf.long()]
        leaf = find_leaf(tables, pos + (u - 0.5) * (hi - lo))
    leaf = leaf.long()
    w = torch.where(valid, weight, 0.0)
    flat = add_w.view(-1)
    ct, uu = dir_to_uv(dirs)
    base = leaf * (RES * RES)
    if box:
        fy = ct * RES - 0.5
        fx = uu * RES - 0.5
        y0 = torch.floor(fy)
        x0 = torch.floor(fx)
        wy1 = fy - y0
        wx1 = fx - x0
        y0 = y0.to(torch.int64)
        x0 = x0.to(torch.int64)
        idxs, vals = [], []
        for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
            for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
                yy = (y0 + dy).clamp(0, RES - 1)
                xx = torch.remainder(x0 + dx, RES)
                idxs.append(base + yy * RES + xx)
                vals.append(w * wy * wx)
        flat.index_add_(0, torch.cat(idxs), torch.cat(vals))
    else:
        flat.index_add_(0, base + dir_to_cell(dirs).long(), w)
    counts.index_add_(0, leaf, valid.to(counts.dtype))
    return add_w, counts, leaf


@dataclass
class PPGConfig:
    max_leaves: int = 2048
    stree_threshold: int = 4000  # sTreeThreshold
    bsdf_fraction: float = 0.5
    bsdf_fraction_loss: str = "none"  # "none" | "kl" | "var"
    rho: float = 0.01  # dTreeThreshold (the 1% subdivision rule)
    rays_per_wave: int = 1 << 16
    seed: int = 1234
    directional_filter: str = "box"
    spatial_filter: str = "stochastic"


class PPGTrainer:
    """The budget-doubling training loop: iteration i renders 2^i spp with
    the histograms of the iterations before it."""

    def __init__(self, scene, render_cfg, cfg: PPGConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = dev = resolve_device(device)
        self.scene = scene_to(scene, dev)
        self.render_cfg = render_cfg
        self.cfg = c = cfg or PPGConfig()
        lo = self.scene.aabb_lo.cpu().numpy().astype(np.float64)
        hi = self.scene.aabb_hi.cpu().numpy().astype(np.float64)
        ext = hi - lo
        self.spatial_norm = float(ext.max())
        eps = 1e-5
        self.tree = STree(-eps * np.ones(3), ext / self.spatial_norm + eps,
                          max_leaves=c.max_leaves,
                          split_threshold=c.stree_threshold)
        self.tree.split_to_depth(2)
        self.tables = self.tree.device_tables(dev)
        L = c.max_leaves
        self.hist = torch.zeros((L, RES * RES), device=dev)
        self.initialized = torch.zeros(L, dtype=torch.bool, device=dev)
        self.theta = torch.zeros(L, device=dev)
        self.adam_m1 = torch.zeros(L, device=dev)
        self.adam_m2 = torch.zeros(L, device=dev)
        self.adam_t = torch.zeros(L, dtype=torch.int32, device=dev)
        self.iteration = 0
        self.stats: list[dict] = []

    def _project(self):
        eff, eff_row, total = project_adaptive(self.hist, self.cfg.rho)
        return eff.reshape(-1, RES), eff_row, total

    def _apply_copies(self, copies):
        """Fresh leaf slots after splits: each takes half its source's
        histogram (the source keeps the other half, halved once per copy)
        and its fraction state; all sources are read before any write."""
        dev = self.device
        dst = torch.as_tensor([d for d, _ in copies], device=dev)
        src = torch.as_tensor([s for _, s in copies], device=dev)
        halvings = torch.bincount(src, minlength=self.hist.shape[0])
        self.hist = self.hist.index_copy(0, dst, self.hist[src] * 0.5)
        self.hist = self.hist * (0.5 ** halvings.float())[:, None]
        for name in ("initialized", "theta", "adam_m1", "adam_m2", "adam_t"):
            a = getattr(self, name)
            setattr(self, name, a.index_copy(0, dst, a[src]))

    def run(self, total_spp: int, verbose: bool = False):
        """Budget-doubling iterations 1, 2, 4, … spp (the last one cut to the
        budget); returns (the inverse-variance combination [H, W, 3], the
        per-iteration films)."""
        rc, c, dev = self.render_cfg, self.cfg, self.device
        w, h = rc.width, rc.height
        n_pix = w * h
        wave = min(c.rays_per_wave, n_pix)
        n_waves = -(-n_pix // wave)
        pix_all = torch.arange(n_waves * wave, device=dev) % n_pix
        learn = c.bsdf_fraction_loss != "none"
        ratio_power = 2.0 if c.bsdf_fraction_loss == "var" else 1.0
        inv_norm = 1.0 / self.spatial_norm
        iters = []
        spp_this = 1
        spp_done = 0
        while spp_done < total_spp:
            spp_this = min(spp_this, total_spp - spp_done)
            image = torch.zeros((n_pix, 3), device=dev)
            sqr = torch.zeros((n_pix, 3), device=dev)
            weight = torch.zeros(n_pix, device=dev)
            add_w = torch.zeros_like(self.hist)
            counts = torch.zeros(c.max_leaves, dtype=torch.int32, device=dev)
            eff2d, eff_row, total = self._project()
            t0 = time.time()
            for s in range(spp_this):
                for wv in range(n_waves):
                    gen = _seeded(dev, c.seed, self.iteration, s, wv)
                    idx = pix_all[wv * wave:(wv + 1) * wave]
                    u = torch.rand((idx.shape[0], 2), generator=gen,
                                   device=dev)
                    ro, rd = generate_rays(
                        self.scene, torch.stack([(idx % w).float() + u[:, 0],
                                                 (idx // w).float() + u[:, 1]],
                                                -1), w, h, rc.fov_axis)
                    li, samples = trace_wave_ppg(
                        self.scene, eff2d, eff_row, total, self.theta,
                        self.initialized, self.tables, self.scene.aabb_lo,
                        inv_norm, gen, ro, rd, max_depth=rc.max_depth,
                        rr_depth=rc.rr_depth, bsdf_fraction=c.bsdf_fraction,
                        bsdf_types=rc.bsdf_types or None,
                        learn_fraction=learn)
                    image, sqr, weight = film_mod.splat(
                        image, sqr, weight, idx, torch.nan_to_num(
                            li, nan=0.0, posinf=0.0, neginf=0.0))
                    u_s = torch.rand(samples["pos"].shape, generator=gen,
                                     device=dev)
                    splat(add_w, counts, samples["pos"], samples["dir"],
                          samples["weight"], samples["valid"],
                          samples["leaf"], self.tables, u_s,
                          c.spatial_filter == "stochastic",
                          c.directional_filter == "box")
                    if learn:
                        # Keyed on the record's own leaf, where its θ and
                        # g_pdf were evaluated.
                        gw = torch.stack([samples["product"],
                                          samples["wo_pdf"],
                                          samples["bsdf_pdf"],
                                          samples["g_pdf"]], -1)
                        (self.theta, self.adam_m1, self.adam_m2,
                         self.adam_t) = adam_fraction_steps(
                            self.theta, self.adam_m1, self.adam_m2,
                            self.adam_t, gw,
                            torch.ones_like(samples["wo_pdf"]),
                            samples["leaf"],
                            samples["valid"] & (samples["product"] > 0),
                            ratio_power=ratio_power)
            # Each trained leaf's histogram is replaced by this iteration's.
            counts_h = counts.cpu().numpy().astype(np.float64)
            trained = torch.as_tensor(counts_h >= 64, device=dev)
            self.hist = torch.where(trained[:, None], add_w, self.hist)
            self.initialized = self.initialized | trained
            self.tree.split_threshold = int(np.sqrt(spp_this / 4.0)
                                            * c.stree_threshold)
            copies = self.tree.refit(counts_h)
            if copies:
                self.tables = self.tree.device_tables(dev)
                self._apply_copies(copies)
            iters.append({"image": image.cpu().numpy(),
                          "sqr": sqr.cpu().numpy(),
                          "weight": weight.cpu().numpy(), "spp": spp_this})
            self.stats.append({
                "iteration": self.iteration, "spp": spp_this,
                "seconds": time.time() - t0,
                "leaf_nodes_count": self.tree.n_leaves,
                "active": int(self.initialized.sum()),
            })
            if verbose:
                print(self.stats[-1])
            spp_done += spp_this
            spp_this *= 2
            self.iteration += 1
        return combine(iters, h, w), iters


def combine(iters, height: int, width: int) -> np.ndarray:
    """Inverse-variance combination of the iterations' images (the
    per-channel mean variance of each mean); 1-spp iterations, which have no
    variance estimate, get the weight 1e-6."""
    n_pix = height * width
    num = np.zeros((n_pix, 3))
    den = np.zeros((n_pix, 3))
    for it in iters:
        nw = np.maximum(it["weight"], 1.0)[:, None]
        mean = it["image"] / nw
        if it["spp"] < 2:
            iv = 1e-6
        else:
            var = np.maximum(it["sqr"] / nw - mean * mean, 0) \
                / np.maximum(nw - 1, 1)
            iv = 1.0 / max(var.mean(), 1e-12)
        num += iv * mean
        den += iv
    return (num / np.maximum(den, 1e-12)).reshape(height, width, 3)
