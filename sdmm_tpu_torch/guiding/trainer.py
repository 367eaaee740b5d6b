"""SDMM training loop: iterate render → collect → split → EM (port of
sdmm_tpu/guiding/trainer.py for one device).

Per iteration: render ``samples_per_iteration`` spp with guided sampling
while recording training vertices, refit the spatial tree (split leaves at
≥ 4000 samples, ≤ 2048 leaves), add jittered cross-leaf replicas, then run
batched stepwise EM over every trainable leaf. Training runs for the first
``train_fraction`` of the sample budget; the frozen-model tail renders on
the same guided lane pool. The options: a prioritized sample reservoir
that the EM fits instead of one iteration's samples
(``reservoir_capacity``), k-means++ spatial seeds for leaves that activate
(``data_init``), the EM's result held aside and adopted at the top of the
next iteration (``optimize_async``), learned-BSDF product sampling
(``sample_product``), and a full checkpoint to resume a render from
(``restore``, ``run(iters=)``). Training iterations with
``pooled_training=False``, and every iteration of an image above 2^20
pixels, take the scan tracer ``trace_wave_guided`` over fixed waves of
camera rays instead. Per-iteration images are combined by inverse
variance. Mixtures of ``n_components`` != 16 take the reference's route for
such a K: no kernel table, so guided lanes condition and sample through the
mixture (``render.guided.mixture_route``), both fused gates stay shut, and
the E-step runs the twin's math on any device (``em.use_em_kernel``).
Every iteration feeds the trainer's counters and the global ones of
``utils/stats.py``, which the process reports at exit;
SDMM_TPU_TIME_OPTIMIZE=1 prints the seconds of ``optimize``'s stages.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import guided_sample as gso
from ..render import film as film_mod
from ..render.guided import (
    GuideState, guided_fused_supported, render_pool_guided,
    render_pool_guided_fused, trace_wave_guided,
)
from ..scene.scene import scene_to
from ..scene.sensor import generate_rays
from ..utils import stats as stats_mod
from . import em as em_mod
from . import init as init_mod
from . import mixture as mix
from .stree import STree, find_leaf


@dataclass
class TrainerConfig:
    n_components: int = 16
    max_leaves: int = 2048
    split_threshold: int = 4000
    samples_per_iteration: int = 4
    bsdf_fraction: float = 0.5  # one-sample-MIS heuristic weight
    rays_per_wave: int = 1 << 16
    train_fraction: float = 0.25  # train on the first quarter of the spp
    em: em_mod.EMConfig = field(default_factory=em_mod.EMConfig)
    seed: int = 1234
    double_em_until: int = 4  # 2 EM inner steps in early iterations
    sample_product: bool = False  # learned-BSDF product sampling
    jitter_replicas: bool = True  # cross-leaf sample sharing: replicate
    # path-terminal and weight > 1000 samples into a neighbouring leaf
    saved_samples_per_path: int = 8  # record only the last N path vertices
    data_init: bool = False  # k-means++ reseed of the spatial means of a
    # leaf when it first activates
    reservoir_capacity: int = 0  # > 0: the EM fits a prioritized-replay
    # reservoir of this many samples instead of one iteration's
    per_decay: float = 0.5  # priority decay per iteration of stored samples
    optimize_async: bool = False  # hold the EM's result aside and adopt it
    # at the top of the next iteration, before that iteration renders
    sample_capacity: int = 2_000_000  # training-vertex buffer cap per
    # iteration; overflow samples are dropped
    pooled_training: bool = True  # collect training vertices on the lane
    # pool; False takes the fixed-wave scan tracer
    cond_floor_frac: float = 0.35  # spatial covariance inflation (fraction
    # of leaf extent, per axis) applied to the GUIDE STATE only; the EM
    # keeps fitting the sharp model
    tail_chunk_spp: int = 0  # > 0: after training, render the remaining
    # budget in chunks of this many spp per iteration


SCAN_PIXELS = 1 << 20  # above it every iteration takes the scan tracer


def _seeded(device, *parts) -> torch.Generator:
    """A generator on ``device`` seeded from integer parts."""
    seed = 0
    for p in parts:
        seed = (seed * 1_000_003 + int(p)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


class SDMMTrainer:
    def __init__(self, scene, render_cfg, cfg: TrainerConfig | None = None,
                 mesh=None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = c = cfg or TrainerConfig()
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported")
        self.scene = scene_to(scene, self.device)
        if render_cfg.has_sss and not render_cfg.sss_baked:
            from ..render.subsurface import bake_subsurface

            self.scene = bake_subsurface(self.scene, render_cfg, seed=c.seed,
                                         device=self.device)
        self.render_cfg = render_cfg
        self.counters = stats_mod.trainer_counters()

        lo = self.scene.aabb_lo.cpu().numpy().astype(np.float64)
        hi = self.scene.aabb_hi.cpu().numpy().astype(np.float64)
        ext = hi - lo
        self.spatial_norm = float(ext.max())
        eps = 1e-5
        self.tree = STree(-eps * np.ones(3), ext / self.spatial_norm + eps,
                          max_leaves=c.max_leaves,
                          split_threshold=c.split_threshold)
        self.tree.split_to_depth(2)
        self.tables = self.tree.device_tables(self.device)

        self.sdmm = init_mod.init_leaf_params(
            _seeded(self.device, c.seed), self.tables["leaf_lo"],
            self.tables["leaf_hi"], c.n_components)
        self.prep = mix.prepare(self.sdmm)
        self.em = em_mod.init_em_state(c.max_leaves, c.n_components,
                                       self.device)
        self.initialized = torch.zeros(c.max_leaves, dtype=torch.bool,
                                       device=self.device)
        self.cum_counts = np.zeros(c.max_leaves)
        self.reseeded_leaves = 0  # leaves data_init reseeded, in all
        self.learned = None
        self.learned_seconds = 0.0
        if c.sample_product:
            from .learned_bsdf import build_learned_table

            t0 = time.time()
            self.learned = build_learned_table(self.scene, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.learned_seconds = time.time() - t0
        self.reservoir = None
        if c.reservoir_capacity > 0:
            from .reservoir import make_reservoir

            self.reservoir = make_reservoir(c.reservoir_capacity,
                                            self.device)
        self.iteration = 0
        self.total_spp = 0
        self.stats: list[dict] = []
        self._model_version = 0
        self._gs_cache = None

    # ------------------------------------------------------------------

    def guide_state(self) -> GuideState:
        """The guide state of the current model, rebuilt only when the
        model version counter moved."""
        if self._gs_cache is not None and \
                self._gs_cache[0] == self._model_version:
            return self._gs_cache[1]
        gs = self._build_guide_state()
        self._gs_cache = (self._model_version, gs)
        return gs

    def _bump_model_version(self):
        self._model_version += 1

    def _build_guide_state(self) -> GuideState:
        sdmm_c, prep_c = self.sdmm, self.prep
        if self.cfg.cond_floor_frac > 0.0:
            # Condition-time spatial inflation: the guide state's
            # conditionals use leaf-wide spatial marginals; the EM state
            # stays sharp.
            ext = self.tables["leaf_hi"] - self.tables["leaf_lo"]
            fl = torch.zeros((ext.shape[0], 5), device=self.device)
            fl[:, :3] = (self.cfg.cond_floor_frac * ext) ** 2
            sdmm_c = self.sdmm._replace(
                cov=self.sdmm.cov + torch.diag_embed(fl)[:, None])
            prep_c = mix.prepare(sdmm_c)
        return GuideState(
            sdmm=sdmm_c, prep=prep_c, initialized=self.initialized,
            tables=self.tables, aabb_lo=self.scene.aabb_lo,
            inv_norm=1.0 / self.spatial_norm,
            kernel_table=gso.pack_guided_rows(
                prep_c, sdmm_c.weight, self.initialized).T.contiguous()
            if self.sdmm.weight.shape[1] == gso.K else None,
            learned=self.learned,
        )

    def _count(self, name: str, v: float, base: float):
        """Feed the trainer's counter ``name`` and the global one."""
        self.counters[name].add(v, base)
        stats_mod.GLOBAL[name].add(v, base)

    def _apply_copies(self, copies):
        """Propagate mixture state to fresh leaf slots after tree splits
        (all sources are read before any destination is written)."""
        if not copies:
            return
        dst = torch.as_tensor([d for d, _ in copies], device=self.device)
        src = torch.as_tensor([s for _, s in copies], device=self.device)

        def cp(a):
            return a.index_copy(0, dst, a[src])

        self.sdmm = mix.SDMM(*(cp(a) for a in self.sdmm))
        self.em = em_mod.EMState(*(cp(a) for a in self.em))
        self.initialized = cp(self.initialized)
        self.prep = mix.prepare(self.sdmm)
        self._bump_model_version()

    def render_iteration(self, collect: bool, spp: int | None = None):
        """Render ``spp`` (default samples_per_iteration) spp on the guided
        lane pool; returns (image, sqr, weight, sample batches). A frozen
        iteration (``collect=False``) on the card takes the fused trace +
        shade pool where the scene allows it, as the reference does on its
        accelerator. A training iteration with ``pooled_training=False``,
        and any iteration above 2^20 pixels, takes the scan tracer."""
        rc, c = self.render_cfg, self.cfg
        spp = c.samples_per_iteration if spp is None else spp
        w, h = rc.width, rc.height
        n_pix = w * h
        if n_pix > SCAN_PIXELS or (collect and not c.pooled_training):
            return self._render_scan(collect, spp)
        gs = self.guide_state()
        lanes = min(c.rays_per_wave * 2, n_pix * spp)
        if not collect and self.device.type == "cuda" and \
                guided_fused_supported(self.scene, rc, gs):
            out = render_pool_guided_fused(
                self.scene, gs, _seeded(self.device, c.seed, self.iteration),
                n_lanes=max(2048, lanes // 2048 * 2048), spp=spp, width=w,
                height=h, max_depth=rc.max_depth, rr_depth=rc.rr_depth,
                bsdf_fraction=c.bsdf_fraction,
                bsdf_types=tuple(rc.bsdf_types), fov_axis=rc.fov_axis,
                device=self.device)
            return self._frozen_result(out, n_pix * spp)
        cap = 0
        if collect:
            cap = min(c.sample_capacity,
                      n_pix * spp * min(c.saved_samples_per_path,
                                        rc.max_depth))
            cap = -(-cap // 1024) * 1024
        out = render_pool_guided(
            self.scene, gs, _seeded(self.device, c.seed, self.iteration),
            n_lanes=lanes, spp=spp, width=w, height=h,
            max_depth=rc.max_depth, rr_depth=rc.rr_depth,
            bsdf_fraction=c.bsdf_fraction,
            bsdf_types=rc.bsdf_types or None, fov_axis=rc.fov_axis,
            collect_cap=cap, saved_samples_per_path=c.saved_samples_per_path,
            has_medium=rc.has_medium, has_hetero=rc.has_hetero,
            has_sss=rc.has_sss, device=self.device,
        )
        if not collect:
            return self._frozen_result(out, n_pix * spp)
        self._last_mean_path_length = float(out["n_vertices"]) / max(
            1, n_pix * spp)
        return out["image"], out["sqr"], out["weight"], [out["samples"]]

    def _render_scan(self, collect: bool, spp: int):
        """An iteration on the scan tracer: ``spp`` passes over the pixels
        in waves of ``rays_per_wave`` camera rays; returns what
        ``render_iteration`` does, one sample batch per wave."""
        rc, c, dev = self.render_cfg, self.cfg, self.device
        w, h = rc.width, rc.height
        n_pix = w * h
        gs = self.guide_state()
        table = None if gs.kernel_table is None else \
            gso.pack_sample_table(gs.kernel_table)
        gen = _seeded(dev, c.seed, self.iteration)
        wave = min(c.rays_per_wave, n_pix)
        n_waves = -(-n_pix // wave)
        pix_all = torch.arange(n_waves * wave, device=dev) % n_pix
        image = torch.zeros((n_pix, 3), device=dev)
        sqr = torch.zeros((n_pix, 3), device=dev)
        weight = torch.zeros(n_pix, device=dev)
        batches = []
        for _ in range(spp):
            for wv in range(n_waves):
                idx = pix_all[wv * wave:(wv + 1) * wave]
                u = torch.rand((idx.shape[0], 2), generator=gen, device=dev)
                ro, rd = generate_rays(
                    self.scene, torch.stack([(idx % w).float() + u[:, 0],
                                             (idx // w).float() + u[:, 1]],
                                            -1), w, h, rc.fov_axis)
                li, samples = trace_wave_guided(
                    self.scene, gs, gen, ro, rd, max_depth=rc.max_depth,
                    rr_depth=rc.rr_depth, bsdf_fraction=c.bsdf_fraction,
                    bsdf_types=rc.bsdf_types or None,
                    saved_samples_per_path=c.saved_samples_per_path,
                    has_medium=rc.has_medium, has_hetero=rc.has_hetero,
                    has_sss=rc.has_sss, sample_table=table)
                image, sqr, weight = film_mod.splat(
                    image, sqr, weight, idx, torch.nan_to_num(
                        li, nan=0.0, posinf=0.0, neginf=0.0))
                batches.append(samples)
        if collect:
            return image, sqr, weight, batches
        out = {"n_vertices": sum(float(b["n_vertices"]) for b in batches),
               "n_cond_ok": sum(float(b["n_cond_ok"]) for b in batches),
               "n_cond_try": sum(float(b["n_cond_try"]) for b in batches),
               "image": image, "sqr": sqr, "weight": weight}
        return self._frozen_result(out, n_pix * spp)

    def _frozen_result(self, out, n_paths: int):
        """Counters of a frozen iteration; returns its render outputs."""
        n_paths = max(1, n_paths)
        n_vertices = float(out["n_vertices"])
        self._last_mean_path_length = n_vertices / n_paths
        self._count("avg_path_length", n_vertices, n_paths)
        self._last_samples_count = 0
        self._count("avg_found_conditional", float(out["n_cond_ok"]),
                    max(1, int(out["n_cond_try"])))
        return out["image"], out["sqr"], out["weight"], []

    def _compact(self, mask, rcap, *arrays):
        """Fixed-size compaction of the rows where ``mask``; returns
        (filled [rcap] bool, compacted arrays)."""
        rank = torch.cumsum(mask.long(), 0) - 1
        idx = torch.where(mask & (rank < rcap), rank, rcap)
        nfill = torch.clamp(mask.sum(), max=rcap)
        filled = torch.arange(rcap, device=self.device) < nfill
        cols = [a[:, None] if a.ndim == 1 else a for a in arrays]
        widths = [col.shape[1] for col in cols]
        packed = torch.cat([col.float() for col in cols], dim=1)
        buf = torch.zeros((rcap + 1, packed.shape[1]), device=self.device)
        buf = buf.index_copy(0, idx, packed)[:rcap]
        outs, off = [], 0
        for a, wd in zip(arrays, widths):
            sl = buf[:, off:off + wd]
            outs.append((sl[:, 0] if a.ndim == 1 else sl).to(a.dtype))
            off += wd
        return filled, outs

    def _dest_leaf(self, gen, cpos, cleaf, cdiag):
        """First-success-of-8-attempts destination leaf per sample: the
        position jittered by ±half the leaf diagonal until it lands in a
        different leaf. Returns (leaf, jittered position that found it)."""
        offs = (torch.rand((8,) + tuple(cpos.shape), generator=gen,
                           device=self.device) - 0.5) * cdiag
        cand_pos = (cpos + offs).reshape(-1, 3)
        cand = find_leaf(self.tables, cand_pos).reshape(8, -1)
        ok = cand != cleaf
        first = torch.argmax(ok.to(torch.int32), dim=0)[None]
        got = ok.gather(0, first)[0]
        dest = cand.gather(0, first)[0]
        dpos = cand_pos.reshape(8, -1, 3).gather(
            0, first[..., None].expand(1, -1, 3))[0]
        return (torch.where(got, dest, cleaf),
                torch.where(got[:, None], dpos, cpos))

    def optimize(self, sample_batches):
        """Tree refit, jitter replicas and the EM step(s); returns the
        number of leaves optimized."""
        c = self.cfg
        L = c.max_leaves
        dev = self.device
        mark = self._stage_timer()
        self._count(
            "avg_found_conditional",
            float(sum(float(s.get("n_cond_ok", 0.0)) for s in sample_batches)),
            max(1, int(sum(float(s.get("n_cond_try", 0.0))
                           for s in sample_batches))))
        n_vertices = sum(float(s.get("n_vertices", 0.0))
                         for s in sample_batches)
        sample_batches = [{k: v for k, v in s.items() if not k.startswith("n_")}
                          for s in sample_batches]
        pos = torch.cat([s["pos"] for s in sample_batches])
        d = torch.cat([s["dir"] for s in sample_batches])
        wgt = torch.cat([s["weight"] for s in sample_batches])
        valid = torch.cat([s["valid"] for s in sample_batches])
        n_paths = max(1, self.render_cfg.width * self.render_cfg.height
                      * c.samples_per_iteration)
        self._count("avg_path_length", n_vertices, n_paths)
        self._last_samples_count = int(valid.sum())
        self._last_mean_path_length = n_vertices / n_paths

        mark("concat")

        # Leaf counts for split decisions (device → host).
        leaf = find_leaf(self.tables, pos).long()
        counts = torch.zeros(L, dtype=torch.int32, device=dev).index_add_(
            0, leaf, valid.to(torch.int32)).cpu().numpy()
        mark("counts")
        copies = self.tree.refit(counts)
        if copies:
            self.tables = self.tree.device_tables(dev)
            self._apply_copies(copies)
            leaf = find_leaf(self.tables, pos).long()

        mark("refit")

        # Jittered cross-leaf replicas: one for the path-terminal vertex,
        # one more for weight > 1000; a replica keeps the ORIGINAL position
        # and direction, the jitter only picks the destination leaf. Its
        # lookup position is the jittered one, so a leaf re-derived after a
        # reservoir merge or a refit stays the destination.
        lookup_pos = pos
        if c.jitter_replicas:
            if not sample_batches or "terminal" not in sample_batches[0]:
                raise KeyError("jitter_replicas requires a 'terminal' field "
                               "in the sample batches")
            terminal = torch.cat([s["terminal"] for s in sample_batches])
            n_rep = terminal.long() + (wgt > 1000.0).long()
            diag = self.tables["leaf_hi"][leaf] - self.tables["leaf_lo"][leaf]
            n_paths_i = (self.render_cfg.width * self.render_cfg.height
                         * c.samples_per_iteration)
            rcap0 = 8192
            while rcap0 < n_paths_i:
                rcap0 *= 2
            n_mask1 = int((valid & (n_rep > 1)).sum())
            rcap1 = 8192
            while rcap1 < n_mask1:
                rcap1 *= 2
            parts = {"pos": [pos], "lk": [lookup_pos], "d": [d], "w": [wgt],
                     "leaf": [leaf], "v": [valid]}
            for r, rcap in ((0, rcap0), (1, rcap1)):
                gen = _seeded(dev, c.seed ^ 0x9E37, self.iteration, r)
                mask = valid & (n_rep > r)
                filled, (cpos, cd, cw, cleaf, cdiag) = self._compact(
                    mask, rcap, pos, d, wgt, leaf, diag)
                leaf_r, pos_r = self._dest_leaf(gen, cpos, cleaf, cdiag)
                keep = filled & (leaf_r != cleaf)
                parts["pos"].append(torch.where(keep[:, None], cpos, 0.5))
                parts["lk"].append(torch.where(keep[:, None], pos_r, 0.5))
                parts["d"].append(cd)
                parts["w"].append(torch.where(keep, cw, -1.0))
                parts["leaf"].append(torch.where(keep, leaf_r, 0))
                parts["v"].append(keep)
            pos = torch.cat(parts["pos"])
            lookup_pos = torch.cat(parts["lk"])
            d = torch.cat(parts["d"])
            wgt = torch.cat(parts["w"])
            leaf = torch.cat(parts["leaf"])
            valid = torch.cat(parts["v"])

        mark("jitter")
        # Prioritized replay: merge into the fixed-capacity reservoir and fit
        # the EM on its decayed, roulette-thinned contents.
        if self.reservoir is not None:
            from .reservoir import reservoir_update

            self.reservoir = reservoir_update(
                self.reservoir, pos, d, wgt, valid,
                _seeded(dev, c.seed ^ 0x51ED, self.iteration),
                c.reservoir_capacity, c.per_decay, lookup_pos=lookup_pos)
            pos = self.reservoir["pos"]
            d = self.reservoir["dir"]
            wgt = self.reservoir["weight"]
            valid = self.reservoir["valid"]
            leaf = find_leaf(self.tables, self.reservoir["lookup_pos"]).long()

        mark("reservoir")
        counts_dev = torch.zeros(L, dtype=torch.int32, device=dev).index_add_(
            0, leaf, valid.to(torch.int32))
        self.cum_counts[:] = self.tree.leaf_counts[:L]
        # canBeOptimized gate.
        active = (
            (counts_dev >= 8)
            & (torch.as_tensor(self.tree.leaf_counts, dtype=torch.float32,
                               device=dev) >= 64.0)
            & ((self.total_spp > 12) | (counts_dev > 1000))
        )
        # k-means++ spatial seeds for leaves activating for the first time.
        if c.data_init:
            newly = active & ~self.initialized
            if bool(newly.any()):
                centers, has = init_mod.kmeanspp_centers(
                    _seeded(dev, c.seed ^ 0x4B4D, self.iteration), pos, leaf,
                    valid, L, n_centers=2)
                self.sdmm = init_mod.reseed_spatial_means(
                    self.sdmm, centers, newly & has, n_spatial=2)
                self.reseeded_leaves += int((newly & has).sum())
        mark("gate")
        n_inner = 2 if self.iteration < c.double_em_until else 1
        leaf_ext = self.tables["leaf_hi"] - self.tables["leaf_lo"]
        for _ in range(n_inner):
            self.sdmm, self.em, _ = em_mod.em_step(
                self.sdmm, self.em, pos, d, wgt, leaf.to(torch.int32), active,
                c.em, leaf_ext=leaf_ext, device=dev)
        mark("em")
        self.prep = mix.prepare(self.sdmm)
        self.initialized = self.initialized | active
        self._bump_model_version()
        return int(active.sum())

    def _stage_timer(self):
        """``mark(name)`` of ``optimize``'s stages: with
        SDMM_TPU_TIME_OPTIMIZE=1 it prints the seconds since the last mark
        (the card synchronised first), as the reference does; else it does
        nothing."""
        if os.environ.get("SDMM_TPU_TIME_OPTIMIZE") != "1":
            return lambda name: None
        t = [time.perf_counter()]

        def mark(name):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            print(f"  opt[{name}] {now - t[0]:.3f}s", flush=True)
            t[0] = now

        return mark

    def restore(self, path: str):
        """Resume from a full checkpoint (io.save_full_checkpoint, either
        package's). Every random draw of ``run`` and ``optimize`` is
        seeded from the iteration index, so the continued run matches an
        uninterrupted one. Returns the restored per-iteration films to pass
        to ``run(iters=...)``."""
        from . import io as gio

        state, iters = gio.load_full_checkpoint(path, self.device)
        if state["sdmm"].weight.shape[1] != self.cfg.n_components:
            raise ValueError(
                f"{path}: {state['sdmm'].weight.shape[1]} components, the "
                f"trainer has n_components = {self.cfg.n_components}")
        self.tree = state["tree"]
        self.tables = self.tree.device_tables(self.device)
        self.sdmm = state["sdmm"]
        self.em = state["em"]
        self.prep = mix.prepare(self.sdmm)
        self.initialized = state["initialized"]
        self.cum_counts = state["cum_counts"]
        self.iteration = state["iteration"]
        self.total_spp = state["total_spp"]
        self.stats = list(state["stats"])
        self._bump_model_version()
        return iters

    def run(self, total_spp: int, verbose: bool = False, on_iteration=None,
            iters=None):
        """Full training render; returns (combined image [H, W, 3],
        per-iteration films). ``iters``: the films of the iterations
        already rendered (a resumed run)."""
        c = self.cfg
        iters = list(iters) if iters else []
        pending = None  # optimize_async: the (sdmm, em, prep, initialized)
        # of the last EM, adopted at the top of the next iteration
        while self.total_spp < total_spp:
            t0 = time.time()
            still_training = self.total_spp < total_spp * c.train_fraction
            spp_iter = c.samples_per_iteration
            if not still_training and c.tail_chunk_spp > 0:
                spp_iter = min(c.tail_chunk_spp, total_spp - self.total_spp)
            if pending is not None:
                self.sdmm, self.em, self.prep, self.initialized = pending
                self._bump_model_version()
                pending = None
            image, sqr, weight, batches = self.render_iteration(
                collect=still_training, spp=spp_iter)
            t_render = time.time() - t0
            t0 = time.time()
            n_opt = 0
            if still_training and batches:
                if c.optimize_async:
                    old = (self.sdmm, self.em, self.prep, self.initialized)
                    n_opt = self.optimize(batches)
                    pending = (self.sdmm, self.em, self.prep,
                               self.initialized)
                    self.sdmm, self.em, self.prep, self.initialized = old
                    self._bump_model_version()
                else:
                    n_opt = self.optimize(batches)
            t_train = time.time() - t0
            iters.append({"image": image.cpu().numpy(),
                          "sqr": sqr.cpu().numpy(),
                          "weight": weight.cpu().numpy()})
            self.stats.append({
                "iteration": self.iteration,
                "spp": spp_iter,
                "total_spp": self.total_spp + spp_iter,
                "elapsed_seconds": t_render + t_train,
                "rendering_seconds": t_render,
                "training_seconds": t_train,
                "mean_path_length": getattr(self, "_last_mean_path_length",
                                            0.0),
                "samples_count": getattr(self, "_last_samples_count", 0),
                "max_depth": max(self.tree.depth) if self.tree.depth else 0,
                "leaf_nodes_count": self.tree.n_leaves,
                "optimized_nodes_count": n_opt,
                "active_nodes_count": int(self.initialized.sum()),
            })
            if verbose:
                print(self.stats[-1])
            if on_iteration is not None:
                on_iteration(self, iters[-1])
            self.iteration += 1
            self.total_spp += spp_iter
        return self.combine(iters), iters

    def combine(self, iters):
        """Inverse-variance weighted combination of per-iteration images:
        iterations < 4 are excluded (when there are more than 4), per-sample
        variance is clipped at 2000, weights are per-channel mean
        variances scaled by each iteration's spp."""
        rc = self.render_cfg
        h, w = rc.height, rc.width
        num = np.zeros((h * w, 3))
        den = np.zeros((h * w, 3))
        start = 4 if len(iters) > 4 else 0
        means, pvars, spps = [], [], []
        for it in iters[start:]:
            n = np.maximum(it["weight"], 1.0)[:, None]
            mean = it["image"] / n
            var = np.maximum(it["sqr"] / n - mean * mean, 0.0) \
                * (n / np.maximum(n - 1, 1.0))
            var = np.clip(var, 0.0, 2000.0)
            means.append(mean)
            pvars.append(var.mean(axis=0))
            spps.append(float(n.mean()))
        pv = np.stack(pvars) if pvars else np.zeros((0, 3))
        pos = np.where(pv > 0.0, pv, np.inf)
        floor = np.where(np.isfinite(pos.min(axis=0)), pos.min(axis=0), 1e-12)
        for mean, var_c, spp_i in zip(means, pv, spps):
            iv = spp_i / np.maximum(var_c, floor)  # [3]
            num += iv[None, :] * mean
            den += iv[None, :]
        if iters and self.stats:
            last = iters[-1]
            n = np.maximum(last["weight"], 1.0)[:, None]
            mean = last["image"] / n
            var = np.maximum(last["sqr"] / n - mean * mean, 0.0) / np.maximum(
                n - 1, 1)
            scale = float(n.mean()) / max(1, self.cfg.samples_per_iteration)
            mpv = float(var.mean()) * scale
            total_s = sum(st.get("rendering_seconds", 0.0)
                          for st in self.stats)
            self.stats[-1]["mean_pixel_variance"] = mpv
            self.stats[-1]["ttuv"] = mpv * total_s
        return (num / np.maximum(den, 1e-12)).reshape(h, w, 3)
