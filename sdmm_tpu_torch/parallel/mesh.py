"""Multi-rank execution: ray waves split over the ranks of a
``torch.distributed`` process group (port of sdmm_tpu/parallel/mesh.py).

The reference shards a wave over a ``jax.sharding.Mesh`` with
``shard_map`` and combines the film and the EM sufficient statistics with
``psum``. Here each rank is one process driving one device (``torchrun
--nproc_per_node=N`` starts them; a process without a group forms a group
of one), traces its contiguous block of a wave, and the film and the
statistics are all-reduced (SUM); the mixture state is replicated. Every
collective waits with the mesh's timeout, so a lost rank fails the others
instead of hanging them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..core.draws import seeded
from ..guiding import em as em_mod
from ..guiding import mixture as mix
from ..guiding.stree import find_leaf
from ..guiding.trainer import TrainerConfig
from ..ops import em_suffstats
from ..ops import guided_sample as gso
from ..render.guided import GuideState, trace_wave_guided
from ..render.volpath import trace_wave
from ..scene.scene import scene_to
from ..scene.sensor import pixel_rays


@dataclass
class Mesh:
    """A process group along one axis: this process's rank, the world size
    and the device the rank drives."""
    group: object
    rank: int
    world_size: int
    axis_name: str
    device: torch.device
    timeout: timedelta

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows (``PartitionSpec``'s
        split; ``n`` must divide evenly)."""
        if n % self.world_size:
            raise ValueError(f"{n} rows do not split evenly over "
                             f"{self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns it."""
        dist.all_reduce(x, group=self.group, async_op=True).wait(self.timeout)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes), concatenated in rank order
        along ``dim``."""
        src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src, group=self.group,
                        async_op=True).wait(self.timeout)
        return torch.cat(parts, dim).to(x.dtype)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` of rank ``src`` on every rank, in place; returns it."""
        dist.broadcast(x, src, group=self.group,
                       async_op=True).wait(self.timeout)
        return x


def make_mesh(devices=None, axis_name: str = "rays",
              device: str | torch.device = "cuda",
              timeout: float = 600.0) -> Mesh:
    """The mesh of this process. It takes the default process group where
    one is initialised (``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``; the caller runs ``init_process_group``), else forms a
    group of one: NCCL for a CUDA device, gloo for the CPU. The rank drives
    ``devices[LOCAL_RANK]`` (default: ``cuda:LOCAL_RANK``, or the CPU).
    ``timeout``: seconds every collective waits."""
    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if devices is not None:
        dev = resolve_device(devices[local])
    elif dev.type == "cuda":
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    wait = timedelta(seconds=timeout)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                timeout=wait)
    group = dist.group.WORLD
    return Mesh(group=group, rank=dist.get_rank(group),
                world_size=dist.get_world_size(group), axis_name=axis_name,
                device=dev, timeout=wait)


def build_train_step(scene, render_cfg, mesh: Mesh,
                     trainer_cfg: TrainerConfig | None = None):
    """A distributed training step:

    step(sdmm, em_state, initialized, tables, aabb_lo, inv_norm,
         pixel_idx [N], seed) → (new_sdmm, new_em, new_init,
                                 film [n_pix, 3], counts [L])

    Each rank traces its block of ``pixel_idx`` with the guided scan tracer
    from a generator seeded (seed, rank), as the reference folds the device
    index into its key; the film and the E-step statistics are
    all-reduced, and every rank runs the same M-step on them."""
    tc = trainer_cfg or TrainerConfig()
    scene = scene_to(scene, mesh.device)
    n_pix = render_cfg.width * render_cfg.height

    def step(sdmm, em_state, initialized, tables, aabb_lo, inv_norm,
             pixel_idx, seed: int):
        dev = mesh.device
        gen = seeded(dev, seed, mesh.rank)
        idx = pixel_idx.to(dev)[mesh.block(pixel_idx.shape[0])]
        prep = mix.prepare(sdmm)
        gs = GuideState(
            sdmm=sdmm, prep=prep, initialized=initialized, tables=tables,
            aabb_lo=aabb_lo, inv_norm=float(inv_norm),
            kernel_table=gso.pack_guided_rows(
                prep, sdmm.weight, initialized).T.contiguous()
            if sdmm.weight.shape[1] == gso.K else None)
        ro, rd = pixel_rays(scene, idx, gen, render_cfg.width,
                            render_cfg.height, render_cfg.fov_axis)
        li, samples = trace_wave_guided(
            scene, gs, gen, ro, rd, max_depth=render_cfg.max_depth,
            rr_depth=render_cfg.rr_depth, bsdf_fraction=tc.bsdf_fraction,
            bsdf_types=render_cfg.bsdf_types or None,
            has_medium=render_cfg.has_medium,
            has_hetero=render_cfg.has_hetero)
        li = torch.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)
        film = mesh.all_reduce(torch.zeros((n_pix, 3), device=dev)
                               .index_add_(0, idx.long(), li))
        leaf = find_leaf(tables, samples["pos"])
        e_step = em_suffstats.e_step if em_mod.use_em_kernel(sdmm) \
            else em_suffstats.e_step_plain
        stats = e_step(sdmm, prep, samples["pos"], samples["dir"],
                       samples["weight"], leaf, tc.max_leaves,
                       batch_size=tc.em.batch_size)
        sw, sm, sc, ws, cnt = (mesh.all_reduce(s) for s in stats)
        active = (cnt >= 8) & (sw.sum(-1) > 0)
        new_sdmm, new_em = em_mod.m_step(sdmm, prep, em_state, sw, sm, sc,
                                         ws, active, tc.em)
        return new_sdmm, new_em, initialized | active, film, cnt

    return step


def build_render_step(scene, render_cfg, mesh: Mesh):
    """A distributed plain rendering step (no training):
    step(pixel_idx [N], seed) → the all-reduced film [n_pix, 3]. Each rank
    traces its block of ``pixel_idx`` with NEE from a generator seeded
    (seed, rank)."""
    scene = scene_to(scene, mesh.device)
    n_pix = render_cfg.width * render_cfg.height

    def step(pixel_idx, seed: int):
        dev = mesh.device
        gen = seeded(dev, seed, mesh.rank)
        idx = pixel_idx.to(dev)[mesh.block(pixel_idx.shape[0])]
        ro, rd = pixel_rays(scene, idx, gen, render_cfg.width,
                            render_cfg.height, render_cfg.fov_axis)
        li = trace_wave(scene, gen, ro, rd, max_depth=render_cfg.max_depth,
                        rr_depth=render_cfg.rr_depth,
                        bsdf_types=render_cfg.bsdf_types or None)
        li = torch.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)
        return mesh.all_reduce(torch.zeros((n_pix, 3), device=dev)
                               .index_add_(0, idx.long(), li))

    return step
