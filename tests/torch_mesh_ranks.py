"""The rank side of tests/test_torch_mesh.py: one process of a gloo group
on the CPU, started by torch.multiprocessing's spawn. Each rank runs the
port's multi-rank paths at the reference tests' configurations
(tests/test_parallel.py, tests/test_diff.py) and writes what it got to
rank<r>.npz for the test to compare. Imports no JAX."""

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from torch_parity import make_box, make_rough_box, to_np

from sdmm_tpu_torch.core.draws import seeded
from sdmm_tpu_torch.diff import inverse
from sdmm_tpu_torch.guiding import em as em_mod
from sdmm_tpu_torch.guiding import init as init_mod
from sdmm_tpu_torch.guiding.stree import STree
from sdmm_tpu_torch.guiding.trainer import SDMMTrainer, TrainerConfig
from sdmm_tpu_torch.parallel import mesh as mesh_mod
from sdmm_tpu_torch.scene import scene as tscene
from sdmm_tpu_torch.scene import shapes as tshapes

TIMEOUT = 60  # seconds every collective waits
RENDER_SEED, TRAIN_SEED, GRAD_SEED = 5, 1, 11
# tests/test_parallel.py's configurations.
TRAIN_TC = dict(n_components=8, max_leaves=16,
                em=em_mod.EMConfig(batch_size=256))
TRAINER_TC = dict(n_components=8, max_leaves=32, split_threshold=500,
                  samples_per_iteration=16, rays_per_wave=512,
                  em=em_mod.EMConfig(batch_size=256), pooled_training=False)


def box():
    b = make_box(tscene, tshapes, 16, 16)
    b.max_depth = b.rr_depth = 3
    return b.build(device="cpu")


def train_state(tc, scene):
    """test_parallel's train-step inputs: a tree split to depth 1 and
    mixtures initialised from a seeded generator."""
    tree = STree(-1e-5 * np.ones(3), np.ones(3) + 1e-5,
                 max_leaves=tc.max_leaves)
    tree.split_to_depth(1)
    tables = tree.device_tables("cpu")
    sdmm = init_mod.init_leaf_params(seeded("cpu", 0), tables["leaf_lo"],
                                     tables["leaf_hi"], tc.n_components)
    em = em_mod.init_em_state(tc.max_leaves, tc.n_components)
    inv_norm = 1.0 / float((scene.aabb_hi - scene.aabb_lo).max())
    return (sdmm, em, torch.zeros(tc.max_leaves, dtype=torch.bool), tables,
            scene.aabb_lo, inv_norm)


def run_trainer(scene, cfg, mesh):
    """test_parallel's trainer run: two iterations of 16 spp, each
    optimized, then a third render on the trained model."""
    tr = SDMMTrainer(scene, cfg, TrainerConfig(**TRAINER_TC), mesh=mesh,
                     device="cpu")
    trained = 0
    for _ in range(2):
        img, _, _, batches = tr.render_iteration(collect=True)
        trained = max(trained, tr.optimize(batches))
        tr.iteration += 1
        tr.total_spp += tr.cfg.samples_per_iteration
    img_g, _, _, batches_g = tr.render_iteration(collect=True)
    return {"img": to_np(img), "weight": to_np(tr.sdmm.weight),
            "mean": to_np(tr.sdmm.mean), "init": to_np(tr.initialized),
            "trained": np.int64(trained), "img_g": to_np(img_g),
            "n_try": np.float64(sum(float(s["n_cond_try"])
                                    for s in batches_g)),
            "n_ok": np.float64(sum(float(s["n_cond_ok"])
                                   for s in batches_g))}


def grad_params(scene):
    return {n: getattr(scene, n).clone().requires_grad_(True)
            for n in ("bsdf_albedo", "bsdf_alpha")}


def rank_main(rank: int, world: int, init_file: str, out_dir: str):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT))
    try:
        mesh = mesh_mod.make_mesh(device="cpu", timeout=TIMEOUT)
        scene, cfg = box()
        out = {}
        n_pix = cfg.width * cfg.height
        step = mesh_mod.build_render_step(scene, cfg, mesh)
        out["render"] = to_np(step(torch.arange(n_pix * 8) % n_pix,
                                   RENDER_SEED))

        tc = TrainerConfig(**TRAIN_TC)
        train = mesh_mod.build_train_step(scene, cfg, mesh, tc)
        sdmm, em, init, film, cnt = train(
            *train_state(tc, scene), torch.arange(1024) % n_pix, TRAIN_SEED)
        out.update(train_weight=to_np(sdmm.weight),
                   train_mean=to_np(sdmm.mean), train_it=to_np(em.iterations),
                   train_init=to_np(init), train_film=to_np(film),
                   train_cnt=to_np(cnt))

        rough, rough_cfg = make_rough_box(tscene, tshapes).build(
            device="cpu")
        render = inverse.make_render_fn_multi(
            rough, rough_cfg, torch.arange(rough_cfg.width
                                           * rough_cfg.height),
            spp=2, mesh=mesh)
        p = grad_params(rough)
        inverse.pixel_mean(render(p, GRAD_SEED), mesh).backward()
        inverse.all_reduce_grads(p.values(), mesh)
        out.update({"grad_" + k: to_np(v.grad) for k, v in p.items()})

        out.update({"trainer_" + k: v
                    for k, v in run_trainer(scene, cfg, mesh).items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
