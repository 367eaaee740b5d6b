"""Guiding-model checkpoints (.asdmm JSON), full resume checkpoints (.npz)
and learned-BSDF mixtures (.sdmm JSON): port of sdmm_tpu/guiding/io.py, in
the same schemas, so a file written by either package loads in the other.

An .asdmm checkpoint holds the spatial tree, every leaf's mixture
parameters, the initialised flags and the normalisation of the guiding
domain; a full checkpoint adds the EM running statistics and the
per-iteration films.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.device import resolve_device
from .mixture import SDMM
from .stree import STree


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _list(t: torch.Tensor) -> list:
    return _np(t).tolist()


def _tree_meta(t: STree) -> dict:
    return {
        "lo": t.lo.tolist(),
        "hi": t.hi.tolist(),
        "axis": list(map(int, t.axis)),
        "split": list(map(float, t.split)),
        "child": list(map(int, t.child)),
        "leaf": list(map(int, t.leaf)),
        "depth": list(map(int, t.depth)),
        "n_leaves": t.n_leaves,
        "max_leaves": t.max_leaves,
        "split_threshold": t.split_threshold,
    }


def _tree_from_meta(td: dict, leaf_counts: np.ndarray) -> STree:
    """The STree of a saved tree dict; node bounds from a walk down it."""
    tree = STree(np.asarray(td["lo"]), np.asarray(td["hi"]),
                 max_leaves=td["max_leaves"],
                 split_threshold=td["split_threshold"])
    tree.axis = list(td["axis"])
    tree.split = list(td["split"])
    tree.child = list(td["child"])
    tree.leaf = list(td["leaf"])
    tree.depth = list(td["depth"])
    tree.n_leaves = td["n_leaves"]
    tree.leaf_counts = leaf_counts
    n_nodes = len(tree.axis)
    tree.node_lo = [None] * n_nodes
    tree.node_hi = [None] * n_nodes
    tree.node_lo[0] = tree.lo.copy()
    tree.node_hi[0] = tree.hi.copy()
    for i in range(n_nodes):
        c = tree.child[i]
        if c >= 0:
            ax, sp = tree.axis[i], tree.split[i]
            for side in range(2):
                lo = tree.node_lo[i].copy()
                hi = tree.node_hi[i].copy()
                if side == 0:
                    hi[ax] = sp
                else:
                    lo[ax] = sp
                tree.node_lo[c + side] = lo
                tree.node_hi[c + side] = hi
    return tree


def save_checkpoint(path: str, trainer) -> None:
    """Serialize a trainer's guiding state to .asdmm JSON."""
    t = trainer.tree
    obj = {
        "format": "asdmm",
        "version": 1,
        "spatial_norm": trainer.spatial_norm,
        "aabb_lo": _list(trainer.scene.aabb_lo),
        "n_components": trainer.cfg.n_components,
        "iteration": trainer.iteration,
        "tree": {**_tree_meta(t), "leaf_counts": t.leaf_counts.tolist()},
        "mixture": {
            "weight": _list(trainer.sdmm.weight),
            "mean": _list(trainer.sdmm.mean),
            "cov": _list(trainer.sdmm.cov),
        },
        "initialized": _list(trainer.initialized),
    }
    with open(path, "w") as f:
        json.dump(obj, f)


def load_checkpoint(path: str, device: str | torch.device = "cuda"):
    """Load .asdmm JSON → (STree, SDMM, initialized, meta), the tensors on
    ``device``."""
    dev = resolve_device(device)
    with open(path) as f:
        obj = json.load(f)
    tree = _tree_from_meta(obj["tree"],
                           np.asarray(obj["tree"]["leaf_counts"]))
    m = obj["mixture"]
    sdmm = SDMM(*(torch.tensor(m[k], dtype=torch.float32, device=dev)
                  for k in ("weight", "mean", "cov")))
    initialized = torch.tensor(obj["initialized"], dtype=torch.bool,
                               device=dev)
    meta = {
        "spatial_norm": obj["spatial_norm"],
        "aabb_lo": np.asarray(obj["aabb_lo"]),
        "iteration": obj["iteration"],
        "n_components": obj["n_components"],
    }
    return tree, sdmm, initialized, meta


def save_bsdf_mixture(path: str, weight, mean_dir, cov2) -> None:
    """Write a directional learned-BSDF mixture (.sdmm JSON)."""
    obj = {
        "format": "sdmm",
        "version": 1,
        "weight": np.asarray(_np(weight)).tolist(),
        "mean_dir": np.asarray(_np(mean_dir)).tolist(),
        "cov": np.asarray(_np(cov2)).tolist(),
    }
    with open(path, "w") as f:
        json.dump(obj, f)


def load_bsdf_mixture(path: str, device: str | torch.device = "cuda"):
    """Read a .sdmm mixture → (weight, mean_dir, cov) float32 on
    ``device``."""
    dev = resolve_device(device)
    with open(path) as f:
        obj = json.load(f)
    return tuple(torch.tensor(obj[k], dtype=torch.float32, device=dev)
                 for k in ("weight", "mean_dir", "cov"))


def save_full_checkpoint(path: str, trainer, iters) -> None:
    """Mid-render resume checkpoint (.npz, the reference package's schema
    key for key): the model state of the .asdmm file plus the EM running
    statistics, the leaf counters and the per-iteration films. Every
    random draw of a run is seeded from the iteration index, so a restored
    run continues as the uninterrupted one does."""
    t = trainer.tree
    em = trainer.em
    np.savez_compressed(
        path,
        meta=json.dumps({
            "tree": _tree_meta(t),
            "spatial_norm": trainer.spatial_norm,
            "iteration": trainer.iteration,
            "total_spp": trainer.total_spp,
            "n_components": trainer.cfg.n_components,
            "stats": trainer.stats,
        }),
        leaf_counts=np.asarray(t.leaf_counts),
        weight=_np(trainer.sdmm.weight),
        mean=_np(trainer.sdmm.mean),
        cov=_np(trainer.sdmm.cov),
        em_stats_w=_np(em.stats_w),
        em_stats_mean=_np(em.stats_mean),
        em_stats_cov=_np(em.stats_cov),
        em_total_weight=_np(em.total_weight),
        em_iterations=_np(em.iterations),
        initialized=_np(trainer.initialized),
        cum_counts=np.asarray(trainer.cum_counts),
        it_image=np.stack([i["image"] for i in iters])
        if iters else np.zeros((0, 1, 3)),
        it_sqr=np.stack([i["sqr"] for i in iters])
        if iters else np.zeros((0, 1, 3)),
        it_weight=np.stack([i["weight"] for i in iters])
        if iters else np.zeros((0, 1)),
    )


def load_full_checkpoint(path: str, device: str | torch.device = "cuda"):
    """Load a resume checkpoint → (state dict, per-iteration films), the
    tensors on ``device``."""
    from .em import EMState

    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))

    def dt(key, dtype=None):
        return torch.as_tensor(np.array(z[key]), dtype=dtype, device=dev)

    state = {
        "tree": _tree_from_meta(meta["tree"], z["leaf_counts"]),
        "sdmm": SDMM(dt("weight"), dt("mean"), dt("cov")),
        "em": EMState(
            stats_w=dt("em_stats_w"), stats_mean=dt("em_stats_mean"),
            stats_cov=dt("em_stats_cov"),
            total_weight=dt("em_total_weight"),
            iterations=dt("em_iterations", torch.int32)),
        "initialized": dt("initialized", torch.bool),
        "cum_counts": z["cum_counts"],
        "iteration": meta["iteration"],
        "total_spp": meta["total_spp"],
        "stats": meta["stats"],
    }
    iters = [{"image": z["it_image"][i], "sqr": z["it_sqr"][i],
              "weight": z["it_weight"][i]}
             for i in range(z["it_image"].shape[0])]
    return state, iters
