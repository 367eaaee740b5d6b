"""Guiding-model checkpoints, ``.asdmm`` JSON (port of the ``.asdmm`` half of
sdmm_tpu/guiding/io.py, in the same schema).

A checkpoint holds the spatial tree, every leaf's mixture parameters, the
initialised flags and the normalisation of the guiding domain, so a file
written by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.device import resolve_device
from .mixture import SDMM
from .stree import STree


def _list(t: torch.Tensor) -> list:
    return t.detach().cpu().numpy().tolist()


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
        "tree": {
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
            "leaf_counts": t.leaf_counts.tolist(),
        },
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
    td = obj["tree"]
    tree = STree(np.asarray(td["lo"]), np.asarray(td["hi"]),
                 max_leaves=td["max_leaves"],
                 split_threshold=td["split_threshold"])
    tree.axis = list(td["axis"])
    tree.split = list(td["split"])
    tree.child = list(td["child"])
    tree.leaf = list(td["leaf"])
    tree.depth = list(td["depth"])
    tree.n_leaves = td["n_leaves"]
    tree.leaf_counts = np.asarray(td["leaf_counts"])
    # Node bounds from a walk down the tree.
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
