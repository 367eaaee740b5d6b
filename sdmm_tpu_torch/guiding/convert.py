"""Carry a trainer's state across as numpy arrays.

``trainer_state_to_numpy`` reads any trainer with the reference package's
attribute layout (its own or the port's: ``sdmm``, ``em``, ``initialized``,
``tree``, ``iteration``, ``total_spp``);
``trainer_state_from_numpy`` loads such a state into a port trainer, so
that both then hold the same model. The same goes for a PPG trainer's state
(``ppg_state_to_numpy``, ``ppg_state_from_numpy``), a learned-BSDF table
and a sample reservoir (``tensors_from_numpy``), and for a scene:
``scene_from_arrays`` builds the port's ``SceneData`` from any scene with
the reference's field layout, its Irawan weave tables (the normalisation
constant as it was drawn there) and keyframed motion included, so that
both packages then render the same scene. The light-path integrators'
state goes the same way: a photon map and its grid
(``photons_from_arrays``, ``photon_grid_from_arrays``) and a VPL set
(``vpls_from_arrays``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from . import mixture as mix
from .em import EMState
from .stree import STree

_TREE_LISTS = ("axis", "split", "child", "leaf", "depth")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tree_to_numpy(t) -> dict:
    return {
        **{k: list(getattr(t, k)) for k in _TREE_LISTS},
        "node_lo": [np.asarray(a) for a in t.node_lo],
        "node_hi": [np.asarray(a) for a in t.node_hi],
        "lo": np.asarray(t.lo), "hi": np.asarray(t.hi),
        "n_leaves": int(t.n_leaves),
        "leaf_counts": np.asarray(t.leaf_counts),
        "max_leaves": int(t.max_leaves),
        "split_threshold": int(t.split_threshold),
    }


def _tree_from_numpy(td: dict) -> STree:
    tree = STree(td["lo"], td["hi"], max_leaves=td["max_leaves"],
                 split_threshold=td["split_threshold"])
    for k in _TREE_LISTS:
        setattr(tree, k, list(td[k]))
    tree.node_lo = [np.asarray(a, np.float64) for a in td["node_lo"]]
    tree.node_hi = [np.asarray(a, np.float64) for a in td["node_hi"]]
    tree.n_leaves = int(td["n_leaves"])
    tree.leaf_counts = np.asarray(td["leaf_counts"], np.float64).copy()
    return tree


def tensors_from_numpy(d: dict, device) -> dict:
    """A dict of arrays (a learned-BSDF table, a sample reservoir) as
    tensors on ``device``, float64 arrays as float32."""
    def conv(a):
        a = np.array(a)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(a, device=device)

    return {k: conv(v) for k, v in d.items()}


def scene_from_arrays(scene, device="cuda"):
    """The port's ``SceneData`` on ``device`` from ``scene``: a NamedTuple
    with the reference's fields (either package's) or a dict of arrays.
    Every field is copied as it is (``iw_consts`` too: its specular
    normalisation is a Monte Carlo estimate, and recomputing it would draw
    other samples); the port's own fields are derived from the clusters."""
    from ..scene.scene import scene_from_numpy

    arrays = scene if isinstance(scene, dict) else scene._asdict()
    return scene_from_numpy({k: _np(v) for k, v in arrays.items()}, device)


def photons_from_arrays(photons: dict, device="cuda") -> dict:
    """A photon map (``trace_photons``' dict: p, wi, n, power, valid) of
    either package as the port's tensors on ``device``."""
    return tensors_from_numpy({k: _np(v) for k, v in photons.items()},
                              resolve_device(device))


def photon_grid_from_arrays(grid: dict, device="cuda") -> dict:
    """A photon grid (``build_photon_grid``'s dict: order, cids, dims, lo,
    inv_cell) of either package as the port's on ``device``: order as
    int64, cids and dims int32, lo float32, inv_cell a Python float."""
    dev = resolve_device(device)
    return {"order": torch.as_tensor(_np(grid["order"]).astype(np.int64),
                                     device=dev),
            "cids": torch.as_tensor(_np(grid["cids"]).astype(np.int32),
                                    device=dev).contiguous(),
            "dims": torch.as_tensor(_np(grid["dims"]).astype(np.int32),
                                    device=dev),
            "lo": torch.as_tensor(_np(grid["lo"]).astype(np.float32),
                                  device=dev),
            "inv_cell": float(_np(grid["inv_cell"]))}


def vpls_from_arrays(vpls: dict, device="cuda") -> dict:
    """A VPL set (``generate_vpls``' dict: p, n, wi, beta, kind, bsdf, uv,
    valid) of either package as the port's tensors on ``device``."""
    return tensors_from_numpy({k: _np(v) for k, v in vpls.items()},
                              resolve_device(device))


def trainer_state_to_numpy(tr) -> dict:
    t = tr.tree
    return {
        "sdmm_weight": _np(tr.sdmm.weight),
        "sdmm_mean": _np(tr.sdmm.mean),
        "sdmm_cov": _np(tr.sdmm.cov),
        "em_stats_w": _np(tr.em.stats_w),
        "em_stats_mean": _np(tr.em.stats_mean),
        "em_stats_cov": _np(tr.em.stats_cov),
        "em_total_weight": _np(tr.em.total_weight),
        "em_iterations": _np(tr.em.iterations),
        "initialized": _np(tr.initialized),
        "tree": _tree_to_numpy(t),
        "iteration": int(tr.iteration),
        "total_spp": int(tr.total_spp),
    }


def trainer_state_from_numpy(tr, d: dict):
    """Load the numpy state ``d`` into the port trainer ``tr`` (on its
    device); rebuilds the tree tables and the prepared mixtures."""
    dev = tr.device

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    tr.tree = _tree_from_numpy(d["tree"])
    tr.tables = tr.tree.device_tables(dev)
    tr.sdmm = mix.SDMM(weight=f32(d["sdmm_weight"]), mean=f32(d["sdmm_mean"]),
                       cov=f32(d["sdmm_cov"]))
    tr.em = EMState(
        stats_w=f32(d["em_stats_w"]), stats_mean=f32(d["em_stats_mean"]),
        stats_cov=f32(d["em_stats_cov"]),
        total_weight=f32(d["em_total_weight"]),
        iterations=torch.as_tensor(np.array(d["em_iterations"], np.int32),
                                   device=dev),
    )
    tr.initialized = torch.as_tensor(np.array(d["initialized"], bool),
                                     device=dev)
    tr.prep = mix.prepare(tr.sdmm)
    tr.iteration = int(d["iteration"])
    tr.total_spp = int(d["total_spp"])
    tr._bump_model_version()


_PPG_ARRAYS = ("hist", "initialized", "theta", "adam_m1", "adam_m2",
               "adam_t")


def ppg_state_to_numpy(tr) -> dict:
    """A PPG trainer's histograms, fraction state, tree and iteration
    (either package's)."""
    return {**{k: _np(getattr(tr, k)) for k in _PPG_ARRAYS},
            "tree": _tree_to_numpy(tr.tree), "iteration": int(tr.iteration)}


def ppg_state_from_numpy(tr, d: dict):
    """Load the numpy PPG state ``d`` into the port's PPGTrainer ``tr``."""
    for k in _PPG_ARRAYS:
        a = np.array(d[k])
        setattr(tr, k, torch.as_tensor(
            a.astype(np.float32) if a.dtype == np.float64 else a,
            device=tr.device))
    tr.tree = _tree_from_numpy(d["tree"])
    tr.tables = tr.tree.device_tables(tr.device)
    tr.iteration = int(d["iteration"])
