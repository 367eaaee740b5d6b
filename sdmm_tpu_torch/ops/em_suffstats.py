"""EM E-step sufficient statistics (port of sdmm_tpu/ops/em_pallas.py and of
the plain e_step of sdmm_tpu/guiding/em.py).

``e_step`` is the wrapper of the hand-written CUDA kernels in
``csrc/em_suffstats.cu``. Samples are sorted by leaf and padded so that
every 1024-sample tile belongs to one leaf (``sort_and_tile``, torch glue);
one block per tile sums its partial [K, 21] statistics and a second kernel
adds the contiguous tiles of each leaf, in tile order, into [L, K, 21]. For
a CPU tensor the wrapper runs ``e_step_plain``, the chunked gather +
scatter-add twin of the same statistics.

The 21 statistics per (leaf, component) are Σγw, Σγw·t (5) and the lower
triangle of Σγw·t tᵀ (15), with t = (canonical position, tangent coords).
"""

from __future__ import annotations

import ctypes

import torch

from ..guiding import mixture as mix
from . import _build

TILE = 1024  # samples per tile
K = 16  # mixture components per leaf
NSTAT = 21  # 1 weight + 5 mean + 15 covariance lower-triangle entries
PARAM_COLS = 32  # per-component param scalars
ROWS = 8  # sample attribute rows: px py pz dx dy dz w (1 spare)
TRI_PAIRS = [(i, j) for i in range(5) for j in range(i + 1)]


def e_step_plain(sdmm, prep, pos, d, weight, leaf, n_leaves: int,
                 batch_size: int = 1 << 16):
    """Sufficient statistics via chunked gather + scatter-add (the plain
    twin). Samples with a negative or non-finite weight are invalid; zero
    weights are counted but add nothing.

    Returns (stats_w [L,K], stats_mean [L,K,5], stats_cov [L,K,5,5],
    weight_sum [L], count [L] int32).
    """
    L = n_leaves
    k = sdmm.weight.shape[-1]
    dev, dt = pos.device, pos.dtype
    sw = torch.zeros((L, k), dtype=dt, device=dev)
    sm = torch.zeros((L, k, 5), dtype=dt, device=dev)
    sc = torch.zeros((L, k, 5, 5), dtype=dt, device=dev)
    ws = torch.zeros(L, dtype=dt, device=dev)
    cnt = torch.zeros(L, dtype=torch.int32, device=dev)
    for sl in range(0, pos.shape[0], batch_size):
        cp = pos[sl:sl + batch_size]
        cd = d[sl:sl + batch_size]
        cw = weight[sl:sl + batch_size]
        raw = leaf[sl:sl + batch_size].long()
        # Out-of-range leaf ids read a clamped row and add nothing (XLA's
        # clamped gather and dropped scatter).
        in_range = (raw >= 0) & (raw < L)
        cl = raw.clamp(0, L - 1)
        cv = torch.isfinite(cw) & (cw >= 0.0) & in_range
        _, post, t_abs = mix.posterior_and_log(
            sdmm.weight[cl], sdmm.mean[cl], prep.inv_chol[cl],
            prep.inv_det_chol[cl], prep.rot[cl], cp, cd)
        post = torch.where((post < 1e-10) | ~torch.isfinite(post), 0.0, post)
        t_abs = torch.nan_to_num(t_abs, nan=0.0, posinf=0.0, neginf=0.0)
        wgt = torch.where(cv, cw, 0.0)
        gw = wgt[:, None] * post  # [B, K]
        sw.index_add_(0, cl, gw)
        sm.index_add_(0, cl, gw[..., None] * t_abs)
        sc.index_add_(0, cl, gw[..., None, None] * t_abs[..., :, None]
                      * t_abs[..., None, :])
        ws.index_add_(0, cl, wgt)
        cnt.index_add_(0, cl, cv.to(torch.int32))
    return sw, sm, sc, ws, cnt


def pack_params(sdmm, prep) -> torch.Tensor:
    """[L+1, K, 32] per-component scalars: w, mean (6), rot (9), inv_chol
    lower triangle row-major (15), inv_det. Row L is an all-zero dummy."""
    L, k = sdmm.weight.shape
    tri_i, tri_j = zip(*TRI_PAIRS)
    icl = prep.inv_chol[..., list(tri_i), list(tri_j)]  # [L, K, 15]
    par = torch.cat([
        sdmm.weight[..., None], sdmm.mean, prep.rot.reshape(L, k, 9), icl,
        prep.inv_det_chol[..., None],
    ], dim=-1)
    return torch.cat([par, torch.zeros((1, k, PARAM_COLS), device=par.device)],
                     dim=0).contiguous()


def sort_and_tile(pos, d, weight, leaf, n_leaves: int, cap: int):
    """Sort samples by leaf and pad each leaf's run to whole tiles.

    Returns (samples [8, cap_tiles·TILE] attribute-major, tile_leaf
    [cap_tiles] int32 (L for unused tiles), tile_off [L+1] int32 (first
    tile of each leaf), weight_sum [L], count [L] int32), with cap_tiles =
    cap // TILE + L + 1. Invalid samples (non-finite or negative weight, or
    a leaf out of range) are dropped from the tiles and from the counts.
    """
    L = n_leaves
    s = pos.shape[0]
    if s > cap:
        raise ValueError(f"{s} samples exceed cap {cap}")
    dev = pos.device
    valid = torch.isfinite(weight) & (weight >= 0) & (leaf >= 0) & (leaf < L)
    leaf_eff = torch.where(valid, leaf.long(), L)
    counts = torch.zeros(L + 1, dtype=torch.int64, device=dev).index_add_(
        0, leaf_eff, torch.ones_like(leaf_eff))
    counts[L] = 0  # invalid samples go to the dump area
    tiles_per_leaf = (counts[:L] + TILE - 1) // TILE
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    tile_off = torch.cat([zero, torch.cumsum(tiles_per_leaf, 0)])  # [L+1]
    start_orig = torch.cat([zero, torch.cumsum(counts, 0)])  # [L+2]

    order = torch.sort(leaf_eff, stable=True).indices
    cap_tiles = cap // TILE + L + 1
    rows_nm = torch.stack([
        pos[:, 0], pos[:, 1], pos[:, 2], d[:, 0], d[:, 1], d[:, 2],
        torch.where(valid, weight, 0.0), torch.zeros_like(weight),
    ], dim=1)
    rows_nm = torch.cat([rows_nm, torch.zeros((1, ROWS), device=dev)])

    n_used = tile_off[L]
    tids = torch.arange(cap_tiles, dtype=torch.int64, device=dev)
    tleaf = (torch.searchsorted(tile_off, tids, right=True) - 1).clamp(0, L - 1)
    tile_leaf = torch.where(tids < n_used, tleaf, L)

    # Sort ∘ pad as one row gather: each output slot's source sample.
    slot = torch.arange(cap_tiles * TILE, dtype=torch.int64, device=dev)
    slot_tile = slot // TILE
    slot_leaf = tleaf[slot_tile]
    within = slot - tile_off[slot_leaf] * TILE
    fill = (within >= 0) & (within < counts[slot_leaf]) & (slot_tile < n_used)
    src = torch.where(fill, start_orig[slot_leaf] + within, s)
    osrc = torch.where(fill, order[src.clamp(0, max(s - 1, 0))], s)
    samples = rows_nm[osrc].T.contiguous()

    wgt = torch.where(valid, weight, 0.0)
    weight_sum = torch.zeros(L + 1, device=dev).index_add_(0, leaf_eff, wgt)
    count = torch.zeros(L + 1, dtype=torch.int32, device=dev).index_add_(
        0, leaf_eff, valid.to(torch.int32))
    return (samples, tile_leaf.to(torch.int32), tile_off.to(torch.int32),
            weight_sum[:L], count[:L])


def assemble(flat: torch.Tensor, count: torch.Tensor):
    """[L, K, 21] statistics → (stats_w, stats_mean, stats_cov), zero for
    leaves without samples."""
    L, k, _ = flat.shape
    visited = (count > 0)[:, None]
    sw = torch.where(visited, flat[..., 0], 0.0)
    sm = torch.where(visited[..., None], flat[..., 1:6], 0.0)
    tri_i, tri_j = zip(*TRI_PAIRS)
    cov = torch.zeros((L, k, 5, 5), device=flat.device)
    cov[..., list(tri_i), list(tri_j)] = flat[..., 6:21]
    cov[..., list(tri_j), list(tri_i)] = flat[..., 6:21]
    sc = torch.where(visited[..., None, None], cov, 0.0)
    return sw, sm, sc


def _lib():
    lib = _build.load("em_suffstats")
    fn = lib.em_suffstats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def suffstats(samples, tile_leaf, tile_off, params, n_leaves: int):
    """Launch the two kernels on tiled samples; returns [L, K, 21]."""
    cap_tiles = tile_leaf.shape[0]
    dev = samples.device
    _build.check_inputs("em_suffstats", (
        ("samples", samples, (ROWS, cap_tiles * TILE), torch.float32),
        ("tile_leaf", tile_leaf, (cap_tiles,), torch.int32),
        ("tile_off", tile_off, (n_leaves + 1,), torch.int32),
        ("params", params, (n_leaves + 1, K, PARAM_COLS), torch.float32)))
    partial = torch.empty((cap_tiles, K, NSTAT), device=dev)
    out = torch.empty((n_leaves, K, NSTAT), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(samples.data_ptr(), cap_tiles * TILE, tile_leaf.data_ptr(),
                cap_tiles, params.data_ptr(), tile_off.data_ptr(), n_leaves,
                partial.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "em_suffstats")
    suffstats.launches += 1
    return out


suffstats.launches = 0


def e_step(sdmm, prep, pos, d, weight, leaf, n_leaves: int,
           batch_size: int = 1 << 16):
    """E-step statistics (see ``e_step_plain`` for the outputs). CUDA
    tensors go through the kernels, CPU tensors through the twin."""
    if pos.device.type == "cpu":
        return e_step_plain(sdmm, prep, pos, d, weight, leaf, n_leaves,
                            batch_size)
    if sdmm.weight.shape[-1] != K:
        raise NotImplementedError(
            f"the E-step kernel is specialised to K = {K} components")
    samples, tile_leaf, tile_off, weight_sum, count = sort_and_tile(
        pos, d, weight, leaf, n_leaves, pos.shape[0])
    flat = suffstats(samples, tile_leaf, tile_off, pack_params(sdmm, prep),
                     n_leaves)
    sw, sm, sc = assemble(flat, count)
    return sw, sm, sc, weight_sum, count
