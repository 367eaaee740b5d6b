"""EM E-step sufficient statistics (port of sdmm_tpu/ops/em_pallas.py and of
the plain e_step of sdmm_tpu/guiding/em.py).

``e_step`` is the wrapper of the hand-written CUDA kernels in
``csrc/em_suffstats.cu``, one pipeline on the card with no host sync and no
padded copy of the samples. ``sort_and_tile`` writes a key, a packed
32-byte row and per-chunk leaf counts for every sample (an invalid one
takes the key ``n_leaves`` and nothing else), sorts the valid samples
stably by leaf with a counting sort, and scans each leaf's run of the
order and its first tile. ``suffstats`` then runs one block per tile of at
most ``TILE`` samples of one leaf, read through the order, that sums its
partial [K, 21] statistics, and a per-leaf pass that adds the tiles in tile
order into the outputs. For a CPU tensor the wrapper runs
``e_step_plain``, the chunked gather + scatter-add twin of the same
statistics; ``sort_and_tile`` has its plain twin, and ``work_list`` is the
plain model of the run each tile block derives.

The 21 statistics per (leaf, component) are Σγw, Σγw·t (5) and the lower
triangle of Σγw·t tᵀ (15), with t = (canonical position, tangent coords).
"""

from __future__ import annotations

import ctypes

import torch

from ..guiding import mixture as mix
from . import _build

TILE = 512  # most samples of one leaf a tile block covers
SORT_CHUNK = 8192  # samples a block of the counting sort takes (the .cu's)
K = 16  # mixture components per leaf
NSTAT = 21  # 1 weight + 5 mean + 15 covariance lower-triangle entries
PARAM_COLS = 32  # per-component param scalars


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
    ic = prep.inv_chol
    out = torch.zeros((L + 1, k, PARAM_COLS), dtype=sdmm.weight.dtype,
                      device=sdmm.weight.device)
    torch.cat([sdmm.weight[..., None], sdmm.mean, prep.rot.reshape(L, k, 9),
               *(ic[..., i, :i + 1] for i in range(5)),
               prep.inv_det_chol[..., None]], dim=-1, out=out[:L])
    return out


def sort_and_tile_plain(pos, d, weight, leaf, n_leaves: int,
                        tile: int = TILE):
    """Plain twin of the kernels' packing, sort and work list: (rows [S, 8]
    float32, (px py pz dx dy dz w 0) of each valid sample, zeros for the
    others; order [S] int32, the valid samples sorted stably by leaf, then
    the invalid ones; leaf_start [L+1] int32, leaf l's run of the order is
    [leaf_start[l], leaf_start[l+1]); tile_off [L+1] int32, leaf l's first
    tile, each tile holding at most ``tile`` of its samples; count [L]
    int32, valid samples per leaf). Invalid samples (a non-finite or
    negative weight, or a leaf out of range) are in no run."""
    valid = torch.isfinite(weight) & (weight >= 0) & (leaf >= 0) \
        & (leaf < n_leaves)
    key = torch.where(valid, leaf.long(), n_leaves)
    rows = torch.where(valid[:, None], torch.cat(
        [pos, d, weight[:, None], torch.zeros_like(pos[:, :1])], dim=1), 0.0)
    count = torch.bincount(key, minlength=n_leaves + 1)[:n_leaves]
    order = torch.sort(key, stable=True).indices
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    leaf_start = torch.cat([zero, torch.cumsum(count, 0)])
    tile_off = torch.cat([zero, torch.cumsum((count + tile - 1) // tile, 0)])
    i32 = torch.int32
    return (rows, order.to(i32), leaf_start.to(i32), tile_off.to(i32),
            count.to(i32))


def sort_and_tile(pos, d, weight, leaf, n_leaves: int, tile: int = TILE):
    """The packed rows, the sorted order and the work list of the tile
    blocks (see ``sort_and_tile_plain``; on the card the rows of invalid
    samples and the order past the valid ones are left unwritten). On the
    card one launch function runs the keys kernel (keys, chunk histograms,
    packed rows), a hand-written stable counting sort (scans of the chunk
    histograms, the scans over the leaves, a scatter) and no host sync;
    CPU tensors go through the twin."""
    if pos.device.type == "cpu":
        return sort_and_tile_plain(pos, d, weight, leaf, n_leaves, tile)
    s = pos.shape[0]
    dev = pos.device
    if leaf.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"em_suffstats: leaf ids must be int32 or int64, "
                         f"got {leaf.dtype}")
    f32, i32 = torch.float32, torch.int32
    _build.check_inputs("em_suffstats", (
        ("pos", pos, (s, 3), f32), ("d", d, (s, 3), f32),
        ("weight", weight, (s,), f32), ("leaf", leaf, (s,), leaf.dtype)))
    key = torch.empty(s, dtype=i32, device=dev)
    hist = torch.empty(-(-s // SORT_CHUNK) * n_leaves, dtype=i32,
                       device=dev)
    rows = torch.empty((s, 8), device=dev)
    count = torch.empty(n_leaves, dtype=i32, device=dev)
    leaf_start = torch.empty(n_leaves + 1, dtype=i32, device=dev)
    tile_off = torch.empty(n_leaves + 1, dtype=i32, device=dev)
    order = torch.empty(s, dtype=i32, device=dev)
    rc = _lib().em_sort_launch(
        pos.data_ptr(), d.data_ptr(), weight.data_ptr(), leaf.data_ptr(),
        leaf.element_size(), s, n_leaves, tile, key.data_ptr(),
        hist.data_ptr(), rows.data_ptr(), count.data_ptr(),
        leaf_start.data_ptr(), tile_off.data_ptr(), order.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "em_sort")
    return rows, order, leaf_start, tile_off, count


def cap_tiles(n_samples: int, n_leaves: int, tile: int = TILE) -> int:
    """Tile blocks to launch, from shapes alone: Σ ceil(count_l / tile) <=
    n_samples // tile + n_leaves."""
    return n_samples // tile + n_leaves


def work_list(leaf_start, tile_off, n_tiles: int, tile: int = TILE):
    """What tile block b of ``n_tiles`` covers, as the kernel derives it:
    (leaf [n_tiles] int64, n_leaves for a block past the last tile; start,
    end [n_tiles] int64, its run [start, end) of the sorted order)."""
    L = tile_off.shape[0] - 1
    off, ls = tile_off.long(), leaf_start.long()
    b = torch.arange(n_tiles, device=off.device)
    lf = (torch.searchsorted(off, b, right=True) - 1).clamp(0, max(L - 1, 0))
    used = b < off[L]
    start = ls[lf] + (b - off[lf]) * tile
    end = torch.minimum(start + tile, ls[lf + 1])
    return (torch.where(used, lf, L), torch.where(used, start, 0),
            torch.where(used, end, 0))


def _lib():
    lib = _build.load("em_suffstats")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("em_sort_launch", [vp] * 4 + [i] * 4 + [vp] * 8),
                       ("em_stats_launch", [vp] * 4 + [i] * 3 + [vp] * 7)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def suffstats(rows, order, leaf_start, tile_off, params, n_leaves: int,
              tile: int = TILE):
    """Launch the tile and reduction kernels on the packed rows through the
    sorted order; returns (stats_w [L,K], stats_mean [L,K,5], stats_cov
    [L,K,5,5], weight_sum [L])."""
    s = rows.shape[0]
    dev = rows.device
    i32 = torch.int32
    _build.check_inputs("em_suffstats", (
        ("rows", rows, (s, 8), torch.float32),
        ("order", order, (s,), i32),
        ("leaf_start", leaf_start, (n_leaves + 1,), i32),
        ("tile_off", tile_off, (n_leaves + 1,), i32),
        ("params", params, (n_leaves + 1, K, PARAM_COLS), torch.float32)))
    n_tiles = cap_tiles(s, n_leaves, tile)
    partial = torch.empty(n_tiles * (K * NSTAT + 1), device=dev)
    sw = torch.empty((n_leaves, K), device=dev)
    sm = torch.empty((n_leaves, K, 5), device=dev)
    sc = torch.empty((n_leaves, K, 5, 5), device=dev)
    ws = torch.empty(n_leaves, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().em_stats_launch(
        rows.data_ptr(), order.data_ptr(), leaf_start.data_ptr(),
        tile_off.data_ptr(), n_leaves, tile, n_tiles, params.data_ptr(),
        partial.data_ptr(), sw.data_ptr(), sm.data_ptr(), sc.data_ptr(),
        ws.data_ptr(), stream)
    _build.check(rc, "em_suffstats")
    suffstats.launches += 1
    return sw, sm, sc, ws


suffstats.launches = 0


def e_step(sdmm, prep, pos, d, weight, leaf, n_leaves: int,
           batch_size: int = 1 << 16):
    """E-step statistics (see ``e_step_plain`` for the outputs). CUDA
    tensors go through the kernels, CPU tensors through the twin; the
    kernels take K = 16 components (``guiding.em.use_em_kernel`` sends
    other K to ``e_step_plain``)."""
    if pos.device.type == "cpu":
        return e_step_plain(sdmm, prep, pos, d, weight, leaf, n_leaves,
                            batch_size)
    if sdmm.weight.shape[-1] != K:
        raise NotImplementedError(
            f"the E-step kernel is specialised to K = {K} components")
    rows, order, leaf_start, tile_off, count = sort_and_tile(
        pos, d, weight, leaf, n_leaves)
    sw, sm, sc, ws = suffstats(rows, order, leaf_start, tile_off,
                               pack_params(sdmm, prep), n_leaves)
    return sw, sm, sc, ws, count


def kernel_info() -> dict[str, dict[str, int]]:
    """Registers, spilled (local) bytes, static shared bytes and resident
    blocks an SM of the tile and reduction kernels, as built."""
    return _build.kernel_info("em_suffstats", "em_suffstats_info",
                              ("em_tile", "em_reduce"))
