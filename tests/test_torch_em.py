"""Port parity: EM sufficient statistics (the plain twin of
sdmm_tpu_torch/ops/em_suffstats.py against the reference e_step and the
Pallas kernel in interpret mode), the sort-and-tile glue, and the M-step.
Tolerances as in tests/test_em_pallas.py: weights rtol 2e-4, mean and
covariance statistics rtol 2e-4 / 3e-4 with atol 4e-4 of the statistic's
magnitude (signed tangent columns cancel across samples); M-step weights
and means rtol 1e-4, reconstructed covariances rtol 1e-3 (batched eigh).
This file holds the work list's edge cases; files of few tests, which the
tier-1 scheduler (``--dist loadfile``, files with the most tests first)
runs after the long reference files, hold the comparisons that compile a
reference: the twin against the XLA e_step, the sort-and-tile glue and
the non-finite posteriors (tests/test_torch_em_reference.py), the M-step
and the whole EM step (tests/test_torch_em_mstep.py), and the twin
against the Pallas kernel in interpret mode (tests/test_torch_em_kernel.py,
~2 minutes of CPU); the kernel-vs-twin cases are in
tests/test_torch_gpu_em.py."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_mixture_state, t, to_np  # noqa: E402

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.ops import em_pallas as jep  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.ops import em_suffstats as tes  # noqa: E402

torch.set_num_threads(1)


def _problem(seed=0, L=5, S=5000):
    st = make_mixture_state(seed, L)
    rs = np.random.RandomState(100 + seed)
    pos = rs.rand(S, 3).astype(np.float32)
    d = rs.randn(S, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = (rs.rand(S) * 2.0).astype(np.float32)
    w[::97] = 0.0
    w[1::211] = -1.0
    w[2::503] = np.nan
    leaf = rs.randint(0, L, size=S).astype(np.int32)
    js = jmix.SDMM(weight=jnp.asarray(st["weight"]),
                   mean=jnp.asarray(st["mean"]), cov=jnp.asarray(st["cov"]))
    ts = tmix.SDMM(weight=t(st["weight"]), mean=t(st["mean"]),
                   cov=t(st["cov"]))
    return js, ts, pos, d, w, leaf


def _check_stats(ours, ref):
    sw1, sm1, sc1, ws1, cnt1 = (to_np(x) for x in ours)
    sw0, sm0, sc0, ws0, cnt0 = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(cnt1, cnt0)
    np.testing.assert_allclose(ws1, ws0, rtol=1e-5)
    np.testing.assert_allclose(sw1, sw0, rtol=2e-4,
                               atol=2e-5 * (np.abs(sw0).max() + 1e-12))
    np.testing.assert_allclose(sm1, sm0, rtol=2e-4,
                               atol=4e-4 * (np.abs(sm0).max() + 1e-12))
    np.testing.assert_allclose(sc1, sc0, rtol=3e-4,
                               atol=4e-4 * (np.abs(sc0).max() + 1e-12))


def _plain_twin_matches(reference):
    """The twin's statistics on _problem() against the reference's XLA
    e_step or its Pallas kernel in interpret mode; the CPU wrapper gives
    the twin's bits."""
    js, ts, pos, d, w, leaf = _problem()
    L = 5
    jargs = (js, jmix.prepare(js), jnp.asarray(pos), jnp.asarray(d),
             jnp.asarray(w), jnp.asarray(leaf), L)
    if reference == "e_step":
        ref = jem.e_step(*jargs, batch_size=1 << 12)
    else:
        ref = jep.e_step_pallas(*jargs, interpret=True)
    ours = tes.e_step_plain(ts, tmix.prepare(ts), t(pos), t(d), t(w),
                            torch.as_tensor(leaf), L, batch_size=1 << 12)
    _check_stats(ours, ref)
    # The CPU wrapper is the twin.
    again = tes.e_step(ts, tmix.prepare(ts), t(pos), t(d), t(w),
                       torch.as_tensor(leaf), L, batch_size=1 << 12)
    for a, b in zip(again, ours):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def _check_work_list(order, leaf_start, tile_off, count, leaf, L, tile):
    """Every tile covers a run of one leaf, at most ``tile`` long, and the
    tiles of each leaf cover its run exactly once, in order; the sorted
    runs hold that leaf's valid samples."""
    n_tiles = tes.cap_tiles(order.shape[0], L, tile)
    tl, start, end = (to_np(x) for x in tes.work_list(leaf_start, tile_off,
                                                      n_tiles, tile))
    ls, off, order, leaf = (to_np(x) for x in (leaf_start, tile_off, order,
                                               leaf))
    np.testing.assert_array_equal(np.diff(ls), to_np(count))
    used = tl < L
    assert used.sum() == off[L] <= n_tiles
    assert (end[used] - start[used] >= 1).all()
    assert (end[used] - start[used] <= tile).all()
    for lf in range(L):
        mine = np.flatnonzero(tl == lf)
        np.testing.assert_array_equal(mine, np.arange(off[lf], off[lf + 1]))
        cover = np.concatenate([np.arange(a, b) for a, b in
                                zip(start[mine], end[mine])] or [[]])
        np.testing.assert_array_equal(cover, np.arange(ls[lf], ls[lf + 1]))
        assert (leaf[order[ls[lf]:ls[lf + 1]]] == lf).all()


@pytest.mark.parametrize("case", ["sizes", "all invalid", "empty"])
def test_work_list_edge_cases(case):
    """Leaves of 0, 1, TILE and TILE + 1 samples (and one of 2 TILE + 5),
    with invalid rows interleaved; every sample invalid; no samples."""
    tile, L = tes.TILE, 6
    sizes = {"sizes": [0, 1, tile, tile + 1, 2 * tile + 5, 0],
             "all invalid": [3, 0, 7, 0, 0, 1], "empty": [0] * L}[case]
    rs = np.random.RandomState(3)
    leaf = rs.permutation(np.repeat(np.arange(L), sizes)).astype(np.int64)
    w = rs.rand(leaf.size).astype(np.float32)
    if case == "all invalid":
        w[:] = -1.0
    elif case == "sizes":  # invalid rows: negative, NaN, out of range
        leaf = np.concatenate([leaf, [2, 3, 4, -1, L]])
        w = np.concatenate([w, [-1.0, np.nan, np.inf, 0.5, 0.5]]
                           ).astype(np.float32)
    n = leaf.size
    pos, dirs = rs.rand(n, 3), rs.randn(n, 3)
    dirs /= np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-6)
    _, order, ls, toff, cnt = tes.sort_and_tile(
        t(pos), t(dirs), t(w), torch.as_tensor(leaf), L)
    want = sizes if case != "all invalid" else [0] * L
    np.testing.assert_array_equal(to_np(cnt), want)
    _check_work_list(order, ls, toff, cnt, leaf, L, tile)
    assert int(to_np(toff)[L]) == sum(-(-c // tile) for c in want)
    # The statistics of a leaf without samples are zero.
    st = make_mixture_state(4, L)
    sdmm = tmix.SDMM(weight=t(st["weight"]), mean=t(st["mean"]),
                     cov=t(st["cov"]))
    out = tes.e_step(sdmm, tmix.prepare(sdmm), t(pos), t(dirs), t(w),
                     torch.as_tensor(leaf), L)
    np.testing.assert_array_equal(to_np(out[4]), want)
    for lf in np.flatnonzero(np.asarray(want) == 0):
        assert all(float(x[lf].abs().sum()) == 0.0 for x in out[:4])


def test_empty_and_single_leaf():
    js, ts, pos, d, w, leaf = _problem(2, L=4, S=1500)
    leaf[:] = 2
    sw, sm, sc, ws, cnt = tes.e_step_plain(
        ts, tmix.prepare(ts), t(pos), t(d), t(w), torch.as_tensor(leaf), 4)
    cnt = to_np(cnt)
    assert cnt[0] == cnt[1] == cnt[3] == 0 and cnt[2] > 0
    np.testing.assert_array_equal(to_np(sw[0]), 0.0)
    assert float(sw[2].sum()) > 0.0
    # Symmetric up to the order of the products t_i t_j.
    sc2 = to_np(sc[2])
    np.testing.assert_allclose(sc2, np.swapaxes(sc2, -1, -2), rtol=0,
                               atol=1e-6 * np.abs(sc2).max())
