"""Port parity: EM sufficient statistics (the plain twin of
sdmm_tpu_torch/ops/em_suffstats.py against the reference e_step and the
Pallas kernel in interpret mode), the sort-and-tile glue, and the M-step.
Tolerances as in tests/test_em_pallas.py: weights rtol 2e-4, mean and
covariance statistics rtol 2e-4 / 3e-4 with atol 4e-4 of the statistic's
magnitude (signed tangent columns cancel across samples); M-step weights
and means rtol 1e-4, reconstructed covariances rtol 1e-3 (batched eigh).
The kernel-vs-twin cases are in tests/test_torch_gpu.py."""

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
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
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


@pytest.mark.parametrize("reference", ["e_step", "e_step_pallas"])
def test_plain_twin_matches_reference(reference):
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


def test_sort_and_tile_and_pack_params_match():
    """The sorted order and work list against the reference's
    sort_and_tile with its padding stripped: the same samples in the same
    order, the same counts, weight sums within rtol 1e-6."""
    js, ts, pos, d, w, leaf = _problem(1, L=4, S=3000)
    jsamp, jtl, jws, jcnt = jep.sort_and_tile(
        jnp.asarray(pos), jnp.asarray(d), jnp.asarray(w), jnp.asarray(leaf),
        4, 3000)
    rows, order, ls, toff, cnt = tes.sort_and_tile(
        t(pos), t(d), t(w), torch.as_tensor(leaf), 4)
    np.testing.assert_array_equal(to_np(cnt), np.asarray(jcnt))
    # The reference's rows without padding: each leaf's tiles in order, the
    # first count[leaf] slots of them.
    jsamp = np.asarray(jsamp).reshape(8, -1, jep.TILE)
    jtl, jcnt = np.asarray(jtl), np.asarray(jcnt)
    ref = np.concatenate([jsamp[:, jtl == lf].reshape(8, -1)[:, :jcnt[lf]]
                          for lf in range(4)], axis=1)
    n_valid = int(jcnt.sum())
    o = to_np(order)[:n_valid]
    np.testing.assert_array_equal(to_np(rows)[o].T, ref)
    ws = np.add.reduceat(w[o].astype(np.float64), to_np(ls)[:4]) \
        * (np.asarray(jcnt) > 0)
    np.testing.assert_allclose(ws, np.asarray(jws), rtol=1e-6)
    _check_work_list(order, ls, toff, cnt, leaf, 4, tes.TILE)
    np.testing.assert_allclose(
        to_np(tes.pack_params(ts, tmix.prepare(ts))),
        np.asarray(jep.pack_params(js, jmix.prepare(js))), rtol=1e-4,
        atol=1e-5)


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


def _m_step_inputs(seed=0):
    L = 6
    js, ts, pos, d, w, leaf = _problem(seed, L=L, S=6000)
    jprep = jmix.prepare(js)
    stats = jem.e_step(js, jprep, jnp.asarray(pos), jnp.asarray(d),
                       jnp.asarray(w), jnp.asarray(leaf), L)
    rs = np.random.RandomState(seed)
    active = rs.rand(L) < 0.8
    active[0] = True
    iters = rs.randint(0, 6, size=L).astype(np.int32)
    em0 = jem.init_em_state(L, 16)._replace(iterations=jnp.asarray(iters))
    leaf_ext = (0.5 + rs.rand(L, 3)).astype(np.float32)
    return js, ts, jprep, stats, active, em0, leaf_ext


@pytest.mark.parametrize("seed", [0, 1])
def test_m_step_matches_on_identical_statistics(seed):
    js, ts, jprep, stats, active, em0, leaf_ext = _m_step_inputs(seed)
    # Break one component so the kill rule fires on both sides.
    sc = np.asarray(stats[2]).copy()
    sc[0, 3] = -50.0 * np.eye(5) * np.abs(sc[0, 3]).max()
    stats = (stats[0], stats[1], jnp.asarray(sc), stats[3], stats[4])
    cfg = jem.EMConfig()
    jn, jemn = jem.m_step(js, jprep, em0, *stats[:4], jnp.asarray(active),
                          cfg, leaf_ext=jnp.asarray(leaf_ext))
    tem0 = tem.EMState(*(t(x, torch.int32) if x.dtype == jnp.int32 else t(x)
                         for x in em0))
    tn, temn = tem.m_step(ts, tmix.prepare(ts), tem0,
                          *(t(x) for x in stats[:4]), torch.as_tensor(active),
                          tem.EMConfig(), leaf_ext=t(leaf_ext))
    jw, tw = np.asarray(jn.weight), to_np(tn.weight)
    # Same kill pattern, same weights, means and covariances.
    np.testing.assert_array_equal(tw > 0, jw > 0)
    assert (np.asarray(js.weight) > 0).sum() > (jw > 0).sum()  # a kill
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(tn.mean), np.asarray(jn.mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(tn.cov), np.asarray(jn.cov), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jn.cov)).max())
    np.testing.assert_array_equal(to_np(temn.iterations),
                                  np.asarray(jemn.iterations))
    np.testing.assert_allclose(to_np(temn.stats_w), np.asarray(jemn.stats_w),
                               rtol=1e-4, atol=1e-7)


def test_em_step_matches():
    js, ts, pos, d, w, leaf = _problem(3, L=5, S=4000)
    active = np.array([True, True, False, True, True])
    jn, _, jcnt = jem.em_step(js, jem.init_em_state(5, 16), jnp.asarray(pos),
                              jnp.asarray(d), jnp.asarray(w),
                              jnp.asarray(leaf), jnp.asarray(active))
    tn, _, tcnt = tem.em_step(ts, tem.init_em_state(5, 16), t(pos), t(d),
                              t(w), torch.as_tensor(leaf),
                              torch.as_tensor(active), device="cpu")
    np.testing.assert_array_equal(to_np(tcnt), np.asarray(jcnt))
    np.testing.assert_allclose(to_np(tn.weight), np.asarray(jn.weight),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(tn.mean), np.asarray(jn.mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(tn.cov), np.asarray(jn.cov), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jn.cov)).max())


def test_twin_drops_non_finite_posteriors_as_the_reference():
    """A valid sample whose pdf overflows (at the mean of a component of
    covariance 1e-16·I) and one whose posterior total has no finite
    reciprocal: the twin drops both posteriors, so every statistic stays
    finite, and matches the reference's XLA e_step (the kernel against the
    twin on this batch is in tests/test_torch_gpu.py)."""
    from torch_parity import posterior_fault_batch

    weight, mean, cov, pos, d, w, leaf, L = posterior_fault_batch()
    ts = tmix.SDMM(weight=t(weight), mean=t(mean), cov=t(cov))
    prep = tmix.prepare(ts)
    pdf, _, _ = tmix.posterior_and_log(
        ts.weight[leaf[:2]], ts.mean[leaf[:2]], prep.inv_chol[leaf[:2]],
        prep.inv_det_chol[leaf[:2]], prep.rot[leaf[:2]], t(pos[:2]),
        t(d[:2]))
    total = (ts.weight[leaf[:2]] * pdf).sum(-1)
    assert not torch.isfinite(pdf[0]).all()
    assert 0.0 < float(total[1]) and torch.isinf(1.0 / total[1])
    ours = tes.e_step_plain(ts, prep, t(pos), t(d), t(w),
                            torch.as_tensor(leaf), L)
    for x in ours[:4]:
        assert torch.isfinite(x).all()
    js = jmix.SDMM(weight=jnp.asarray(weight), mean=jnp.asarray(mean),
                   cov=jnp.asarray(cov))
    ref = jem.e_step(js, jmix.prepare(js), jnp.asarray(pos), jnp.asarray(d),
                     jnp.asarray(w), jnp.asarray(leaf), L)
    _check_stats(ours, ref)
