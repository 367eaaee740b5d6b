"""Port parity of the EM E-step's plain twin against the reference's XLA
e_step (also on a batch whose posteriors overflow, where both drop them),
and of the sort-and-tile glue and pack_params against the reference's.
Tolerances as in tests/test_torch_em.py. The file holds few tests, so
that the tier-1 scheduler (``--dist loadfile``, files with the most tests
first) runs it after the long reference files."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_em import (  # noqa: E402
    _check_stats, _check_work_list, _plain_twin_matches, _problem,
)
from torch_parity import t, to_np  # noqa: E402

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.ops import em_pallas as jep  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.ops import em_suffstats as tes  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("reference", ["e_step"])
def test_plain_twin_matches_reference(reference):
    _plain_twin_matches(reference)


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


def test_twin_drops_non_finite_posteriors_as_the_reference():
    """A valid sample whose pdf overflows (at the mean of a component of
    covariance 1e-16·I) and one whose posterior total has no finite
    reciprocal: the twin drops both posteriors, so every statistic stays
    finite, and matches the reference's XLA e_step (the kernel against the
    twin on this batch is in tests/test_torch_gpu_em.py)."""
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
