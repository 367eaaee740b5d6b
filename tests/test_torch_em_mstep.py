"""Port parity of the EM M-step on identical statistics (the kill rule
firing on both sides) and of the whole EM step against the reference's:
weights and means rtol 1e-4, reconstructed covariances rtol 1e-3 (batched
eigh). The file holds few tests, so that the tier-1 scheduler (``--dist
loadfile``, files with the most tests first) runs it after the long
reference files."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_em import _problem  # noqa: E402
from torch_parity import t, to_np  # noqa: E402

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402

torch.set_num_threads(1)


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
