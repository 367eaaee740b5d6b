"""Port parity of mixtures of K = 8 components (the K of the reference's
own training tests, tests/test_guided.py), sdmm_tpu_torch vs sdmm_tpu on
the same seeded numpy inputs: a whole EM step against the reference's
(its E-step the chunked scan, as the reference routes K != 16), the
conditional sample drawn from given uniforms, and a 16x16 training run of
two iterations against the reference's in expectation (the two runs'
films, summed over the iterations, within 4 joint standard errors of
their means: the seed-to-seed spread of either at 16 spp is ~8%; the
reference's run compiles in a background thread). Tolerances as in
tests/test_torch_em_mstep.py and tests/test_torch_mixture_conditional.py.
Few tests, so that the tier-1 scheduler (``--dist loadfile``, files with
the most tests first) runs the file after the long reference files."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mixture import _dirs  # noqa: E402
from test_torch_trainer import _trainers  # noqa: E402
from torch_parity import (  # noqa: E402
    film_mean_se, make_mixture_state, t, to_np, within_se,
)

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402

torch.set_num_threads(2)
K = 8


def _reference_run():
    jt, _ = _trainers(n_components=K, train_fraction=0.5)
    _, iters = jt.run(total_spp=16)
    return _summed(iters), jt.stats, int(jnp.sum(jt.initialized))


def _summed(iters):
    """(mean, standard error) of the films summed over the iterations."""
    return film_mean_se(*(sum(np.asarray(it[k], np.float64) for it in iters)
                          for k in ("image", "sqr", "weight")))


@pytest.fixture(scope="module")
def reference():
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference_run)


def _states(seed, L):
    st = make_mixture_state(seed, L, K)
    js = jmix.SDMM(weight=jnp.asarray(st["weight"]),
                   mean=jnp.asarray(st["mean"]), cov=jnp.asarray(st["cov"]))
    ts = tmix.SDMM(weight=t(st["weight"]), mean=t(st["mean"]),
                   cov=t(st["cov"]))
    return js, ts


def test_em_step_matches_the_reference_at_k8():
    js, ts = _states(3, 5)
    rs = np.random.RandomState(103)
    S = 4000
    pos = rs.rand(S, 3).astype(np.float32)
    d = _dirs(rs, S)
    w = (rs.rand(S) * 2.0).astype(np.float32)
    w[1::211] = -1.0
    leaf = rs.randint(0, 5, size=S).astype(np.int32)
    active = np.array([True, True, False, True, True])
    assert not tem.use_em_kernel(ts)  # the twin's math on any device
    jn, jemn, jcnt = jem.em_step(
        js, jem.init_em_state(5, K), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(w), jnp.asarray(leaf), jnp.asarray(active))
    tn, temn, tcnt = tem.em_step(
        ts, tem.init_em_state(5, K), t(pos), t(d), t(w),
        torch.as_tensor(leaf), torch.as_tensor(active), device="cpu")
    np.testing.assert_array_equal(to_np(tcnt), np.asarray(jcnt))
    np.testing.assert_allclose(to_np(tn.weight), np.asarray(jn.weight),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(tn.mean), np.asarray(jn.mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(tn.cov), np.asarray(jn.cov), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jn.cov)).max())
    np.testing.assert_allclose(to_np(temn.stats_w), np.asarray(jemn.stats_w),
                               rtol=1e-4, atol=1e-7)


def test_conditional_sample_from_uniforms_matches_at_k8():
    L, N = 8, 1024
    js, ts = _states(5, L)
    jp, tp = jmix.prepare(js), tmix.prepare(ts)
    rs = np.random.RandomState(11)
    leaf = rs.randint(0, L, size=N)
    pos = rs.rand(N, 3).astype(np.float32)
    wob = _dirs(rs, N)
    u_sel = rs.rand(N).astype(np.float32)
    u2 = rs.rand(N, 2).astype(np.float32)
    jc = jmix.create_conditional(jax.tree.map(lambda x: x[leaf], jp),
                                 js.weight[leaf], jnp.asarray(pos))
    tc = tmix.create_conditional(
        tmix.Prepared(*(x[torch.as_tensor(leaf)] for x in tp)),
        ts.weight[torch.as_tensor(leaf)], t(pos))
    np.testing.assert_array_equal(to_np(tc.valid), np.asarray(jc.valid))
    jd, jok = jmix.conditional_sample_from_uniforms(
        jc, jnp.asarray(u_sel), jnp.asarray(u2))
    td, tok = tmix.conditional_sample_from_uniforms(tc, t(u_sel), t(u2))
    m = np.asarray(jc.valid)
    assert m.mean() > 0.5 and tc.weight.shape[-1] == K
    np.testing.assert_allclose(to_np(td)[m], np.asarray(jd)[m], atol=1e-4)
    np.testing.assert_array_equal(to_np(tok)[m], np.asarray(jok)[m])
    np.testing.assert_allclose(
        to_np(tmix.conditional_pdf(tc, t(wob))),
        np.asarray(jmix.conditional_pdf(jc, jnp.asarray(wob))), rtol=1e-3,
        atol=1e-5)


def test_k8_training_run_matches_reference_in_mean(reference):
    """Two 8-spp iterations, the first trained: the port's guided lanes
    take the mixture route (no kernel table), and its image agrees with
    the reference's in mean."""
    _, tt = _trainers(n_components=K, train_fraction=0.5)
    assert tt.guide_state().kernel_table is None
    img_t, iters = tt.run(total_spp=16)
    got = _summed(iters)
    want, stats_j, active_j = reference.result()
    assert tt.sdmm.weight.shape[1] == K and len(tt.stats) == len(stats_j)
    assert int(tt.initialized.sum()) > 0 and active_j > 0
    assert not torch.isnan(tt.em.stats_w).any()
    assert np.isfinite(img_t).all()
    assert within_se(got, want), (got, want)
