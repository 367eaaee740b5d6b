"""Port parity: tangent maps, the mixture core (prepare / conditioning /
sampling / pdf), the kernel table packing, the STree refit and find_leaf.
Tolerances: tangent maps and prepare rtol 1e-5 / 1e-4 (float32 triangular
solves); conditionals rtol 1e-4; sampled directions 1e-4 absolute;
find_leaf and the tree are exact. prepare, the conditionals and the
table packing are compared in tests/test_torch_mixture_conditional.py, a
file of few tests that the tier-1 scheduler (``--dist loadfile``, files
with the most tests first) runs after the long reference files."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_mixture_state, t, to_np  # noqa: E402

from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.guiding import stree as jstree  # noqa: E402
from sdmm_tpu.guiding import tangent as jtg  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.guiding import stree as tstree  # noqa: E402
from sdmm_tpu_torch.guiding import tangent as ttg  # noqa: E402

torch.set_num_threads(1)


def _dirs(rs, n):
    d = rs.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_tangent_maps_and_jacobians_match():
    rs = np.random.RandomState(0)
    mu = _dirs(rs, 500)
    tan = (rs.randn(500, 2) * 1.2).astype(np.float32)
    d = _dirs(rs, 500)
    jrot = jtg.make_rotation(jnp.asarray(mu))
    trot = ttg.make_rotation(t(mu))
    np.testing.assert_allclose(to_np(trot), np.asarray(jrot), rtol=1e-5,
                               atol=1e-6)
    for ja, ta in zip(jtg.exp_map(jrot, jnp.asarray(tan)),
                      ttg.exp_map(trot, t(tan))):
        np.testing.assert_allclose(to_np(ta), np.asarray(ja), rtol=1e-5,
                                   atol=1e-6)
    for ja, ta in zip(jtg.log_map(jrot, jnp.asarray(d)),
                      ttg.log_map(trot, t(d))):
        np.testing.assert_allclose(to_np(ta), np.asarray(ja), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(to_np(ttg.exp_jacobian(t(tan))),
                               np.asarray(jtg.exp_jacobian(jnp.asarray(tan))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        to_np(ttg.log_jacobian(trot, t(d))),
        np.asarray(jtg.log_jacobian(jrot, jnp.asarray(d))),
        rtol=1e-4, atol=1e-4)


def _states(seed=3, L=8):
    st = make_mixture_state(seed, L)
    js = jmix.SDMM(weight=jnp.asarray(st["weight"]),
                   mean=jnp.asarray(st["mean"]), cov=jnp.asarray(st["cov"]))
    ts = tmix.SDMM(weight=t(st["weight"]), mean=t(st["mean"]),
                   cov=t(st["cov"]))
    return st, js, ts


def test_prepare_masks_dead_and_non_pd_components():
    st, js, ts = _states()
    cov = st["cov"].copy()
    cov[0, 1] = -np.eye(5)  # not positive definite
    w = st["weight"].copy()
    w[0, 2] = 0.0
    jp = jmix.prepare(js._replace(cov=jnp.asarray(cov), weight=jnp.asarray(w)))
    tp = tmix.prepare(ts._replace(cov=t(cov), weight=t(w)))
    np.testing.assert_array_equal(to_np(tp.valid), np.asarray(jp.valid))
    assert not bool(tp.valid[0, 1]) and not bool(tp.valid[0, 2])
    assert np.isfinite(to_np(tp.inv_chol)).all()


def _grow(tree_cls, seed):
    tr = tree_cls(np.zeros(3), np.array([1.0, 0.6, 0.8]), max_leaves=64,
                  split_threshold=50)
    tr.split_to_depth(2)
    rs = np.random.RandomState(seed)
    copies = []
    for _ in range(3):
        copies.append(tr.refit(rs.poisson(40.0, size=tr.max_leaves)
                               * (np.arange(tr.max_leaves) < tr.n_leaves)))
    return tr, copies


@pytest.mark.parametrize("seed", [0, 1])
def test_stree_refit_matches(seed):
    jt, jc = _grow(jstree.STree, seed)
    tt, tc = _grow(tstree.STree, seed)
    assert tc == jc
    assert jt.n_leaves == tt.n_leaves > 4
    for k in ("axis", "split", "child", "leaf", "depth"):
        assert getattr(tt, k) == getattr(jt, k), k
    np.testing.assert_array_equal(tt.leaf_counts, jt.leaf_counts)


@pytest.mark.parametrize("use_grid", [True, False])
def test_find_leaf_is_exact(use_grid):
    jt, _ = _grow(jstree.STree, 0)
    tt, _ = _grow(tstree.STree, 0)
    jtab = jt.device_tables()
    ttab = tt.device_tables("cpu")
    for k, v in ttab.items():
        np.testing.assert_array_equal(to_np(v), np.asarray(jtab[k]),
                                      err_msg=k)
    if not use_grid:
        jtab = {k: v for k, v in jtab.items() if not k.startswith("grid")}
        ttab = {k: v for k, v in ttab.items() if not k.startswith("grid")}
    rs = np.random.RandomState(4)
    p = (rs.rand(5000, 3) * [1.1, 0.7, 0.9] - 0.05).astype(np.float32)
    jl = jstree.find_leaf(jtab, jnp.asarray(p))
    tl = tstree.find_leaf(ttab, t(p))
    np.testing.assert_array_equal(to_np(tl), np.asarray(jl))
