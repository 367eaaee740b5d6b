"""Port parity of the last public functions of the reference without a
counterpart: em.batch_em (full-batch EM, the reference's
tests/test_guiding_components.py case), stree.find_leaf_with_bounds and
frame.cos_theta / dot / cross, each on the same numpy inputs as the
reference. Tolerances: batch_em's weights and means rtol 1e-3 after six
EM passes in float32 (each pass's M-step is held at rtol 1e-4 in
tests/test_torch_em_mstep.py), leaves and bounds exact, the frame helpers
rtol 1e-6."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import t, to_np  # noqa: E402

from sdmm_tpu.core import frame as jframe  # noqa: E402
from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import init as jinit  # noqa: E402
from sdmm_tpu.guiding import stree as jstree  # noqa: E402
from sdmm_tpu_torch.core import frame as tframe  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.guiding import stree as tstree  # noqa: E402

torch.set_num_threads(1)


def _two_clusters(n=4096, seed=1):
    """Directions about +z and +x, positions in a small cube of leaf 0
    (the samples of tests/test_guiding_components.py, from numpy)."""
    rs = np.random.RandomState(seed)
    pick = rs.rand(n) < 0.5
    d = np.where(pick[:, None], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    d = d + 0.05 * rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = rs.rand(n, 3) * 0.1 + 0.45
    return (pos.astype(np.float32), d.astype(np.float32),
            np.ones(n, np.float32), np.zeros(n, np.int32))


def test_batch_em_matches_the_reference():
    """Six full-batch passes on leaf 0 of four: the same fit as the
    reference's (leaves not active untouched), with mass near both sample
    directions."""
    L, K = 4, 8
    js = jinit.init_leaf_params(jax.random.PRNGKey(0), jnp.zeros((L, 3)),
                                jnp.ones((L, 3)), K)
    pos, d, w, leaf = _two_clusters()
    active = np.zeros(L, bool)
    active[0] = True
    jout = jem.batch_em(js, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(w),
                        jnp.asarray(leaf), jnp.asarray(active), n_iters=6)
    ts = tmix.SDMM(*(t(np.asarray(x)) for x in js))
    tout = tem.batch_em(ts, t(pos), t(d), t(w), torch.as_tensor(leaf),
                        torch.as_tensor(active), n_iters=6, device="cpu")
    np.testing.assert_array_equal(to_np(tout.mean[1:]),
                                  np.asarray(js.mean[1:]))
    np.testing.assert_allclose(to_np(tout.weight), np.asarray(jout.weight),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(to_np(tout.mean), np.asarray(jout.mean),
                               rtol=1e-3, atol=1e-4)
    mdirs, wts = to_np(tout.mean[0, :, 3:]), to_np(tout.weight[0])
    assert wts[mdirs @ np.array([0, 0, 1.0]) > 0.9].sum() > 0.25
    assert wts[mdirs @ np.array([1.0, 0, 0]) > 0.9].sum() > 0.25


def test_find_leaf_with_bounds_and_frame_helpers_match_the_reference():
    """The leaf and its corners of 512 points in a refitted tree; cos_theta,
    dot and cross of random vectors."""
    counts = np.zeros(64)
    counts[:2] = [900, 300]
    trees = []
    for mod in (jstree, tstree):
        tree = mod.STree(np.zeros(3), np.ones(3), max_leaves=64,
                         split_threshold=100)
        tree.split_to_depth(2)
        tree.refit(counts[:tree.n_leaves])
        trees.append(tree)
    rs = np.random.RandomState(2)
    p = rs.rand(512, 3).astype(np.float32)
    jout = jstree.find_leaf_with_bounds(trees[0].device_tables(),
                                        jnp.asarray(p))
    tout = tstree.find_leaf_with_bounds(trees[1].device_tables("cpu"), t(p))
    assert trees[1].n_leaves > 4
    for got, want in zip(tout, jout):
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    lo, hi = to_np(tout[1]), to_np(tout[2])
    assert (p >= lo - 1e-6).all() and (p <= hi + 1e-6).all()

    a, b = rs.randn(2, 256, 3).astype(np.float32)
    for name in ("dot", "cross"):
        np.testing.assert_allclose(
            to_np(getattr(tframe, name)(t(a), t(b))),
            np.asarray(getattr(jframe, name)(jnp.asarray(a),
                                             jnp.asarray(b))),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(to_np(tframe.cos_theta(t(a))),
                                  np.asarray(jframe.cos_theta(jnp.asarray(a))))
