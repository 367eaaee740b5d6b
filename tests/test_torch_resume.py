"""Mid-render checkpoint and resume in the port (guiding/io.py
save_full_checkpoint / load_full_checkpoint, SDMMTrainer.restore and
run(iters=)): a run interrupted, checkpointed, restored and continued
equals the uninterrupted run (rtol 1e-5, atol 1e-6: the tolerances of
tests/test_resume.py; every random draw is seeded from the iteration), and
a full checkpoint written by either package loads field for field in the
other."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import io as jio  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.guiding import trainer as jtrainer  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import io as tio  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W = H = 16


def _cfg(mod, **kw):
    em = (jem if mod is jtrainer else tem).EMConfig(batch_size=256)
    return mod.TrainerConfig(samples_per_iteration=4, max_leaves=64,
                             split_threshold=64, rays_per_wave=1 << 10,
                             seed=5, train_fraction=1.0, em=em, **kw)


def _port_trainer(**kw):
    ts, cfg = make_box(tscene, tshapes, W, H).build(device="cpu")
    cfg.max_depth = cfg.rr_depth = 4
    return ttrainer.SDMMTrainer(ts, cfg, _cfg(ttrainer, **kw), device="cpu")


def test_resumed_run_equals_uninterrupted(tmp_path):
    """20 spp in 5 training iterations (the EM gate opens in the last);
    the interrupted run stops after 3, writes its checkpoint, and a fresh
    trainer restores it and renders the last 2."""
    t_full = _port_trainer()
    img_full, iters_full = t_full.run(total_spp=20)
    assert t_full.stats[-1]["optimized_nodes_count"] > 0

    t_a = _port_trainer()
    _, iters_a = t_a.run(total_spp=12)
    ck = str(tmp_path / "resume.npz")
    tio.save_full_checkpoint(ck, t_a, iters_a)

    t_b = _port_trainer()
    iters_b = t_b.restore(ck)
    assert (t_b.iteration, t_b.total_spp) == (3, 12)
    assert t_b.stats == t_a.stats
    img_res, iters_res = t_b.run(total_spp=20, iters=iters_b)
    assert len(iters_res) == len(iters_full) == 5
    for a, b in zip(iters_full, iters_res):
        for k in ("image", "sqr", "weight"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img_res, img_full, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(t_b.sdmm.weight),
                               to_np(t_full.sdmm.weight), rtol=1e-5,
                               atol=1e-7)
    assert t_b.tree.n_leaves == t_full.tree.n_leaves
    assert t_b.tree.child == t_full.tree.child


def _fill(tr, np_mod, rs):
    """Give a trainer (either package's) a split tree, random mixtures and
    EM statistics, and 3 iterations of history; returns its films."""
    counts = np.zeros(64)
    counts[:8] = rs.rand(8) * 300
    tr.tree.split_threshold = 150
    tr.tree.refit(counts)
    L, K = 64, 16
    arr = (jnp.asarray if np_mod == "j" else torch.as_tensor)
    w = rs.rand(L, K).astype(np.float32)
    tr.sdmm = (jmix if np_mod == "j" else tmix).SDMM(
        arr(w / w.sum(-1, keepdims=True)),
        arr(rs.rand(L, K, 6).astype(np.float32)),
        arr(rs.rand(L, K, 5, 5).astype(np.float32)))
    tr.em = (jem if np_mod == "j" else tem).EMState(
        stats_w=arr(rs.rand(L, K).astype(np.float32)),
        stats_mean=arr(rs.rand(L, K, 5).astype(np.float32)),
        stats_cov=arr(rs.rand(L, K, 5, 5).astype(np.float32)),
        total_weight=arr(rs.rand(L).astype(np.float32)),
        iterations=arr(rs.randint(0, 9, L).astype(np.int32)))
    tr.initialized = arr(rs.rand(L) < 0.5)
    tr.cum_counts = rs.rand(L)
    tr.iteration, tr.total_spp = 3, 12
    tr.stats = [{"iteration": i, "spp": 4, "elapsed_seconds": 0.5 * i}
                for i in range(3)]
    return [{"image": rs.rand(W * H, 3).astype(np.float32),
             "sqr": rs.rand(W * H, 3).astype(np.float32),
             "weight": np.full(W * H, 4.0, np.float32)} for _ in range(3)]


def _assert_same_state(got, want, got_iters, want_iters):
    """Every field of a restored trainer against the one that wrote it."""
    for k in ("axis", "split", "child", "leaf", "depth", "n_leaves",
              "max_leaves", "split_threshold"):
        assert getattr(got.tree, k) == getattr(want.tree, k), k
    np.testing.assert_array_equal(got.tree.leaf_counts, want.tree.leaf_counts)
    for a, b in zip(got.tree.node_lo + got.tree.node_hi,
                    want.tree.node_lo + want.tree.node_hi):
        np.testing.assert_array_equal(a, b)
    for a, b in [*zip(got.sdmm, want.sdmm), *zip(got.em, want.em),
                 (got.initialized, want.initialized)]:
        a, b = to_np(a), to_np(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.cum_counts, want.cum_counts)
    assert (got.iteration, got.total_spp, got.stats) == \
        (want.iteration, want.total_spp, want.stats)
    assert len(got_iters) == len(want_iters)
    for a, b in zip(got_iters, want_iters):
        for k in ("image", "sqr", "weight"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_full_checkpoints_load_in_the_other_package(tmp_path, writer):
    rs = np.random.RandomState(0 if writer == "reference" else 1)
    js, jcfg = make_box(jscene, jshapes, W, H).build()
    jt = jtrainer.SDMMTrainer(js, jcfg, _cfg(jtrainer))
    tt = _port_trainer()
    path = str(tmp_path / "full.npz")
    if writer == "reference":
        iters = _fill(jt, "j", rs)
        jio.save_full_checkpoint(path, jt, iters)
        _assert_same_state(tt, jt, tt.restore(path), iters)
        assert tt.guide_state().kernel_table.shape[0] == 64
    else:
        iters = _fill(tt, "t", rs)
        tio.save_full_checkpoint(path, tt, iters)
        _assert_same_state(jt, tt, jt.restore(path), iters)
