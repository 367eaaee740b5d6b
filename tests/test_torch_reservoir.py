"""The sample reservoir, sdmm_tpu_torch vs sdmm_tpu: ``reservoir_update`` on
the same batches and the same Russian-roulette uniforms (the ones the
reference draws from its key) gives the same reservoir, rtol 1e-5; a
reservoir carried across by convert.tensors_from_numpy keeps merging as
the reference's does; the trainer fits the EM to the reservoir."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.guiding import reservoir as jres  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import reservoir as tres  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-5  # the same float32 operations in both packages


def _batch(n, seed):
    rs = np.random.RandomState(seed)
    pos = rs.rand(n, 3).astype(np.float32)
    look = (pos + 0.1 * rs.randn(n, 3)).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    w = (rs.rand(n) * rs.choice([0.1, 1.0, 10.0], n)).astype(np.float32)
    valid = rs.rand(n) < 0.9
    return pos, d, np.where(valid, w, -1.0).astype(np.float32), valid, look


def _merge_both(jr, tr_, batch, key, cap, decay):
    """One merge in each package on the same batch and uniforms."""
    pos, d, w, valid, look = batch
    u = np.asarray(jax.random.uniform(
        key, (jr["valid"].shape[0] + pos.shape[0],)))
    jr = jres.reservoir_update(jr, jnp.asarray(pos), jnp.asarray(d),
                               jnp.asarray(w), jnp.asarray(valid), key, cap,
                               decay, lookup_pos=jnp.asarray(look))
    tr_ = tres.reservoir_update(
        tr_, torch.as_tensor(pos), torch.as_tensor(d), torch.as_tensor(w),
        torch.as_tensor(valid), torch.as_tensor(u), cap, decay,
        lookup_pos=torch.as_tensor(look))
    return jr, tr_


def _assert_same(jr, tr_):
    assert set(jr) == set(tr_)
    np.testing.assert_array_equal(to_np(tr_["valid"]), np.asarray(jr["valid"]))
    for k in ("pos", "lookup_pos", "dir", "weight", "priority"):
        np.testing.assert_allclose(to_np(tr_[k]), np.asarray(jr[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


def _check_merges(cap, n, decay):
    """Two merges in a row: the first fills the reservoir, the second
    decays it and (over capacity) thins it by Russian roulette; the
    survivors keep their order (the stable compaction)."""
    jr = jres.make_reservoir(cap)
    tr_ = tres.make_reservoir(cap, "cpu")
    for step in range(2):
        jr, tr_ = _merge_both(jr, tr_, _batch(n, step),
                              jax.random.PRNGKey(10 + step), cap, decay)
        _assert_same(jr, tr_)
    if 2 * n * 0.9 > cap:
        assert int(tr_["valid"].sum()) < min(cap, 2 * n)  # roulette thinned


def _check_carried_reservoir():
    cap = 256
    jr = jres.make_reservoir(cap)
    batch = _batch(400, 3)
    jr = jres.reservoir_update(jr, *(jnp.asarray(a) for a in batch[:4]),
                               jax.random.PRNGKey(4), cap,
                               lookup_pos=jnp.asarray(batch[4]))
    tr_ = convert.tensors_from_numpy(
        {k: np.asarray(v) for k, v in jr.items()}, "cpu")
    _assert_same(jr, tr_)
    jr, tr_ = _merge_both(jr, tr_, _batch(300, 5), jax.random.PRNGKey(6),
                          cap, 0.5)
    _assert_same(jr, tr_)


def test_generator_draws_and_keeps_the_estimate():
    """With a Generator the uniforms are drawn inside; the roulette keeps
    the weight sum's expectation (mean over 40 merges within 5%)."""
    pos, d, w, valid, _ = _batch(2000, 7)
    w = np.abs(w)
    valid = np.ones_like(valid)
    sums = []
    for s in range(40):
        r = tres.reservoir_update(
            tres.make_reservoir(200, "cpu"), *(torch.as_tensor(a) for a in
                                               (pos, d, w, valid)),
            torch.Generator().manual_seed(s), 200)
        assert int(r["valid"].sum()) <= 200
        sums.append(float(r["weight"][r["valid"]].sum()))
    assert abs(np.mean(sums) - w.sum()) / w.sum() < 0.05


def test_trainer_fits_the_reservoir():
    ts, cfg = make_box(tscene, tshapes, 16, 16).build(device="cpu")
    cfg.max_depth = cfg.rr_depth = 4
    tr = ttrainer.SDMMTrainer(ts, cfg, ttrainer.TrainerConfig(
        max_leaves=64, split_threshold=500, samples_per_iteration=4,
        rays_per_wave=1 << 10, train_fraction=1.0, reservoir_capacity=3000,
        em=tem.EMConfig(batch_size=256), seed=3), device="cpu")
    img, _ = tr.run(total_spp=20)
    res = tr.reservoir
    assert res["weight"].shape == (3000,)
    n_kept = int(res["valid"].sum())
    assert 0 < n_kept <= 3000
    assert (res["weight"][~res["valid"]] == -1.0).all()
    assert np.isfinite(img).all() and int(tr.initialized.sum()) > 0
    assert tr.stats[-1]["optimized_nodes_count"] > 0


def test_reservoir_update_matches_reference():
    """Under capacity, over it, over it with decay 0.8; then a reservoir
    carried across from the reference keeps merging as the reference's."""
    for cap, n, decay in ((1024, 300, 0.5), (256, 600, 0.5), (128, 700, 0.8)):
        _check_merges(cap, n, decay)
    _check_carried_reservoir()
