"""Port parity at the slice level: the guided lane-pool render, the trainer's
optimize step, the state carried across by guiding/convert.py, and a short
training run, sdmm_tpu_torch vs sdmm_tpu on the box scene of
tests/test_render.py. Renders use different random streams (JAX threefry,
torch Philox), so they agree in expectation: image means within 10% (the
seed-to-seed spread of either pool at 16 spp on 16x16 pixels is ~5%).
The optimize step on identical samples gives the identical tree and EM
weights/means within rtol 1e-3."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import trainer as jtrainer  # noqa: E402
from sdmm_tpu.render import guided as jguided  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as tgs  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W = H = 16


def _cfgs(**kw):
    common = dict(max_leaves=16, samples_per_iteration=8, rays_per_wave=1024)
    common.update(kw)
    return (jtrainer.TrainerConfig(em=jem.EMConfig(batch_size=256), **common),
            ttrainer.TrainerConfig(em=tem.EMConfig(batch_size=256), **common))


def _trainers(**kw):
    js, jcfg = make_box(jscene, jshapes, W, H).build()
    ts, tcfg = make_box(tscene, tshapes, W, H).build(device="cpu")
    for c in (jcfg, tcfg):
        c.max_depth = c.rr_depth = 4
    jc, tc = _cfgs(**kw)
    return (jtrainer.SDMMTrainer(js, jcfg, jc),
            ttrainer.SDMMTrainer(ts, tcfg, tc, device="cpu"))


def _synthetic_batch(jt, n=6000, seed=0):
    """Training vertices clustered on the box's floor and back wall."""
    rs = np.random.RandomState(seed)
    hi = np.asarray(jt.tree.hi)
    pos = (rs.rand(n, 3) * hi * 0.9 + 0.05 * hi).astype(np.float32)
    pos[: n // 2, 1] = 0.02  # floor band: dense enough to split
    d = rs.randn(n, 3).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w = (rs.rand(n) * 3.0).astype(np.float32)
    valid = rs.rand(n) < 0.95
    w = np.where(valid, w, -1.0).astype(np.float32)
    return {"pos": pos, "dir": d, "weight": w, "valid": valid,
            "terminal": valid & (rs.rand(n) < 0.3),
            "n_cond_try": 10.0, "n_cond_ok": 7.0, "n_vertices": float(n)}


@pytest.fixture(scope="module")
def trained():
    """A JAX trainer after one optimize on synthetic samples, and the port
    trainer holding the same state (carried across as numpy)."""
    jt, tt = _trainers(split_threshold=500, jitter_replicas=False)
    convert.trainer_state_from_numpy(tt, convert.trainer_state_to_numpy(jt))
    jt.total_spp = tt.total_spp = 16
    batch = _synthetic_batch(jt)
    n_j = jt.optimize([{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                            else v) for k, v in batch.items()}])
    n_t = tt.optimize([{k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                            else v) for k, v in batch.items()}])
    return jt, tt, n_j, n_t


def test_optimize_on_identical_samples_matches(trained):
    jt, tt, n_j, n_t = trained
    assert n_j == n_t > 0
    assert tt.tree.n_leaves == jt.tree.n_leaves > 4  # the tree split
    for k in ("axis", "split", "child", "leaf", "depth"):
        assert getattr(tt.tree, k) == getattr(jt.tree, k), k
    np.testing.assert_array_equal(tt.tree.leaf_counts, jt.tree.leaf_counts)
    np.testing.assert_array_equal(to_np(tt.initialized),
                                  np.asarray(jt.initialized))
    np.testing.assert_allclose(to_np(tt.sdmm.weight), np.asarray(jt.sdmm.weight),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(to_np(tt.sdmm.mean), np.asarray(jt.sdmm.mean),
                               rtol=1e-3, atol=1e-4)
    cj = np.asarray(jt.sdmm.cov)
    np.testing.assert_allclose(to_np(tt.sdmm.cov), cj, rtol=1e-2,
                               atol=1e-3 * np.abs(cj).max())


def test_carried_state_gives_identical_kernel_table(trained):
    jt, _, _, _ = trained
    _, tt = _trainers(split_threshold=500)
    convert.trainer_state_from_numpy(tt, convert.trainer_state_to_numpy(jt))
    jtab = np.asarray(jt.guide_state().kernel_table)
    ttab = to_np(tt.guide_state().kernel_table)
    assert ttab.shape == jtab.shape == (16, tgs.N_ROWS)
    np.testing.assert_allclose(ttab, jtab, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ttab[:, -1], jtab[:, -1])  # initialized


def _mean_image(out):
    img = to_np(out["image"]) / np.maximum(to_np(out["weight"])[:, None], 1.0)
    return img


def test_render_pool_guided_matches_reference_in_mean(trained):
    jt, tt, _, _ = trained
    kw = dict(n_lanes=1024, spp=16, width=W, height=H, max_depth=4,
              rr_depth=4, bsdf_fraction=0.5, fov_axis="x")
    out_j = jguided.render_pool_guided(
        jt.scene, jt.guide_state(), jax.random.PRNGKey(3),
        bsdf_types=jt.render_cfg.bsdf_types or None, **kw)
    out_t = tguided.render_pool_guided(
        tt.scene, tt.guide_state(), torch.Generator().manual_seed(3),
        bsdf_types=tt.render_cfg.bsdf_types or None, device="cpu", **kw)
    ij, it = _mean_image(out_j), _mean_image(out_t)
    assert np.isfinite(it).all()
    assert float(out_t["weight"].sum()) == W * H * 16  # every sample splatted
    assert abs(it.mean() - ij.mean()) / ij.mean() < 0.1, (it.mean(), ij.mean())
    assert int(out_t["n_cond_ok"]) > 0  # guided sampling engaged
    # Path statistics agree in expectation too.
    vj = float(out_j["n_vertices"]) / (W * H * 16)
    vt = float(out_t["n_vertices"]) / (W * H * 16)
    assert abs(vt - vj) / vj < 0.1, (vt, vj)


def test_collected_training_samples_are_consistent(trained):
    _, tt, _, _ = trained
    out = tguided.render_pool_guided(
        tt.scene, tt.guide_state(), torch.Generator().manual_seed(5),
        n_lanes=512, spp=4, width=W, height=H, max_depth=4, rr_depth=4,
        collect_cap=4096, device="cpu")
    s = out["samples"]
    v = to_np(s["valid"])
    assert 0 < v.sum() <= int(out["n_emitted"])
    assert (to_np(s["weight"])[v] >= 0).all()
    assert (to_np(s["weight"])[~v] == -1.0).all()
    assert to_np(s["terminal"])[v].sum() <= W * H * 4  # ≤ 1 per path
    assert not to_np(s["terminal"])[~v].any()


def test_short_training_run_matches_reference_in_mean():
    jt, tt = _trainers(train_fraction=0.5)
    img_j, _ = jt.run(total_spp=24)
    img_t, _ = tt.run(total_spp=24)
    assert len(tt.stats) == len(jt.stats) == 3
    assert set(tt.stats[-1]) == set(jt.stats[-1])  # same stats schema
    assert [s["optimized_nodes_count"] > 0 for s in tt.stats] == \
        [s["optimized_nodes_count"] > 0 for s in jt.stats]
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 0.1, (
        img_t.mean(), img_j.mean())


def test_scan_training_run_matches_reference_in_mean():
    """pooled_training=False: both trainers collect their training vertices
    with the scan tracer (trace_wave_guided) and then render the frozen
    tail on the pool; the images agree in mean as above."""
    jt, tt = _trainers(train_fraction=0.5, pooled_training=False)
    img_j, _ = jt.run(total_spp=24)
    img_t, _ = tt.run(total_spp=24)
    assert [s["optimized_nodes_count"] > 0 for s in tt.stats] == \
        [s["optimized_nodes_count"] > 0 for s in jt.stats] == \
        [True, True, False]
    assert tt.stats[0]["samples_count"] > 0
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 0.1, (
        img_t.mean(), img_j.mean())


def test_images_above_the_pool_limit_take_the_scan(monkeypatch):
    """Above SCAN_PIXELS (2^20, lowered here) every iteration, training
    and frozen, takes the scan tracer and never the pool."""
    def no_pool(*a, **k):
        raise AssertionError("the lane pool ran")

    monkeypatch.setattr(ttrainer, "SCAN_PIXELS", W * H - 1)
    monkeypatch.setattr(ttrainer, "render_pool_guided", no_pool)
    _, tt = _trainers(train_fraction=0.5)
    img, iters = tt.run(total_spp=16)
    assert len(iters) == 2 and np.isfinite(img).all() and img.mean() > 0
    assert tt.stats[0]["optimized_nodes_count"] > 0
    assert (iters[1]["weight"] == 8).all()
