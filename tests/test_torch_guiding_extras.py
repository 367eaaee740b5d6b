"""The trainer's other extras in the port, against sdmm_tpu: k-means++ data
init (``_segment_argmax``, ``kmeanspp_centers`` on the reference's Gumbel
draws, ``reseed_spatial_means``: rtol 1e-5), the asynchronous EM (adopted
at the top of the next iteration, as the reference does), the SVD component split
(rtol 1e-5; the two children may swap slots, a singular vector's sign
being arbitrary) and the uniform grid's density normalization (rtol
1e-5); and a training run with data_init and optimize_async, whose
iterations' films agree with the reference's in expectation (4 standard
errors). The reference's run compiles in a background thread while the
other tests run."""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import film_mean_se, make_box, to_np, within_se  # noqa

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import hashgrid as jhg  # noqa: E402
from sdmm_tpu.guiding import init as jinit  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.guiding import split as jsplit  # noqa: E402
from sdmm_tpu.guiding import trainer as jtrainer  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import hashgrid as thg  # noqa: E402
from sdmm_tpu_torch.guiding import init as tinit  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.guiding import split as tsplit  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-5  # the same float32 operations in both packages
W = H = 16
SPP = 20  # 5 iterations: the EM gate opens in the last


CFG = dict(samples_per_iteration=4, max_leaves=64, split_threshold=500,
           rays_per_wave=1 << 10, seed=3, train_fraction=1.0)


def _cfg(mod, **kw):
    em = (jem if mod is jtrainer else tem).EMConfig(batch_size=256)
    return mod.TrainerConfig(em=em, **CFG, **kw)


def _box(pkg):
    if pkg == "j":
        scene, cfg = make_box(jscene, jshapes, W, H).build()
    else:
        scene, cfg = make_box(tscene, tshapes, W, H).build(device="cpu")
    cfg.max_depth = cfg.rr_depth = 4
    return scene, cfg


@pytest.fixture(scope="module", autouse=True)
def reference_run():
    """The reference's training run with data_init and optimize_async,
    started in a thread at the module's first test (its compiles take most
    of its time)."""
    out = {}

    def work():
        tr = jtrainer.SDMMTrainer(*_box("j"), _cfg(
            jtrainer, data_init=True, optimize_async=True))
        _, iters = tr.run(total_spp=SPP)
        out["films"] = {k: np.stack([it[k] for it in iters])
                        for k in ("image", "sqr", "weight")}
        out["optimized"] = [s["optimized_nodes_count"] for s in tr.stats]

    th = threading.Thread(target=work)
    th.start()
    yield out, th
    th.join()


def _clusters(seed=2, n=512):
    rs = np.random.RandomState(seed)
    pos = np.concatenate([c + 0.02 * rs.randn(n, 3) for c in
                          ([0.2, 0.2, 0.2], [0.8, 0.8, 0.8],
                           [0.5, 0.1, 0.9])]).astype(np.float32)
    leaf = np.concatenate([np.zeros(2 * n), np.ones(n // 2),
                           np.full(n // 2, 2)]).astype(np.int32)
    valid = rs.rand(3 * n) < 0.9
    return pos, leaf, valid


def _check_kmeanspp():
    """The reference's Gumbel draws (its key and fold_in(key, j)) fed to the
    port give the same centres; leaf 3 holds no sample."""
    pos, leaf, valid = _clusters()
    key = jax.random.PRNGKey(5)
    s = pos.shape[0]
    g = np.stack([np.asarray(jax.random.gumbel(
        key if j == 0 else jax.random.fold_in(key, j), (s,)))
        for j in range(3)])
    jc, jh = jinit.kmeanspp_centers(key, jnp.asarray(pos), jnp.asarray(leaf),
                                    jnp.asarray(valid), 4, 3)
    tc, th = tinit.kmeanspp_centers(None, torch.as_tensor(pos),
                                    torch.as_tensor(leaf),
                                    torch.as_tensor(valid), 4, 3,
                                    gumbels=torch.as_tensor(g))
    np.testing.assert_array_equal(to_np(th), np.asarray(jh))
    assert list(to_np(th)) == [True, True, True, False]
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=RTOL)
    # The segment argmax on its own, ties included.
    score = np.round(g[0], 1)
    want = np.asarray(jinit._segment_argmax(jnp.asarray(score),
                                            jnp.asarray(leaf), 4))
    got = to_np(tinit._segment_argmax(torch.as_tensor(score),
                                      torch.as_tensor(leaf), 4))
    np.testing.assert_array_equal(np.minimum(got, s), np.minimum(want, s))


def _check_reseed():
    rs = np.random.RandomState(3)
    L, K = 8, 16
    w = rs.rand(L, K).astype(np.float32)
    mean = rs.rand(L, K, 6).astype(np.float32)
    cov = rs.rand(L, K, 5, 5).astype(np.float32)
    centers = rs.rand(L, 2, 3).astype(np.float32)
    reseed = rs.rand(L) < 0.5
    want = jinit.reseed_spatial_means(
        jmix.SDMM(*(jnp.asarray(a) for a in (w, mean, cov))),
        jnp.asarray(centers), jnp.asarray(reseed), 2)
    got = tinit.reseed_spatial_means(
        tmix.SDMM(*(torch.as_tensor(a) for a in (w, mean, cov))),
        torch.as_tensor(centers), torch.as_tensor(reseed), 2)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w_), rtol=RTOL)


def _split_state(dead=(2, 3), seed=0, L=5, K=6):
    rs = np.random.RandomState(seed)
    w = np.full((L, K), 1.0 / K, np.float32)
    mean = np.zeros((L, K, 6), np.float32)
    mean[..., :3] = rs.rand(L, K, 3)
    d = rs.randn(L, K, 3)
    mean[..., 3:] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    a = rs.randn(L, K, 5, 5) * 0.1
    cov = (a @ np.swapaxes(a, -1, -2) + np.eye(5) * 0.01).astype(np.float32)
    cov[..., 3, 3] += rs.rand(L, K) * 0.5
    for k in dead:
        w[:, k] = 0.0
    w /= w.sum(-1, keepdims=True)
    stats = [rs.rand(L, K).astype(np.float32),
             rs.rand(L, K, 5).astype(np.float32),
             rs.rand(L, K, 5, 5).astype(np.float32),
             rs.rand(L).astype(np.float32), np.arange(L, dtype=np.int32)]
    active = np.array([True, True, False, True, True])
    return (w, mean, cov), stats, active


def _check_split(dead):
    (w, mean, cov), stats, active = _split_state(dead)
    js, je, jd = jax.jit(jsplit.svd_split)(
        jmix.SDMM(*(jnp.asarray(a) for a in (w, mean, cov))),
        jem.EMState(*(jnp.asarray(a) for a in stats)), jnp.asarray(active))
    ts, te, td = tsplit.svd_split(
        tmix.SDMM(*(torch.as_tensor(a) for a in (w, mean, cov))),
        tem.EMState(*(torch.as_tensor(a) for a in stats)),
        torch.as_tensor(active))
    did = np.asarray(jd)
    np.testing.assert_array_equal(to_np(td), did)
    assert did.any() == bool(dead)
    for g, w_ in [*zip(te, je), (ts.weight, js.weight), (ts.cov, js.cov)]:
        np.testing.assert_allclose(to_np(g), np.asarray(w_), rtol=RTOL,
                                   atol=1e-7)
    # Means: the same pair of children in each split leaf.
    gm, wm = to_np(ts.mean), np.asarray(js.mean)
    for lf in range(gm.shape[0]):
        changed = np.nonzero(np.abs(wm[lf] - mean[lf]).max(-1) > 0)[0]
        same = np.allclose(gm[lf], wm[lf], rtol=RTOL, atol=1e-6)
        swapped = gm[lf].copy()
        if len(changed) == 2:
            swapped[changed] = gm[lf][changed[::-1]]
        assert same or np.allclose(swapped, wm[lf], rtol=RTOL, atol=1e-6), lf


def _check_hashgrid():
    rs = np.random.RandomState(7)
    p = np.concatenate([0.1 + 0.01 * rs.rand(1000, 3),
                        0.45 + 0.5 * rs.rand(10, 3)]).astype(np.float32)
    valid = rs.rand(1010) < 0.95
    wgt = rs.rand(1010).astype(np.float32)
    jt = jhg.UniformGrid(np.zeros(3), np.ones(3), 4).device_tables()
    tt = thg.UniformGrid(np.zeros(3), np.ones(3), 4).device_tables("cpu")
    np.testing.assert_array_equal(
        to_np(thg.grid_cell(tt, torch.as_tensor(p))),
        np.asarray(jhg.grid_cell(jt, jnp.asarray(p))))
    jc = jhg.cell_counts(jt, jnp.asarray(p), jnp.asarray(valid))
    tc = thg.cell_counts(tt, torch.as_tensor(p), torch.as_tensor(valid))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    jd = jhg.density_at(jt, jc, jnp.asarray(p))
    td = thg.density_at(tt, tc, torch.as_tensor(p))
    np.testing.assert_allclose(to_np(td), np.asarray(jd), rtol=RTOL)
    np.testing.assert_allclose(
        to_np(thg.normalize_weights(torch.as_tensor(wgt), td,
                                    torch.as_tensor(valid))),
        np.asarray(jhg.normalize_weights(jnp.asarray(wgt), jd,
                                         jnp.asarray(valid))), rtol=RTOL)


def _check_async(monkeypatch):
    """optimize_async keeps the EM's result aside and adopts it at the top
    of the next iteration, before that iteration renders (the reference's
    loop): every iteration renders with the model of the last EM, as the
    synchronous loop does, and gives the same film; only the stats taken
    between the EM and the adoption lag by one iteration."""
    runs = {}
    for asyn in (False, True):
        tr = ttrainer.SDMMTrainer(*_box("t"), _cfg(
            ttrainer, optimize_async=asyn), device="cpu")
        seen, after_em = [], [tr.sdmm.weight.clone()]
        real_render, real_opt = tr.render_iteration, tr.optimize

        def render(*a, tr=tr, seen=seen, real=real_render, **k):
            seen.append(tr.sdmm.weight.clone())
            return real(*a, **k)

        def optimize(batches, tr=tr, after_em=after_em, real=real_opt):
            n = real(batches)
            after_em.append(tr.sdmm.weight.clone())
            return n

        monkeypatch.setattr(tr, "render_iteration", render)
        monkeypatch.setattr(tr, "optimize", optimize)
        _, iters = tr.run(total_spp=SPP)
        assert tr.stats[-1]["optimized_nodes_count"] > 0
        for i, w in enumerate(seen):
            assert torch.equal(w, after_em[i]), (asyn, i)
        runs[asyn] = (tr.stats, iters)
    (s_sync, it_sync), (s_async, it_async) = runs[False], runs[True]
    for a, b in zip(it_sync, it_async):
        np.testing.assert_array_equal(a["image"], b["image"])
    act_sync = [s["active_nodes_count"] for s in s_sync]
    act_async = [s["active_nodes_count"] for s in s_async]
    assert act_async == [0] + act_sync[:-1] and act_sync[-1] > 0


def _check_data_init():
    tr = ttrainer.SDMMTrainer(*_box("t"), _cfg(ttrainer, data_init=True),
                              device="cpu")
    init_means = tr.sdmm.mean.clone()
    batches = []
    real = tr.render_iteration
    tr.render_iteration = lambda *a, **k: batches.append(real(*a, **k)) \
        or batches[-1]
    tr.run(total_spp=SPP)
    assert tr.reseeded_leaves > 0
    # A reseeded leaf's spatial means moved off the stratified init.
    moved = (tr.sdmm.mean[..., :3] - init_means[..., :3]).abs().amax((1, 2))
    assert int((moved > 0).sum()) >= tr.reseeded_leaves


def test_init_split_and_grid_match_reference():
    """k-means++ and the reseed, the SVD split (two dead slots, none, the
    last) and the uniform grid's density normalization."""
    _check_kmeanspp()
    _check_reseed()
    for dead in ((2, 3), (), (5,)):
        _check_split(dead)
    _check_hashgrid()


def test_async_and_data_init_in_the_port(monkeypatch):
    """The asynchronous EM's adoption, and data init's reseeded means."""
    _check_async(monkeypatch)
    _check_data_init()


def test_async_and_data_init_training_match_reference_in_expectation(
        reference_run):
    tr = ttrainer.SDMMTrainer(*_box("t"), _cfg(
        ttrainer, data_init=True, optimize_async=True), device="cpu")
    img, iters = tr.run(total_spp=SPP)
    assert np.isfinite(img).all() and tr.reseeded_leaves > 0
    out, th = reference_run
    th.join()
    assert "films" in out, "the reference's run failed"
    assert [s["optimized_nodes_count"] > 0 for s in tr.stats] == \
        [n > 0 for n in out["optimized"]]

    def pooled(films):
        return film_mean_se(*(np.sum(films[k], 0)
                              for k in ("image", "sqr", "weight")))

    got = pooled({k: np.stack([it[k] for it in iters])
                  for k in ("image", "sqr", "weight")})
    want = pooled(out["films"])
    assert within_se(got, want), (got, want)
