"""Practical path guiding, sdmm_tpu_torch vs sdmm_tpu. Function parity on
the same inputs and the same uniforms (the ones the reference draws from
its keys): the direction ↔ cell maps, the adaptive projection, the grid
pdf and sampler, the Adam steps of the learned fraction and the training
splat (rtol 1e-5; the splat's index sums and the Adam step's per-leaf sums
in another order, rtol 1e-4); a reference PPG state carried across by
convert.ppg_state_from_numpy projects as the reference's does; and
PPGTrainer.run, whose iterations' films agree with the reference's in
expectation (4 standard errors). The reference's run compiles in a
background thread while the function tests run."""

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

from sdmm_tpu.guiding import ppg as jppg  # noqa: E402
from sdmm_tpu.guiding import stree as jstree  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.guiding import ppg as tppg  # noqa: E402
from sdmm_tpu_torch.guiding import stree as tstree  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-5  # the same float32 operations in both packages
SUM_RTOL = 1e-4  # index sums and per-leaf sums in another order
RES = tppg.RES
W = H = 16
RUN = dict(max_leaves=64, rays_per_wave=1 << 10, stree_threshold=200)
SPP = 15  # 1 + 2 + 4 + 8


def _box(pkg):
    scene_mod, shapes_mod = (jscene, jshapes) if pkg == "j" else \
        (tscene, tshapes)
    kw = {} if pkg == "j" else {"device": "cpu"}
    scene, cfg = make_box(scene_mod, shapes_mod, W, H).build(**kw)
    cfg.max_depth = cfg.rr_depth = 4
    return scene, cfg


@pytest.fixture(scope="module")
def reference_run():
    """The reference's PPGTrainer.run, started in a thread at the module's
    first test."""
    out = {}

    def work():
        scene, cfg = _box("j")
        tr = jppg.PPGTrainer(scene, cfg, jppg.PPGConfig(**RUN, seed=3))
        out["image"], out["iters"] = tr.run(total_spp=SPP)
        out["trainer"] = tr

    th = threading.Thread(target=work)
    th.start()
    yield out, th
    th.join()


def _dirs(n, seed):
    d = np.random.RandomState(seed).randn(n, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _hist(L=4, seed=0):
    rs = np.random.RandomState(seed)
    h = rs.gamma(0.05, size=(L, RES, RES)).astype(np.float32) * 0.01
    h[:, 4:6, 8:10] += 5.0
    h[1] *= 3.0
    h[3] = 0.0  # an empty leaf
    return h.reshape(L, -1)


def _check_direction_maps():
    d = _dirs(4096, 0)
    ct_j, u_j = jppg.dir_to_uv(jnp.asarray(d))
    ct_t, u_t = tppg.dir_to_uv(torch.as_tensor(d))
    np.testing.assert_allclose(to_np(ct_t), np.asarray(ct_j), rtol=RTOL)
    np.testing.assert_allclose(to_np(u_t), np.asarray(u_j), rtol=RTOL,
                               atol=1e-7)
    cell = np.asarray(jppg.dir_to_cell(jnp.asarray(d)))
    np.testing.assert_array_equal(to_np(tppg.dir_to_cell(torch.as_tensor(d))),
                                  cell)
    jit = np.random.RandomState(1).rand(4096, 2).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tppg.cell_to_dir(torch.as_tensor(cell), torch.as_tensor(jit))),
        np.asarray(jppg.cell_to_dir(jnp.asarray(cell), jnp.asarray(jit))),
        rtol=RTOL, atol=1e-6)


def _check_projection(rho):
    h = _hist()
    want = jppg.project_adaptive(jnp.asarray(h), rho)
    got = tppg.project_adaptive(torch.as_tensor(h), rho)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=RTOL,
                                   atol=1e-9)


def _check_grid():
    h = _hist()
    eff, eff_row, total = jppg.project_adaptive(jnp.asarray(h), 0.01)
    eff2d = eff.reshape(-1, RES)
    n = 4096
    leaf = np.random.RandomState(2).randint(0, 3, n).astype(np.int32)
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    u = np.concatenate([np.asarray(jax.random.uniform(k1, (n,)))[:, None],
                        np.asarray(jax.random.uniform(k2, (n,)))[:, None],
                        np.asarray(jax.random.uniform(k3, (n, 2)))], -1)
    jl = jnp.asarray(leaf)
    d_j = jppg.grid_sample(eff2d, eff_row[jl], jl, key)
    t_eff2d, t_row, t_total = (torch.as_tensor(np.asarray(x))
                               for x in (eff2d, eff_row, total))
    tl = torch.as_tensor(leaf)
    d_t = tppg.grid_sample(t_eff2d, t_row[tl.long()], tl, torch.as_tensor(u))
    np.testing.assert_allclose(to_np(d_t), np.asarray(d_j), rtol=RTOL,
                               atol=1e-6)
    d = _dirs(n, 3)
    ct, _ = jppg.dir_to_uv(jnp.asarray(d))
    y = np.clip((np.asarray(ct) * RES).astype(np.int32), 0, RES - 1)
    rows = eff2d[jl * RES + jnp.asarray(y)]
    np.testing.assert_allclose(
        to_np(tppg.grid_pdf(torch.as_tensor(np.asarray(rows)),
                            t_total[tl.long()], torch.as_tensor(d))),
        np.asarray(jppg.grid_pdf(rows, total[jl], jnp.asarray(d))),
        rtol=RTOL)


def _check_adam():
    rs = np.random.RandomState(4)
    L, n = 8, 5000
    leaf = rs.randint(0, 6, n).astype(np.int32)
    g_pdf = rs.rand(n).astype(np.float32) * 2.0
    bsdf_pdf = rs.rand(n).astype(np.float32)
    wo_pdf = 0.5 * bsdf_pdf + 0.5 * g_pdf
    product = rs.rand(n).astype(np.float32) * 3.0
    gw = np.stack([product, wo_pdf, bsdf_pdf, g_pdf], -1)
    valid = rs.rand(n) < 0.8
    stat_w = np.ones(n, np.float32)
    state_j = (jnp.zeros(L), jnp.zeros(L), jnp.zeros(L), jnp.zeros(L,
                                                                  jnp.int32))
    state_t = (torch.zeros(L), torch.zeros(L), torch.zeros(L),
               torch.zeros(L, dtype=torch.int32))
    for power in (1.0, 2.0):
        state_j = jppg.adam_fraction_steps(
            *state_j, jnp.asarray(gw), jnp.asarray(stat_w), jnp.asarray(leaf),
            jnp.asarray(valid), ratio_power=power)
        state_t = tppg.adam_fraction_steps(
            *state_t, torch.as_tensor(gw), torch.as_tensor(stat_w),
            torch.as_tensor(leaf), torch.as_tensor(valid), ratio_power=power)
        for g, w in zip(state_t, state_j):
            np.testing.assert_allclose(to_np(g), np.asarray(w),
                                       rtol=SUM_RTOL, atol=1e-7)
    assert (np.abs(to_np(state_t[0])[:6]) > 0).all()


def _check_splat(stochastic, box):
    L = 64
    tj = jstree.STree(np.zeros(3), np.ones(3), max_leaves=L)
    tt = tstree.STree(np.zeros(3), np.ones(3), max_leaves=L)
    for t in (tj, tt):
        t.split_to_depth(3)
    tab_j, tab_t = tj.device_tables(), tt.device_tables("cpu")
    rs = np.random.RandomState(5)
    n = 6000
    pos = rs.rand(n, 3).astype(np.float32)
    d = _dirs(n, 6)
    w = rs.rand(n).astype(np.float32)
    valid = rs.rand(n) < 0.9
    leaf = np.asarray(jstree.find_leaf(tab_j, jnp.asarray(pos)))
    key = jax.random.PRNGKey(8)
    u = np.asarray(jax.random.uniform(key, pos.shape))
    add_j, cnt_j, lf_j = jppg._splat_jit(
        jnp.zeros((L, RES * RES)), jnp.zeros(L, jnp.int32), jnp.asarray(pos),
        jnp.asarray(d), jnp.asarray(w), jnp.asarray(valid), jnp.asarray(leaf),
        tab_j, key, stochastic, box)
    add_t, cnt_t, lf_t = tppg.splat(
        torch.zeros((L, RES * RES)), torch.zeros(L, dtype=torch.int32),
        *(torch.as_tensor(a) for a in (pos, d, w, valid, leaf)), tab_t,
        torch.as_tensor(u), stochastic, box)
    np.testing.assert_array_equal(to_np(lf_t), np.asarray(lf_j))
    np.testing.assert_array_equal(to_np(cnt_t), np.asarray(cnt_j))
    np.testing.assert_allclose(to_np(add_t), np.asarray(add_j),
                               rtol=SUM_RTOL, atol=1e-5)


def test_grid_functions_match_reference(reference_run):
    """The direction maps, the adaptive projection at rho 0, 0.01 and
    0.05, the grid pdf and the sampler."""
    _check_direction_maps()
    for rho in (0.0, 0.01, 0.05):
        _check_projection(rho)
    _check_grid()


def test_training_steps_match_reference():
    """The Adam steps of the learned fraction (ratio powers 1 and 2) and
    the splat, stochastic with the box filter and nearest-cell."""
    _check_adam()
    for stochastic, box in ((True, True), (False, False)):
        _check_splat(stochastic, box)


def test_ppg_run_matches_reference_in_expectation(reference_run):
    """PPGTrainer.run at 15 spp (1 + 2 + 4 + 8) on the box: the pooled
    films of all iterations agree with the reference's within 4 standard
    errors; both trained every leaf they reached and split the tree."""
    ts, cfg = _box("t")
    tr = tppg.PPGTrainer(ts, cfg, tppg.PPGConfig(**RUN, seed=3), device="cpu")
    img, iters = tr.run(total_spp=SPP)
    assert [it["spp"] for it in iters] == [1, 2, 4, 8]
    assert np.isfinite(img).all()
    assert tr.tree.n_leaves > 8 and int(tr.initialized.sum()) > 0
    assert set(tr.stats[-1]) == {"iteration", "spp", "seconds",
                                 "leaf_nodes_count", "active"}
    out, th = reference_run
    th.join()
    ref_iters = out["iters"]
    assert [it["spp"] for it in ref_iters] == [1, 2, 4, 8]

    def pooled(its):
        return film_mean_se(*(np.sum([it[k] for it in its], 0)
                              for k in ("image", "sqr", "weight")))

    got, want = pooled(iters), pooled(ref_iters)
    assert within_se(got, want), (got, want)
    # The carried-across reference state projects as the reference's.
    jt = out["trainer"]
    convert.ppg_state_from_numpy(tr, convert.ppg_state_to_numpy(jt))
    assert tr.tree.n_leaves == jt.tree.n_leaves
    for g, w in zip(tr._project(), jt._project()):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=RTOL,
                                   atol=1e-9)
