"""The port's device mesh (parallel/mesh.py, SDMMTrainer(mesh=),
diff/inverse.py's multi-rank gradients) on four gloo ranks on the CPU,
against one process and the reference's 8-device runs
(tests/test_parallel.py, tests/test_diff.py). The ranks
(tests/torch_mesh_ranks.py) are spawned once for the file, with a 60 s
timeout on every collective, and joined with a deadline: a lost rank
fails the tests instead of hanging them. Tolerances: films rtol 1e-5
against the summed single-process replays; the mesh trainer and the
multi-rank gradients rtol 2e-3 against one process (tests/test_parallel.py
and tests/test_diff.py's); the render step's mean within 4 joint standard
errors of the reference's."""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_ranks as ranks  # noqa: E402
from torch_parity import make_box, make_rough_box, to_np  # noqa: E402

from sdmm_tpu.parallel import mesh as jmesh  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.core.draws import seeded  # noqa: E402
from sdmm_tpu_torch.diff import inverse  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.guiding.stree import find_leaf  # noqa: E402
from sdmm_tpu_torch.guiding.trainer import TrainerConfig  # noqa: E402
from sdmm_tpu_torch.ops import em_suffstats  # noqa: E402
from sdmm_tpu_torch.render.guided import (  # noqa: E402
    GuideState, trace_wave_guided,
)
from sdmm_tpu_torch.render.volpath import trace_wave  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.scene.sensor import generate_rays  # noqa: E402

torch.set_num_threads(2)
WORLD = 4
DEADLINE = 300.0  # seconds the ranks may take in all


def _reference_render(out):
    """The reference's 8-device build_render_step on the same pixels, eight
    keys: each film's mean a sample and channel."""
    b = make_box(jscene, jshapes, 16, 16)
    b.max_depth = b.rr_depth = 3
    scene, cfg = b.build()
    n_pix = cfg.width * cfg.height
    step = jmesh.build_render_step(scene, cfg, jmesh.make_mesh())
    pix = jnp.arange(n_pix * 8, dtype=jnp.int32) % n_pix
    out["means"] = [float(np.asarray(step(pix, jax.random.PRNGKey(k))).sum())
                    / (pix.shape[0] * 3) for k in range(8)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, and the reference's render means."""
    tmp = tmp_path_factory.mktemp("mesh")
    ref = {}
    th = threading.Thread(target=_reference_render, args=(ref,))
    th.start()
    ctx = mp.start_processes(
        ranks.rank_main, args=(WORLD, str(tmp / "init"), str(tmp)),
        nprocs=WORLD, join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=max(1.0, end - time.monotonic())):
            if time.monotonic() > end:
                pytest.fail(f"the ranks did not finish in {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    th.join(timeout=DEADLINE)
    assert not th.is_alive() and "means" in ref
    out = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    # The state is replicated: every rank holds rank 0's results.
    for r in range(1, WORLD):
        for k, v in out[0].items():
            np.testing.assert_array_equal(out[r][k], v, err_msg=k)
    return out[0], ref


def _camera(scene, cfg, idx, gen):
    w, h = cfg.width, cfg.height
    u = torch.rand((idx.shape[0], 2), generator=gen)
    return generate_rays(scene, torch.stack(
        [(idx % w).float() + u[:, 0], (idx // w).float() + u[:, 1]], -1),
        w, h, cfg.fov_axis)


def _blocks(n):
    per = n // WORLD
    return [slice(r * per, (r + 1) * per) for r in range(WORLD)]


def test_render_step_is_the_sum_of_its_ranks(runs):
    """build_render_step's film equals four single-process replays of the
    ranks' blocks (generator (seed, rank)) summed, and its mean lies within
    4 joint standard errors of the reference's over eight keys (the port's
    error from the spread of each pixel's four rank sums)."""
    got, ref = runs
    scene, cfg = ranks.box()
    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_pix * 8) % n_pix
    films = []
    for r, blk in enumerate(_blocks(pix.shape[0])):
        gen = seeded("cpu", ranks.RENDER_SEED, r)
        ro, rd = _camera(scene, cfg, pix[blk], gen)
        li = torch.nan_to_num(trace_wave(
            scene, gen, ro, rd, max_depth=cfg.max_depth,
            rr_depth=cfg.rr_depth, bsdf_types=cfg.bsdf_types or None),
            nan=0.0, posinf=0.0, neginf=0.0)
        films.append(torch.zeros((n_pix, 3)).index_add_(0, pix[blk], li))
    films = torch.stack(films)
    np.testing.assert_allclose(got["render"], to_np(films.sum(0)),
                               rtol=1e-5, atol=1e-6)
    n = pix.shape[0] * 3
    se = float(np.sqrt((WORLD * to_np(films.mean(-1)).var(0, ddof=1)).sum())
               / pix.shape[0])
    m_ref = np.asarray(ref["means"])
    se_ref = m_ref.std(ddof=1) / np.sqrt(len(m_ref))
    m = float(got["render"].sum()) / n
    assert abs(m - m_ref.mean()) <= 4.0 * np.hypot(se, se_ref), (
        m, m_ref.mean(), se, se_ref)


def test_trainer_on_the_mesh_matches_one_process(runs):
    """SDMMTrainer(mesh=) on four ranks against mesh=None at
    tests/test_parallel.py's configuration: both training iterations'
    film, the trained weights and means, the initialized leaves and the
    third render's conditionals."""
    got, _ = runs
    scene, cfg = ranks.box()
    want = ranks.run_trainer(scene, cfg, None)
    got = {k[len("trainer_"):]: v for k, v in got.items()
           if k.startswith("trainer_")}
    assert want["trained"] > 0 and got["trained"] > 0
    assert want["init"].any() and want["n_ok"] > 0
    np.testing.assert_allclose(got["img"], want["img"], rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(got["init"], want["init"])
    assert (got["n_try"], got["n_ok"]) == (want["n_try"], want["n_ok"])
    np.testing.assert_allclose(got["img_g"], want["img_g"], rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=2e-3,
                               atol=1e-5)
    init = want["init"]
    np.testing.assert_allclose(got["mean"][init], want["mean"][init],
                               rtol=2e-3, atol=2e-4)


def test_train_step_and_gradients_match_one_process(runs):
    """build_train_step's all-reduced E-step statistics, through its
    M-step, against one process's E-step over every rank's rows (the
    ranks' traces replayed); make_render_fn_multi(mesh=)'s gradients of
    the image mean, all-reduced, against one process's (tests/test_diff.py's
    multi-device parity)."""
    got, _ = runs
    scene, cfg = ranks.box()
    tc = TrainerConfig(**ranks.TRAIN_TC)
    sdmm, em, init, tables, aabb_lo, inv_norm = ranks.train_state(tc, scene)
    prep = tmix.prepare(sdmm)
    gs = GuideState(sdmm=sdmm, prep=prep, initialized=init, tables=tables,
                    aabb_lo=aabb_lo, inv_norm=inv_norm, kernel_table=None)
    n_pix = cfg.width * cfg.height
    pix = torch.arange(1024) % n_pix
    film = torch.zeros((n_pix, 3))
    rows = []
    for r, blk in enumerate(_blocks(pix.shape[0])):
        gen = seeded("cpu", ranks.TRAIN_SEED, r)
        ro, rd = _camera(scene, cfg, pix[blk], gen)
        li, s = trace_wave_guided(
            scene, gs, gen, ro, rd, max_depth=cfg.max_depth,
            rr_depth=cfg.rr_depth, bsdf_fraction=tc.bsdf_fraction,
            bsdf_types=cfg.bsdf_types or None)
        film.index_add_(0, pix[blk], torch.nan_to_num(
            li, nan=0.0, posinf=0.0, neginf=0.0))
        rows.append(s)
    pos, d, w = (torch.cat([s[k] for s in rows])
                 for k in ("pos", "dir", "weight"))
    sw, sm, sc, ws, cnt = em_suffstats.e_step_plain(
        sdmm, prep, pos, d, w, find_leaf(tables, pos), tc.max_leaves,
        batch_size=tc.em.batch_size)
    active = (cnt >= 8) & (sw.sum(-1) > 0)
    new, new_em = tem.m_step(sdmm, prep, em, sw, sm, sc, ws, active, tc.em)
    assert bool(active.any())
    np.testing.assert_array_equal(got["train_cnt"], to_np(cnt))
    np.testing.assert_array_equal(got["train_init"], to_np(active))
    np.testing.assert_array_equal(got["train_it"], to_np(new_em.iterations))
    np.testing.assert_allclose(got["train_film"], to_np(film), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["train_weight"], to_np(new.weight),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got["train_mean"], to_np(new.mean),
                               rtol=2e-3, atol=2e-4)

    rough, rough_cfg = make_rough_box(tscene, tshapes).build(device="cpu")
    p = ranks.grad_params(rough)
    inverse.make_render_fn_multi(
        rough, rough_cfg, torch.arange(rough_cfg.width * rough_cfg.height),
        spp=2, device="cpu")(p, ranks.GRAD_SEED).mean().backward()
    for k, v in p.items():
        assert float(v.grad.abs().max()) > 0.0
        np.testing.assert_allclose(got["grad_" + k], to_np(v.grad),
                                   rtol=2e-3, atol=1e-6)
