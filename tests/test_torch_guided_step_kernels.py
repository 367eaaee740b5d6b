"""Port parity of the fused guided bounce against the reference's kernels
and pool: the trace and shade twins (ops/guided_step.py) against one
interpret-mode call of each reference kernel on one 16 x 128 lane tile of
the four-type box (every in-kernel BSDF type), in one module-scoped
fixture that starts them in a background thread, and the frozen-model pool
render_pool_guided_fused against the reference's XLA guided pool. A file
of few tests, so that the tier-1 scheduler (``--dist loadfile``, files with
the most tests first) runs it after the long reference files; the tables
and helpers are in tests/test_torch_guided_step.py.

Tolerances: trace: the winner's attributes exact, positions, shading
normals and radiance rtol 1e-5; shade: state rtol 2e-4 / atol 1e-5 (the
mixture pdf divides the throughput; sums in another order), meta and splat
rows equal, each on >= 99.8% of the lanes (a u_sel within an ulp of a CDF
step or a roulette draw within an ulp of q flips a lane). The fused pool
draws its own random numbers, so it agrees with the reference's XLA pool
in expectation, within the bounds of tests/test_guided_pallas.py's
fused-pool test (mean 12%, median 4x4-block difference 0.3). Both render
256 spp: the guide of the synthetic-sample recipe leaves a per-sample
standard deviation ~5x the mean, so at 24 spp the reference pool against
itself already reaches block medians of 0.20-0.32; at 256 spp the two
pools differed by <= 4% in mean and <= 0.135 in block median over seeds
3-7.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guided_step import (  # noqa: E402
    FRACTION, MAX_DEPTH, N, R, RR_DEPTH, TYPES, _scenes,
)
from test_torch_trainer import _synthetic_batch, _trainers  # noqa: E402
from torch_parity import lane_wave, make_mixture_state, to_np  # noqa: E402

from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu.ops import guided_step_pallas as gsp  # noqa: E402
from sdmm_tpu.render import guided as jguided  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from sdmm_tpu_torch.ops import guided_step as gst  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402

torch.set_num_threads(2)


def _reference_kernels():
    """One interpret-mode call of each reference kernel on one lane tile of
    the four-type box, with every input as numpy. Nearly all of its time
    is XLA's compile, which releases the GIL: shade is lowered first from
    its shapes alone and compiled in a second thread while trace is
    lowered, compiled and run; shade then runs on trace's hit buffer."""
    js, _, tcfg = _scenes(True)
    assert tcfg.bsdf_types == TYPES
    tri, _, env = (np.asarray(a) for a in bp.build_tables(js))
    state, meta, rand = lane_wave(N, seed=7, max_depth=MAX_DEPTH)
    tile = (R, 128)

    def spec(rows, dtype=jnp.float32):
        return jax.ShapeDtypeStruct((rows, *tile), dtype)

    shade_j = jax.jit(lambda *a: gsp.shade(
        *a, types=TYPES, max_depth=MAX_DEPTH, rr_depth=RR_DEPTH,
        bsdf_fraction=FRACTION, interpret=True)).lower(
            spec(16), jax.ShapeDtypeStruct(tile, jnp.int32),
            spec(gst.HIT_ROWS), spec(3),
            spec(gso.N_ROWS, jnp.bfloat16), spec(gst.RAND_ROWS))
    with ThreadPoolExecutor(1) as ex:
        shade_j = ex.submit(shade_j.compile)
        st_j, hit_j = gsp.trace(
            jnp.asarray(state.reshape(16, *tile)),
            jnp.asarray(meta.reshape(tile)), jnp.asarray(tri),
            jnp.asarray(env), n_tris=js.tri_v0.shape[0], types=TYPES,
            interpret=True)
        shade_j = shade_j.result()
    st_j = np.asarray(st_j).reshape(16, N)
    hit_j = np.asarray(hit_j).reshape(gst.HIT_ROWS, N)

    ms = make_mixture_state(seed=2, L=8)
    sdmm = tmix.SDMM(*(torch.as_tensor(ms[k]) for k in ("weight", "mean",
                                                         "cov")))
    table16 = gso.pack_guided_rows(
        tmix.prepare(sdmm), sdmm.weight,
        torch.as_tensor(ms["initialized"])).T.to(torch.bfloat16).contiguous()
    rs = np.random.RandomState(8)
    leaf = rs.randint(0, 8, N).astype(np.int32)
    cpos = ((hit_j[0:3] - np.array([[-1.0], [0.0], [-1.0]])) / 2.0
            ).astype(np.float32)
    rows_t = table16.float().numpy()[leaf].T  # exact bf16 values
    out_j = shade_j(
        jnp.asarray(st_j.reshape(16, *tile)), jnp.asarray(meta.reshape(tile)),
        jnp.asarray(hit_j.reshape(gst.HIT_ROWS, *tile)),
        jnp.asarray(cpos.reshape(3, *tile)),
        jnp.asarray(rows_t.reshape(gso.N_ROWS, *tile)).astype(jnp.bfloat16),
        jnp.asarray(rand.reshape(gst.RAND_ROWS, *tile)))
    shade_j = tuple(np.asarray(a).reshape(a.shape[0], N) if a.ndim == 3
                    else np.asarray(a).reshape(N) for a in out_j)
    return dict(tri=tri, env=env, state=state, meta=meta, rand=rand,
                st_j=st_j, hit_j=hit_j, table16=table16, leaf=leaf,
                cpos=cpos, shade_j=shade_j)


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """Starts the reference kernels at the top of the module, so that
    their compile overlaps the tests that do not need them."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference_kernels)


@pytest.fixture(scope="module")
def kernels(_reference_run):
    return _reference_run.result()


def test_trace_twin_matches_reference_kernel(kernels):
    k = kernels
    st, hit = gst.trace(torch.as_tensor(k["state"]),
                        torch.as_tensor(k["meta"]), torch.as_tensor(k["tri"]),
                        torch.as_tensor(k["env"]), TYPES)
    st, hit, hit_j = to_np(st), to_np(hit), k["hit_j"]
    assert hit.shape == (gst.HIT_ROWS, N)
    on = hit_j[21] > 0.5
    assert 0.3 < on.mean() < 0.95  # hits and misses, alive and dead lanes
    assert len(set(hit_j[12][on].tolist())) == 4  # every BSDF type was hit
    exact = [3, 4, 5] + list(range(9, 22))
    np.testing.assert_array_equal(hit[exact], hit_j[exact])
    np.testing.assert_allclose(hit[0:3], hit_j[0:3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hit[6:9], hit_j[6:9], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st, k["st_j"], rtol=1e-5, atol=1e-6)


def test_shade_twin_matches_reference_kernel(kernels):
    k = kernels
    st, meta, splat = gst.shade(
        torch.as_tensor(k["st_j"]), torch.as_tensor(k["meta"]),
        torch.as_tensor(k["hit_j"]), torch.as_tensor(k["cpos"]),
        torch.as_tensor(k["leaf"]), gst.pack_shade_table(k["table16"]),
        torch.as_tensor(k["rand"]), TYPES, MAX_DEPTH, RR_DEPTH, FRACTION)
    st_r, meta_r, splat_r = k["shade_j"]
    st, meta, splat = to_np(st), to_np(meta), to_np(splat)
    assert meta.dtype == np.int32 and splat.shape == (gst.SPLAT_ROWS, N)
    assert not st[13:].any()
    # The comparison exercises the branches: guided and BSDF samples, RR,
    # splats, and NaN radiance splatting 0.
    assert 0 < splat_r[9].sum() <= splat_r[8].sum() < splat_r[7].sum()
    assert 0 < splat_r[6].sum() < N
    assert np.isfinite(splat_r).all()
    ok_state = np.isclose(st, st_r, rtol=2e-4, atol=1e-5,
                          equal_nan=True).all(0)
    ok_meta = meta == meta_r
    ok_splat = (splat == splat_r).all(0)
    for name, ok in (("state", ok_state), ("meta", ok_meta),
                     ("splat", ok_splat)):
        assert ok.mean() >= 0.998, (name, ok.mean(), np.nonzero(~ok)[0][:8])


@pytest.fixture(scope="module")
def carried():
    """The trained recipe of test_torch_trainer.py: a JAX trainer after one
    optimize on synthetic samples, its state carried to the port."""
    jt, tt = _trainers(split_threshold=500, jitter_replicas=False)
    jt.total_spp = 16
    batch = _synthetic_batch(jt)
    jt.optimize([{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in batch.items()}])
    convert.trainer_state_from_numpy(tt, convert.trainer_state_to_numpy(jt))
    return jt, tt


def test_fused_pool_matches_reference_pool_estimator(carried):
    jt, tt = carried
    W = H = 16
    spp = 256
    kw = dict(spp=spp, width=W, height=H, max_depth=4, rr_depth=4,
              bsdf_fraction=0.5, fov_axis="x")
    gs = tt.guide_state()
    assert tguided.guided_fused_supported(tt.scene, tt.render_cfg, gs)
    out_x = jguided.render_pool_guided(
        jt.scene, jt.guide_state(), jax.random.PRNGKey(3), n_lanes=1024,
        bsdf_types=jt.render_cfg.bsdf_types or None, **kw)
    out_f = tguided.render_pool_guided_fused(
        tt.scene, gs, torch.Generator().manual_seed(3), n_lanes=2048,
        bsdf_types=tt.render_cfg.bsdf_types, device="cpu", **kw)
    ix = np.asarray(out_x["image"]) / np.maximum(
        np.asarray(out_x["weight"])[:, None], 1.0)
    i_f = to_np(out_f["image"]) / np.maximum(
        to_np(out_f["weight"])[:, None], 1.0)
    assert np.isfinite(i_f).all()
    assert float(out_f["weight"].sum()) == W * H * spp  # each sample once
    assert abs(i_f.mean() - ix.mean()) / ix.mean() < 0.12, (
        i_f.mean(), ix.mean())
    bx = ix.mean(-1).reshape(4, 4, 4, 4).mean((1, 3))
    bf = i_f.mean(-1).reshape(4, 4, 4, 4).mean((1, 3))
    rel = np.abs(bf - bx) / np.maximum(bx, 5e-2)
    assert np.median(rel) < 0.3, (np.median(rel), rel)
    assert 0 < float(out_f["n_cond_ok"]) <= float(out_f["n_cond_try"])
    assert float(out_f["n_vertices"]) > 0
