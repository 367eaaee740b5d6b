"""Port parity: the unguided pools with NEE (render/wavefront.py) and the
bounce kernel's twin, sdmm_tpu_torch vs sdmm_tpu.

``bounce_plain`` is held against one interpret-mode call of the reference
``bounce_pallas.bounce`` on one 8192-lane tile of the 12-triangle box of
tests/test_render.py, on the same numpy inputs (state and splat rtol 1e-5 /
atol 1e-6, meta equal, each on >= 99.9% of the lanes). The reference's
compile and its eager ``render_pool`` run in background threads while the
port's renders run. Whole renders draw their own random numbers, so they
agree in expectation: the port's eager pool against the reference's at 128
spp within 5% in image mean (the bound of tests/test_wavefront.py), NEE
against BSDF sampling alone within the port within 5%, and the port's
fused pools on the CPU (their plain twins) against its eager pool at 64 spp
within 6% (tests/test_bounce_pallas.py:310,350), each landing exactly spp
samples on every pixel.
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
from torch_parity import make_box, path_wave, to_np  # noqa: E402

from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W = H = 16
R = bo.RT  # one 64 x 128 lane tile
N = R * 128
MAX_DEPTH, RR_DEPTH = 5, 5


def _box():
    js, _ = make_box(jscene, jshapes, W, H).build()
    ts, tcfg = make_box(tscene, tshapes, W, H).build(device="cpu")
    return js, ts, tcfg


def _wave():
    state, meta, _, _, rand = path_wave(N, 5, W, H, MAX_DEPTH)
    return state, meta, rand[:bo.RAND_ROWS].copy()


def _reference_bounce():
    js, _, _ = _box()
    tri, em, env = bp.build_tables(js)
    state, meta, rand = _wave()
    out = bp.bounce(jnp.asarray(state.reshape(16, R, 128)),
                    jnp.asarray(meta.reshape(R, 128)),
                    jnp.asarray(rand.reshape(bo.RAND_ROWS, R, 128)), tri, em,
                    env, n_tris=int(js.tri_v0.shape[0]),
                    n_em=int(js.em_tri_idx.shape[0]), max_depth=MAX_DEPTH,
                    rr_depth=RR_DEPTH, types=(0,), interpret=True)
    return tuple(np.asarray(a).reshape(a.shape[0], N) if a.ndim == 3
                 else np.asarray(a).reshape(N) for a in out)


def _mean(out):
    img = np.asarray(out["image"]) / np.maximum(
        np.asarray(out["weight"]), 1.0)[:, None]
    return float(img.mean())


def _reference_pool():
    js, _, tcfg = _box()
    out = jwf.render_pool(js, jax.random.PRNGKey(3), n_lanes=4096, spp=128,
                          width=W, height=H, max_depth=MAX_DEPTH,
                          rr_depth=RR_DEPTH, nee=True,
                          bsdf_types=tcfg.bsdf_types)
    assert (np.asarray(out["weight"]) == 128).all()
    return _mean(out)


@pytest.fixture(scope="module", autouse=True)
def _reference_runs():
    """Starts the reference kernel and pool at the top of the module, so
    that their compiles overlap the port's renders."""
    with ThreadPoolExecutor(2) as ex:
        yield {"bounce": ex.submit(_reference_bounce),
               "pool": ex.submit(_reference_pool)}


def _port_pool(spp, nee=True, seed=1):
    _, ts, tcfg = _box()
    return twf.render_pool(ts, torch.Generator().manual_seed(seed),
                           n_lanes=4096, spp=spp, width=W, height=H,
                           max_depth=MAX_DEPTH, rr_depth=RR_DEPTH, nee=nee,
                           bsdf_types=tcfg.bsdf_types, device="cpu")


@pytest.fixture(scope="module")
def eager64():
    out = _port_pool(64)
    assert (to_np(out["weight"]) == 64).all() and out["pool"] == "eager"
    return out


def test_bounce_twin_matches_reference_kernel(_reference_runs):
    _, ts, _ = _box()
    tri, em, env = bo.build_tables(ts)
    state, meta, rand = _wave()
    st, me, sp = (to_np(a) for a in bo.bounce(
        torch.as_tensor(state), torch.as_tensor(meta), torch.as_tensor(rand),
        tri, em, env, int(ts.em_tri_idx.shape[0]), MAX_DEPTH, RR_DEPTH,
        (0,)))
    st_r, me_r, sp_r = _reference_runs["bounce"].result()
    assert me.dtype == np.int32 and sp.shape == (8, N)
    assert sp_r[6].sum() > 100 and sp_r[7].sum() > N // 4
    assert np.isfinite(sp_r).all()
    for name, ok in (
            ("state", np.isclose(st, st_r, rtol=1e-5, atol=1e-6,
                                 equal_nan=True).all(0)),
            ("meta", me == me_r),
            ("splat", np.isclose(sp, sp_r, rtol=1e-5, atol=1e-6).all(0))):
        assert ok.mean() >= 0.999, (name, ok.mean(), np.nonzero(~ok)[0][:8])


def test_bounce_twin_tile_skip():
    _, ts, _ = _box()
    tri, em, env = bo.build_tables(ts)
    state, meta, rand = (torch.as_tensor(a) for a in _wave())
    st, me, sp = bo.bounce(state, meta, rand, tri, em, env, 2, MAX_DEPTH,
                           RR_DEPTH, (0,), torch.zeros(1, dtype=torch.int32))
    assert torch.equal(me, meta) and not sp.any()
    assert torch.equal(st.nan_to_num(), state.nan_to_num())


def test_render_pool_matches_reference_pool(_reference_runs):
    out = _port_pool(128, seed=2)
    assert (to_np(out["weight"]) == 128).all()
    m_t, m_j = _mean(out), _reference_runs["pool"].result()
    assert abs(m_t - m_j) / m_j < 0.05, (m_t, m_j)


def test_render_pool_nee_matches_bsdf_sampling(eager64):
    out_b = _port_pool(512, nee=False, seed=7)
    assert (to_np(out_b["weight"]) == 512).all()
    m_n, m_b = _mean(eager64), _mean(out_b)
    assert abs(m_n - m_b) / m_b < 0.05, (m_n, m_b)


@pytest.mark.parametrize("pool", ["sorted2", "striped"])
def test_fused_pool_twins_match_eager_pool(eager64, pool):
    _, ts, tcfg = _box()
    kw = dict(spp=64, width=W, height=H, max_depth=MAX_DEPTH,
              rr_depth=RR_DEPTH, bsdf_types=tcfg.bsdf_types, device="cpu")
    if pool == "sorted2":
        out = twf.render_pool_fused_sorted2(ts, 3, spp_pilot=16, **kw)
        assert 0 < out["alive_tile_steps"] <= out["total_tile_steps"]
    else:
        out = twf.render_pool_fused_striped(ts, 3, **kw)
    assert out["pool"] == pool
    assert (to_np(out["weight"]) == 64).all()  # every pixel exactly spp
    img = to_np(out["image"]) / 64
    assert np.isfinite(img).all()
    m_f, m_p = float(img.mean()), _mean(eager64)
    assert abs(m_f - m_p) / m_p < 0.06, (m_f, m_p)
    # Vertices: the fused pools count after the back-face cull, the eager
    # pool before it (as the reference pools do); the box has no back faces
    # in view, so the two agree in expectation.
    nv_f, nv_p = float(out["n_vertices"]), float(eager64["n_vertices"])
    assert abs(nv_f - nv_p) / nv_p < 0.03, (nv_f, nv_p)


def test_render_wavefront_routes_on_the_cpu():
    _, ts, tcfg = _box()
    assert twf.fused_supported(ts, tcfg)
    assert not twf.fused_supported(ts, tcfg, nee=False)
    res = twf.render_wavefront(ts, tcfg, spp=3, seed=2, n_lanes=64,
                               device="cpu")
    assert res["pool"] == "eager"  # every CPU render takes the eager pool
    assert res["image"].shape == (H, W, 3) and res["raw"].shape == (H, W, 3)
    np.testing.assert_array_equal(res["weight"], 3.0)
    assert np.isfinite(res["image"]).all() and res["n_vertices"] > 0
    dark = tscene.SceneBuilder()
    dark.add_shape(tshapes.make_rectangle(np.eye(4)), 0)
    scene, cfg = dark.build(device="cpu")
    assert not twf.fused_supported(scene, cfg)  # no emissive triangle
