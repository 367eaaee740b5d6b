"""Port parity of the unguided bounce and eager pool against the
reference's: ``bounce_plain`` against one interpret-mode call of the
reference ``bounce_pallas.bounce`` on one 8192-lane tile of the
12-triangle box of tests/test_render.py, on the same numpy inputs (state
and splat rtol 1e-5 / atol 1e-6, meta equal, each on >= 99.9% of the
lanes), and the port's eager ``render_pool`` against the reference's at
128 spp within 5% in image mean (the bound of tests/test_wavefront.py;
each draws its own random numbers). The reference's compile and pool run
in background threads; the file holds few tests, so that the tier-1
scheduler (``--dist loadfile``, files with the most tests first) runs it
after the long reference files.
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
from test_torch_wavefront import (  # noqa: E402
    MAX_DEPTH, RR_DEPTH, H, N, R, W, _box, _mean, _port_pool, _wave,
)
from torch_parity import to_np  # noqa: E402

from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402

torch.set_num_threads(2)


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


@pytest.fixture(scope="module", autouse=True)
def _reference_runs():
    """Starts the reference kernel and pool at the top of the module, so
    that their compiles overlap the port's renders."""
    with ThreadPoolExecutor(2) as ex:
        yield {"bounce": ex.submit(_reference_bounce),
               "pool": ex.submit(_reference_pool)}


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


def test_render_pool_matches_reference_pool(_reference_runs):
    out = _port_pool(128, seed=2)
    assert (to_np(out["weight"]) == 128).all()
    m_t, m_j = _mean(out), _reference_runs["pool"].result()
    assert abs(m_t - m_j) / m_j < 0.05, (m_t, m_j)
