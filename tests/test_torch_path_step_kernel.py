"""Port parity of the fused unguided step with NEE (the ops/bounce.py step
twin) against the reference kernel ``bounce_pallas.step`` in interpret
mode on one 8192-lane tile of the 18-triangle glossy box (every in-kernel
BSDF type): three consecutive steps from a wave with fresh, mid-path and
exhausted lanes, both sides on the same host uniforms; each port step
starts from the reference's previous output, so each step is compared from
equal inputs. The reference's compile (~26 s) runs in a background thread;
the file holds few tests, so that the tier-1 scheduler (``--dist
loadfile``, files with the most tests first) runs it after the long
reference files. Tolerances: state and film rtol 1e-5 / atol 1e-6, meta
equal, each on >= 99.9% of the lanes (an RR draw or a Fresnel choice
within an ulp of its threshold, or a sine an ulp apart in the disk map,
moves a lane). The film is not compared bit for bit: XLA's CPU backend
contracts film + radiance² into fused multiply-adds, so ~8% of the lanes
differ from the twin in the last bits (at most 3e-6 relative).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_path_step import (  # noqa: E402
    MAX_DEPTH, RR_DEPTH, STEPS, TYPES, H, N, R, W, _port_step, _scenes,
    _wave,
)

from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402

torch.set_num_threads(2)


def _reference_steps():
    """Three interpret-mode calls of the reference step kernel, each on
    the previous call's output; returns every step's inputs and outputs as
    numpy."""
    js, _, tcfg = _scenes()
    assert tcfg.bsdf_types == TYPES
    tri, em, env = bp.build_tables(js)
    cam = bp.build_cam_params(js, W, H)
    state, meta, film, pxpy, rands = _wave()
    ins, outs = [], []
    for k in range(STEPS):
        ins.append((state, meta, film))
        out = bp.step(
            jnp.asarray(state.reshape(16, R, 128)),
            jnp.asarray(meta.reshape(R, 128)),
            jnp.asarray(film.reshape(8, R, 128)), jnp.ones((1,), jnp.int32),
            cam, jnp.zeros((2,), jnp.int32),
            jnp.asarray(pxpy.reshape(3, R, 128)), tri, em, env,
            n_tris=int(js.tri_v0.shape[0]), n_em=int(js.em_tri_idx.shape[0]),
            max_depth=MAX_DEPTH, rr_depth=RR_DEPTH, types=TYPES, width=W,
            height=H, interpret=True,
            rand=jnp.asarray(rands[k].reshape(bo.STEP_RAND_ROWS, R, 128)))
        state, meta, film = (np.asarray(a).reshape(a.shape[0], N)
                             if a.ndim == 3 else np.asarray(a).reshape(N)
                             for a in out)
        outs.append((state, meta, film))
    return dict(pxpy=pxpy, rands=rands, ins=ins, outs=outs)


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """Starts the reference steps at the top of the module, so that their
    compile overlaps the tests that do not need them."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference_steps)


@pytest.fixture(scope="module")
def reference(_reference_run):
    return _reference_run.result()


@pytest.mark.parametrize("k", range(STEPS))
def test_step_twin_matches_reference_kernel(reference, k):
    ref = reference
    st, me, fi = _port_step(ref["ins"][k], ref["pxpy"], ref["rands"][k])
    st_r, me_r, fi_r = ref["outs"][k]
    me_in = ref["ins"][k][1]
    assert me.dtype == np.int32 and st.shape == (16, N) and fi.shape == (8, N)
    # The step exercises regeneration, exhaustion, splats and NEE.
    alive_in = (me_in & bo._ALIVE) != 0
    exh_in = (me_in & bo._EXH) != 0
    regen = ~alive_in & ~exh_in & ((me_in & bo._PIX_MASK)
                                   < ref["pxpy"][2])
    assert regen.sum() > 50 and ((me_r & bo._EXH) != 0).sum() > exh_in.sum()
    splat = fi_r - ref["ins"][k][2]
    assert (splat[6] > 0).sum() > 100 and (splat[7] > 0).sum() > 1000
    ok_state = np.isclose(st, st_r, rtol=1e-5, atol=1e-6,
                          equal_nan=True).all(0)
    ok_meta = me == me_r
    ok_film = np.isclose(fi, fi_r, rtol=1e-5, atol=1e-6, equal_nan=True).all(0)
    for name, ok in (("state", ok_state), ("meta", ok_meta),
                     ("film", ok_film)):
        assert ok.mean() >= 0.999, (name, ok.mean(), np.nonzero(~ok)[0][:8])
