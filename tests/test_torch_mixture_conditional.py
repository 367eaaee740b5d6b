"""Port parity of the mixture core: prepare, the conditionals (creation,
sampling from uniforms, pdf) and the packing of the kernel table and the
conditioning rows, sdmm_tpu_torch vs sdmm_tpu on the same seeded states.
Tolerances as in tests/test_torch_mixture.py. The file holds few tests,
so that the tier-1 scheduler (``--dist loadfile``, files with the most
tests first) runs it after the long reference files."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mixture import _dirs, _states  # noqa: E402
from torch_parity import t, to_np  # noqa: E402

from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.ops import guided_pallas as jgp  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as tgs  # noqa: E402

torch.set_num_threads(1)


def test_prepare_matches():
    st, js, ts = _states()
    jp = jmix.prepare(js)
    tp = tmix.prepare(ts)
    for name in jmix.Prepared._fields:
        a, b = to_np(getattr(tp, name)), np.asarray(getattr(jp, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def _lookup(seed, L, N):
    rs = np.random.RandomState(seed)
    leaf = rs.randint(0, L, size=N)
    pos = rs.rand(N, 3).astype(np.float32)
    return leaf, pos, _dirs(rs, N), rs.rand(N).astype(np.float32), \
        rs.rand(N, 2).astype(np.float32)


def test_conditional_sample_and_pdf_match():
    L, N = 8, 1024
    st, js, ts = _states(5, L)
    jp, tp = jmix.prepare(js), tmix.prepare(ts)
    leaf, pos, wob, u_sel, u2 = _lookup(11, L, N)
    jc = jmix.create_conditional(jax.tree.map(lambda x: x[leaf], jp),
                                 js.weight[leaf], jnp.asarray(pos))
    tc = tmix.create_conditional(
        tmix.Prepared(*(x[torch.as_tensor(leaf)] for x in tp)),
        ts.weight[torch.as_tensor(leaf)], t(pos))
    np.testing.assert_array_equal(to_np(tc.valid), np.asarray(jc.valid))
    for name in ("weight", "mu_dir", "chol", "inv_det"):
        np.testing.assert_allclose(to_np(getattr(tc, name)),
                                   np.asarray(getattr(jc, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    jd, jok = jmix.conditional_sample_from_uniforms(
        jc, jnp.asarray(u_sel), jnp.asarray(u2))
    td, tok = tmix.conditional_sample_from_uniforms(tc, t(u_sel), t(u2))
    m = np.asarray(jc.valid)
    assert m.mean() > 0.5
    np.testing.assert_allclose(to_np(td)[m], np.asarray(jd)[m], atol=1e-4)
    np.testing.assert_array_equal(to_np(tok)[m], np.asarray(jok)[m])
    np.testing.assert_allclose(to_np(tmix.conditional_pdf(tc, t(wob))),
                               np.asarray(jmix.conditional_pdf(
                                   jc, jnp.asarray(wob))),
                               rtol=1e-3, atol=1e-5)


def test_pack_conditioning_and_guided_rows_match():
    st, js, ts = _states(2, 6)
    jp, tp = jmix.prepare(js), tmix.prepare(ts)
    init = st["initialized"]
    ja = jgp.pack_guided_rows(jp, js.weight, jnp.asarray(init))
    ta = tgs.pack_guided_rows(tp, ts.weight, torch.as_tensor(init))
    assert ta.shape == (tgs.N_ROWS, 6)
    np.testing.assert_allclose(to_np(ta), np.asarray(ja), rtol=1e-4,
                               atol=1e-5)
    jc = jmix.pack_conditioning(jp, js.weight, jnp.asarray(init))
    tc = tmix.pack_conditioning(tp, ts.weight, torch.as_tensor(init))
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=1e-4,
                               atol=1e-5)
    w, prep_u, ini = tmix.unpack_conditioning(tc, 16)
    np.testing.assert_allclose(to_np(prep_u.premult), to_np(tp.premult))
    np.testing.assert_array_equal(to_np(ini), init)
