"""Port parity: the guided-sampling kernel's plain twin
(sdmm_tpu_torch/ops/guided_sample.py) against the reference Pallas kernel
in interpret mode, with identical uniforms. Tolerances as in
tests/test_guided_pallas.py: directions rtol/atol 1e-4, pdf at the BSDF
direction rtol 2e-3 / atol 1e-5, pdf at the guided direction the same with
≤ 0.2% outliers (the Duff-frame sign branch at mu_dir.z ≈ 0).
The kernel-vs-twin cases are in tests/test_torch_gpu.py."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_mixture_state, t, to_np  # noqa: E402

from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.ops import guided_pallas as jgp  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as tgs  # noqa: E402

torch.set_num_threads(1)


def _jax_table(st):
    js = jmix.SDMM(weight=jnp.asarray(st["weight"]),
                   mean=jnp.asarray(st["mean"]), cov=jnp.asarray(st["cov"]))
    return jgp.pack_guided_rows(jmix.prepare(js), js.weight,
                                jnp.asarray(st["initialized"]))


def _torch_table(st, weight=None, initialized=None):
    w = st["weight"] if weight is None else weight
    ini = st["initialized"] if initialized is None else initialized
    ts = tmix.SDMM(weight=t(w), mean=t(st["mean"]), cov=t(st["cov"]))
    return tgs.pack_guided_rows(tmix.prepare(ts), ts.weight,
                                torch.as_tensor(ini))


@pytest.fixture(scope="module")
def tables3():
    """The 8-leaf mixture state of seed 3 and its [353, L] tables from both
    packages: the reference's jitted pack runs once a module (~7 s)."""
    st = make_mixture_state(3, 8)
    return st, _jax_table(st), _torch_table(st)


def _lanes(seed, L, N):
    rs = np.random.RandomState(seed)
    leaf = rs.randint(0, L, size=N).astype(np.int32)
    pos = rs.rand(N, 3).astype(np.float32)
    wob = rs.randn(N, 3).astype(np.float32)
    wob /= np.linalg.norm(wob, axis=-1, keepdims=True)
    u = rs.rand(N, 3).astype(np.float32)
    return leaf, pos, wob, u


def test_plain_twin_matches_reference_kernel(tables3):
    L, N = 8, 2048
    _, jtab, ttab = tables3
    leaf, pos, wob, u = _lanes(11, L, N)
    jd, jok, jpg, jpb, jv = jgp.guided_sample(
        jtab[:, leaf], jnp.asarray(pos.T), jnp.asarray(wob.T),
        jnp.asarray(u.T), interpret=True)
    td, tok, tpg, tpb, tv = tgs.guided_sample_plain(
        ttab[:, torch.as_tensor(leaf).long()], t(pos.T), t(wob.T), t(u.T))
    m = np.asarray(jv)
    np.testing.assert_array_equal(to_np(tv), m)
    assert m.sum() > N // 2  # the comparison is not vacuous
    np.testing.assert_allclose(to_np(td).T[m], np.asarray(jd).T[m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(to_np(tok)[m], np.asarray(jok)[m])
    np.testing.assert_allclose(to_np(tpb)[m], np.asarray(jpb)[m], rtol=2e-3,
                               atol=1e-5)
    close = np.isclose(to_np(tpg)[m], np.asarray(jpg)[m], rtol=2e-3,
                       atol=1e-5)
    assert close.mean() > 0.998, close.mean()


def test_twin_matches_mixture_path():
    """The twin also agrees with the mixture functions it fuses."""
    L, N = 8, 1024
    st = make_mixture_state(4, L)
    ttab = _torch_table(st)
    leaf, pos, wob, u = _lanes(12, L, N)
    ts = tmix.SDMM(weight=t(st["weight"]), mean=t(st["mean"]),
                   cov=t(st["cov"]))
    tp = tmix.prepare(ts)
    li = torch.as_tensor(leaf).long()
    cond = tmix.create_conditional(tmix.Prepared(*(x[li] for x in tp)),
                                   ts.weight[li], t(pos))
    d_ref, _ = tmix.conditional_sample_from_uniforms(cond, t(u[:, 0]),
                                                     t(u[:, 1:]))
    td, _, _, tpb, tv = tgs.guided_sample(tgs.pack_sample_table(ttab.T),
                                          torch.as_tensor(leaf), t(pos),
                                          t(wob), t(u))
    m = to_np(tv)
    assert m.mean() > 0.5
    np.testing.assert_array_equal(m, to_np(cond.valid)
                                  & st["initialized"][leaf])
    np.testing.assert_allclose(to_np(td)[m], to_np(d_ref)[m], atol=1e-4)
    np.testing.assert_allclose(to_np(tpb)[m],
                               to_np(tmix.conditional_pdf(cond, t(wob)))[m],
                               rtol=2e-3, atol=1e-5)


def test_uninitialized_and_empty_leaves_are_invalid_and_finite():
    L, N = 4, 1024
    st = make_mixture_state(7, L)
    w = st["weight"].copy()
    w[2] = 0.0  # leaf 2: every component dead
    ini = np.array([True, False, True, True])
    ttab = _torch_table(st, w, ini)
    leaf, pos, wob, u = _lanes(5, L, N)
    d, ok, pg, pb, v = tgs.guided_sample(tgs.pack_sample_table(ttab.T),
                                         torch.as_tensor(leaf), t(pos),
                                         t(wob), t(u))
    v = to_np(v)
    assert not v[leaf == 1].any()
    assert not v[leaf == 2].any()
    assert v[(leaf == 0) | (leaf == 3)].mean() > 0.9
    for a in (d, pg, pb):
        assert np.isfinite(to_np(a)).all()


def test_pack_sample_table_round_trips_reference_rows(tables3):
    """The packed float32 table the kernel reads holds the reference's
    rows bit for bit: each component's 22 values on a 24-value stride (a
    component is six 16-byte words), the init flag in component 0's first
    pad, the other pads 0."""
    _, jtab, _ = tables3
    rows = torch.as_tensor(np.asarray(jtab).T.copy())  # [L, 353]
    L = rows.shape[0]
    packed = tgs.pack_sample_table(rows)
    assert packed.dtype == torch.float32
    assert packed.shape == (L, tgs.PACK_COLS)
    assert tgs.PACK_STRIDE * 4 % 16 == 0
    assert torch.equal(tgs.unpack_sample_table(packed).view(torch.int32),
                       rows.view(torch.int32))
    comp = packed.reshape(L, tgs.K, tgs.PACK_STRIDE)
    assert torch.equal(comp[:, :, :tgs.ROWS_PER_K],
                       rows[:, :-1].reshape(L, tgs.K, tgs.ROWS_PER_K))
    assert torch.equal(comp[:, 0, tgs.PACK_INIT], rows[:, -1])
    pads = comp[:, :, tgs.ROWS_PER_K:].clone()
    pads[:, 0, tgs.PACK_INIT - tgs.ROWS_PER_K] = 0.0
    assert not pads.any()


def test_cpu_branch_on_packed_table_equals_plain_twin(tables3):
    """guided_sample on the packed table (its CPU branch) gives bit for bit
    what guided_sample_plain gives on the lanes' rows of the [L, 353]
    table."""
    _, _, ttab = tables3
    leaf, pos, wob, u = _lanes(19, ttab.shape[1], 1024)
    got = tgs.guided_sample(tgs.pack_sample_table(ttab.T),
                            torch.as_tensor(leaf), t(pos), t(wob), t(u))
    want = tgs.guided_sample_plain(ttab.T[torch.as_tensor(leaf).long()].T,
                                   t(pos).T, t(wob).T, t(u).T)
    assert torch.equal(got[0], want[0].T)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
