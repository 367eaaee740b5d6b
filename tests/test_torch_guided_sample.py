"""Port parity: the guided-sampling kernel's plain twin
(sdmm_tpu_torch/ops/guided_sample.py) against the reference Pallas kernel
in interpret mode, with identical uniforms. Tolerances as in
tests/test_guided_pallas.py: directions rtol/atol 1e-4, pdf at the BSDF
direction rtol 2e-3 / atol 1e-5, pdf at the guided direction the same with
≤ 0.2% outliers (the Duff-frame sign branch at mu_dir.z ≈ 0).
The twin against the mixture functions it fuses is in
tests/test_torch_guided_sample_twin.py, the kernel-vs-twin cases in
tests/test_torch_gpu.py."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    guided_lanes, guided_rows, make_mixture_state, t, to_np,
)

from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.ops import guided_pallas as jgp  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as tgs  # noqa: E402

torch.set_num_threads(1)


def _jax_table(st):
    js = jmix.SDMM(weight=jnp.asarray(st["weight"]),
                   mean=jnp.asarray(st["mean"]), cov=jnp.asarray(st["cov"]))
    return jgp.pack_guided_rows(jmix.prepare(js), js.weight,
                                jnp.asarray(st["initialized"]))


@pytest.fixture(scope="module")
def tables3():
    """The 8-leaf mixture state of seed 3 and its [353, L] tables from both
    packages: the reference's jitted pack runs once a module (~7 s)."""
    st = make_mixture_state(3, 8)
    return st, _jax_table(st), guided_rows(st)


def test_plain_twin_matches_reference_kernel(tables3):
    L, N = 8, 2048
    _, jtab, ttab = tables3
    leaf, pos, wob, u = guided_lanes(11, L, N)
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
    leaf, pos, wob, u = guided_lanes(19, ttab.shape[1], 1024)
    got = tgs.guided_sample(tgs.pack_sample_table(ttab.T),
                            torch.as_tensor(leaf), t(pos), t(wob), t(u))
    want = tgs.guided_sample_plain(ttab.T[torch.as_tensor(leaf).long()].T,
                                   t(pos).T, t(wob).T, t(u).T)
    assert torch.equal(got[0], want[0].T)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
