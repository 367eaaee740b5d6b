"""Port parity: the guided-sampling kernel's plain twin
(sdmm_tpu_torch/ops/guided_sample.py) against the mixture functions it
fuses (directions atol 1e-4, pdf rtol 2e-3 / atol 1e-5, the valid lanes
equal), and on uninitialized and empty leaves. Imports no JAX; the twin
against the reference kernel is in tests/test_torch_guided_sample.py."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    guided_lanes, guided_rows, make_mixture_state, t, to_np,
)

from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as tgs  # noqa: E402

torch.set_num_threads(1)


def test_twin_matches_mixture_path():
    """The twin also agrees with the mixture functions it fuses."""
    L, N = 8, 1024
    st = make_mixture_state(4, L)
    ttab = guided_rows(st)
    leaf, pos, wob, u = guided_lanes(12, L, N)
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
    ttab = guided_rows(st, w, ini)
    leaf, pos, wob, u = guided_lanes(5, L, N)
    d, ok, pg, pb, v = tgs.guided_sample(tgs.pack_sample_table(ttab.T),
                                         torch.as_tensor(leaf), t(pos),
                                         t(wob), t(u))
    v = to_np(v)
    assert not v[leaf == 1].any()
    assert not v[leaf == 2].any()
    assert v[(leaf == 0) | (leaf == 3)].mean() > 0.9
    for a in (d, pg, pb):
        assert np.isfinite(to_np(a)).all()
