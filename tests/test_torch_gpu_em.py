"""The E-step kernels (em_suffstats.e_step and sort_and_tile) against
their plain twins, on the card.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerances as in tests/test_em_pallas.py: rtol 2e-4 / 3e-4, atol 4e-4 of
the magnitude (float32 sums in another order).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_gpu_cases import cuda, guide_state  # noqa: E402,F401

from sdmm_tpu_torch.guiding import mixture as mix  # noqa: E402
from sdmm_tpu_torch.ops import em_suffstats as ems  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("L,S", [(32, 100_000), (7, 2_500)])
def test_em_suffstats_kernel_matches_twin(cuda, L, S):
    sdmm, _ = guide_state(4, L, cuda)
    prep = mix.prepare(sdmm)
    rs = np.random.RandomState(100)
    pos = torch.as_tensor(rs.rand(S, 3).astype(np.float32), device=cuda)
    d = rs.randn(S, 3).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    w = (rs.rand(S) * 2.0).astype(np.float32)
    w[::97] = 0.0
    w[1::211] = -1.0
    w[2::503] = np.nan
    w = torch.as_tensor(w, device=cuda)
    leaf = torch.as_tensor(rs.randint(0, L, size=S).astype(np.int32),
                           device=cuda)
    leaf[::5] = 1  # an uneven leaf: several tiles
    ref = ems.e_step_plain(sdmm, prep, pos, d, w, leaf, L)
    before = ems.suffstats.launches
    out = ems.e_step(sdmm, prep, pos, d, w, leaf, L)
    torch.cuda.synchronize()
    assert ems.suffstats.launches == before + 1
    assert bool((out[4] == ref[4]).all())
    torch.testing.assert_close(out[3], ref[3], rtol=1e-5, atol=0)
    for a, b, rtol, af in ((out[0], ref[0], 2e-4, 2e-5),
                           (out[1], ref[1], 2e-4, 4e-4),
                           (out[2], ref[2], 3e-4, 4e-4)):
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=af * float(b.abs().max()) + 1e-12)


def test_em_suffstats_kernel_drops_non_finite_posteriors(cuda):
    """The batch of tests/torch_parity.posterior_fault_batch (a sample
    whose pdf overflows, one whose posterior total has no finite
    reciprocal): the kernel's statistics are finite and match the twin's,
    which drops both posteriors as the reference's XLA E-step does."""
    from torch_parity import posterior_fault_batch

    weight, mean, cov, pos, d, w, leaf, L = (
        torch.as_tensor(a, device=cuda) if isinstance(a, np.ndarray) else a
        for a in posterior_fault_batch())
    sdmm = mix.SDMM(weight=weight, mean=mean, cov=cov)
    prep = mix.prepare(sdmm)
    ref = ems.e_step_plain(sdmm, prep, pos, d, w, leaf, L)
    out = ems.e_step(sdmm, prep, pos, d, w, leaf, L)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out[:4])
    assert torch.equal(out[4], ref[4])
    torch.testing.assert_close(out[3], ref[3], rtol=1e-5, atol=0)
    for a, b, rtol, af in ((out[0], ref[0], 2e-4, 2e-5),
                           (out[1], ref[1], 2e-4, 4e-4),
                           (out[2], ref[2], 3e-4, 4e-4)):
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=af * float(b.abs().max()) + 1e-12)


def _em_case(cuda, case):
    """E-step inputs: leaves of 0, 1, TILE and TILE + 1 samples (and
    2 TILE + 5), int32 leaf ids; 16,384 leaves, past the 12,288 whose
    counters the sort keeps in shared memory, some invalid rows; or the
    trainer's replica layout, int64 leaf ids with most rows w = -1 (rows
    past the filled replicas)."""
    L, tile = 6, ems.TILE
    rs = np.random.RandomState(8)
    if case == "sizes":
        leaf = rs.permutation(np.repeat(np.arange(L), [0, 1, tile, tile + 1,
                                                       2 * tile + 5, 0]))
        leaf = leaf.astype(np.int32)
        w = (rs.rand(leaf.size) * 2.0).astype(np.float32)
    elif case == "many leaves":
        L = 16_384
        leaf = rs.randint(0, L - 8, size=300_000).astype(np.int32)
        leaf[::7] = 5  # several tiles
        w = (rs.rand(leaf.size) * 2.0).astype(np.float32)
        w[1::211] = -1.0
        leaf[2::307] = L  # out of range
    else:
        L, n, filled = 64, 1 << 17, 20_000
        leaf = rs.randint(0, L - 4, size=n).astype(np.int64)  # 4 empty
        w = np.full(n, -1.0, np.float32)
        w[:filled] = rs.rand(filled) * 2.0
        leaf[filled:] = 0
    n = leaf.size
    sdmm, _ = guide_state(6, L, cuda)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (sdmm, mix.prepare(sdmm),
            *(torch.as_tensor(a, device=cuda) for a in (
                rs.rand(n, 3).astype(np.float32), d, w, leaf)), L)


@pytest.mark.parametrize("case", ["sizes", "many leaves", "replicas"])
def test_e_step_pipeline_on_edge_layouts(cuda, case):
    """The kernels' packed rows, sort and work list equal their twin's; the
    statistics match a float64 evaluation of the twin (tolerances of the
    test above) and two calls on one input give the same bits."""
    sdmm, prep, pos, d, w, leaf, L = _em_case(cuda, case)
    got = ems.sort_and_tile(pos, d, w, leaf, L)
    want = ems.sort_and_tile_plain(pos, d, w, leaf, L)
    n_valid = int(want[2][-1])
    o = want[1][:n_valid].long()
    assert torch.equal(got[1][:n_valid].long(), o)
    assert torch.equal(got[0][o], want[0][o])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)
    # The statistics against a float64 evaluation of the twin: near a
    # component's antipode the float32 twin's own rounding reaches the
    # tolerance (chip_smoke.py phase 3 measures the two errors).
    ref = ems.e_step_plain(
        type(sdmm)(*(x.double() for x in sdmm)),
        type(prep)(*(x.double() if x.is_floating_point() else x
                     for x in prep)), pos.double(), d.double(), w.double(),
        leaf, L)
    ref = tuple(x.float() if x.is_floating_point() else x for x in ref)
    out = ems.e_step(sdmm, prep, pos, d, w, leaf, L)
    again = ems.e_step(sdmm, prep, pos, d, w, leaf, L)
    torch.cuda.synchronize()
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    assert torch.equal(out[4], ref[4])
    torch.testing.assert_close(out[3], ref[3], rtol=1e-5, atol=0)
    for a, b, rtol, af in ((out[0], ref[0], 2e-4, 2e-5),
                           (out[1], ref[1], 2e-4, 4e-4),
                           (out[2], ref[2], 3e-4, 4e-4)):
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=af * float(b.abs().max()) + 1e-12)
    empty = ref[4] == 0
    assert bool(empty.any()) and all(
        float(x[empty].abs().sum()) == 0.0 for x in out[:4])
