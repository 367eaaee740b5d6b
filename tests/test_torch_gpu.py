"""The port's CUDA kernels against their plain PyTorch twins, on the card:
here the guided-sampling kernel; the other kernels' cases are in the
other tests/test_torch_gpu_*.py files (EM, the fused guided bounce, the
unguided path kernels, the dense sweep, the cluster cull, and the port's
paths that run on the card).

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerances: directions 1e-4 absolute and pdfs rtol 2e-3 / atol 1e-5, each
with ≤ 0.2% outliers (a u_sel within an ulp of a CDF step, the
Duff-frame sign branch at mu_dir.z ≈ 0).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_gpu_cases import cuda, guide_state  # noqa: E402,F401

from sdmm_tpu_torch.guiding import mixture as mix  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402

pytestmark = pytest.mark.gpu


# Sizes that are no multiple of the 128-thread block (a masked tail) and
# large enough that 0.2% of the lanes is several lanes.
@pytest.mark.parametrize("n", [4_099, 50_003])
def test_guided_sample_kernel_matches_twin(cuda, n):
    L = 64
    sdmm, init = guide_state(9, L, cuda)
    table = gso.pack_guided_rows(mix.prepare(sdmm), sdmm.weight,
                                 init).T.contiguous()
    packed = gso.pack_sample_table(table)
    rs = np.random.RandomState(13)
    leaf = torch.as_tensor(rs.randint(0, L, size=n).astype(np.int32),
                           device=cuda)
    pos = torch.as_tensor(rs.rand(n, 3).astype(np.float32), device=cuda)
    wob = rs.randn(n, 3).astype(np.float32)
    wob = torch.as_tensor(wob / np.linalg.norm(wob, axis=-1, keepdims=True),
                          device=cuda)
    u = torch.as_tensor(rs.rand(n, 3).astype(np.float32), device=cuda)
    before = gso.guided_sample.launches
    out = gso.guided_sample(packed, leaf, pos, wob, u)
    torch.cuda.synchronize()
    assert gso.guided_sample.launches == before + 1
    _guided_sample_agrees(out, table, leaf, pos, wob, u)


def _guided_sample_agrees(out, table, leaf, pos, wob, u):
    """The kernel's outputs ``out`` against the twin on the [L, 353]
    rows."""
    dk, okk, pgk, pbk, vk = out
    dp, okp, pgp, pbp, vp = gso.guided_sample_plain(
        table[leaf.long()].T, pos.T, wob.T, u.T)
    assert bool((vk == vp).all())
    m = vk
    assert int(m.sum()) > leaf.shape[0] // 2
    err = (dk - dp.T).abs().max(-1).values[m]
    assert float((err > 1e-4).float().mean()) <= 0.002
    for a, b in ((pbk, pbp), (pgk, pgp)):
        close = torch.isclose(a[m], b[m], rtol=2e-3, atol=1e-5)
        assert float(close.float().mean()) > 0.998
    assert torch.isfinite(dk).all() and torch.isfinite(pgk).all()


# The kernel on 2,048 leaves of the packed table: lanes on random leaves (a
# gather of up to 32 rows a warp) and every lane on one leaf.
@pytest.mark.parametrize("leaves", ["random", "one"])
def test_guided_sample_kernel_on_2048_leaves(cuda, leaves):
    n, L = 50_003, 2048
    sdmm, init = guide_state(14, L, cuda)
    table = gso.pack_guided_rows(mix.prepare(sdmm), sdmm.weight,
                                 init).T.contiguous()
    rs = np.random.RandomState(16)
    leaf = rs.randint(0, L, n) if leaves == "random" else np.full(
        n, int(init.nonzero()[0]))
    leaf = torch.as_tensor(leaf.astype(np.int32), device=cuda)
    pos = torch.as_tensor(rs.rand(n, 3).astype(np.float32), device=cuda)
    wob = rs.randn(n, 3).astype(np.float32)
    wob = torch.as_tensor(wob / np.linalg.norm(wob, axis=-1, keepdims=True),
                          device=cuda)
    u = torch.as_tensor(rs.rand(n, 3).astype(np.float32), device=cuda)
    out = gso.guided_sample(gso.pack_sample_table(table), leaf, pos, wob, u)
    torch.cuda.synchronize()
    _guided_sample_agrees(out, table, leaf, pos, wob, u)


def test_guided_sample_wrapper_rejects_bad_inputs(cuda):
    packed = torch.zeros((5, gso.PACK_COLS), device=cuda)
    table = packed[:4]
    leaf = torch.zeros(8, dtype=torch.int32, device=cuda)
    x = torch.zeros((8, 3), device=cuda)
    gso.guided_sample(table, leaf, x, x, x)  # the well-formed call runs
    with pytest.raises(ValueError):  # leaf not int32
        gso.guided_sample(table, leaf.long(), x, x, x)
    for bad in (torch.zeros((4, gso.N_ROWS), device=cuda),  # [L, 353] rows
                table.double(),  # not float32
                table.to(torch.bfloat16),  # shade's table
                packed.view(-1)[1:1 + 4 * gso.PACK_COLS]
                .view(4, gso.PACK_COLS)):  # off a 16-byte boundary
        with pytest.raises(ValueError):
            gso.guided_sample(bad, leaf, x, x, x)
