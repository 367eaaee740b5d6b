"""The unguided path kernels (bounce.step and bounce.bounce) against their
plain twins, on the card; their edge cases are in
tests/test_torch_gpu_path_edges.py.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerances: state, film and splat rtol 1e-5 / atol 1e-6 (the disk map's
sine and cosine differ by an ulp between the kernel's sincospif and
PyTorch's), meta equal, each on >= 99.9% of the lanes.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_gpu_cases import (  # noqa: E402,F401
    agree, cuda, path_setup, same_bits,
)

from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("mode,tiled", [("rand", False), ("philox", False),
                                        ("philox", True)])
def test_step_kernel_matches_twin(cuda, mode, tiled):
    types, tri, em, env, cam, n_em, wave = path_setup(cuda, 16_384, 8,
                                                       tiled)
    state, meta, film, pxpy, rand = wave
    tile = bo.lane_tile(tri.shape[1])
    tile_alive = torch.ones(16_384 // tile, dtype=torch.int32, device=cuda)
    tile_alive[1] = 0  # a drained tile is left as it is
    rand = rand if mode == "rand" else None
    args = (cam, (5, 9), pxpy, tri, em, env, n_em, 10, 5, types, 16, 16)
    ref = bo.step_plain(state, meta, film, tile_alive, *args, rand=rand)
    k = [x.clone() for x in (state, meta, film)]
    before = bo.step.launches
    out = bo.step(*k[:3], tile_alive, *args, rand=rand)
    torch.cuda.synchronize()
    assert bo.step.launches == before + 1 and out[0] is k[0]
    agree([(out[0], ref[0], False), (out[1], ref[1], True),
            (out[2], ref[2], False)])
    sl = slice(tile, 2 * tile)
    for a, b in zip(out, (state, meta, film)):
        assert same_bits(a[..., sl], b[..., sl])
    assert int(((ref[2] - film)[6] > 0).sum()) > 100  # paths ended
    if mode == "philox":
        # The kernel's in-kernel uniforms are the twin's bits.
        k2 = [x.clone() for x in (state, meta, film)]
        bo.step(*k2, tile_alive, *args,
                rand=bo.philox_uniforms((5, 9), 16_384, device=cuda))
        for a, b in zip(out, k2):
            assert same_bits(a, b)


@pytest.mark.parametrize("n,skip", [(4_099, False), (16_384, True)])
def test_bounce_kernel_matches_twin(cuda, n, skip):
    types, tri, em, env, _, n_em, wave = path_setup(cuda, n, 12)
    state, meta, _, _, rand = wave
    rand = rand[:bo.RAND_ROWS].contiguous()
    tile_alive = None
    if skip:
        tile_alive = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    ref = bo.bounce_plain(state, meta, rand, tri, em, env, n_em, 10, 5,
                          types, tile_alive)
    before = bo.bounce.launches
    out = bo.bounce(state, meta, rand, tri, em, env, n_em, 10, 5, types,
                    tile_alive)
    torch.cuda.synchronize()
    assert bo.bounce.launches == before + 1
    agree([(out[0], ref[0], False), (out[1], ref[1], True),
            (out[2], ref[2], False)])
    assert int(ref[2][6].sum()) > 100 and int(ref[2][7].sum()) > n // 4
