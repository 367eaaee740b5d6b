"""The dense Möller–Trumbore sweep (intersect_sweep.mt_sweep) against its
plain twin, on the card; duplicated triangles and grazing rays are in
tests/test_torch_gpu_mt_sweep_edges.py.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerance: the sweep's hit ids, t, u and v equal to its twin's on every
ray (both round every operation alone).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, random_rays  # noqa: E402
from torch_gpu_cases import card_rays, cuda, sweep_equal  # noqa: E402,F401

from sdmm_tpu_torch.ops import intersect_sweep  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n,extra", [(4_099, False), (50_003, True)])
def test_mt_sweep_kernel_matches_twin(cuda, n, extra):
    scene, _ = make_box(tscene, tshapes, 16, 16, extra).build(device=cuda)
    ro, rd, tm = card_rays(cuda, scene, n, 21)
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    before = intersect_sweep.mt_sweep.launches
    got = intersect_sweep.mt_sweep(ro, rd, tm, *tris)
    torch.cuda.synchronize()
    assert intersect_sweep.mt_sweep.launches == before + 1
    want = intersect_sweep.mt_sweep_plain(ro, rd, tm, *tris)
    for k in ("tri", "valid", "t", "u", "v"):
        assert torch.equal(got[k], want[k]), k
    assert 0.3 < float(want["valid"].float().mean()) < 0.95


def _random_tris(cuda, n_tris, seed):
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-1.0, 1.0, (n_tris, 3))
    e1, e2 = rs.uniform(-0.3, 0.3, (2, n_tris, 3))
    return tuple(torch.as_tensor(a.astype(np.float32), device=cuda)
                 for a in (v0, e1, e2))


# One triangle, the whole staging budget, and past it (a second staged
# chunk); ray counts that are no multiple of the 256 rays of a block.
@pytest.mark.parametrize("n_tris,n", [(1, 257), (1024, 4_099),
                                      (1100, 1)])
def test_mt_sweep_on_scene_sizes(cuda, n_tris, n):
    tris = _random_tris(cuda, n_tris, n_tris)
    ro, rd, tm = (torch.as_tensor(a, device=cuda) for a in random_rays(
        tris[0].cpu().numpy(), n, 24))
    if n_tris == 1:  # every other ray toward the triangle
        c = tris[0] + (tris[1] + tris[2]) / 3.0
        toward = torch.nn.functional.normalize(c - ro, dim=-1)
        rd = torch.where((torch.arange(n, device=cuda) % 2 == 0)[:, None],
                         toward, rd).contiguous()
    want = sweep_equal(ro, rd, tm, tris)
    if n > 1:
        assert bool(want["valid"].any()) and not bool(want["valid"].all())
