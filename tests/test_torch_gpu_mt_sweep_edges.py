"""The dense sweep on the card on duplicated triangles and grazing rays,
below and above its DEFER_FROM.

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
from torch_parity import grazing_rays, make_box, make_tiled_box  # noqa: E402
from torch_gpu_cases import card_rays, cuda, sweep_equal  # noqa: E402,F401

from sdmm_tpu_torch.ops import intersect_sweep  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


def _sweep_scene(cuda, which):
    """The 12-triangle box, below the sweep's DEFER_FROM (one ray a thread),
    or the 116-triangle tiled box, above it (four rays a thread, the
    warp-voted reciprocal)."""
    make = make_box if which == "box" else make_tiled_box
    scene, _ = make(tscene, tshapes, 16, 16).build(device=cuda)
    n_tris = scene.tri_v0.shape[0]
    voted = n_tris >= intersect_sweep.DEFER_FROM
    assert voted == (which == "tiled box")
    assert intersect_sweep.rays_per_thread(n_tris) == (4 if voted else 1)
    return scene


@pytest.mark.parametrize("which", ["box", "tiled box"])
def test_mt_sweep_keeps_the_lower_index_on_duplicated_triangles(cuda, which):
    scene = _sweep_scene(cuda, which)
    tris = tuple(torch.cat([a, a]).contiguous() for a in (
        scene.tri_v0, scene.tri_e1, scene.tri_e2))
    ro, rd, tm = card_rays(cuda, scene, 8_192, 25)
    want = sweep_equal(ro, rd, tm, tris)
    hit = want["valid"]
    assert float(hit.float().mean()) > 0.3
    assert bool((want["tri"][hit] < scene.tri_v0.shape[0]).all())


@pytest.mark.parametrize("which", ["box", "tiled box"])
def test_mt_sweep_on_grazing_rays(cuda, which):
    """Rays toward points on the triangles' edges (u = 0, v = 0, u + v = 1
    up to rounding), and rays almost in the plane of the axis-aligned
    triangles, with |det| from 0.5e-12 to 2e-12 on both sides of the 1e-12
    test (torch_parity.grazing_rays). On the tiled box the voted kernel
    runs, and most of its triangles are small panels that no other lane of
    a warp comes near, so a grazing lane's own pre-test decides the vote."""
    scene = _sweep_scene(cuda, which)
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    ro, rd = (torch.as_tensor(x, device=cuda) for x in grazing_rays(
        *(a.cpu().numpy().astype(np.float64) for a in tris), 8_189, 26))
    tm = torch.full((ro.shape[0],), intersect_sweep.INF, device=cuda)
    want = sweep_equal(ro, rd, tm, tris)
    assert float(want["valid"].float().mean()) > 0.3
