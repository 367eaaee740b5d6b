"""The unguided path kernels on the card at their edges: past the staging
budget, an empty and a full shadow-ray queue, and the wrappers' checks.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerances: state, film and splat rtol 1e-5 / atol 1e-6 (the disk map's
sine and cosine differ by an ulp between the kernel's sincospif and
PyTorch's), meta equal, each on >= 99.9% of the lanes.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, make_sphere_box, path_wave  # noqa: E402
from torch_gpu_cases import agree, cuda, path_setup  # noqa: E402,F401

from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


# Past STAGE_MAX triangles (csrc/bounce.cu) the kernels sweep the Woop rows
# in chunks staged per sweep: both path kernels on a 2,172-triangle scene.
def test_path_kernels_past_the_staging_budget(cuda):
    scene, cfg = make_sphere_box(tscene, tshapes, 16, 16).build(device=cuda)
    tri, em, env = bo.build_tables(scene)
    assert tri.shape[1] > 1024
    n_em = int(scene.em_tri_idx.shape[0])
    cam = bo.build_cam_params(scene, 16, 16)
    state, meta, film, pxpy, rand = (torch.as_tensor(a, device=cuda) for a
                                     in path_wave(8_192, 16, max_depth=10))
    ones = torch.ones(8_192 // bo.lane_tile(tri.shape[1]), dtype=torch.int32,
                      device=cuda)
    args = (cam, (3, 4), pxpy, tri, em, env, n_em, 10, 5, cfg.bsdf_types,
            16, 16)
    stats = {}
    ref = bo.step_plain(state, meta, film, ones, *args, stats=stats)
    out = bo.step(*(x.clone() for x in (state, meta, film)), ones, *args)
    rand8 = rand[:bo.RAND_ROWS].contiguous()
    ref_b = bo.bounce_plain(state, meta, rand8, tri, em, env, n_em, 10, 5,
                            cfg.bsdf_types)
    out_b = bo.bounce(state, meta, rand8, tri, em, env, n_em, 10, 5,
                      cfg.bsdf_types)
    torch.cuda.synchronize()
    for o, r in ((out, ref), (out_b, ref_b)):
        agree([(o[0], r[0], False), (o[1], r[1], True),
                (o[2], r[2], False)])
    assert stats["nee_candidates"] > 1000


def _nee_wave(cuda, n, seed):
    """Lanes at depth 0 above the box's floor, heading down: each hits the
    diffuse floor in view of the ceiling light, so every lane is an NEE
    candidate below depth max_depth - 1."""
    rs = np.random.RandomState(seed)
    state = np.zeros((16, n), np.float32)
    state[0] = rs.uniform(-0.7, 0.7, n)
    state[1] = rs.uniform(0.5, 1.5, n)
    state[2] = rs.uniform(-0.7, 0.5, n)  # the box is open toward +z
    d = np.stack([rs.uniform(-0.2, 0.2, n), -np.ones(n),
                  rs.uniform(-0.2, 0.2, n)])
    state[3:6] = d / np.linalg.norm(d, axis=0)
    state[6:9] = 1.0
    state[12:14] = 1.0
    meta = (np.arange(n) % 256) | bo._ALIVE
    return (torch.as_tensor(state, device=cuda),
            torch.as_tensor(meta.astype(np.int32), device=cuda),
            torch.as_tensor(rs.rand(bo.RAND_ROWS, n).astype(np.float32),
                            device=cuda))


# The block's shadow-ray queue when it is empty and when it is full:
# max_depth 1 gates every lane's NEE off, max_depth 10 leaves every lane of
# the wave above a candidate.
@pytest.mark.parametrize("max_depth,share", [(1, 0.0), (10, 1.0)])
def test_bounce_kernel_nee_queue_empty_and_full(cuda, max_depth, share):
    scene, cfg = make_box(tscene, tshapes, 16, 16).build(device=cuda)
    tri, em, env = bo.build_tables(scene)
    n_em = int(scene.em_tri_idx.shape[0])
    state, meta, rand = _nee_wave(cuda, 4_099, 17)
    stats = {}
    ref = bo.bounce_plain(state, meta, rand, tri, em, env, n_em, max_depth,
                          5, cfg.bsdf_types, stats=stats)
    out = bo.bounce(state, meta, rand, tri, em, env, n_em, max_depth, 5,
                    cfg.bsdf_types)
    torch.cuda.synchronize()
    assert stats["nee_candidates"] == int(share * 4_099)
    agree([(out[0], ref[0], False), (out[1], ref[1], True),
            (out[2], ref[2], False)])
    if share:  # the candidates' light reached the film
        assert float(ref[0][9:12].sum()) > 0.0


def test_path_wrappers_reject_bad_inputs(cuda):
    types, tri, em, env, cam, n_em, wave = path_setup(cuda, 8_192, 3)
    state, meta, film, pxpy, rand = wave
    ones = torch.ones(1, dtype=torch.int32, device=cuda)
    args = (cam, (0, 0), pxpy, tri, em, env, n_em, 10, 5, types, 16, 16)
    with pytest.raises(ValueError):  # meta not int32
        bo.step(state, meta.long(), film, ones, *args)
    with pytest.raises(ValueError):  # no whole number of tiles
        bo.step(state[:, :4096].contiguous(), meta[:4096].contiguous(),
                film[:, :4096].contiguous(), ones, *args)
    with pytest.raises(ValueError):  # host uniforms of the wrong height
        bo.step(state, meta, film, ones, *args, rand=rand[:8].contiguous())
    with pytest.raises(ValueError):  # 10 uniform rows where bounce takes 8
        bo.bounce(state, meta, rand, tri, em, env, n_em, 10, 5, types)
    with pytest.raises(ValueError):  # more emitters than the kernel stages
        bo.bounce(state, meta, rand[:8].contiguous(), tri, em, env, 65, 10,
                  5, types)
