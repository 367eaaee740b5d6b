"""The fused guided bounce's kernels (guided_step.trace and shade) against
their plain twins, on the card.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerances as in tests/test_torch_guided_step.py: trace, winner
attributes exact and the rest rtol 1e-5; shade, state rtol 2e-4 / atol
1e-5, meta and splat equal; each on >= 99.8% of the lanes.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import lane_wave, make_box, make_sphere_box  # noqa: E402
from torch_gpu_cases import cuda, guide_state  # noqa: E402,F401

from sdmm_tpu_torch.guiding import mixture as mix  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from sdmm_tpu_torch.ops import guided_step as gst  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


def _wave(cuda, n, seed):
    scene, cfg = make_box(tscene, tshapes, 16, 16, True).build(device=cuda)
    tri, _, env = bo.build_tables(scene)
    state, meta, rand = (torch.as_tensor(a, device=cuda)
                         for a in lane_wave(n, seed, max_depth=10))
    return scene, cfg.bsdf_types, tri, env, state, meta, rand


# Lane counts that are no multiple of the 128-thread block.
@pytest.mark.parametrize("n", [4_099, 50_003])
def test_trace_kernel_matches_twin(cuda, n):
    _, types, tri, env, state, meta, _ = _wave(cuda, n, 5)
    before = gst.trace.launches
    st_k, hit_k = gst.trace(state, meta, tri, env, types)
    torch.cuda.synchronize()
    assert gst.trace.launches == before + 1
    st_p, hit_p = gst.trace_plain(state, meta, tri, env, types)
    exact = [3, 4, 5] + list(range(9, 22))
    ok = (hit_k[exact] == hit_p[exact]).all(0)
    ok &= torch.isclose(hit_k, hit_p, rtol=1e-5, atol=1e-6).all(0)
    ok &= torch.isclose(st_k, st_p, rtol=1e-5, atol=1e-6,
                        equal_nan=True).all(0)
    assert float(ok.float().mean()) >= 0.998
    assert int((hit_p[21] > 0.5).sum()) > n // 4


@pytest.mark.parametrize("n", [4_099, 50_003])
def test_shade_kernel_matches_twin(cuda, n):
    scene, types, tri, env, state, meta, rand = _wave(cuda, n, 6)
    st, hit = gst.trace_plain(state, meta, tri, env, types)
    L = 64
    sdmm, init = guide_state(9, L, cuda)
    table = gso.pack_guided_rows(mix.prepare(sdmm), sdmm.weight, init).T
    table16 = table.to(torch.bfloat16).contiguous()
    leaf = torch.as_tensor(np.random.RandomState(3).randint(0, L, n)
                           .astype(np.int32), device=cuda)
    cpos = ((hit[0:3].T - scene.aabb_lo) / 2.0).T.contiguous()
    before = gst.shade.launches
    out_k = gst.shade(st, meta, hit, cpos, leaf, gst.pack_shade_table(table),
                      rand, types, 10, 5, 0.5)
    torch.cuda.synchronize()
    assert gst.shade.launches == before + 1
    out_p = gst.shade_plain(st, meta, hit, cpos,
                            table16[leaf.long()].T.float(), rand, types, 10,
                            5, 0.5)
    for ok in (torch.isclose(out_k[0], out_p[0], rtol=2e-4, atol=1e-5,
                             equal_nan=True).all(0),
               out_k[1] == out_p[1], (out_k[2] == out_p[2]).all(0)):
        assert float(ok.float().mean()) >= 0.998
    assert int(out_p[2][9].sum()) > 0  # guided samples were drawn


# The shade kernel on 2,048 leaves of the packed table: lanes on random
# leaves (a gather of up to 32 rows a warp) and every lane on one leaf.
@pytest.mark.parametrize("leaves", ["random", "one"])
def test_shade_kernel_on_2048_leaves(cuda, leaves):
    n, L = 50_003, 2048
    scene, types, tri, env, state, meta, rand = _wave(cuda, n, 13)
    st, hit = gst.trace_plain(state, meta, tri, env, types)
    sdmm, init = guide_state(14, L, cuda)
    table = gso.pack_guided_rows(mix.prepare(sdmm), sdmm.weight, init).T
    rs = np.random.RandomState(15)
    leaf = rs.randint(0, L, n) if leaves == "random" else np.full(
        n, int(init.nonzero()[0]))
    leaf = torch.as_tensor(leaf.astype(np.int32), device=cuda)
    cpos = ((hit[0:3].T - scene.aabb_lo) / 2.0).T.contiguous()
    out_k = gst.shade(st, meta, hit, cpos, leaf, gst.pack_shade_table(table),
                      rand, types, 10, 5, 0.5)
    torch.cuda.synchronize()
    rows_t = table.to(torch.bfloat16)[leaf.long()].T.float()
    out_p = gst.shade_plain(st, meta, hit, cpos, rows_t, rand, types, 10, 5,
                            0.5)
    for ok in (torch.isclose(out_k[0], out_p[0], rtol=2e-4, atol=1e-5,
                             equal_nan=True).all(0),
               out_k[1] == out_p[1], (out_k[2] == out_p[2]).all(0)):
        assert float(ok.float().mean()) >= 0.998
    assert int(out_p[2][9].sum()) > n // 8  # guided samples were drawn


# Past STAGE_MAX triangles (csrc/woop_stage.cuh) trace sweeps the Woop
# rows in chunks: the 2,172-triangle scene of the path kernels' case.
def test_trace_kernel_past_the_staging_budget(cuda):
    scene, cfg = make_sphere_box(tscene, tshapes, 16, 16).build(device=cuda)
    tri, _, env = bo.build_tables(scene)
    assert tri.shape[1] > 1024
    state, meta, _ = (torch.as_tensor(a, device=cuda)
                      for a in lane_wave(8_192, 18, max_depth=10))
    st_k, hit_k = gst.trace(state, meta, tri, env, cfg.bsdf_types)
    torch.cuda.synchronize()
    st_p, hit_p = gst.trace_plain(state, meta, tri, env, cfg.bsdf_types)
    _trace_agrees(st_k, hit_k, st_p, hit_p)
    assert int((hit_p[21] > 0.5).sum()) > 8_192 // 4


def _trace_agrees(st_k, hit_k, st_p, hit_p):
    exact = [3, 4, 5] + list(range(9, 22))
    ok = (hit_k[exact] == hit_p[exact]).all(0)
    ok &= torch.isclose(hit_k, hit_p, rtol=1e-5, atol=1e-6).all(0)
    ok &= torch.isclose(st_k, st_p, rtol=1e-5, atol=1e-6,
                        equal_nan=True).all(0)
    assert float(ok.float().mean()) >= 0.998


# Every triangle twice, the copy with another albedo: among equal t the
# lower index wins, in the kernel as in the twin.
@pytest.mark.parametrize("first", ["original", "copy"])
def test_trace_keeps_the_lower_index_on_duplicated_triangles(cuda, first):
    _, types, tri, env, state, meta, _ = _wave(cuda, 8_192, 19)
    copy = tri.clone()
    copy[bo._TAL:bo._TAL + 3] = 0.125
    pair = (tri, copy) if first == "original" else (copy, tri)
    tri2 = torch.cat(pair, dim=1).contiguous()
    st_k, hit_k = gst.trace(state, meta, tri2, env, types)
    torch.cuda.synchronize()
    st_p, hit_p = gst.trace_plain(state, meta, tri2, env, types)
    _trace_agrees(st_k, hit_k, st_p, hit_p)
    on = hit_k[21] > 0.5
    assert int(on.sum()) > 8_192 // 4
    marked = (hit_k[9:12, on] == 0.125).all(0)
    assert bool(marked.all() if first == "copy" else (~marked).all())


def test_guided_step_wrappers_reject_bad_inputs(cuda):
    _, types, tri, env, state, meta, rand = _wave(cuda, 256, 7)
    with pytest.raises(ValueError):
        gst.trace(state, meta.long(), tri, env, types)  # meta not int32
    hit = torch.zeros((gst.HIT_ROWS, 256), device=cuda)
    cpos = state[0:3].contiguous()
    packed = torch.zeros((5, gso.PACK_COLS), dtype=torch.bfloat16,
                         device=cuda)
    for table in (torch.zeros((4, gso.PACK_COLS), device=cuda),  # not bf16
                  torch.zeros((4, gso.N_ROWS), dtype=torch.bfloat16,
                              device=cuda),  # the unpacked [L, 353] rows
                  packed.view(-1)[4:4 + 4 * gso.PACK_COLS]
                  .view(4, gso.PACK_COLS)):  # off a 16-byte boundary
        with pytest.raises(ValueError):
            gst.shade(state, meta, hit, cpos, meta, table, rand, types, 10,
                      5, 0.5)
