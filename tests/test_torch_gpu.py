"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These cases need a CUDA device and skip elsewhere; this file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances: guided sampling, directions 1e-4 absolute and pdfs rtol 2e-3 /
atol 1e-5, each with ≤ 0.2% outliers (a u_sel within an ulp of a CDF step,
the Duff-frame sign branch at mu_dir.z ≈ 0); EM statistics as in
tests/test_em_pallas.py (rtol 2e-4 / 3e-4, atol 4e-4 of the magnitude:
float32 sums in another order); the fused bounce as in
tests/test_torch_guided_step.py (trace: winner attributes exact, the rest
rtol 1e-5; shade: state rtol 2e-4 / atol 1e-5, meta and splat equal; each
on >= 99.8% of the lanes); the unguided step and bounce: state, film and
splat rtol 1e-5 / atol 1e-6 (the disk map's sine and cosine differ by an
ulp between the kernel's sincospif and PyTorch's), meta equal, each on
>= 99.9% of the lanes; the intersection kernels: the dense sweep's hit
ids, t, u and v equal to its twin's on every ray (both round every
operation alone), the cluster cull's on >= 99.9% of the rays, and its
any-hit form's answer on as many (culling skips work only, except on a ray
whose hit lies within rounding of its cluster box's face).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    doubled_spheres, grazing_rays, lane_wave, make_box, make_glossy_box,
    make_sphere_box, make_tiled_box, path_wave, random_rays, rays_at,
)

from sdmm_tpu_torch.guiding import init as init_mod  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as mix  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.ops import em_suffstats as ems  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from sdmm_tpu_torch.ops import guided_step as gst  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep  # noqa: E402
from sdmm_tpu_torch.render import clas as tclas  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(seed, L, dev):
    rs = np.random.RandomState(seed)
    hi = torch.as_tensor((np.ones((L, 3)) * rs.rand(L, 1) + 0.5)
                         .astype(np.float32))
    base = init_mod.init_leaf_params(torch.Generator().manual_seed(seed),
                                     torch.zeros((L, 3)), hi, 16)
    w = rs.dirichlet(np.ones(16), size=L)
    w = np.where(rs.rand(L, 16) < 0.2, 0.0, w)
    w = (w / np.maximum(w.sum(-1, keepdims=True), 1e-9)).astype(np.float32)
    jit = rs.randn(L, 16, 5, 5).astype(np.float32) * 0.01
    sdmm = mix.SDMM(weight=torch.as_tensor(w), mean=base.mean,
                    cov=base.cov + torch.as_tensor(
                        0.5 * (jit + np.swapaxes(jit, -1, -2))))
    sdmm = mix.SDMM(*(x.to(dev) for x in sdmm))
    return sdmm, torch.as_tensor(rs.rand(L) < 0.9, device=dev)


# Sizes that are no multiple of the 128-thread block (a masked tail) and
# large enough that 0.2% of the lanes is several lanes.
@pytest.mark.parametrize("n", [4_099, 50_003])
def test_guided_sample_kernel_matches_twin(cuda, n):
    L = 64
    sdmm, init = _state(9, L, cuda)
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
    sdmm, init = _state(14, L, cuda)
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


@pytest.mark.parametrize("L,S", [(32, 100_000), (7, 2_500)])
def test_em_suffstats_kernel_matches_twin(cuda, L, S):
    sdmm, _ = _state(4, L, cuda)
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
    sdmm, _ = _state(6, L, cuda)
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
    sdmm, init = _state(9, L, cuda)
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
    sdmm, init = _state(14, L, cuda)
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


def _path_setup(cuda, n, seed, tiled=False):
    make = make_tiled_box if tiled else make_glossy_box
    scene, cfg = make(tscene, tshapes, 16, 16).build(device=cuda)
    tri, em, env = bo.build_tables(scene)
    cam = bo.build_cam_params(scene, 16, 16)
    wave = tuple(torch.as_tensor(a, device=cuda)
                 for a in path_wave(n, seed, max_depth=10))
    return (cfg.bsdf_types, tri, em, env, cam, int(scene.em_tri_idx.shape[0]),
            wave)


def _same(a, b):
    """Bitwise equal, NaN included."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all()) \
        if a.is_floating_point() else torch.equal(a, b)


def _agree(pairs, share=0.999):
    """Each (kernel, twin, exact) pair agrees on ``share`` of the lanes."""
    for a, b, exact in pairs:
        if exact:
            ok = a == b
        else:
            ok = torch.isclose(a, b, rtol=1e-5, atol=1e-6, equal_nan=True)
        ok = ok.all(0) if ok.dim() == 2 else ok
        assert float(ok.float().mean()) >= share, float(ok.float().mean())


@pytest.mark.parametrize("mode,tiled", [("rand", False), ("philox", False),
                                        ("philox", True)])
def test_step_kernel_matches_twin(cuda, mode, tiled):
    types, tri, em, env, cam, n_em, wave = _path_setup(cuda, 16_384, 8,
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
    _agree([(out[0], ref[0], False), (out[1], ref[1], True),
            (out[2], ref[2], False)])
    sl = slice(tile, 2 * tile)
    for a, b in zip(out, (state, meta, film)):
        assert _same(a[..., sl], b[..., sl])
    assert int(((ref[2] - film)[6] > 0).sum()) > 100  # paths ended
    if mode == "philox":
        # The kernel's in-kernel uniforms are the twin's bits.
        k2 = [x.clone() for x in (state, meta, film)]
        bo.step(*k2, tile_alive, *args,
                rand=bo.philox_uniforms((5, 9), 16_384, device=cuda))
        for a, b in zip(out, k2):
            assert _same(a, b)


@pytest.mark.parametrize("n,skip", [(4_099, False), (16_384, True)])
def test_bounce_kernel_matches_twin(cuda, n, skip):
    types, tri, em, env, _, n_em, wave = _path_setup(cuda, n, 12)
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
    _agree([(out[0], ref[0], False), (out[1], ref[1], True),
            (out[2], ref[2], False)])
    assert int(ref[2][6].sum()) > 100 and int(ref[2][7].sum()) > n // 4


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
        _agree([(o[0], r[0], False), (o[1], r[1], True),
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
    _agree([(out[0], ref[0], False), (out[1], ref[1], True),
            (out[2], ref[2], False)])
    if share:  # the candidates' light reached the film
        assert float(ref[0][9:12].sum()) > 0.0


def test_path_wrappers_reject_bad_inputs(cuda):
    types, tri, em, env, cam, n_em, wave = _path_setup(cuda, 8_192, 3)
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


def _rays(cuda, scene, n, seed):
    return tuple(torch.as_tensor(a, device=cuda) for a in random_rays(
        scene.tri_v0.cpu().numpy(), n, seed))


@pytest.mark.parametrize("n,extra", [(4_099, False), (50_003, True)])
def test_mt_sweep_kernel_matches_twin(cuda, n, extra):
    scene, _ = make_box(tscene, tshapes, 16, 16, extra).build(device=cuda)
    ro, rd, tm = _rays(cuda, scene, n, 21)
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    before = intersect_sweep.mt_sweep.launches
    got = intersect_sweep.mt_sweep(ro, rd, tm, *tris)
    torch.cuda.synchronize()
    assert intersect_sweep.mt_sweep.launches == before + 1
    want = intersect_sweep.mt_sweep_plain(ro, rd, tm, *tris)
    for k in ("tri", "valid", "t", "u", "v"):
        assert torch.equal(got[k], want[k]), k
    assert 0.3 < float(want["valid"].float().mean()) < 0.95


def _sweep_equal(ro, rd, tm, tris):
    got = intersect_sweep.mt_sweep(ro, rd, tm, *tris)
    torch.cuda.synchronize()
    want = intersect_sweep.mt_sweep_plain(ro, rd, tm, *tris)
    for k in ("tri", "valid", "t", "u", "v"):
        assert torch.equal(got[k], want[k]), k
    return want


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
    want = _sweep_equal(ro, rd, tm, tris)
    if n > 1:
        assert bool(want["valid"].any()) and not bool(want["valid"].all())


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
    ro, rd, tm = _rays(cuda, scene, 8_192, 25)
    want = _sweep_equal(ro, rd, tm, tris)
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
    want = _sweep_equal(ro, rd, tm, tris)
    assert float(want["valid"].float().mean()) > 0.3


def _clusters(cuda, tris, t_c):
    """The kernel's cluster tensors on the card for float32 triangle
    arrays (v0, e1, e2) as numpy, and the twin's Woop rows."""
    c = tclas.build_clusters(*tris, t_c=t_c)
    tree = clas_cull.build_tree(c["aabb"], c["ids"].shape[0])
    return tuple(torch.as_tensor(a, device=cuda) for a in (
        tree, clas_cull.slot_rows(c["woop"]), c["ids"], c["woop"]))


def _cull_against_twin(cuda, tris, ro, rd, tm, t_c):
    """cull and any_hit against the twin; returns the twin's closest hit."""
    tree, slot, ids, woop = _clusters(cuda, tris, t_c)
    before = clas_cull.cull.launches
    got = clas_cull.cull(ro, rd, tm, tree, slot, ids)
    occ = clas_cull.any_hit(ro, rd, tm, tree, slot, ids)
    torch.cuda.synchronize()
    assert clas_cull.cull.launches == before + 2
    want = clas_cull.cull_plain(ro, rd, tm, woop, ids)
    same = (got[1] == want[1]) & (got[0] == want[0]) & (got[2] == want[2]) \
        & (got[3] == want[3])
    assert float(same.float().mean()) >= 0.999
    occ_want = (want[1] >= 0) & (want[0] < tm)
    assert float((occ == occ_want).float().mean()) >= 0.999
    return want


@pytest.mark.parametrize("n,t_c", [(4_099, None), (50_003, 128)])
def test_clas_cull_kernel_matches_twin(cuda, n, t_c):
    scene, _ = make_sphere_box(tscene, tshapes).build(device=cuda)
    tris = tuple(a.cpu().numpy() for a in (scene.tri_v0, scene.tri_e1,
                                            scene.tri_e2))
    ro, rd, tm = _rays(cuda, scene, n, 22)
    want = _cull_against_twin(cuda, tris, ro, rd, tm, t_c)
    assert 0.3 < float((want[1] >= 0).float().mean()) < 0.95
    finite = tm < 1e30
    occ_want = (want[1] >= 0) & (want[0] < tm)
    assert occ_want[finite].any() and (~occ_want[finite]).any()


def test_clas_cull_keeps_the_lower_code_on_exact_ties(cuda):
    """Six spheres with every triangle twice in clusters of three (the
    case of tests/test_torch_clas.py): the kernel returns the twin's
    winner, the original's id."""
    tris, n_t = doubled_spheres()
    ro, rd = (torch.as_tensor(a, device=cuda) for a in rays_at(tris, 20_000,
                                                                 6))
    tm = torch.full((20_000,), clas_cull.INF, device=cuda)
    want = _cull_against_twin(cuda, tris, ro, rd, tm, 3)
    hits = want[1] >= 0
    assert float(hits.float().mean()) > 0.9
    assert bool((want[1][hits] < n_t).all())


def test_intersect_wrappers_reject_bad_inputs(cuda):
    scene, _ = make_sphere_box(tscene, tshapes).build(device=cuda)
    ro, rd, tm = _rays(cuda, scene, 256, 23)
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    tree, slot, ids = scene.clas_tree, scene.clas_woop_slot, scene.clas_ids
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        intersect_sweep.mt_sweep(ro, rd, tm.cpu(), *tris)
    with pytest.raises(ValueError):  # t_max not float32
        intersect_sweep.mt_sweep(ro, rd, tm.double(), *tris)
    for fn in (clas_cull.cull, clas_cull.any_hit):
        with pytest.raises(ValueError):  # rays not [N, 3] contiguous
            fn(ro.T.contiguous().T, rd, tm, tree, slot, ids)
        with pytest.raises(ValueError):  # ids not int32
            fn(ro, rd, tm, tree, slot, ids.long())
        with pytest.raises(ValueError):  # a CPU tree
            fn(ro, rd, tm, tree.cpu(), slot, ids)
        with pytest.raises(ValueError):  # the reference's [C, 12, t_c] rows
            fn(ro, rd, tm, tree, scene.clas_woop, ids)
        with pytest.raises(ValueError):  # a tree of too few leaves
            fn(ro, rd, tm, tree[:4].contiguous(), slot, ids)
        with pytest.raises(ValueError):  # Woop rows off 16-byte alignment
            fn(ro, rd, tm, tree, torch.empty(slot.numel() + 1, device=cuda)
               [1:].view(slot.shape), ids)
        with pytest.raises(ValueError):  # a counter that is not int64 [1]
            fn(ro, rd, tm, tree, slot, ids,
               tests=torch.zeros(1, dtype=torch.int32, device=cuda))


def test_product_pool_on_the_card_matches_the_cpu(cuda):
    """The guided pool with a learned-BSDF table (product lanes, no
    guided_sample launch) on the four-type box: the card's film mean within
    4 standard errors of the CPU's on the same trained guide state."""
    from torch_parity import film_mean_se, within_se

    from sdmm_tpu_torch.guiding import em as tem
    from sdmm_tpu_torch.guiding import trainer as ttrainer
    from sdmm_tpu_torch.render import guided as tguided

    scene, cfg = make_box(tscene, tshapes, 32, 32, extra_bsdfs=True).build(
        device="cpu")
    cfg.max_depth = cfg.rr_depth = 5
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(
        max_leaves=64, split_threshold=2000, train_fraction=1.0,
        sample_product=True, em=tem.EMConfig(batch_size=1024), seed=4),
        device="cpu")
    tr.run(total_spp=20)
    assert int(tr.initialized.sum()) > 0
    gs = tr.guide_state()
    before = gso.guided_sample.launches
    stats = {}
    for dev in ("cpu", "cuda"):
        out = tguided.render_pool_guided(
            scene, gs, torch.Generator(device=dev).manual_seed(3),
            n_lanes=8192, spp=16, width=32, height=32, max_depth=5,
            rr_depth=5, bsdf_types=cfg.bsdf_types or None, device=dev)
        assert int(out["n_product"]) > 0
        stats[dev] = film_mean_se(*(out[k].cpu().numpy()
                                    for k in ("image", "sqr", "weight")))
    assert gso.guided_sample.launches == before
    assert within_se(stats["cuda"], stats["cpu"]), stats


def test_reservoir_update_on_the_card_equals_the_cpu(cuda):
    """reservoir_update on CUDA tensors equals the CPU's on the same batch
    and uniforms (the compaction's stable sort included)."""
    from sdmm_tpu_torch.guiding import reservoir as tres

    rs = np.random.RandomState(0)
    cap, n = 4096, 6000
    res = {d: tres.make_reservoir(cap, d) for d in ("cpu", "cuda")}
    for step in range(3):
        pos = rs.rand(n, 3).astype(np.float32)
        d = rs.randn(n, 3).astype(np.float32)
        w = (rs.rand(n) * 5).astype(np.float32)
        valid = rs.rand(n) < 0.9
        u = rs.rand(cap + n).astype(np.float32)
        for dev in res:
            t = [torch.as_tensor(a, device=dev) for a in (pos, d, w, valid,
                                                         u)]
            res[dev] = tres.reservoir_update(res[dev], *t, cap, 0.5)
        for k, v in res["cpu"].items():
            got = res["cuda"][k].cpu()
            if v.dtype == torch.bool:
                assert torch.equal(got, v), k
            else:
                torch.testing.assert_close(got, v, rtol=1e-6, atol=1e-7)
