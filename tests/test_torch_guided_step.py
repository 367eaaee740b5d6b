"""Port parity: the fused guided bounce (ops/bounce.py tables and helpers,
ops/guided_step.py trace and shade twins) and the frozen-model pool
render_pool_guided_fused, sdmm_tpu_torch vs sdmm_tpu on the same numpy
inputs.

The reference kernels run once each, in interpret mode, on one 16 x 128
lane tile of the four-type box (every in-kernel BSDF type), in one
module-scoped fixture that starts them in a background thread.
Tolerances: tables rtol 1e-6 (the same float32 3x3 inverse, LU in both);
helpers rtol 1e-5; trace: the winner's attributes exact, positions,
shading normals and radiance rtol 1e-5; shade: state rtol 2e-4 / atol
1e-5 (the mixture pdf divides the throughput; sums in another order), meta
and splat rows equal, each on >= 99.8% of the lanes (a u_sel within an ulp
of a CDF step or a roulette draw within an ulp of q flips a lane). The fused pool draws its own random numbers, so it agrees
with the reference's XLA pool in expectation, within the bounds of
tests/test_guided_pallas.py's fused-pool test (mean 12%, median 4x4-block
difference 0.3). Both render 256 spp: the guide of the synthetic-sample
recipe leaves a per-sample standard deviation ~5x the mean, so at 24 spp
the reference pool against itself already reaches block medians of
0.20-0.32; at 256 spp the two pools differed by <= 4% in mean and <= 0.135
in block median over seeds 3-7.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import _synthetic_batch, _trainers  # noqa: E402
from torch_parity import (  # noqa: E402
    jax_scene_arrays, lane_wave, make_box, make_mixture_state, to_np,
)

from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu.ops import guided_pallas as jgp  # noqa: E402
from sdmm_tpu.ops import guided_step_pallas as gsp  # noqa: E402
from sdmm_tpu.render import guided as jguided  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.bsdf import fresnel as tfresnel  # noqa: E402
from sdmm_tpu_torch.core import frame as tframe  # noqa: E402
from sdmm_tpu_torch.core import warp as twarp  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.guiding import mixture as tmix  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from sdmm_tpu_torch.ops import guided_step as gst  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
R = 16  # lane rows of 128: one shade tile and one trace tile
N = R * 128
MAX_DEPTH, RR_DEPTH, FRACTION = 5, 3, 0.5
TYPES = (0, 1, 2, 3)


def _scenes(extra):
    js, _ = make_box(jscene, jshapes, 16, 16, extra).build()
    ts, tcfg = make_box(tscene, tshapes, 16, 16, extra).build(device="cpu")
    return js, ts, tcfg


def _reference_kernels():
    """One interpret-mode call of each reference kernel on one lane tile of
    the four-type box, with every input as numpy. Nearly all of its time
    is XLA's compile, which releases the GIL: shade is lowered first from
    its shapes alone and compiled in a second thread while trace is
    lowered, compiled and run; shade then runs on trace's hit buffer."""
    js, _, tcfg = _scenes(True)
    assert tcfg.bsdf_types == TYPES
    tri, _, env = (np.asarray(a) for a in bp.build_tables(js))
    state, meta, rand = lane_wave(N, seed=7, max_depth=MAX_DEPTH)
    tile = (R, 128)

    def spec(rows, dtype=jnp.float32):
        return jax.ShapeDtypeStruct((rows, *tile), dtype)

    shade_j = jax.jit(lambda *a: gsp.shade(
        *a, types=TYPES, max_depth=MAX_DEPTH, rr_depth=RR_DEPTH,
        bsdf_fraction=FRACTION, interpret=True)).lower(
            spec(16), jax.ShapeDtypeStruct(tile, jnp.int32),
            spec(gst.HIT_ROWS), spec(3),
            spec(gso.N_ROWS, jnp.bfloat16), spec(gst.RAND_ROWS))
    with ThreadPoolExecutor(1) as ex:
        shade_j = ex.submit(shade_j.compile)
        st_j, hit_j = gsp.trace(
            jnp.asarray(state.reshape(16, *tile)),
            jnp.asarray(meta.reshape(tile)), jnp.asarray(tri),
            jnp.asarray(env), n_tris=js.tri_v0.shape[0], types=TYPES,
            interpret=True)
        shade_j = shade_j.result()
    st_j = np.asarray(st_j).reshape(16, N)
    hit_j = np.asarray(hit_j).reshape(gst.HIT_ROWS, N)

    ms = make_mixture_state(seed=2, L=8)
    sdmm = tmix.SDMM(*(torch.as_tensor(ms[k]) for k in ("weight", "mean",
                                                         "cov")))
    table16 = gso.pack_guided_rows(
        tmix.prepare(sdmm), sdmm.weight,
        torch.as_tensor(ms["initialized"])).T.to(torch.bfloat16).contiguous()
    rs = np.random.RandomState(8)
    leaf = rs.randint(0, 8, N).astype(np.int32)
    cpos = ((hit_j[0:3] - np.array([[-1.0], [0.0], [-1.0]])) / 2.0
            ).astype(np.float32)
    rows_t = table16.float().numpy()[leaf].T  # exact bf16 values
    out_j = shade_j(
        jnp.asarray(st_j.reshape(16, *tile)), jnp.asarray(meta.reshape(tile)),
        jnp.asarray(hit_j.reshape(gst.HIT_ROWS, *tile)),
        jnp.asarray(cpos.reshape(3, *tile)),
        jnp.asarray(rows_t.reshape(gso.N_ROWS, *tile)).astype(jnp.bfloat16),
        jnp.asarray(rand.reshape(gst.RAND_ROWS, *tile)))
    shade_j = tuple(np.asarray(a).reshape(a.shape[0], N) if a.ndim == 3
                    else np.asarray(a).reshape(N) for a in out_j)
    return dict(tri=tri, env=env, state=state, meta=meta, rand=rand,
                st_j=st_j, hit_j=hit_j, table16=table16, leaf=leaf,
                cpos=cpos, shade_j=shade_j)


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """Starts the reference kernels at the top of the module, so that
    their compile overlaps the tests that do not need them."""
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference_kernels)


@pytest.fixture(scope="module")
def kernels(_reference_run):
    return _reference_run.result()


@pytest.mark.parametrize("extra", [False, True])
def test_em_tri_fields_match_reference(extra):
    js, ts, _ = _scenes(extra)
    for name in ("em_tri_idx", "em_tri_cdf", "em_tri_pdf", "em_tri_area"):
        np.testing.assert_array_equal(to_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)), name)
    from sdmm_tpu.scene import emitters as jem
    from sdmm_tpu_torch.scene import emitters as tem

    np.testing.assert_array_equal(to_np(tem.tri_pdf_over_area(ts)),
                                  np.asarray(jem.tri_pdf_over_area(js)))


@pytest.mark.parametrize("extra", [False, True])
def test_build_tables_match_reference(extra):
    js, ts, _ = _scenes(extra)
    ts_j = tscene.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    for port in (bo.build_tables(ts), bo.build_tables(ts_j)):
        for a, b in zip(port, bp.build_tables(js)):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == torch.float32
            np.testing.assert_allclose(to_np(a), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
    assert bo.build_tables(ts)[0].shape[0] == bo.TRI_ROWS == bp.TRI_ROWS


def test_build_tables_pads_past_the_unroll_limit():
    js, _ = make_box(jscene, jshapes, 8, 8, True).build(pad_tris_to=100)
    ts = tscene.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    tri = to_np(bo.build_tables(ts)[0])
    assert tri.shape == (bo.TRI_ROWS, 128) == np.asarray(
        bp.build_tables(js)[0]).shape
    assert not tri[:, 100:].any()


def _helper_inputs(seed=0, n=4096):
    rs = np.random.RandomState(seed)
    v = rs.randn(3, n)
    v /= np.linalg.norm(v, axis=0)
    wi = v * np.array([[1.0], [1.0], [-1.0]]) ** (v[2:3] < 0)  # z >= 0
    m = rs.randn(3, n)
    m[2] = np.abs(m[2])
    m /= np.linalg.norm(m, axis=0)
    cos_i = rs.uniform(-1, 1, n)
    cos_i[::50] = 0.0  # sign(0) = 0 in the refracted cosine
    u = rs.rand(2, n)
    u[:, ::64] = 0.5  # the disk map's centre
    f = np.float32
    return dict(v=v.astype(f), wi=wi.astype(f), m=m.astype(f),
                cos_i=cos_i.astype(f),
                eta=rs.uniform(0.2, 2.5, n).astype(f),
                k=rs.uniform(0.0, 4.0, n).astype(f),
                alpha=rs.uniform(0.05, 0.8, n).astype(f), u=u.astype(f))


def _same(call):
    """A helper whose twin in ops/bounce.py has the reference's name and
    signature."""
    return (lambda x: call(bo, x), lambda x: call(bp, x))


# name: (port twin, reference helper), each called on a dict of inputs. The
# first four twins are the port's frame, warp and Fresnel functions.
HELPERS = {
    "coordinate_system": (
        lambda x: tuple(torch.cat(tframe.coordinate_system(
            torch.stack(tuple(x["v"]), -1)), -1).unbind(-1)),
        lambda x: bp._coordinate_system(*x["v"])),
    "disk_concentric": (
        lambda x: tuple(twarp.square_to_uniform_disk_concentric(
            x["u"].T).unbind(-1)),
        lambda x: bp._disk_concentric(*x["u"])),
    "fresnel_dielectric": (
        lambda x: tfresnel.fresnel_dielectric(x["cos_i"], x["eta"]),
        lambda x: bp._fresnel_dielectric(x["cos_i"], x["eta"])),
    "fresnel_conductor_1": (
        lambda x: tfresnel.fresnel_conductor(
            x["cos_i"], x["eta"][:, None], x["k"][:, None])[:, 0],
        lambda x: bp._fresnel_conductor_1(x["cos_i"], x["eta"], x["k"])),
    "ggx_d": _same(lambda m, x: m._ggx_d(x["m"][2], x["alpha"])),
    "smith_g1": _same(lambda m, x: m._smith_g1(*x["v"], *x["m"],
                                               x["alpha"])),
    "sample_vndf": _same(lambda m, x: m._sample_vndf(*x["wi"], x["alpha"],
                                                     *x["u"])),
    "vndf_pdf": _same(lambda m, x: m._vndf_pdf(*x["v"], *x["m"],
                                               x["alpha"])),
}


TRIG = ("disk_concentric", "sample_vndf")


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_twins_match_reference(name):
    x = _helper_inputs()
    port, ref = HELPERS[name]
    out_t = port({k: torch.as_tensor(v) for k, v in x.items()})
    out_j = ref({k: jnp.asarray(v) for k, v in x.items()})
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        a, b = to_np(a), np.asarray(b)
        if name not in TRIG:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            continue
        # torch's and XLA's cos/sin differ by an ulp, and the VNDF's
        # sqrt(1 - p1² - p2²) amplifies it where the argument nears 0.
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert close.mean() >= 0.999, close.mean()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_woop_tri_twin_matches_reference():
    js, _, _ = _scenes(True)
    tri = np.asarray(bp.build_tables(js)[0])
    state, _, _ = lane_wave(2048, seed=3)
    ro_rd_t = [torch.as_tensor(r) for r in state[0:6]]
    ro_rd_j = [jnp.asarray(r) for r in state[0:6]]
    for j in (0, 5, 13, 40):
        for a, b in zip(bo._woop_tri(*ro_rd_t, torch.as_tensor(tri), j),
                        bp._woop_tri(*ro_rd_j, jnp.asarray(tri), j)):
            if a.dtype == torch.bool:
                assert float((to_np(a) == np.asarray(b)).mean()) > 0.999
            else:
                np.testing.assert_allclose(to_np(a), np.asarray(b),
                                           rtol=1e-5, atol=1e-5)


def test_trace_twin_matches_reference_kernel(kernels):
    k = kernels
    st, hit = gst.trace(torch.as_tensor(k["state"]),
                        torch.as_tensor(k["meta"]), torch.as_tensor(k["tri"]),
                        torch.as_tensor(k["env"]), TYPES)
    st, hit, hit_j = to_np(st), to_np(hit), k["hit_j"]
    assert hit.shape == (gst.HIT_ROWS, N)
    on = hit_j[21] > 0.5
    assert 0.3 < on.mean() < 0.95  # hits and misses, alive and dead lanes
    assert len(set(hit_j[12][on].tolist())) == 4  # every BSDF type was hit
    exact = [3, 4, 5] + list(range(9, 22))
    np.testing.assert_array_equal(hit[exact], hit_j[exact])
    np.testing.assert_allclose(hit[0:3], hit_j[0:3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hit[6:9], hit_j[6:9], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st, k["st_j"], rtol=1e-5, atol=1e-6)


def test_shade_twin_matches_reference_kernel(kernels):
    k = kernels
    st, meta, splat = gst.shade(
        torch.as_tensor(k["st_j"]), torch.as_tensor(k["meta"]),
        torch.as_tensor(k["hit_j"]), torch.as_tensor(k["cpos"]),
        torch.as_tensor(k["leaf"]), gst.pack_shade_table(k["table16"]),
        torch.as_tensor(k["rand"]), TYPES, MAX_DEPTH, RR_DEPTH, FRACTION)
    st_r, meta_r, splat_r = k["shade_j"]
    st, meta, splat = to_np(st), to_np(meta), to_np(splat)
    assert meta.dtype == np.int32 and splat.shape == (gst.SPLAT_ROWS, N)
    assert not st[13:].any()
    # The comparison exercises the branches: guided and BSDF samples, RR,
    # splats, and NaN radiance splatting 0.
    assert 0 < splat_r[9].sum() <= splat_r[8].sum() < splat_r[7].sum()
    assert 0 < splat_r[6].sum() < N
    assert np.isfinite(splat_r).all()
    ok_state = np.isclose(st, st_r, rtol=2e-4, atol=1e-5,
                          equal_nan=True).all(0)
    ok_meta = meta == meta_r
    ok_splat = (splat == splat_r).all(0)
    for name, ok in (("state", ok_state), ("meta", ok_meta),
                     ("splat", ok_splat)):
        assert ok.mean() >= 0.998, (name, ok.mean(), np.nonzero(~ok)[0][:8])


def _reference_table(L, seed):
    """The reference's pack_guided_rows of a seeded mixture state, carried
    to the port as numpy (convert's array bridge): [L, N_ROWS] float32."""
    ms = make_mixture_state(seed=seed, L=L)
    js = jmix.SDMM(weight=jnp.asarray(ms["weight"]),
                   mean=jnp.asarray(ms["mean"]), cov=jnp.asarray(ms["cov"]))
    rows = jgp.pack_guided_rows(jmix.prepare(js), js.weight,
                                jnp.asarray(ms["initialized"]))
    return torch.as_tensor(convert._np(rows).T.copy()), ms["initialized"]


def test_pack_shade_table_round_trips_reference_rows():
    L = 64
    table, initialized = _reference_table(L, seed=4)
    t16 = table.to(torch.bfloat16)
    packed = gst.pack_shade_table(table)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (L, gso.PACK_COLS) and packed.is_contiguous()
    # Every row and every component's three words start on 16 bytes.
    assert (gso.PACK_COLS * 2) % 16 == 0 and (gso.PACK_STRIDE * 2) % 16 == 0
    bits = packed.view(torch.int16)
    assert torch.equal(gso.unpack_sample_table(packed).view(torch.int16),
                       t16.view(torch.int16))
    comp = bits.reshape(L, gso.K, gso.PACK_STRIDE)
    ref = t16.view(torch.int16)
    # The kernel's blocks: values 0-15 (two words) and 16-21 (one word).
    assert torch.equal(comp[:, :, :16].reshape(L, -1),
                       ref[:, :gso.K * 22].reshape(L, gso.K, 22)[:, :, :16]
                       .reshape(L, -1))
    assert torch.equal(comp[:, :, 16:22],
                       ref[:, :gso.K * 22].reshape(L, gso.K, 22)[:, :, 16:])
    # The init flag in component 0's first pad; every other pad is 0.
    assert torch.equal(comp[:, 0, gso.PACK_INIT], ref[:, gso.N_ROWS - 1])
    assert torch.equal(packed.float()[:, gso.PACK_INIT] > 0.5,
                       torch.as_tensor(initialized))
    pads = comp[:, :, 22:].clone()
    pads[:, 0, 0] = 0
    assert not pads.any()


def test_shade_on_packed_table_equals_shade_on_rows():
    _, ts, tcfg = _scenes(True)
    tri, _, env = bo.build_tables(ts)
    n, L = 2048, 64
    state, meta, rand = (torch.as_tensor(a) for a in
                         lane_wave(n, seed=12, max_depth=MAX_DEPTH))
    st, hit = gst.trace(state, meta, tri, env, TYPES)
    table, _ = _reference_table(L, seed=5)
    leaf = torch.as_tensor(np.random.RandomState(6).randint(0, L, n)
                           .astype(np.int32))
    cpos = ((hit[0:3].T - ts.aabb_lo) / 2.0).T.contiguous()
    packed = gst.shade(st, meta, hit, cpos, leaf,
                       gst.pack_shade_table(table), rand, TYPES, MAX_DEPTH,
                       RR_DEPTH, FRACTION)
    rows = gst.shade_plain(st, meta, hit, cpos,
                           table.to(torch.bfloat16)[leaf.long()].T.float(),
                           rand, TYPES, MAX_DEPTH, RR_DEPTH, FRACTION)
    for a, b in zip(packed, rows):  # bit for bit, NaN radiance included
        assert bool(((a == b) | (a.isnan() & b.isnan())).all())
    assert 0 < int(rows[2][9].sum())  # guided samples were drawn


@pytest.fixture(scope="module")
def carried():
    """The trained recipe of test_torch_trainer.py: a JAX trainer after one
    optimize on synthetic samples, its state carried to the port."""
    jt, tt = _trainers(split_threshold=500, jitter_replicas=False)
    jt.total_spp = 16
    batch = _synthetic_batch(jt)
    jt.optimize([{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in batch.items()}])
    convert.trainer_state_from_numpy(tt, convert.trainer_state_to_numpy(jt))
    return jt, tt


def test_fused_pool_matches_reference_pool_estimator(carried):
    jt, tt = carried
    W = H = 16
    spp = 256
    kw = dict(spp=spp, width=W, height=H, max_depth=4, rr_depth=4,
              bsdf_fraction=0.5, fov_axis="x")
    gs = tt.guide_state()
    assert tguided.guided_fused_supported(tt.scene, tt.render_cfg, gs)
    out_x = jguided.render_pool_guided(
        jt.scene, jt.guide_state(), jax.random.PRNGKey(3), n_lanes=1024,
        bsdf_types=jt.render_cfg.bsdf_types or None, **kw)
    out_f = tguided.render_pool_guided_fused(
        tt.scene, gs, torch.Generator().manual_seed(3), n_lanes=2048,
        bsdf_types=tt.render_cfg.bsdf_types, device="cpu", **kw)
    ix = np.asarray(out_x["image"]) / np.maximum(
        np.asarray(out_x["weight"])[:, None], 1.0)
    i_f = to_np(out_f["image"]) / np.maximum(
        to_np(out_f["weight"])[:, None], 1.0)
    assert np.isfinite(i_f).all()
    assert float(out_f["weight"].sum()) == W * H * spp  # each sample once
    assert abs(i_f.mean() - ix.mean()) / ix.mean() < 0.12, (
        i_f.mean(), ix.mean())
    bx = ix.mean(-1).reshape(4, 4, 4, 4).mean((1, 3))
    bf = i_f.mean(-1).reshape(4, 4, 4, 4).mean((1, 3))
    rel = np.abs(bf - bx) / np.maximum(bx, 5e-2)
    assert np.median(rel) < 0.3, (np.median(rel), rel)
    assert 0 < float(out_f["n_cond_ok"]) <= float(out_f["n_cond_try"])
    assert float(out_f["n_vertices"]) > 0
