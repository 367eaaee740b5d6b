"""Port parity: the dense Möller–Trumbore sweep (``ops/intersect_sweep``,
the plain twin of the mt_sweep kernel and the CPU route of
render/intersect.py at <= 1024 triangles), and the slice as a whole on a
scene above 1024 triangles, sdmm_tpu_torch vs sdmm_tpu.

The twin is held against the reference's XLA sweep
(``render/intersect.intersect`` / ``occluded``) and against its kernel
``intersect_pallas.mt_sweep`` in interpret mode: the test swaps the
module's ``pl`` for one whose ``pallas_call`` passes ``interpret=True``, and
no file of the reference changes. On the 12-triangle box and on the box
plus one 16 x 32 sphere (972 triangles), 4,096 random rays, t_max finite on
half of them: hit ids and valid equal on every ray, t, u and v within rtol
1e-5 / atol 1e-5 (XLA's CPU backend may contract products into FMAs; u
and v are sums of O(1) products that cancel, so a contraction moves them by
ulps of the products, ~2e-6 on one ray in 2,600).

The slice: on tests/test_clas_pallas.py's sphere scene (2,172 triangles) at
16 x 16, ``render_wavefront`` takes the eager pool through the cluster
twin, lands exactly spp samples on every pixel and agrees with the
reference's ``render_pool`` at 64 spp in image mean within 5% (the bound
of tests/test_torch_wavefront.py; the reference renders in a background
thread); ``SDMMTrainer.run`` at 8 spp runs to its end through the cluster
twin.
"""

import functools
import os
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    defer_pretest, grazing_rays, make_box, make_sphere_box, make_tiled_box,
    random_rays, to_np,
)

from sdmm_tpu.ops import intersect_pallas  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
N = 4096
W = H = 16
SPP = 64


def _box(scene_mod, shapes_mod, with_sphere):
    b = make_box(scene_mod, shapes_mod, 16, 16)
    if with_sphere:
        white = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[0.5] * 3)
        b.add_shape(shapes_mod.make_sphere([0.1, 0.8, -0.2], 0.45, np.eye(4),
                                           n_theta=16, n_phi=32), white)
    return b


def _reference_pool():
    js, cfg = make_sphere_box(jscene, jshapes, W, H).build()
    out = jwf.render_pool(js, jax.random.PRNGKey(5), n_lanes=4096, spp=SPP,
                          width=W, height=H, max_depth=cfg.max_depth,
                          rr_depth=cfg.rr_depth, nee=True,
                          bsdf_types=cfg.bsdf_types)
    assert (np.asarray(out["weight"]) == SPP).all()
    img = np.asarray(out["image"]) / np.asarray(out["weight"])[:, None]
    return float(img.mean())


@pytest.fixture(scope="module", autouse=True)
def _reference_runs():
    """Starts the reference's render at the top of the module, so that its
    compile overlaps the port's tests."""
    with ThreadPoolExecutor(1) as ex:
        yield {"pool": ex.submit(_reference_pool)}


@pytest.mark.parametrize("with_sphere", [False, True],
                         ids=["box", "box+sphere"])
def test_dense_twin_matches_reference(with_sphere, monkeypatch):
    js = _box(jscene, jshapes, with_sphere).build()[0]
    ts = _box(tscene, tshapes, with_sphere).build(device="cpu")[0]
    n_tris = ts.tri_v0.shape[0]
    assert n_tris == (972 if with_sphere else 12)
    ro, rd, tm = random_rays(to_np(ts.tri_v0), N, seed=7)
    got = tisect.intersect(ts, *(torch.as_tensor(a) for a in (ro, rd, tm)))
    occ = tisect.occluded(ts, *(torch.as_tensor(a) for a in (ro, rd, tm)))
    jr = tuple(jnp.asarray(a) for a in (ro, rd, tm))
    monkeypatch.setattr(intersect_pallas, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, ds=pl.ds))
    for want in (jisect.intersect(js, *jr),
                 intersect_pallas.mt_sweep(*jr, js.tri_v0, js.tri_e1,
                                           js.tri_e2)):
        want = {k: np.asarray(v) for k, v in want.items()}
        np.testing.assert_array_equal(to_np(got["valid"]), want["valid"])
        np.testing.assert_array_equal(to_np(got["tri"]), want["tri"])
        ok = want["valid"]
        assert 0.3 < ok.mean() < 0.95
        for k in ("t", "u", "v"):
            np.testing.assert_allclose(to_np(got[k])[ok], want[k][ok],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(to_np(occ),
                                  np.asarray(jisect.occluded(js, *jr)))
    np.testing.assert_array_equal(to_np(occ), to_np(got["valid"]))
    # A miss carries the kernel's record: t INF, u = v = 0.
    miss = ~to_np(got["valid"])
    assert (to_np(got["t"])[miss] == intersect_sweep.INF).all()
    assert not to_np(got["u"])[miss].any() and not to_np(got["v"])[miss].any()


@pytest.mark.parametrize("make", [make_box, make_tiled_box],
                         ids=["box", "tiled box"])
def test_deferred_reciprocal_pretest_passes_every_hit(make):
    """The warp-voted sweep kernel skips a triangle's reciprocal when no lane
    of the warp passes its pre-test (torch_parity.defer_pretest, the
    kernel's float32 operations in its order). On rays that graze the
    triangles' edges, with the limit of every other hitting ray just above
    its hit's t, the pre-test passes every pair that the twin accepts, the
    pairs at u = 0 and at u + v = 1 among them."""
    ts = make(tscene, tshapes, 16, 16).build(device="cpu")[0]
    tris = (ts.tri_v0, ts.tri_e1, ts.tri_e2)
    ro, rd = (torch.as_tensor(x) for x in grazing_rays(
        *(to_np(a).astype(np.float64) for a in tris), 4_096, 27))
    inf = torch.full((ro.shape[0],), intersect_sweep.INF)
    best = intersect_sweep.mt_sweep_plain(ro, rd, inf, *tris)
    tight = best["valid"] & (torch.arange(ro.shape[0]) % 2 == 1)
    lim = torch.where(tight, torch.nextafter(best["t"], inf), inf)
    _, u, v, hit = intersect_sweep._mt_chunk(ro, rd, *tris, lim)
    pre = defer_pretest(ro, rd, lim, *tris)
    assert not bool((hit & ~pre).any())
    assert bool(hit[tight, best["tri"][tight].long()].all())
    assert bool((hit & (u == 0)).any()) and bool((hit & (u + v == 1)).any())


def _sphere_scene():
    return make_sphere_box(tscene, tshapes, W, H).build(device="cpu")


def test_render_wavefront_above_1024_triangles(_reference_runs, monkeypatch):
    ts, cfg = _sphere_scene()
    assert ts.tri_v0.shape[0] > tisect.BRUTE_FORCE_MAX
    calls = []
    plain = clas_cull.cull_plain
    monkeypatch.setattr(clas_cull, "cull_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = twf.render_wavefront(ts, cfg, spp=SPP, seed=2, n_lanes=4096,
                               device="cpu")
    assert out["pool"] == "eager" and len(calls) == 2 * out["steps"]
    np.testing.assert_array_equal(out["weight"], SPP)
    assert np.isfinite(out["image"]).all()
    m_t, m_j = float(out["image"].mean()), _reference_runs["pool"].result()
    assert abs(m_t - m_j) / m_j < 0.05, (m_t, m_j)


def test_trainer_runs_above_1024_triangles(monkeypatch):
    ts, cfg = _sphere_scene()
    calls = []
    plain = clas_cull.cull_plain
    monkeypatch.setattr(clas_cull, "cull_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tr = ttrainer.SDMMTrainer(
        ts, cfg, ttrainer.TrainerConfig(max_leaves=64, rays_per_wave=1024),
        device="cpu")
    img, iters = tr.run(total_spp=8)
    assert len(calls) > 0 and len(iters) == len(tr.stats) > 0
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.mean() > 0
