"""The schedulers that no entry point reaches, on the CPU (their kernels'
plain twins):

- the four bounce pools (``render_pool_fused``, ``_blocked``, ``_sorted``,
  ``_shuffled``) against the eager ``render_pool`` on the tiled box of
  tests/test_bounce_pallas.py (116 triangles, so 2,048-lane tiles; at
  64x48 pixels the shuffled pool's lanes each own two slots);
- the lane layouts of the blocked and shuffled pools (which lane renders
  each pixel, how many samples each lane takes), read off the reference's
  pools and the port's alike by a stand-in bounce that ends every path at
  once and splats its lane's index;
- the guided sorted2 and striped pools against ``render_pool_guided`` on a
  trained K = 16 model.

Random streams differ between the pools, so images agree in expectation
only: each image mean within 4 joint standard errors. The pools against
the reference's own, in Pallas interpret mode, are in
tests/test_torch_pools_reference.py. Few tests, so that the tier-1
scheduler (``--dist loadfile``, files with the most tests first) runs the
file after the long reference files."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import _trainers  # noqa: E402
from torch_parity import (  # noqa: E402
    film_mean_se, make_box, make_tiled_box, to_np, within_se,
)

from sdmm_tpu.ops import bounce_pallas as jbp  # noqa: E402
from sdmm_tpu.ops import guided_step_pallas as jgsp  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.ops import bounce as tbo  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W, H, SPP = 64, 48, 4


def _mean_se(out):
    return film_mean_se(to_np(out["image"]), to_np(out["sqr"]),
                        to_np(out["weight"]))


def test_bounce_pools_match_render_pool_in_expectation():
    scene, cfg = make_tiled_box(tscene, tshapes, W, H).build(device="cpu")
    assert tbo.lane_tile(tbo.build_tables(scene)[0].shape[1]) == 2048
    kw = dict(spp=SPP, width=W, height=H, max_depth=cfg.max_depth,
              rr_depth=cfg.rr_depth, fov_axis=cfg.fov_axis, device="cpu")
    ref = _mean_se(twf.render_pool(
        scene, torch.Generator().manual_seed(0), n_lanes=4096,
        bsdf_types=cfg.bsdf_types, **kw))
    kw["bsdf_types"] = tuple(cfg.bsdf_types)
    for name, fn, extra in (
            ("fused", twf.render_pool_fused, dict(n_lanes=8192)),
            ("blocked", twf.render_pool_fused_blocked, {}),
            ("sorted", twf.render_pool_fused_sorted, dict(spp_pilot=1)),
            ("shuffled", twf.render_pool_fused_shuffled, dict(groups=2))):
        out = fn(scene, 7, **kw, **extra)
        assert out["pool"] == name
        w = to_np(out["weight"])
        assert w.min() == w.max() == SPP, name  # exact spp on every pixel
        got = _mean_se(out)
        assert within_se(got, ref), (name, got, ref)


def _lanes_of_pixels(out):
    """Each pixel's lane and sample count, from a pool run on
    ``_splat_lane``'s bounce."""
    img, w = np.asarray(out["image"])[:, 0], np.asarray(out["weight"])
    lane = img / np.maximum(w, 1.0)
    assert (lane == np.round(lane)).all()
    return lane.astype(np.int64), w


def _splat_lane(xp, n_lanes):
    """A stand-in for the bounce kernel (either package's, ``xp`` jnp or
    torch) that ends every live path at once with a splat of its lane's
    index and weight 1, and records the pool's lane count."""

    def bounce(state, meta, *args, **kw):
        n_lanes.append(int(np.prod(meta.shape)))
        if xp is jnp:
            lane = jnp.arange(meta.size, dtype=jnp.float32).reshape(
                meta.shape)
            live = ((meta & jwf._ALIVE) != 0).astype(jnp.float32)
            splat = jnp.zeros((8,) + meta.shape).at[0].set(live * lane)
            return state, meta & ~jwf._ALIVE, splat.at[6].set(live)
        live = ((meta & twf._ALIVE) != 0).float()
        splat = torch.zeros((8, meta.numel()))
        splat[0] = live * torch.arange(meta.numel(), dtype=torch.float32)
        splat[6] = live
        return state, meta & ~twf._ALIVE, splat

    return bounce


def test_pool_layouts_match_the_reference(monkeypatch):
    """The blocked and shuffled pools' lane layouts as the reference's
    pools (sdmm_tpu/render/wavefront.py render_pool_fused_blocked and
    _shuffled, traced on a stand-in bounce whose trace is dropped after)
    produce them: the
    blocked pool renders each pixel on the same lane, the shuffled pool
    has as many lanes, each with the same budget. The guided sorted2
    pool's tile is the larger of the reference's trace and shade tiles
    (sdmm_tpu/render/guided.py render_pool_guided_sorted2)."""
    for w, h, tiled in ((64, 48, False), (200, 37, True)):
        build = make_tiled_box if tiled else make_box
        js, jcfg = build(jscene, jshapes, w, h).build()
        ts, _ = build(tscene, tshapes, w, h).build(device="cpu")
        n_tris = js.tri_v0.shape[0]
        assert (n_tris > jbp.MAX_UNROLL_TRIS) == tiled
        tile = tbo.lane_tile(tbo.build_tables(ts)[0].shape[1])
        n_pix, spp, groups = w * h, 2, 8
        kw = dict(spp=spp, width=w, height=h, max_depth=4, rr_depth=4,
                  fov_axis=jcfg.fov_axis)
        runs = {}
        for name, extra in (("blocked", {}), ("shuffled", dict(groups=groups))):
            n_ref, n_port = [], []
            monkeypatch.setattr(jbp, "bounce", _splat_lane(jnp, n_ref))
            monkeypatch.setattr(tbo, "bounce", _splat_lane(torch, n_port))
            pool = getattr(jwf, f"render_pool_fused_{name}")
            try:
                ref = pool(js, jax.random.PRNGKey(1), **kw, **extra)
                jax.block_until_ready(ref)
            finally:  # drop the trace that holds the stand-in
                pool.clear_cache()
            port = getattr(twf, f"render_pool_fused_{name}")(
                ts, 1, device="cpu", **kw, **extra)
            runs[name] = (_lanes_of_pixels(ref), n_ref[0],
                          _lanes_of_pixels(port), n_port[0])
        # Blocked: the same lane for every pixel, spp samples each.
        (lane_r, w_r), n_r, (lane_p, w_p), n_p = runs["blocked"]
        pix, in_image, _, _, n_tiles = twf.blocked_layout(w, h, tile)
        assert n_p == n_r == n_tiles * tile
        assert (w_r == spp).all() and (w_p == spp).all()
        np.testing.assert_array_equal(lane_p, lane_r)
        np.testing.assert_array_equal(pix[lane_r], np.arange(n_pix))
        assert int(in_image.sum()) == n_pix
        # Shuffled: the same lane count and per-lane budgets.
        (lane_r, w_r), n_r, (lane_p, w_p), n_p = runs["shuffled"]
        n_lanes, budget = twf.shuffled_layout(n_pix, spp, groups, tile)
        assert n_p == n_r == n_lanes
        assert (w_r == spp).all() and (w_p == spp).all()
        want = spp * np.bincount(lane_r, minlength=n_r)
        np.testing.assert_array_equal(budget, want)
        np.testing.assert_array_equal(
            spp * np.bincount(lane_p, minlength=n_p), want)
        # Guided sorted2: the larger of trace's and shade's tiles.
        r0 = -(-n_pix // 128)
        rt_tr = jgsp.trace_rt(-(-r0 // jgsp.RT) * jgsp.RT, n_tris)
        g_tile = max(rt_tr, jgsp.RT) * 128
        assert tguided.guided_sorted2_layout(n_pix, n_tris) == (
            g_tile, -(-n_pix // g_tile) * g_tile)


def test_guided_pools_match_render_pool_guided_in_expectation():
    """A K = 16 model trained for one iteration, frozen: the guided sorted2
    and striped pools (trace + shade twins) against the eager guided
    pool."""
    _, tt = _trainers(train_fraction=0.5)
    tt.run(total_spp=8)
    gs = tt.guide_state()
    assert int(tt.initialized.sum()) > 0
    rc = tt.render_cfg
    kw = dict(spp=16, width=rc.width, height=rc.height,
              max_depth=rc.max_depth, rr_depth=rc.rr_depth,
              bsdf_fraction=0.5, fov_axis=rc.fov_axis, device="cpu")
    ref = _mean_se(tguided.render_pool_guided(
        tt.scene, gs, torch.Generator().manual_seed(3), n_lanes=4096,
        bsdf_types=rc.bsdf_types, **kw))
    kw["bsdf_types"] = tuple(rc.bsdf_types)
    for fn, extra in ((tguided.render_pool_guided_sorted2,
                       dict(spp_pilot=4)),
                      (tguided.render_pool_guided_striped, {})):
        out = fn(tt.scene, gs, torch.Generator().manual_seed(4), **kw,
                 **extra)
        w = to_np(out["weight"])
        assert w.min() == w.max() == 16
        assert 0 < float(out["n_cond_ok"]) <= float(out["n_cond_try"])
        got = _mean_se(out)
        assert within_se(got, ref), (fn.__name__, got, ref)
