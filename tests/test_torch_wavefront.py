"""The unguided pools with NEE (render/wavefront.py) and the bounce
kernel's twin in the port: the twin skips a tile whose lanes are done,
and render_wavefront routes every CPU render to the eager pool.

Files of few tests, which the tier-1 scheduler (``--dist loadfile``,
files with the most tests first) runs after the long reference files,
hold the renders: NEE against BSDF sampling and the fused pools' twins
against the eager pool (tests/test_torch_wavefront_pools.py), and the
bounce twin against the reference's kernel with the eager pool against
the reference's (tests/test_torch_wavefront_kernels.py).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, path_wave  # noqa: E402

from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W = H = 16
R = bo.RT  # one 64 x 128 lane tile
N = R * 128
MAX_DEPTH, RR_DEPTH = 5, 5


def _box():
    js, _ = make_box(jscene, jshapes, W, H).build()
    ts, tcfg = make_box(tscene, tshapes, W, H).build(device="cpu")
    return js, ts, tcfg


def _wave():
    state, meta, _, _, rand = path_wave(N, 5, W, H, MAX_DEPTH)
    return state, meta, rand[:bo.RAND_ROWS].copy()


def _mean(out):
    img = np.asarray(out["image"]) / np.maximum(
        np.asarray(out["weight"]), 1.0)[:, None]
    return float(img.mean())


def _port_pool(spp, nee=True, seed=1):
    _, ts, tcfg = _box()
    return twf.render_pool(ts, torch.Generator().manual_seed(seed),
                           n_lanes=4096, spp=spp, width=W, height=H,
                           max_depth=MAX_DEPTH, rr_depth=RR_DEPTH, nee=nee,
                           bsdf_types=tcfg.bsdf_types, device="cpu")


def test_bounce_twin_tile_skip():
    _, ts, _ = _box()
    tri, em, env = bo.build_tables(ts)
    state, meta, rand = (torch.as_tensor(a) for a in _wave())
    st, me, sp = bo.bounce(state, meta, rand, tri, em, env, 2, MAX_DEPTH,
                           RR_DEPTH, (0,), torch.zeros(1, dtype=torch.int32))
    assert torch.equal(me, meta) and not sp.any()
    assert torch.equal(st.nan_to_num(), state.nan_to_num())


def test_render_wavefront_routes_on_the_cpu():
    _, ts, tcfg = _box()
    assert twf.fused_supported(ts, tcfg)
    assert not twf.fused_supported(ts, tcfg, nee=False)
    res = twf.render_wavefront(ts, tcfg, spp=3, seed=2, n_lanes=64,
                               device="cpu")
    assert res["pool"] == "eager"  # every CPU render takes the eager pool
    assert res["image"].shape == (H, W, 3) and res["raw"].shape == (H, W, 3)
    np.testing.assert_array_equal(res["weight"], 3.0)
    assert np.isfinite(res["image"]).all() and res["n_vertices"] > 0
    dark = tscene.SceneBuilder()
    dark.add_shape(tshapes.make_rectangle(np.eye(4)), 0)
    scene, cfg = dark.build(device="cpu")
    assert not twf.fused_supported(scene, cfg)  # no emissive triangle
