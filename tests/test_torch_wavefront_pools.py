"""The unguided pools with NEE (render/wavefront.py) in the port. Whole
renders draw their own random numbers, so they agree in expectation: NEE
against BSDF sampling alone within 5%, and the fused pools on the CPU
(their plain twins) against the eager pool at 64 spp within 6%
(tests/test_bounce_pallas.py:310,350), each landing exactly spp samples
on every pixel. The file holds few tests, so that the tier-1 scheduler
(``--dist loadfile``, files with the most tests first) runs it after the
long reference files."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_wavefront import (  # noqa: E402
    H, MAX_DEPTH, RR_DEPTH, W, _box, _mean, _port_pool,
)
from torch_parity import to_np  # noqa: E402

from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def eager64():
    out = _port_pool(64)
    assert (to_np(out["weight"]) == 64).all() and out["pool"] == "eager"
    return out


def test_render_pool_nee_matches_bsdf_sampling(eager64):
    out_b = _port_pool(512, nee=False, seed=7)
    assert (to_np(out_b["weight"]) == 512).all()
    m_n, m_b = _mean(eager64), _mean(out_b)
    assert abs(m_n - m_b) / m_b < 0.05, (m_n, m_b)


@pytest.mark.parametrize("pool", ["sorted2", "striped"])
def test_fused_pool_twins_match_eager_pool(eager64, pool):
    _, ts, tcfg = _box()
    kw = dict(spp=64, width=W, height=H, max_depth=MAX_DEPTH,
              rr_depth=RR_DEPTH, bsdf_types=tcfg.bsdf_types, device="cpu")
    if pool == "sorted2":
        out = twf.render_pool_fused_sorted2(ts, 3, spp_pilot=16, **kw)
        assert 0 < out["alive_tile_steps"] <= out["total_tile_steps"]
    else:
        out = twf.render_pool_fused_striped(ts, 3, **kw)
    assert out["pool"] == pool
    assert (to_np(out["weight"]) == 64).all()  # every pixel exactly spp
    img = to_np(out["image"]) / 64
    assert np.isfinite(img).all()
    m_f, m_p = float(img.mean()), _mean(eager64)
    assert abs(m_f - m_p) / m_p < 0.06, (m_f, m_p)
    # Vertices: the fused pools count after the back-face cull, the eager
    # pool before it (as the reference pools do); the box has no back faces
    # in view, so the two agree in expectation.
    nv_f, nv_p = float(out["n_vertices"]), float(eager64["n_vertices"])
    assert abs(nv_f - nv_p) / nv_p < 0.03, (nv_f, nv_p)
