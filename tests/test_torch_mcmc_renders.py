"""The port's Metropolis and irradiance-cache renders in expectation, at
configurations near the reference's own tests' (tests/test_pssmlt.py,
test_mlt.py, test_irrcache.py): each image mean against one reference
render of the same configuration and against the port's own path tracer
(renderer.render; without NEE for MLT, as the reference's test), both
within the reference test's band:

- render_pssmlt, Kelemen (32x32, 32 spp, 2^12 chains, a bootstrap of
  2^16; 5%, and a healthy acceptance) and veach mutations (the same; 12%);
- render_erpt (32x32, 2^16 seeds, chains of 8; 8%) and render_irrcache
  (32x32, TABLE 512 in both packages through monkeypatch, 24 spp; 15%,
  and the indirect-only image darker);
- render_mlt on the diffuse box (32x32, 96 spp, 4,096 chains; 10%, and
  the 8x8 block means within the reference test's median 0.25).

The reference's renders run in a background thread while the port's run;
every reference call passes the scene's bsdf_types (its renderers read
cfg.bsdf_types).
"""

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box  # noqa: E402

from sdmm_tpu.render import irrcache as jic  # noqa: E402
from sdmm_tpu.render import mlt as jmlt  # noqa: E402
from sdmm_tpu.render import pssmlt as jps  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import irrcache as tic  # noqa: E402
from sdmm_tpu_torch.render import mlt as tmlt  # noqa: E402
from sdmm_tpu_torch.render import pssmlt as tps  # noqa: E402
from sdmm_tpu_torch.render.renderer import render  # noqa: E402

torch.set_num_threads(2)
TABLE = 512
DEPTH = 5

# name: (reference call, port call (scene, cfg), band). The PSSMLT and
# ERPT cases share their bootstrap's size (2^16 vectors), so that the
# reference compiles one eval_path for the three.
CASES = {
    "pssmlt": (lambda s, c: jps.render_pssmlt(
        s, c, spp=32, n_chains=1 << 12, n_bootstrap=1 << 16),
        lambda s, c: tps.render_pssmlt(
            s, c, spp=32, n_chains=1 << 12, n_bootstrap=1 << 16,
            device="cpu"), 0.05),
    "veach": (lambda s, c: jps.render_pssmlt(
        s, c, spp=32, n_chains=1 << 12, n_bootstrap=1 << 16,
        mutations="veach"),
        lambda s, c: tps.render_pssmlt(
            s, c, spp=32, n_chains=1 << 12, n_bootstrap=1 << 16,
            mutations="veach", device="cpu"), 0.12),
    "erpt": (lambda s, c: jps.render_erpt(s, c, n_seeds=1 << 16,
                                          chain_length=8),
             lambda s, c: tps.render_erpt(s, c, n_seeds=1 << 16,
                                          chain_length=8, device="cpu"),
             0.08),
    "irrcache": (lambda s, c: jic.render_irrcache(
        s, c, spp=24, grid_res=16, gather_res=8),
        lambda s, c: tic.render_irrcache(s, c, spp=24, grid_res=16,
                                         gather_res=8, device="cpu"), 0.15),
    "mlt": (lambda s, c: jmlt.render_mlt(s, c, spp=96, seed=3,
                                         n_chains=4096),
            lambda s, c: tmlt.render_mlt(s, c, spp=96, seed=3,
                                         n_chains=4096, device="cpu"), 0.10),
}


def _scene(size=32):
    js, cfg = make_box(jscene, jshapes, size, size).build()
    cfg.max_depth = cfg.rr_depth = DEPTH
    return js, cfg


def _reference(name):
    res = CASES[name][0](*_scene())
    return {k: np.asarray(v) if k == "image" else v for k, v in res.items()}


@pytest.fixture(scope="module")
def table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jic, "TABLE", TABLE)
        mp.setattr(tic, "TABLE", TABLE)
        yield


@pytest.fixture(scope="module")
def reference(table):
    """The reference's renders in one background thread, in the tests'
    order, each ready as soon as it is done."""
    with ThreadPoolExecutor(1) as ex:
        futures = {name: ex.submit(_reference, name) for name in CASES}
        yield lambda name: futures[name].result()


@functools.lru_cache
def _path_traced(nee):
    """The port's path tracer on the scene of every case (64 spp)."""
    js, cfg = _scene()
    return render(convert.scene_from_arrays(js, device="cpu"), cfg, spp=64,
                  seed=7, nee=nee, device="cpu")["image"]


def _port(name, nee=True):
    """The port's render of case ``name`` and its path tracer's image on
    the same scene."""
    js, cfg = _scene()
    out = CASES[name][1](convert.scene_from_arrays(js, device="cpu"), cfg)
    return out, _path_traced(nee)


def _check(name, out, pt, want):
    band = CASES[name][2]
    img = np.asarray(out["image"])
    assert np.isfinite(img).all(), name
    m, m_ref, m_pt = img.mean(), np.asarray(want["image"]).mean(), pt.mean()
    assert abs(m - m_ref) < band * m_ref, (name, m, m_ref)
    assert abs(m - m_pt) < band * m_pt, (name, m, m_pt)
    if "b" in want:
        assert out["b"] > 0 and abs(out["b"] - want["b"]) < band * want["b"]


def test_pssmlt_renders_match_reference(table, reference):
    acceptance = {}
    for name in ("pssmlt", "veach"):
        out, pt = _port(name)
        _check(name, out, pt, reference(name))
        acceptance[name] = out["acceptance"]
    assert 0.3 < acceptance["pssmlt"] < 0.95  # healthy chain mixing
    assert acceptance["veach"] > 0.2


def test_erpt_and_irrcache_render_match_reference(table, reference):
    for name in ("erpt", "irrcache"):
        out, pt = _port(name)
        _check(name, out, pt, reference(name))
    js, cfg = _scene()
    ts = convert.scene_from_arrays(js, device="cpu")
    dark = tic.render_irrcache(ts, cfg, spp=8, grid_res=12, gather_res=6,
                               indirect_only=True, device="cpu")["image"]
    assert dark.mean() < out["image"].mean()


def test_mlt_render_matches_reference(reference):
    out, pt = _port("mlt", nee=False)
    _check("mlt", out, pt, reference("mlt"))
    bm = out["image"].mean(-1).reshape(8, 4, 8, 4).mean((1, 3))
    br = pt.mean(-1).reshape(8, 4, 8, 4).mean((1, 3))
    assert np.median(np.abs(bm - br) / np.maximum(br, 0.05)) < 0.25
