"""Port parity: the volumetric path (sdmm_tpu_torch/render/volpath.py
``trace_wave`` through ``renderer.render``, ``render_wavefront``'s media
route, the media guided pool and ``trace_wave_guided``) against the
reference's ``renderer.render`` on the box of make_media_box: a
scene-level fog and a dielectric sphere holding a medium, a grid density
or a homogeneous one. Whole renders draw their own uniforms, so image means
are held within 4 standard errors (channels taken as correlated), as
tests/test_guided_pallas.py holds its pools; a render without the media
must differ by more (the reference's own check, tests/test_guided.py).
The samplers and rfilters keep the independent/box image's mean."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    film_mean_se, make_box, make_media_box, within_se,
)

from sdmm_tpu.render import renderer as jrenderer  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.render import renderer as trenderer  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.scene.sensor import generate_rays  # noqa: E402

torch.set_num_threads(2)


def _stats(out):
    return film_mean_se(out["raw"], out["sqr"], out["weight"])


@pytest.fixture(scope="module")
def reference():
    """The reference's image means of both media boxes, 48 spp."""
    out = {}
    for het in (True, False):
        js, jcfg = make_media_box(jscene, jshapes, hetero=het).build()
        r = jrenderer.render(js, jcfg, spp=48, seed=11, rays_per_wave=256)
        out[het] = _stats({k: np.asarray(r[k])
                           for k in ("raw", "sqr", "weight")})
    return out


def _port(hetero=True):
    return make_media_box(tscene, tshapes, hetero=hetero).build(device="cpu")


@pytest.mark.parametrize("hetero", [True, False], ids=["grid", "homogeneous"])
def test_trace_wave_matches_reference(reference, hetero):
    ts, tcfg = _port(hetero)
    out = trenderer.render(ts, tcfg, spp=64, seed=3, device="cpu")
    assert (out["weight"] == 64).all() and out["pool"] == "scan"
    got = _stats(out)
    assert within_se(got, reference[hetero]), (got, reference[hetero])
    # Without its media the box renders another image.
    vac, vcfg = make_box(tscene, tshapes).build(device="cpu")
    assert not vcfg.has_medium
    bare = _stats(trenderer.render(vac, vcfg, spp=64, seed=3, device="cpu"))
    assert not within_se(bare, got), (bare, got)


def test_render_wavefront_takes_the_wave_renderer(reference):
    ts, tcfg = _port()
    out = twf.render_wavefront(ts, tcfg, spp=32, seed=4, device="cpu")
    assert out["pool"] == "scan" and out["image"].shape == (16, 16, 3)
    assert within_se(_stats(out), reference[True])


def test_media_guided_pool_matches_reference(reference):
    """The eager guided pool on an untrained guide state (every direction
    from the BSDF) carries the lanes' media: its mean is the reference's."""
    ts, tcfg = _port()
    tr = ttrainer.SDMMTrainer(ts, tcfg, ttrainer.TrainerConfig(max_leaves=16),
                              device="cpu")
    out = tguided.render_pool_guided(
        ts, tr.guide_state(), torch.Generator().manual_seed(5), n_lanes=4096,
        spp=64, width=16, height=16, max_depth=tcfg.max_depth,
        rr_depth=tcfg.rr_depth, bsdf_types=tcfg.bsdf_types,
        has_medium=True, has_hetero=True, device="cpu")
    assert float(out["weight"].sum()) == 16 * 16 * 64
    got = _stats({k: out[k].numpy() for k in ("image", "sqr", "weight")}
                 | {"raw": out["image"].numpy()})
    assert within_se(got, reference[True]), (got, reference[True])


def test_trace_wave_guided_matches_reference(reference):
    """The scan tracer on the same untrained state: its image mean is the
    reference's, and it emits valid training vertices with finite
    weights."""
    ts, tcfg = _port()
    tr = ttrainer.SDMMTrainer(ts, tcfg, ttrainer.TrainerConfig(max_leaves=16),
                              device="cpu")
    gs = tr.guide_state()
    gen = torch.Generator().manual_seed(6)
    spp, n_pix = 64, 256
    pix = torch.arange(n_pix * spp) % n_pix
    u = torch.rand((pix.shape[0], 2), generator=gen)
    ro, rd = generate_rays(ts, torch.stack([(pix % 16) + u[:, 0],
                                            (pix // 16) + u[:, 1]], -1),
                           16, 16)
    li, smp = tguided.trace_wave_guided(
        ts, gs, gen, ro, rd, max_depth=tcfg.max_depth,
        rr_depth=tcfg.rr_depth, bsdf_types=tcfg.bsdf_types,
        has_medium=True, has_hetero=True)
    li = torch.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)
    raw = torch.zeros((n_pix, 3)).index_add_(0, pix, li)
    sqr = torch.zeros((n_pix, 3)).index_add_(0, pix, li * li)
    got = film_mean_se(raw.numpy(), sqr.numpy(), np.full(n_pix, spp))
    assert within_se(got, reference[True]), (got, reference[True])
    n = ro.shape[0] * tcfg.max_depth
    assert smp["pos"].shape == (n, 3) and smp["weight"].shape == (n,)
    v = smp["valid"]
    assert v.any() and torch.isfinite(smp["weight"][v]).all()
    assert (smp["weight"][v] >= 0).all() and (smp["weight"][~v] == -1).all()
    assert (smp["terminal"] <= v).all()
    assert 0 < int(smp["n_vertices"]) and int(smp["n_cond_ok"]) == 0


@pytest.mark.parametrize("sampler,rfilter", [
    ("stratified", "box"), ("halton", "box"), ("sobol", "box"),
    ("independent", "tent"), ("independent", "gaussian"),
    ("independent", "mitchell"), ("independent", "catmullrom"),
    ("independent", "lanczos")])
def test_samplers_and_rfilters_keep_the_mean(sampler, rfilter):
    """On the plain box the image mean under each sampler and filter lies
    within 4 standard errors of the independent/box image's."""
    ts, tcfg = make_box(tscene, tshapes).build(device="cpu")
    base = _stats(trenderer.render(ts, tcfg, spp=32, seed=8, device="cpu"))
    out = trenderer.render(ts, tcfg, spp=32, seed=9, sampler=sampler,
                           rfilter=rfilter, device="cpu")
    assert np.isfinite(out["image"]).all()
    if rfilter == "box":
        assert (out["weight"] == 32).all()
    got = _stats(out)
    assert within_se(got, base), (got, base)
