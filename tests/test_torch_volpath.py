"""Port parity: the volumetric path (sdmm_tpu_torch/render/volpath.py
``trace_wave`` through ``renderer.render``, and ``render_wavefront``'s
media route) against the reference's ``renderer.render`` on the box of
make_media_box: a scene-level fog and a dielectric sphere holding a
medium, a grid density or a homogeneous one. Whole renders draw their own
uniforms, so image means are held within 4 standard errors (channels taken
as correlated), as tests/test_guided_pallas.py holds its pools; a render
without the media must differ by more (the reference's own check,
tests/test_guided.py). The media guided pool and ``trace_wave_guided``
are held in tests/test_torch_volpath_guided.py, the samplers and rfilters
in tests/test_torch_sampler.py: this file and that one hold few tests, so
that the tier-1 scheduler (``--dist loadfile``, files with the most tests
first) runs them after the long reference files."""

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
from sdmm_tpu_torch.render import renderer as trenderer  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)


def _stats(out):
    return film_mean_se(out["raw"], out["sqr"], out["weight"])


def reference_means(hetero):
    """The reference's image mean of a media box, 48 spp."""
    js, jcfg = make_media_box(jscene, jshapes, hetero=hetero).build()
    r = jrenderer.render(js, jcfg, spp=48, seed=11, rays_per_wave=256)
    return _stats({k: np.asarray(r[k]) for k in ("raw", "sqr", "weight")})


@pytest.fixture(scope="module")
def reference():
    """The reference's image means of both media boxes."""
    return {het: reference_means(het) for het in (True, False)}


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
