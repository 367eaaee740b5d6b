"""Port parity of the media guided pool and ``trace_wave_guided``
(sdmm_tpu_torch/render/guided.py) against the reference's
``renderer.render`` on the grid-density box of make_media_box, on an
untrained guide state (every direction from the BSDF): image means within
4 standard errors, as tests/test_torch_volpath.py holds ``trace_wave``.
The file holds few tests, so that the tier-1 scheduler (``--dist
loadfile``, files with the most tests first) runs it after the long
reference files."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_volpath import _port, _stats, reference_means  # noqa: E402
from torch_parity import film_mean_se, within_se  # noqa: E402

from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.scene.sensor import generate_rays  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    """The reference's image mean of the grid-density box, under the key
    True as in tests/test_torch_volpath.py."""
    return {True: reference_means(True)}


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
