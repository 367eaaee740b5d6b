"""The schedulers, the K != 16 route and the intersectors that no entry
point reaches by default, on the card: the four bounce pools (row 6's
kernel) and the guided sorted2 and striped pools (rows 3-4) against the
eager pools in expectation (4 joint standard errors), each launching its
kernels; a K = 8 trainer that launches neither guided_sample nor the
E-step kernels and keeps its statistics finite; the BVH and the round
loop against clas_cull on the card (hit ids equal but on equal-distance
ties, occluded equal).

These cases need a CUDA device and skip elsewhere; the file imports no
JAX:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    film_mean_se, make_box, make_sphere_box, make_tiled_box, within_se,
)
from torch_gpu_cases import card_rays, cuda  # noqa: E402,F401

from sdmm_tpu_torch.guiding.trainer import (  # noqa: E402
    SDMMTrainer, TrainerConfig,
)
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.ops import em_suffstats as ems  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from sdmm_tpu_torch.ops import guided_step as gst  # noqa: E402
from sdmm_tpu_torch.render import bvh, clas  # noqa: E402
from sdmm_tpu_torch.render import guided as tg  # noqa: E402
from sdmm_tpu_torch.render import wavefront as wf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


def _mean_se(out):
    return film_mean_se(*(out[k].cpu().numpy()
                          for k in ("image", "sqr", "weight")))


def test_bounce_pools_on_the_card(cuda):
    scene, cfg = make_tiled_box(tscene, tshapes, 64, 48).build(device=cuda)
    kw = dict(spp=8, width=64, height=48, max_depth=cfg.max_depth,
              rr_depth=cfg.rr_depth, fov_axis=cfg.fov_axis, device=cuda)
    ref = _mean_se(wf.render_pool(
        scene, torch.Generator(device=cuda).manual_seed(0), n_lanes=8192,
        bsdf_types=cfg.bsdf_types, **kw))
    kw["bsdf_types"] = tuple(cfg.bsdf_types)
    for fn, extra in ((wf.render_pool_fused, dict(n_lanes=8192)),
                      (wf.render_pool_fused_blocked, {}),
                      (wf.render_pool_fused_sorted, dict(spp_pilot=2)),
                      (wf.render_pool_fused_shuffled, dict(groups=2))):
        bo.bounce.launches = 0
        out = fn(scene, 5, **kw, **extra)
        assert bo.bounce.launches > 0, fn.__name__
        assert float(out["weight"].min()) == float(out["weight"].max()) == 8
        got = _mean_se(out)
        assert within_se(got, ref), (fn.__name__, got, ref)


def test_guided_pools_and_k8_on_the_card(cuda):
    scene, cfg = make_box(tscene, tshapes, 32, 32).build(device=cuda)
    tr = SDMMTrainer(scene, cfg, TrainerConfig(max_leaves=64), device=cuda)
    tr.run(16)
    gs = tr.guide_state()
    kw = dict(spp=16, width=32, height=32, max_depth=cfg.max_depth,
              rr_depth=cfg.rr_depth, bsdf_fraction=0.5,
              fov_axis=cfg.fov_axis, device=cuda)
    ref = _mean_se(tg.render_pool_guided(
        scene, gs, torch.Generator(device=cuda).manual_seed(1),
        n_lanes=8192, bsdf_types=cfg.bsdf_types, **kw))
    kw["bsdf_types"] = tuple(cfg.bsdf_types)
    for fn, extra in ((tg.render_pool_guided_sorted2, dict(spp_pilot=4)),
                      (tg.render_pool_guided_striped, {})):
        gst.trace.launches = gst.shade.launches = 0
        out = fn(scene, gs, torch.Generator(device=cuda).manual_seed(2),
                 **kw, **extra)
        assert gst.trace.launches > 0 and gst.shade.launches > 0
        got = _mean_se(out)
        assert within_se(got, ref), (fn.__name__, got, ref)
    # K = 8: the mixture route and the E-step twin's math on the card.
    gso.guided_sample.launches = ems.suffstats.launches = 0
    tr8 = SDMMTrainer(scene, cfg, TrainerConfig(n_components=8,
                                                max_leaves=64), device=cuda)
    img, _ = tr8.run(16)
    assert gso.guided_sample.launches == 0 and ems.suffstats.launches == 0
    assert int(tr8.initialized.sum()) > 0 and np.isfinite(img).all()
    assert not torch.isnan(tr8.em.stats_w).any()


def test_bvh_and_round_loop_against_clas_cull(cuda):
    scene, _ = make_sphere_box(tscene, tshapes).build(device=cuda)
    ro, rd, _ = card_rays(cuda, scene, 1 << 14, 3)
    inf = torch.full((ro.shape[0],), 3.4e38, device=cuda)
    base = clas_cull.intersect(scene, ro, rd, inf)
    for h in (bvh.traverse(scene, ro, rd), clas.intersect(scene, ro, rd)):
        assert torch.equal(h["valid"], base["valid"])
        diff = h["tri"] != base["tri"]
        tie = (h["t"] - base["t"]).abs() <= 1e-6 * base["t"].abs()
        assert not bool((diff & ~tie).any())
    tm = torch.full_like(inf, 1.5)
    occ = clas_cull.occluded(scene, ro, rd, tm)
    assert torch.equal(bvh.traverse(scene, ro, rd, tm, any_hit=True), occ)
    assert torch.equal(clas.occluded(scene, ro, rd, tm), occ)
