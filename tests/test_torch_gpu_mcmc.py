"""The PSS measurement of PSSMLT and ERPT and the irradiance cache's
interpolation on the card, against the same calls on the CPU.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

- pssmlt.eval_path on 16,384 equal PSS vectors at depth 6 on the box with
  a conductor, a dielectric and a rough-conductor cube (mt_sweep on the
  card): pix equal on every lane, value within 1e-4 relative (atol 1e-6)
  on all but EVAL_PATH_OFF_LANES lanes;
- irrcache.interpolate over one cache built on the CPU, at 4,096 first
  hits: within rtol 1e-5 / atol 1e-7, covered equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box  # noqa: E402
from torch_gpu_cases import cuda  # noqa: E402,F401

from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu

# Lanes whose value may leave 1e-4 relative between the card and the CPU
# (16 of the 16,384 on the H100): float32 rounding that differs between
# the devices moves a path's later vertices, and the specular and rough
# bounces of a depth-6 walk on the glossy box amplify it.
EVAL_PATH_OFF_LANES = 16


def _scene(size=16):
    scene, cfg = make_box(tscene, tshapes, size, size,
                          extra_bsdfs=True).build(device="cpu")
    cfg.max_depth = cfg.rr_depth = 6
    return scene, cfg


def test_eval_path_on_the_card_matches_the_cpu(cuda):
    from sdmm_tpu_torch.ops import intersect_sweep as isweep
    from sdmm_tpu_torch.render import pssmlt

    scene, cfg = _scene()
    u = torch.rand((1 << 14, pssmlt.pss_dims(6)),
                   generator=torch.Generator().manual_seed(5))
    out = {}
    before = isweep.mt_sweep.launches
    for dev in ("cpu", "cuda"):
        out[dev] = {k: v.cpu() for k, v in pssmlt.eval_path(
            scene, u, 16, 16, max_depth=6, bsdf_types=cfg.bsdf_types,
            device=dev).items()}
    assert isweep.mt_sweep.launches > before
    assert torch.equal(out["cpu"]["pix"], out["cuda"]["pix"])
    a, b = out["cuda"]["value"], out["cpu"]["value"]
    off = ((a - b).abs() > 1e-6 + 1e-4 * b.abs()).any(-1)
    print(f"eval_path: {int(off.sum())} of {off.numel()} lanes off")
    assert int(off.sum()) <= EVAL_PATH_OFF_LANES, int(off.sum())
    assert (b.sum(-1) > 0).float().mean() > 0.5


def test_interpolate_on_the_card_matches_the_cpu(cuda, monkeypatch):
    from sdmm_tpu_torch.render import intersect as isect
    from sdmm_tpu_torch.render import irrcache
    from sdmm_tpu_torch.scene.sensor import generate_rays

    monkeypatch.setattr(irrcache, "TABLE", 1024)
    scene, cfg = _scene(32)
    cache = irrcache.build_cache(scene, torch.Generator().manual_seed(1), 32,
                                 32, grid_res=16, gather_res=4,
                                 bsdf_types=cfg.bsdf_types, max_depth=4,
                                 n_candidates=1 << 13, device="cpu")
    pix = torch.rand((4096, 2), generator=torch.Generator().manual_seed(2)
                     ) * 32
    ro, rd = generate_rays(scene, pix, 32, 32)
    it = isect.surface_interaction(scene, ro, rd,
                                   isect.intersect(scene, ro, rd))
    want = irrcache.interpolate(cache, scene, it["p"], it["ns"], 16)
    dev = torch.device("cuda")
    got = irrcache.interpolate({k: v.to(dev) for k, v in cache.items()},
                               tscene.scene_to(scene, dev), it["p"].to(dev),
                               it["ns"].to(dev), 16)
    assert torch.equal(got[1].cpu(), want[1])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-7)
    assert want[1].float().mean() > 0.7
