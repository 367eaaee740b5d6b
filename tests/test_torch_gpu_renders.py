"""The port's paths that run on the card without a kernel of their own,
against the same paths on the CPU: the product pool, the reservoir
update, Irawan's evaluation and classic.trace_field.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerances are stated in each case.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box  # noqa: E402
from torch_gpu_cases import cuda  # noqa: E402,F401

from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


def test_product_pool_on_the_card_matches_the_cpu(cuda):
    """The guided pool with a learned-BSDF table (product lanes, no
    guided_sample launch) on the four-type box: the card's film mean within
    4 standard errors of the CPU's on the same trained guide state."""
    from torch_parity import film_mean_se, within_se

    from sdmm_tpu_torch.guiding import em as tem
    from sdmm_tpu_torch.guiding import trainer as ttrainer
    from sdmm_tpu_torch.render import guided as tguided

    scene, cfg = make_box(tscene, tshapes, 32, 32, extra_bsdfs=True).build(
        device="cpu")
    cfg.max_depth = cfg.rr_depth = 5
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(
        max_leaves=64, split_threshold=2000, train_fraction=1.0,
        sample_product=True, em=tem.EMConfig(batch_size=1024), seed=4),
        device="cpu")
    tr.run(total_spp=20)
    assert int(tr.initialized.sum()) > 0
    gs = tr.guide_state()
    before = gso.guided_sample.launches
    stats = {}
    for dev in ("cpu", "cuda"):
        out = tguided.render_pool_guided(
            scene, gs, torch.Generator(device=dev).manual_seed(3),
            n_lanes=8192, spp=16, width=32, height=32, max_depth=5,
            rr_depth=5, bsdf_types=cfg.bsdf_types or None, device=dev)
        assert int(out["n_product"]) > 0
        stats[dev] = film_mean_se(*(out[k].cpu().numpy()
                                    for k in ("image", "sqr", "weight")))
    assert gso.guided_sample.launches == before
    assert within_se(stats["cuda"], stats["cpu"]), stats


def test_reservoir_update_on_the_card_equals_the_cpu(cuda):
    """reservoir_update on CUDA tensors equals the CPU's on the same batch
    and uniforms (the compaction's stable sort included)."""
    from sdmm_tpu_torch.guiding import reservoir as tres

    rs = np.random.RandomState(0)
    cap, n = 4096, 6000
    res = {d: tres.make_reservoir(cap, d) for d in ("cpu", "cuda")}
    for step in range(3):
        pos = rs.rand(n, 3).astype(np.float32)
        d = rs.randn(n, 3).astype(np.float32)
        w = (rs.rand(n) * 5).astype(np.float32)
        valid = rs.rand(n) < 0.9
        u = rs.rand(cap + n).astype(np.float32)
        for dev in res:
            t = [torch.as_tensor(a, device=dev) for a in (pos, d, w, valid,
                                                         u)]
            res[dev] = tres.reservoir_update(res[dev], *t, cap, 0.5)
        for k, v in res["cpu"].items():
            got = res["cuda"][k].cpu()
            if v.dtype == torch.bool:
                assert torch.equal(got, v), k
            else:
                torch.testing.assert_close(got, v, rtol=1e-6, atol=1e-7)


def test_irawan_on_the_card_equals_the_cpu(cuda):
    """eval_irawan on CUDA tensors equals the CPU's on the same lanes: in
    float64 on every lane (rtol 1e-5 / atol 1e-6), and in float32 (the
    same, or on an ill-conditioned lane no further than twice the CPU's
    own float32 error against float64: irawan.float32_disagreement) on all
    but 4 of the 2^18 lanes (one H100: 4, ill-conditioned lanes where the
    two devices' float32 roundings fall apart; irawan.ulp_sensitivity)."""
    from torch_parity import TEST_WEAVE, TEST_WEAVE_PARAMS

    from sdmm_tpu_torch.bsdf import irawan as tirawan

    tab = tirawan.build_tables(tirawan.parse_weave(TEST_WEAVE,
                                                   TEST_WEAVE_PARAMS))
    g = torch.Generator().manual_seed(9)
    n = 1 << 18
    uv = torch.rand((n, 2), generator=g) * 4.0 - 1.5
    wi, wo = (torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g) * torch.tensor([1.0, 1.0, 0.5])
        + torch.tensor([0.0, 0.0, 0.6]), dim=-1) for _ in range(2))
    out = {}
    for name, d, dt in (("cpu", "cpu", torch.float32),
                        ("cuda", "cuda", torch.float32),
                        ("cpu64", "cpu", torch.float64),
                        ("cuda64", "cuda", torch.float64)):
        t = {k: torch.as_tensor(v, device=d) for k, v in tab.items()}
        t = {k: v.to(dt) if v.is_floating_point() else v for k, v in t.items()}
        out[name] = tirawan.eval_irawan(
            t, *(x.to(d, dt) for x in (uv, wi, wo))).cpu().numpy()
    np.testing.assert_allclose(out["cuda64"], out["cpu64"], rtol=1e-5,
                               atol=1e-6)
    off, sens = tirawan.lanes_off(
        {k: torch.as_tensor(v) for k, v in tab.items()}, uv, wi, wo,
        out["cuda"], out["cpu"], out["cpu64"])
    assert len(off) <= 4, (off, sens, out["cuda"][off], out["cpu"][off],
                           out["cpu64"][off])
    assert (out["cpu"] > 0).mean() > 0.5


def test_trace_field_on_the_card_equals_the_cpu(cuda):
    """Every field of classic.trace_field on the card equals the CPU's on
    the same camera rays (rtol 1e-5, atol 1e-5), the hit ids exactly."""
    from sdmm_tpu_torch.render import classic
    from sdmm_tpu_torch.scene.sensor import generate_rays

    scene, cfg = make_box(tscene, tshapes, 64, 48).build(device="cpu")
    g = torch.Generator().manual_seed(2)
    idx = torch.arange(64 * 48)
    pix = torch.stack([idx % 64, idx // 64], -1).float() + torch.rand(
        (idx.numel(), 2), generator=g)
    ro, rd = generate_rays(scene, pix, 64, 48)
    for field in classic.FIELDS:
        got = {d: classic.trace_field(scene, None, ro, rd, field=field,
                                      bsdf_types=cfg.bsdf_types,
                                      device=d).cpu()
               for d in ("cpu", "cuda")}
        if field in ("shapeIndex", "primIndex"):
            assert torch.equal(got["cuda"], got["cpu"]), field
        torch.testing.assert_close(got["cuda"], got["cpu"], rtol=1e-5,
                                   atol=1e-5, msg=field)
