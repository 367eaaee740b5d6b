"""The port trainer's collected training samples (the guided pool on the
state carried across from the reference's optimize: the ``trained``
fixture of tests/test_torch_trainer.py) are consistent, and images above
SCAN_PIXELS take the scan tracer in every iteration. The file holds few tests, so that the tier-1
scheduler (``--dist loadfile``, files with the most tests first) runs it
after the long reference files."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import H, W, _trainers, trained  # noqa: E402,F401
from torch_parity import to_np  # noqa: E402

from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402

torch.set_num_threads(2)


def test_collected_training_samples_are_consistent(trained):
    _, tt, _, _ = trained
    out = tguided.render_pool_guided(
        tt.scene, tt.guide_state(), torch.Generator().manual_seed(5),
        n_lanes=512, spp=4, width=W, height=H, max_depth=4, rr_depth=4,
        collect_cap=4096, device="cpu")
    s = out["samples"]
    v = to_np(s["valid"])
    assert 0 < v.sum() <= int(out["n_emitted"])
    assert (to_np(s["weight"])[v] >= 0).all()
    assert (to_np(s["weight"])[~v] == -1.0).all()
    assert to_np(s["terminal"])[v].sum() <= W * H * 4  # ≤ 1 per path
    assert not to_np(s["terminal"])[~v].any()


def test_images_above_the_pool_limit_take_the_scan(monkeypatch):
    """Above SCAN_PIXELS (2^20, lowered here) every iteration, training
    and frozen, takes the scan tracer and never the pool."""
    def no_pool(*a, **k):
        raise AssertionError("the lane pool ran")

    monkeypatch.setattr(ttrainer, "SCAN_PIXELS", W * H - 1)
    monkeypatch.setattr(ttrainer, "render_pool_guided", no_pool)
    _, tt = _trainers(train_fraction=0.5)
    img, iters = tt.run(total_spp=16)
    assert len(iters) == 2 and np.isfinite(img).all() and img.mean() > 0
    assert tt.stats[0]["optimized_nodes_count"] > 0
    assert (iters[1]["weight"] == 8).all()
