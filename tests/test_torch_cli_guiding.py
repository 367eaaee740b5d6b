"""The port's command line on the CPU at 16x12 (tests/test_torch_cli.py's
box): ``--integrator ppg`` gives PPGTrainer's image and per-iteration
stats, and -D reservoirCapacity and -D optimizeAsync reach TrainerConfig
(the image equals SDMMTrainer's with the option). The file holds few
tests, so that the tier-1 scheduler (``--dist loadfile``, files with the
most tests first) runs it after the long reference files."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cli import _render, box  # noqa: E402,F401

from sdmm_tpu_torch.guiding.trainer import (  # noqa: E402
    SDMMTrainer, TrainerConfig,
)
from sdmm_tpu_torch.scene.xml_loader import load_scene  # noqa: E402

torch.set_num_threads(2)


def test_render_ppg(box, tmp_path):
    """--integrator ppg: PPGTrainer's budget-doubling render (1 + 2 + 1
    spp), stats.json its per-iteration stats."""
    from sdmm_tpu_torch.guiding.ppg import PPGConfig, PPGTrainer

    out = tmp_path / "ppg" / "img.npy"
    _render(box, out, "--integrator", "ppg", "--spp", "4")
    scene, cfg = load_scene(box).build(device="cpu")
    tr = PPGTrainer(scene, cfg, PPGConfig(seed=77), device="cpu")
    want, iters = tr.run(total_spp=4)
    assert [it["spp"] for it in iters] == [1, 2, 1]
    np.testing.assert_array_equal(np.load(out), want)
    stats = json.loads((out.parent / "stats.json").read_text())
    assert [{k: v for k, v in st.items() if k != "seconds"} for st in stats] \
        == [{k: v for k, v in st.items() if k != "seconds"}
            for st in tr.stats]


@pytest.mark.parametrize("define,option,spp", [
    ("reservoirCapacity=64", {"reservoir_capacity": 64}, 4),
    ("optimizeAsync=true", {"optimize_async": True}, 8)],
    ids=["reservoir", "async"])
def test_render_sdmm_options(box, tmp_path, define, option, spp):
    """-D reservoirCapacity and -D optimizeAsync reach TrainerConfig: the
    image equals SDMMTrainer's with the option (the reservoir fills in the
    first iteration's optimize; the async EM is adopted in the second)."""
    out = tmp_path / "opt" / "img.npy"
    _render(box, out, "--integrator", "sdmm", "--spp", str(spp), "-D",
            define)
    scene, cfg = load_scene(box).build(device="cpu")
    tr = SDMMTrainer(scene, cfg, TrainerConfig(seed=77, **option),
                     device="cpu")
    want, _ = tr.run(total_spp=spp)
    np.testing.assert_array_equal(np.load(out), want)
    if tr.reservoir is not None:
        assert int(tr.reservoir["valid"].sum()) > 0
