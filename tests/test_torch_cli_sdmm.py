"""The port's command line on the CPU at 16x12 (tests/test_torch_cli.py's
box): ``render --integrator sdmm`` writes the image, stats.json in the
reference's schema and checkpoints/model_NNNNN.asdmm, each equal to what
SDMMTrainer(...).run gives on the same loaded scene and seed; --checkpoint
and --resume continue a render to the uninterrupted image; ``python -m
sdmm_tpu_torch`` runs as a module. The file holds few tests, so that the
tier-1 scheduler (``--dist loadfile``, files with the most tests first)
runs it after the long reference files."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cli import ROOT, _render, box  # noqa: E402,F401

from sdmm_tpu_torch.guiding import io as tio  # noqa: E402
from sdmm_tpu_torch.guiding.trainer import (  # noqa: E402
    SDMMTrainer, TrainerConfig,
)
from sdmm_tpu_torch.scene.xml_loader import load_scene  # noqa: E402
from sdmm_tpu_torch.utils.exr import read_exr  # noqa: E402

torch.set_num_threads(2)


def test_render_sdmm(box, tmp_path):
    out = tmp_path / "sdmm" / "img.exr"
    npy = tmp_path / "film.npy"
    _render(box, out, "--integrator", "sdmm", "--spp", "8", "--npy", str(npy),
            "--dump-iterations")
    builder = load_scene(box)
    scene, cfg = builder.build(device="cpu")
    tr = SDMMTrainer(scene, cfg, TrainerConfig(seed=77), device="cpu")
    want, iters = tr.run(total_spp=8)
    np.testing.assert_array_equal(read_exr(str(out)),
                                  want.astype(np.float32))
    np.testing.assert_array_equal(np.load(npy), want)
    stats = json.loads((out.parent / "stats.json").read_text())
    assert len(stats) == len(tr.stats) == 2
    timed = ("elapsed_seconds", "rendering_seconds", "training_seconds",
             "ttuv")  # wall clock, or a product with it
    for st, ref in zip(stats, tr.stats):
        assert st.keys() == ref.keys()
        assert {k: v for k, v in st.items() if k not in timed} == \
            {k: v for k, v in ref.items() if k not in timed}
    ckpt = out.parent / "checkpoints" / "model_00002.asdmm"
    tree, sdmm, init, meta = tio.load_checkpoint(str(ckpt), device="cpu")
    assert meta["iteration"] == 2 and tree.n_leaves == tr.tree.n_leaves
    for a, b in zip(sdmm, tr.sdmm):
        assert torch.equal(a, b)
    for i, it in enumerate(iters):
        n = np.maximum(it["weight"], 1.0)[:, None]
        np.testing.assert_array_equal(
            read_exr(str(out.parent / f"iteration{i:05d}.exr")),
            (it["image"] / n).reshape(12, 16, 3).astype(np.float32))
        assert (out.parent / f"iteration_sqr{i:05d}.exr").exists()


def test_checkpoint_then_resume(box, tmp_path):
    """--checkpoint writes a full checkpoint at 2 spp (2 spp an
    iteration); --resume continues it to 4 spp; the image equals the
    uninterrupted 4-spp render (both train in the first iteration only)."""
    ck = tmp_path / "full.npz"
    spi = ["--integrator", "sdmm", "--samples-per-iteration", "2"]
    _render(box, tmp_path / "a" / "img.npy", *spi, "--spp", "2",
            "--checkpoint", str(ck))
    assert ck.exists()
    out = tmp_path / "b" / "img.npy"
    _render(box, out, *spi, "--spp", "4", "--resume", str(ck))
    scene, cfg = load_scene(box).build(device="cpu")
    tr = SDMMTrainer(scene, cfg, TrainerConfig(seed=77,
                                               samples_per_iteration=2),
                     device="cpu")
    want, _ = tr.run(total_spp=4)
    np.testing.assert_array_equal(np.load(out), want)
    stats = json.loads((out.parent / "stats.json").read_text())
    assert [st["iteration"] for st in stats] == [0, 1]


def test_module_entry_point(box, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = tmp_path / "m.exr"
    res = subprocess.run(
        [sys.executable, "-m", "sdmm_tpu_torch", "render", box, "-o",
         str(out), "--integrator", "gt", "--spp", "2", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "Rendered" in res.stdout
    assert read_exr(str(out)).shape == (12, 16, 3)
