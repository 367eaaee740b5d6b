"""Port parity of short training runs, sdmm_tpu_torch vs sdmm_tpu on the
box scene of tests/test_render.py (tests/test_torch_trainer.py's
trainers): the pooled training and the scan tracer's (pooled_training=
False), 24 spp each. Renders use different random streams (JAX threefry,
torch Philox), so they agree in expectation: image means within 10% (the
seed-to-seed spread of either pool at 16 spp on 16x16 pixels is ~5%). The
reference's runs start in a background thread at the top of the module;
the file holds few tests, so that the tier-1 scheduler (``--dist
loadfile``, files with the most tests first) runs it after the long
reference files."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import _trainers  # noqa: E402

torch.set_num_threads(2)
RUNS = {"pooled": {}, "scan": {"pooled_training": False}}


def _reference_runs():
    out = {}
    for name, kw in RUNS.items():
        jt, _ = _trainers(train_fraction=0.5, **kw)
        img, _ = jt.run(total_spp=24)
        out[name] = (np.asarray(img), jt.stats)
    return out


@pytest.fixture(scope="module")
def reference():
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference_runs)


def test_short_training_run_matches_reference_in_mean(reference):
    _, tt = _trainers(train_fraction=0.5)
    img_t, _ = tt.run(total_spp=24)
    img_j, stats_j = reference.result()["pooled"]
    assert len(tt.stats) == len(stats_j) == 3
    assert set(tt.stats[-1]) == set(stats_j[-1])  # same stats schema
    assert [s["optimized_nodes_count"] > 0 for s in tt.stats] == \
        [s["optimized_nodes_count"] > 0 for s in stats_j]
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 0.1, (
        img_t.mean(), img_j.mean())


def test_scan_training_run_matches_reference_in_mean(reference):
    """pooled_training=False: both trainers collect their training vertices
    with the scan tracer (trace_wave_guided) and then render the frozen
    tail on the pool; the images agree in mean as above."""
    _, tt = _trainers(train_fraction=0.5, pooled_training=False)
    img_t, _ = tt.run(total_spp=24)
    img_j, stats_j = reference.result()["scan"]
    assert [s["optimized_nodes_count"] > 0 for s in tt.stats] == \
        [s["optimized_nodes_count"] > 0 for s in stats_j] == \
        [True, True, False]
    assert tt.stats[0]["samples_count"] > 0
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 0.1, (
        img_t.mean(), img_j.mean())
