"""Port parity of the slice as a whole on a scene above 1024 triangles:
on tests/test_clas_pallas.py's sphere scene (2,172 triangles) at 16 x 16,
``render_wavefront`` takes the eager pool through the cluster twin, lands
exactly spp samples on every pixel and agrees with the reference's
``render_pool`` at 64 spp in image mean within 5% (the bound of
tests/test_torch_wavefront.py; the reference renders in a background
thread); ``SDMMTrainer.run`` at 8 spp runs to its end through the cluster
twin. A file of few tests, so that the tier-1 scheduler (``--dist
loadfile``, files with the most tests first) runs it after the long
reference files.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_sphere_box  # noqa: E402

from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W = H = 16
SPP = 64


def _reference_pool():
    js, cfg = make_sphere_box(jscene, jshapes, W, H).build()
    out = jwf.render_pool(js, jax.random.PRNGKey(5), n_lanes=4096, spp=SPP,
                          width=W, height=H, max_depth=cfg.max_depth,
                          rr_depth=cfg.rr_depth, nee=True,
                          bsdf_types=cfg.bsdf_types)
    assert (np.asarray(out["weight"]) == SPP).all()
    img = np.asarray(out["image"]) / np.asarray(out["weight"])[:, None]
    return float(img.mean())


@pytest.fixture(scope="module", autouse=True)
def _reference_runs():
    """Starts the reference's render at the top of the module, so that its
    compile overlaps the port's tests."""
    with ThreadPoolExecutor(1) as ex:
        yield {"pool": ex.submit(_reference_pool)}


def _sphere_scene():
    return make_sphere_box(tscene, tshapes, W, H).build(device="cpu")


def test_render_wavefront_above_1024_triangles(_reference_runs, monkeypatch):
    ts, cfg = _sphere_scene()
    assert ts.tri_v0.shape[0] > tisect.BRUTE_FORCE_MAX
    calls = []
    plain = clas_cull.cull_plain
    monkeypatch.setattr(clas_cull, "cull_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = twf.render_wavefront(ts, cfg, spp=SPP, seed=2, n_lanes=4096,
                               device="cpu")
    assert out["pool"] == "eager" and len(calls) == 2 * out["steps"]
    np.testing.assert_array_equal(out["weight"], SPP)
    assert np.isfinite(out["image"]).all()
    m_t, m_j = float(out["image"].mean()), _reference_runs["pool"].result()
    assert abs(m_t - m_j) / m_j < 0.05, (m_t, m_j)


def test_trainer_runs_above_1024_triangles(monkeypatch):
    ts, cfg = _sphere_scene()
    calls = []
    plain = clas_cull.cull_plain
    monkeypatch.setattr(clas_cull, "cull_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tr = ttrainer.SDMMTrainer(
        ts, cfg, ttrainer.TrainerConfig(max_leaves=64, rays_per_wave=1024),
        device="cpu")
    img, iters = tr.run(total_spp=8)
    assert len(calls) > 0 and len(iters) == len(tr.stats) > 0
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.mean() > 0
