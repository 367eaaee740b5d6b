"""Port parity of whole renders on the materials and lights of the scene
files: chip_smoke.write_features_xml's scenes at 16x16, with a cube in the
sphere's place (48 triangles), loaded by each package's own loader (their
SceneData are equal, tests/test_torch_xml.py).

- The eager NEE pool, render_pool, on features_lit.xml (every BSDF type a
  scene file names, bitmap and procedural textures, bump maps, point, spot
  and directional lights, the sunsky env map) at 64 spp, depth 5, against
  the reference's: image means within 5% (the bound of
  tests/test_torch_wavefront.py), and each 4x4 block's mean within 5
  combined standard errors (from each film's sqr and weight).
- SDMMTrainer.run on features.xml (no delta light, no bump; the EXR env
  map) at 16 spp, two training iterations of 8, depth 4, against the
  reference's: image means within 10% (the bound of
  tests/test_torch_trainer.py).

Renders draw their own random numbers (JAX threefry, torch Philox), so they
agree in expectation. The reference's compiles run in background threads
while the port renders.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import write_features_xml  # noqa: E402
from torch_parity import to_np  # noqa: E402

from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.guiding import trainer as jtrainer  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.scene import xml_loader as jxml  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import xml_loader as txml  # noqa: E402

torch.set_num_threads(2)
W = H = 16
SPP = 64
MAX_DEPTH = 5


def _scenes(tmp, lit):
    path = write_features_xml(str(tmp), W, H, SPP, lit=lit, sphere=False)
    return jxml.load_scene(path).build(), \
        txml.load_scene(path).build(device="cpu")


def _film(image, sqr, weight):
    """Per-pixel mean and variance of the mean, [H, W, 3] each."""
    n = np.maximum(np.asarray(weight), 1.0)[:, None]
    mean = np.asarray(image) / n
    var = np.maximum(np.asarray(sqr) / n - mean * mean, 0.0) / n
    return mean.reshape(H, W, 3), var.reshape(H, W, 3)


def _reference_pool(js, jcfg):
    out = jwf.render_pool(js, jax.random.PRNGKey(4), n_lanes=4096, spp=SPP,
                          width=W, height=H, max_depth=MAX_DEPTH,
                          rr_depth=MAX_DEPTH, nee=True,
                          bsdf_types=jcfg.bsdf_types, has_bump=jcfg.has_bump)
    assert (np.asarray(out["weight"]) == SPP).all()
    return _film(out["image"], out["sqr"], out["weight"])


def _trainer_cfgs():
    common = dict(max_leaves=16, samples_per_iteration=8, rays_per_wave=1024,
                  train_fraction=1.0)
    return (jtrainer.TrainerConfig(em=jem.EMConfig(batch_size=256), **common),
            ttrainer.TrainerConfig(em=tem.EMConfig(batch_size=256), **common))


def _reference_training(js, jcfg):
    jcfg.max_depth = jcfg.rr_depth = 4
    jt = jtrainer.SDMMTrainer(js, jcfg, _trainer_cfgs()[0])
    img, _ = jt.run(total_spp=16)
    return np.asarray(img), jt.stats


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("features")
    return {lit: _scenes(tmp, lit) for lit in (False, True)}


@pytest.fixture(scope="module")
def reference(scenes):
    """The reference's pool and training run, started at the top of the
    module so that their compiles overlap the port's renders."""
    with ThreadPoolExecutor(2) as ex:
        yield {"pool": ex.submit(_reference_pool, *scenes[True][0]),
               "train": ex.submit(_reference_training, *scenes[False][0])}


def test_scenes_carry_the_features(scenes):
    (_, jcfg), (ts, tcfg) = scenes[True]
    assert tcfg.bsdf_types == jcfg.bsdf_types == (
        0, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 17)
    assert tcfg.has_bump and ts.pt_pos.shape[0] == 3
    assert ts.env_pdf.shape[0] > 1 and ts.textures.shape[1] > 1
    assert ts.proc_tex.shape[0] == 5 and ts.tri_vc.shape[0] > 0
    (_, _), (ts_a, tcfg_a) = scenes[False]
    assert not tcfg_a.has_bump and ts_a.pt_pos.shape[0] == 0
    for s, c in ((ts, tcfg), (ts_a, tcfg_a)):
        assert not twf.fused_supported(s, c)


def test_render_pool_matches_reference_on_every_feature(scenes, reference):
    (_, _), (ts, tcfg) = scenes[True]
    out = twf.render_pool(ts, torch.Generator().manual_seed(4), 4096, SPP,
                          W, H, MAX_DEPTH, MAX_DEPTH, True, tcfg.bsdf_types,
                          has_bump=True, device="cpu")
    assert out["pool"] == "eager" and (to_np(out["weight"]) == SPP).all()
    m_t, v_t = _film(to_np(out["image"]), to_np(out["sqr"]),
                     to_np(out["weight"]))
    m_j, v_j = reference["pool"].result()
    assert np.isfinite(m_t).all() and (m_t >= 0).all()
    assert abs(m_t.mean() - m_j.mean()) / m_j.mean() < 0.05, (
        m_t.mean(), m_j.mean())

    def blocks(a):
        return a.reshape(H // 4, 4, W // 4, 4, 3).mean(axis=(1, 3, 4))

    # The variance of a block's mean over its 48 pixel-channels.
    se = np.sqrt((blocks(v_t) + blocks(v_j)) / 48.0)
    z = np.abs(blocks(m_t) - blocks(m_j)) / np.maximum(se, 1e-12)
    assert z.max() < 5.0, (z.max(), blocks(m_t), blocks(m_j))


def test_training_run_matches_reference_on_textured_scene(scenes, reference):
    (_, _), (ts, tcfg) = scenes[False]
    tcfg.max_depth = tcfg.rr_depth = 4
    tt = ttrainer.SDMMTrainer(ts, tcfg, _trainer_cfgs()[1], device="cpu")
    img_t, _ = tt.run(total_spp=16)
    img_j, stats_j = reference["train"].result()
    assert len(tt.stats) == len(stats_j) == 2 and np.isfinite(img_t).all()
    assert [st["leaf_nodes_count"] for st in tt.stats] == \
        [st["leaf_nodes_count"] for st in stats_j]
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 0.1, (
        img_t.mean(), img_j.mean())
