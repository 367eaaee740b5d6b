"""The light-path slice as a whole: the port's ptracer, vpl, bdpt,
photonmapper and sppm images of the box of torch_parity.make_box (64x64)
against the reference's path-traced image of the same scene
(sdmm_tpu.render.renderer.render at 128 spp, computed once in a background
thread), in the reference tests' own bands (tests/test_ptracer.py,
tests/test_bdpt.py, tests/test_photonmap.py):

- ptracer: the image mean within 4%, each of 4x4 blocks within 15%; vpl:
  within 25%, and above the port's direct-only render (classic.trace_direct)
  by 2%;
- bdpt: within 5%, and within 7% on the box with a mirror and a glass
  sphere (coarse spheres, 460 triangles);
- photonmapper: the ratio in [0.90, 1.06]; sppm: in [0.88, 1.10], with the
  mean r² below 0.95 of the initial one. Both against the path tracer at
  depth 8, as their walks run past the box's depth 5.

Renders draw their own random numbers, so they agree only in expectation;
the image is 64x64 so that the light's edge pixels, whose coverage noise
dominates a small image's mean, weigh little.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box  # noqa: E402

from sdmm_tpu.render import renderer as jrenderer  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.render import bdpt as tbd  # noqa: E402
from sdmm_tpu_torch.render import classic as tclassic  # noqa: E402
from sdmm_tpu_torch.render import photonmap as tpm  # noqa: E402
from sdmm_tpu_torch.render import ptracer as tpt  # noqa: E402
from sdmm_tpu_torch.render import renderer as trenderer  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W = H = 64


def delta_box(scene_mod, shapes_mod):
    """The box with a mirror and a glass sphere of tests/test_bdpt.py, the
    spheres coarse (8 x 16 quads)."""
    b = make_box(scene_mod, shapes_mod, W, H)
    mirror = b.add_bsdf(scene_mod.BSDF_CONDUCTOR, albedo=[0.9, 0.9, 0.9])
    glass = b.add_bsdf(scene_mod.BSDF_DIELECTRIC, eta=1.5)
    for c, r, bsdf in (([-0.45, 0.4, 0.2], 0.35, mirror),
                       ([0.5, 0.35, -0.1], 0.3, glass)):
        b.add_shape(shapes_mod.make_sphere(np.array(c), r, np.eye(4),
                                           n_theta=8, n_phi=16), bsdf)
    return b


def _reference():
    out = {}
    for name, b, depth in (
            ("box", make_box(jscene, jshapes, W, H), 5),
            ("box8", make_box(jscene, jshapes, W, H), 8),
            ("delta", delta_box(jscene, jshapes), 5)):
        scene, cfg = b.build()
        cfg.max_depth = cfg.rr_depth = depth
        out[name] = np.asarray(jrenderer.render(scene, cfg, spp=128,
                                                seed=1)["image"])
    return out


@pytest.fixture(scope="module")
def reference():
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference)


@pytest.fixture(scope="module")
def box():
    return make_box(tscene, tshapes, W, H).build(device="cpu")


def _blocks(img):
    return img.reshape(4, H // 4, 4, W // 4, 3).mean((1, 3, 4))


def test_ptracer_and_vpl_match_the_path_tracer(box, reference):
    scene, cfg = box
    img = tpt.render_ptracer(scene, cfg, spp=16, seed=2,
                             device="cpu")["image"]
    vpl = tpt.render_vpl(scene, cfg, spp=1, seed=2, n_light_paths=64,
                         vpl_depth=3, device="cpu")["image"]

    def trace(s, g, ro, rd):
        return tclassic.trace_direct(s, g, ro, rd,
                                     bsdf_types=cfg.bsdf_types, device="cpu")

    direct = trenderer.render(scene, cfg, spp=2, seed=2, trace_fn=trace,
                              device="cpu")["image"]
    want = reference.result()["box"]
    assert np.isfinite(img).all() and np.isfinite(vpl).all()
    assert abs(img.mean() / want.mean() - 1.0) < 0.04, (img.mean(),
                                                        want.mean())
    ratio = _blocks(img) / _blocks(want)
    assert np.all(np.abs(ratio - 1.0) < 0.15), ratio
    # The clamped geometry term biases VPL: within 25%, and more energy
    # than direct light alone.
    assert abs(vpl.mean() / want.mean() - 1.0) < 0.25, (vpl.mean(),
                                                        want.mean())
    assert vpl.mean() > 1.02 * direct.mean(), (vpl.mean(), direct.mean())


def test_bdpt_matches_the_path_tracer(box, reference):
    scene, cfg = box
    img = tbd.render_bdpt(scene, cfg, spp=8, seed=3, device="cpu")["image"]
    want = reference.result()
    assert np.isfinite(img).all() and (img >= 0).all()
    ratio = img.mean() / want["box"].mean()
    assert abs(ratio - 1.0) < 0.05, ratio
    scene, cfg = delta_box(tscene, tshapes).build(device="cpu")
    assert cfg.bsdf_types == (0, 1, 2)
    img = tbd.render_bdpt(scene, cfg, spp=4, seed=3, device="cpu")["image"]
    ratio = img.mean() / want["delta"].mean()
    assert abs(ratio - 1.0) < 0.07, ratio


def test_photon_maps_match_the_path_tracer(box, reference):
    scene, cfg = box
    pm = tpm.render_photonmap(scene, cfg, spp=4, seed=4,
                              n_photon_paths=1 << 16, device="cpu")["image"]
    sppm = tpm.render_sppm(scene, cfg, iterations=6, seed=4,
                           photon_paths_per_iter=1 << 14, device="cpu")
    want = reference.result()["box8"].mean()
    assert np.isfinite(pm).all() and np.isfinite(sppm["image"]).all()
    assert 0.90 < pm.mean() / want < 1.06, pm.mean() / want
    assert 0.88 < sppm["image"].mean() / want < 1.10, (
        sppm["image"].mean() / want)
    r2_init = (0.03 * tpm.scene_diagonal(scene)) ** 2
    assert sppm["r2"].mean() < 0.95 * r2_init
