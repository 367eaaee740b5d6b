"""Inverse rendering on the port, tests/test_diff.py's recoveries with its
configurations and limits: the red wall's albedo from 0.3 grey (60 Adam
steps) and, jointly, the albedo and the rough conductor's GGX alpha from
0.6 (80 steps), on the correlated objective (the target rendered with the
optimisation's seed, so the loss has an exact zero at the truth)."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, make_rough_box, to_np  # noqa: E402

from sdmm_tpu_torch.diff import inverse  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)


def _target(render, params, cfg):
    with torch.no_grad():
        return to_np(render(params, 0)).reshape(cfg.height, cfg.width, 3)


def test_inverse_rendering_recovers_albedo():
    b = make_box(tscene, tshapes, 12, 12)
    b.max_depth = b.rr_depth = 3
    scene, cfg = b.build(device="cpu")
    pix = torch.arange(cfg.width * cfg.height)
    render = inverse.make_render_fn(scene, cfg, pix, "bsdf_albedo", spp=4,
                                    device="cpu")
    target = _target(render, scene.bsdf_albedo, cfg)
    init = scene.bsdf_albedo.clone()
    init[1] = 0.3
    fitted, losses = inverse.optimize_parameter(
        scene, cfg, target, "bsdf_albedo", init, steps=60, lr=5e-2, spp=4,
        seed=0, device="cpu")
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    got, true_red = to_np(fitted[1]), to_np(scene.bsdf_albedo[1])
    assert np.abs(got - true_red).max() < 0.08, (got, true_red)


def test_joint_albedo_roughness_recovery():
    scene, cfg = make_rough_box(tscene, tshapes).build(device="cpu")
    pix = torch.arange(cfg.width * cfg.height)
    names = ("bsdf_albedo", "bsdf_alpha")
    render = inverse.make_render_fn_multi(scene, cfg, pix, spp=4,
                                          device="cpu")
    target = _target(render, {n: getattr(scene, n) for n in names}, cfg)
    rough = int(scene.bsdf_alpha.shape[0]) - 1
    init = {"bsdf_albedo": scene.bsdf_albedo.clone(),
            "bsdf_alpha": scene.bsdf_alpha.clone()}
    init["bsdf_albedo"][1] = 0.3
    init["bsdf_alpha"][rough] = 0.6
    fitted, losses = inverse.optimize_parameters(
        scene, cfg, target, names, init, steps=80, lr=4e-2, spp=4, seed=0,
        device="cpu")
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    got_a = to_np(fitted["bsdf_albedo"][1])
    assert np.abs(got_a - to_np(scene.bsdf_albedo[1])).max() < 0.1
    got_r = float(fitted["bsdf_alpha"][rough])
    assert abs(got_r - 0.3) < 0.08, got_r
