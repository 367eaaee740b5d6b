"""Shared fixture and helpers of the card's kernel-against-twin tests
(tests/test_torch_gpu*.py). Imports no JAX."""

import numpy as np
import pytest
import torch

from torch_parity import (
    make_glossy_box, make_tiled_box, path_wave, random_rays,
)

from sdmm_tpu_torch.guiding import init as init_mod
from sdmm_tpu_torch.guiding import mixture as mix
from sdmm_tpu_torch.ops import bounce as bo
from sdmm_tpu_torch.ops import intersect_sweep
from sdmm_tpu_torch.scene import scene as tscene
from sdmm_tpu_torch.scene import shapes as tshapes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def guide_state(seed, L, dev):
    """A 16-component mixture of ``L`` leaves on ``dev`` from ``seed``
    (some weights 0) and its initialized flags (~90% of the leaves)."""
    rs = np.random.RandomState(seed)
    hi = torch.as_tensor((np.ones((L, 3)) * rs.rand(L, 1) + 0.5)
                         .astype(np.float32))
    base = init_mod.init_leaf_params(torch.Generator().manual_seed(seed),
                                     torch.zeros((L, 3)), hi, 16)
    w = rs.dirichlet(np.ones(16), size=L)
    w = np.where(rs.rand(L, 16) < 0.2, 0.0, w)
    w = (w / np.maximum(w.sum(-1, keepdims=True), 1e-9)).astype(np.float32)
    jit = rs.randn(L, 16, 5, 5).astype(np.float32) * 0.01
    sdmm = mix.SDMM(weight=torch.as_tensor(w), mean=base.mean,
                    cov=base.cov + torch.as_tensor(
                        0.5 * (jit + np.swapaxes(jit, -1, -2))))
    sdmm = mix.SDMM(*(x.to(dev) for x in sdmm))
    return sdmm, torch.as_tensor(rs.rand(L) < 0.9, device=dev)


def path_setup(cuda, n, seed, tiled=False):
    make = make_tiled_box if tiled else make_glossy_box
    scene, cfg = make(tscene, tshapes, 16, 16).build(device=cuda)
    tri, em, env = bo.build_tables(scene)
    cam = bo.build_cam_params(scene, 16, 16)
    wave = tuple(torch.as_tensor(a, device=cuda)
                 for a in path_wave(n, seed, max_depth=10))
    return (cfg.bsdf_types, tri, em, env, cam, int(scene.em_tri_idx.shape[0]),
            wave)


def same_bits(a, b):
    """Bitwise equal, NaN included."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all()) \
        if a.is_floating_point() else torch.equal(a, b)


def agree(pairs, share=0.999):
    """Each (kernel, twin, exact) pair agrees on ``share`` of the lanes."""
    for a, b, exact in pairs:
        if exact:
            ok = a == b
        else:
            ok = torch.isclose(a, b, rtol=1e-5, atol=1e-6, equal_nan=True)
        ok = ok.all(0) if ok.dim() == 2 else ok
        assert float(ok.float().mean()) >= share, float(ok.float().mean())


def card_rays(cuda, scene, n, seed):
    """torch_parity.random_rays about the scene's triangles, on the card."""
    return tuple(torch.as_tensor(a, device=cuda) for a in random_rays(
        scene.tri_v0.cpu().numpy(), n, seed))


def sweep_equal(ro, rd, tm, tris):
    """The sweep equals its twin on every ray; returns the twin's hits."""
    got = intersect_sweep.mt_sweep(ro, rd, tm, *tris)
    torch.cuda.synchronize()
    want = intersect_sweep.mt_sweep_plain(ro, rd, tm, *tris)
    for k in ("tri", "valid", "t", "u", "v"):
        assert torch.equal(got[k], want[k]), k
    return want
