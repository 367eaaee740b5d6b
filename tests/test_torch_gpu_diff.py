"""Inverse rendering and the mesh on the card: the hits that
render/intersect.intersect re-attaches to autograd behind mt_sweep (the
box) and clas_cull (the 2,172-triangle sphere box), against the same call
on the twins' hits on the same rays, and a mesh of one over NCCL
(build_render_step against its single-process replay, SDMMTrainer(mesh=)
against one process on the scan tracer).

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerance: the gradients equal (bit for bit) where the route and the twin
pick the same triangle, on >= 99.9% of the rays; the mesh of one equal to
one process within rtol 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, make_sphere_box, rays_at  # noqa: E402
from torch_gpu_cases import cuda  # noqa: E402,F401

from sdmm_tpu_torch.core.draws import seeded  # noqa: E402
from sdmm_tpu_torch.guiding.trainer import (  # noqa: E402
    SDMMTrainer, TrainerConfig,
)
from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep  # noqa: E402
from sdmm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render.volpath import trace_wave  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.scene.sensor import generate_rays  # noqa: E402

pytestmark = pytest.mark.gpu


def _hit_grads(scene, ro, rd, ct):
    """intersect's record and the vector-Jacobian product of its valid
    t, u, v in ro and rd for the cotangents ``ct`` [3, N]."""
    ro = ro.clone().requires_grad_(True)
    rd = rd.clone().requires_grad_(True)
    hit = tisect.intersect(scene, ro, rd)
    sum((torch.where(hit["valid"], hit[k], 0.0) * c).sum()
        for k, c in zip("tuv", ct)).backward()
    return hit, ro.grad, rd.grad


@pytest.mark.parametrize("large", [False, True], ids=["mt_sweep",
                                                       "clas_cull"])
def test_reattached_gradients_match_the_twin_route(cuda, monkeypatch,
                                                   large):
    make = make_sphere_box if large else make_box
    scene, _ = make(tscene, tshapes).build(device=cuda)
    tris = tuple(a.cpu().numpy() for a in (scene.tri_v0, scene.tri_e1,
                                          scene.tri_e2))
    ro, rd = (torch.as_tensor(a, device=cuda)
              for a in rays_at(tris, 65_536, seed=7))
    ct = torch.as_tensor(np.random.RandomState(8).randn(3, 65_536)
                         .astype(np.float32), device=cuda)
    counter = clas_cull.cull if large else intersect_sweep.mt_sweep
    before = counter.launches
    got = _hit_grads(scene, ro, rd, ct)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if large:
        monkeypatch.setattr(
            clas_cull, "cull", lambda ro, rd, tm, tree, woop, ids:
            clas_cull.cull_plain(ro, rd, tm, woop.transpose(1, 2), ids))
    else:
        monkeypatch.setattr(tisect, "mt_sweep",
                            intersect_sweep.mt_sweep_plain)
    want = _hit_grads(scene, ro, rd, ct)
    same = got[0]["tri"] == want[0]["tri"]
    assert float(same.float().mean()) >= 0.999
    assert float(got[0]["valid"].float().mean()) > 0.5
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[same], b[same])


def test_mesh_of_one_over_nccl(cuda):
    """make_mesh() forms a NCCL group of one; build_render_step equals its
    replay, and SDMMTrainer(mesh=) two training iterations and a frozen
    one on the scan tracer equal one process's."""
    b = make_box(tscene, tshapes, 32, 32)
    scene, cfg = b.build(device=cuda)
    mesh = tmesh.make_mesh()
    try:
        assert torch.distributed.get_backend() == "nccl"
        assert (mesh.world_size, mesh.rank) == (1, 0)
        pix = torch.arange(32 * 32, device=cuda)
        film = tmesh.build_render_step(scene, cfg, mesh)(pix, 4)
        gen = seeded(cuda, 4, 0)
        u = torch.rand((pix.shape[0], 2), generator=gen, device=cuda)
        ro, rd = generate_rays(scene, torch.stack(
            [(pix % 32).float() + u[:, 0], (pix // 32).float() + u[:, 1]],
            -1), 32, 32, cfg.fov_axis)
        li = torch.nan_to_num(trace_wave(
            scene, gen, ro, rd, max_depth=cfg.max_depth,
            rr_depth=cfg.rr_depth, bsdf_types=cfg.bsdf_types or None),
            nan=0.0, posinf=0.0, neginf=0.0)
        torch.testing.assert_close(
            film, torch.zeros_like(film).index_add_(0, pix, li), rtol=1e-5,
            atol=1e-7)

        def run(m):
            tr = SDMMTrainer(scene, cfg, TrainerConfig(
                max_leaves=64, samples_per_iteration=8,
                pooled_training=False), mesh=m, device=cuda)
            films = []
            for _ in range(2):
                out = tr.render_iteration(collect=True)
                tr.optimize(out[3])
                tr.iteration += 1
                tr.total_spp += 8
                films.append(out[:3])
            films.append(tr.render_iteration(collect=False)[:3]
                         if m is not None else tr._render_scan(False, 8)[:3])
            return tr, films

        tr_m, films_m = run(mesh)
        tr_s, films_s = run(None)
        for fm, fs in zip(films_m, films_s):
            for a, c in zip(fm, fs):
                torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(tr_m.sdmm.weight, tr_s.sdmm.weight,
                                   rtol=1e-5, atol=1e-7)
        assert torch.equal(tr_m.initialized, tr_s.initialized)
    finally:
        torch.distributed.destroy_process_group()
