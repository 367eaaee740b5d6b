"""The cluster cull (clas_cull.cull and any_hit) against its plain twin,
on the card, and the intersection wrappers' checks.

These cases need a CUDA device and skip elsewhere; the file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu*.py -m gpu -q

Tolerance: the closest hit equal to the twin's on >= 99.9% of the rays,
and the any-hit form's answer on as many (culling skips work only,
except on a ray whose hit lies within rounding of its cluster box's
face).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    doubled_spheres, make_sphere_box, rays_at,
)
from torch_gpu_cases import card_rays, cuda  # noqa: E402,F401

from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep  # noqa: E402
from sdmm_tpu_torch.render import clas as tclas  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

pytestmark = pytest.mark.gpu


def _clusters(cuda, tris, t_c):
    """The kernel's cluster tensors on the card for float32 triangle
    arrays (v0, e1, e2) as numpy, and the twin's Woop rows."""
    c = tclas.build_clusters(*tris, t_c=t_c)
    tree = clas_cull.build_tree(c["aabb"], c["ids"].shape[0])
    return tuple(torch.as_tensor(a, device=cuda) for a in (
        tree, clas_cull.slot_rows(c["woop"]), c["ids"], c["woop"]))


def _cull_against_twin(cuda, tris, ro, rd, tm, t_c):
    """cull and any_hit against the twin; returns the twin's closest hit."""
    tree, slot, ids, woop = _clusters(cuda, tris, t_c)
    before = clas_cull.cull.launches
    got = clas_cull.cull(ro, rd, tm, tree, slot, ids)
    occ = clas_cull.any_hit(ro, rd, tm, tree, slot, ids)
    torch.cuda.synchronize()
    assert clas_cull.cull.launches == before + 2
    want = clas_cull.cull_plain(ro, rd, tm, woop, ids)
    same = (got[1] == want[1]) & (got[0] == want[0]) & (got[2] == want[2]) \
        & (got[3] == want[3])
    assert float(same.float().mean()) >= 0.999
    occ_want = (want[1] >= 0) & (want[0] < tm)
    assert float((occ == occ_want).float().mean()) >= 0.999
    return want


@pytest.mark.parametrize("n,t_c", [(4_099, None), (50_003, 128)])
def test_clas_cull_kernel_matches_twin(cuda, n, t_c):
    scene, _ = make_sphere_box(tscene, tshapes).build(device=cuda)
    tris = tuple(a.cpu().numpy() for a in (scene.tri_v0, scene.tri_e1,
                                            scene.tri_e2))
    ro, rd, tm = card_rays(cuda, scene, n, 22)
    want = _cull_against_twin(cuda, tris, ro, rd, tm, t_c)
    assert 0.3 < float((want[1] >= 0).float().mean()) < 0.95
    finite = tm < 1e30
    occ_want = (want[1] >= 0) & (want[0] < tm)
    assert occ_want[finite].any() and (~occ_want[finite]).any()


def test_clas_cull_keeps_the_lower_code_on_exact_ties(cuda):
    """Six spheres with every triangle twice in clusters of three (the
    case of tests/test_torch_clas.py): the kernel returns the twin's
    winner, the original's id."""
    tris, n_t = doubled_spheres()
    ro, rd = (torch.as_tensor(a, device=cuda) for a in rays_at(tris, 20_000,
                                                                 6))
    tm = torch.full((20_000,), clas_cull.INF, device=cuda)
    want = _cull_against_twin(cuda, tris, ro, rd, tm, 3)
    hits = want[1] >= 0
    assert float(hits.float().mean()) > 0.9
    assert bool((want[1][hits] < n_t).all())


def test_intersect_wrappers_reject_bad_inputs(cuda):
    scene, _ = make_sphere_box(tscene, tshapes).build(device=cuda)
    ro, rd, tm = card_rays(cuda, scene, 256, 23)
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    tree, slot, ids = scene.clas_tree, scene.clas_woop_slot, scene.clas_ids
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        intersect_sweep.mt_sweep(ro, rd, tm.cpu(), *tris)
    with pytest.raises(ValueError):  # t_max not float32
        intersect_sweep.mt_sweep(ro, rd, tm.double(), *tris)
    for fn in (clas_cull.cull, clas_cull.any_hit):
        with pytest.raises(ValueError):  # rays not [N, 3] contiguous
            fn(ro.T.contiguous().T, rd, tm, tree, slot, ids)
        with pytest.raises(ValueError):  # ids not int32
            fn(ro, rd, tm, tree, slot, ids.long())
        with pytest.raises(ValueError):  # a CPU tree
            fn(ro, rd, tm, tree.cpu(), slot, ids)
        with pytest.raises(ValueError):  # the reference's [C, 12, t_c] rows
            fn(ro, rd, tm, tree, scene.clas_woop, ids)
        with pytest.raises(ValueError):  # a tree of too few leaves
            fn(ro, rd, tm, tree[:4].contiguous(), slot, ids)
        with pytest.raises(ValueError):  # Woop rows off 16-byte alignment
            fn(ro, rd, tm, tree, torch.empty(slot.numel() + 1, device=cuda)
               [1:].view(slot.shape), ids)
        with pytest.raises(ValueError):  # a counter that is not int64 [1]
            fn(ro, rd, tm, tree, slot, ids,
               tests=torch.zeros(1, dtype=torch.int32, device=cuda))
