"""Port parity: the cluster build (render/clas.py, ops/clas_cull.py
``build_woop_rows``) and the cluster-cull intersector's plain twin
(``ops/clas_cull.cull_plain``, the CPU route of render/intersect.py above
1024 triangles), sdmm_tpu_torch vs sdmm_tpu.

The scene is tests/test_clas_pallas.py's: the box of tests/test_render.py
plus six spheres of resolution 10 (2,172 triangles), built by both
packages from the same numpy draws. The builds must agree array for array
at the default cluster size (9 clusters of 256) and at t_c = 128. The twin
against the reference's kernel and its XLA round loop is in
tests/test_torch_clas_kernel.py (the kernel's ~40 s interpret-mode trace,
in a file of few tests that the tier-1 scheduler runs late).

The kernel's walk over its cluster tree (``ops/clas_cull.build_tree``) is
held here through a plain model of it (``torch_parity.tree_walk``): on the
same scene at both cluster sizes, and on six spheres with every triangle
duplicated (exact ties across cluster boundaries), it returns the dense
twin's tri, t, u and v bit for bit on every ray, and no ray sweeps fewer
triangles or opens fewer tree nodes than the bound admits.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    admitted_tests, doubled_spheres, jax_scene_arrays, least_slab_tests,
    make_box, make_sphere_box, random_rays, rays_at, to_np, tree_walk,
)

from sdmm_tpu.render import clas as jclas  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep  # noqa: E402
from sdmm_tpu_torch.render import clas as tclas  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
N = 4096


def _js():
    return make_sphere_box(jscene, jshapes).build()[0]


def _ts():
    return make_sphere_box(tscene, tshapes).build(device="cpu")[0]


def _tris(scene):
    return tuple(np.asarray(to_np(a), np.float32)
                 for a in (scene.tri_v0, scene.tri_e1, scene.tri_e2))


def _rays():
    return random_rays(_tris(_ts())[0], N, seed=4)


def _assert_same_hits(got, want, t_max):
    np.testing.assert_array_equal(to_np(got["valid"]), want["valid"])
    np.testing.assert_array_equal(to_np(got["tri"]), want["tri"])
    ok = want["valid"]
    assert 0.3 < ok.mean() < 0.95  # hits and misses on both t_max halves
    np.testing.assert_allclose(to_np(got["t"])[ok], want["t"][ok],
                               rtol=2e-4, atol=2e-5)
    assert (to_np(got["t"])[~ok] == clas_cull.INF).all()
    finite = t_max < 1e30
    assert want["valid"][finite].any() and (~want["valid"][finite]).any()


@pytest.mark.parametrize("t_c", [None, 128])
def test_cluster_build_matches_reference(t_c):
    tris = _tris(_ts())
    got = tclas.build_clusters(*tris, t_c=t_c)
    want = jclas.build_clusters(*tris, t_c=t_c)
    assert got.keys() == want.keys() and got["t_c"] == want["t_c"]
    assert got["ids"].shape[0] == (9 if t_c is None else 17)
    for k in ("lo", "hi", "rows", "ids", "woop", "aabb"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cluster_build_of_an_empty_scene_matches_reference():
    z = np.zeros((0, 3), np.float32)
    got, want = tclas.build_clusters(z, z, z), jclas.build_clusters(z, z, z)
    for k in ("lo", "hi", "rows", "ids", "woop", "aabb"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_scene_from_numpy_gives_the_same_clusters():
    ts = _ts()
    tj = tscene.scene_from_numpy(jax_scene_arrays(_js()), device="cpu")
    assert tj.clas_ids.dtype == torch.int32
    for f in ("clas_ids", "clas_woop", "clas_aabb") + tscene.PORT_FIELDS:
        assert torch.equal(getattr(ts, f), getattr(tj, f)), f


@pytest.mark.parametrize("t_c", [None, 128, 3])
def test_cluster_tree_holds_its_clusters(t_c):
    c = tclas.build_clusters(*_tris(_ts()), t_c=t_c)
    n_c = c["ids"].shape[0]
    tree = clas_cull.build_tree(c["aabb"], n_c)
    leaves = tree.shape[0] // 2
    assert tree.dtype == np.float32 and tree.shape == (2 * leaves, 8)
    assert leaves >= n_c > leaves // 2 and leaves & (leaves - 1) == 0
    lo, hi = tree[:, 0:3], tree[:, 4:7]
    # The leaves are the clusters' boxes, then empty padding.
    np.testing.assert_array_equal(lo[leaves:leaves + n_c], c["lo"])
    np.testing.assert_array_equal(hi[leaves:leaves + n_c], c["hi"])
    assert (lo[leaves + n_c:] > hi[leaves + n_c:]).all()
    assert (lo[0] > hi[0]).all()
    # Every inner node's box is the union of its children's.
    k = np.arange(1, leaves)
    np.testing.assert_array_equal(lo[k], np.minimum(lo[2 * k], lo[2 * k + 1]))
    np.testing.assert_array_equal(hi[k], np.maximum(hi[2 * k], hi[2 * k + 1]))
    assert (tree[:, 3] == 0).all() and (tree[:, 7] == 0).all()
    # The kernel's Woop rows are the reference's, slot by slot.
    slot = clas_cull.slot_rows(c["woop"])
    assert slot.flags["C_CONTIGUOUS"] and slot.shape == (n_c, c["t_c"], 12)
    np.testing.assert_array_equal(slot, c["woop"].transpose(0, 2, 1))


def test_query_order_sorts_by_octant_then_origin():
    ts = _ts()
    ro, rd, _ = (torch.as_tensor(a) for a in _rays())
    order = clas_cull.query_order(ro, rd, ts.clas_tree)
    assert order.dtype == torch.int32
    assert torch.equal(order.sort().values, torch.arange(N, dtype=torch.int32))
    o = order.long()
    octant = ((rd[o] < 0).long() * torch.tensor([4, 2, 1])).sum(1)
    assert bool((octant.diff() >= 0).all())
    # The Morton table is render/clas.py's interleave, and within an octant
    # the origins' codes never fall.
    k = np.arange(1024)
    np.testing.assert_array_equal(clas_cull._SPREAD, tclas._morton3(
        np.stack([k / 1024.0, 0 * k, 0 * k], 1)).astype(np.int64))
    lo, hi = ts.clas_tree[1, 0:3], ts.clas_tree[1, 4:7]
    q = ((ro[o] - lo) * (1024.0 / (hi - lo))).clamp(0, 1023).long().numpy()
    code = sum(clas_cull._SPREAD[q[:, a]] << a for a in range(3))
    same = octant[1:] == octant[:-1]
    assert (np.diff(code)[same.numpy()] >= 0).all()


def _walk_case(t_c, n=384):
    """The sphere box's clusters at ``t_c``, the twin's and the walk
    model's hits for n random rays, the admitted Woop tests, the least
    walk's slab tests and the tree's count of non-empty inner nodes."""
    ts = _ts()
    c = tclas.build_clusters(*_tris(ts), t_c=t_c)
    tree = torch.as_tensor(clas_cull.build_tree(c["aabb"], c["ids"].shape[0]))
    woop, ids = torch.as_tensor(c["woop"]), torch.as_tensor(c["ids"])
    ro, rd, tm = (torch.as_tensor(a[:n]) for a in _rays())
    want = clas_cull.cull_plain(ro, rd, tm, woop, ids)
    got = tree_walk(ro, rd, tm, tree, woop, ids)
    admitted = admitted_tests(ro, rd, tm, want[0], torch.as_tensor(c["aabb"]),
                              ids)
    slabs = least_slab_tests(ro, rd, tm, want[0], tree)
    inner = tree[1:tree.shape[0] // 2]
    return want, got, admitted, slabs, int((inner[:, 0] <= inner[:, 4]).sum())


def _assert_bit_equal(got, want):
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("t_c", [None, 128])
def test_tree_walk_matches_dense_twin(t_c):
    want, got = _walk_case(t_c)[:2]
    _assert_bit_equal(got[:4], want)
    assert 0.3 < float((want[1] >= 0).float().mean()) < 0.95


@pytest.mark.parametrize("t_c", [None, 128])
def test_tree_walk_sweeps_what_the_bound_admits(t_c):
    """No cluster that could hold a ray's hit is skipped, and the walk
    prunes: its mean is within 2x of the bound's."""
    _, got, admitted = _walk_case(t_c)[:3]
    swept = got[4].double()
    assert (swept >= admitted).all()
    assert float(swept.mean()) <= 2.0 * float(admitted.mean())
    assert float(admitted.mean()) > 0


@pytest.mark.parametrize("t_c", [None, 128])
def test_tree_walk_opens_what_the_bound_admits(t_c):
    """The bound's slab tests (two for each inner node a ray enters before
    its hit) are a floor of the walk's on every ray, and fewer than a test
    of every node: the walk and the bound both prune."""
    _, got, _, slabs, inner = _walk_case(t_c)
    walk = 2.0 * got[6].double()
    assert (walk >= slabs).all()
    assert float(walk.mean()) <= 2.0 * float(slabs.mean())
    assert 0 < float(slabs.mean()) < 2 * inner


def test_tree_walk_keeps_the_lower_code_on_exact_ties():
    """Six spheres with every triangle twice: a triangle and its copy sit
    side by side in Morton order, and clusters of three cut a third of the
    pairs apart, so the walk often meets the copy (the higher code) first.
    The tie rule must return the twin's winner, the original's id."""
    tris, n_t = doubled_spheres()
    c = tclas.build_clusters(*tris, t_c=3)
    tree = torch.as_tensor(clas_cull.build_tree(c["aabb"], c["ids"].shape[0]))
    woop, ids = torch.as_tensor(c["woop"]), torch.as_tensor(c["ids"])
    ro, rd = (torch.as_tensor(a) for a in rays_at(tris, 256, 6))
    tm = torch.full((256,), clas_cull.INF)
    want = clas_cull.cull_plain(ro, rd, tm, woop, ids)
    got = tree_walk(ro, rd, tm, tree, woop, ids)
    _assert_bit_equal(got[:4], want)
    hits = want[1] >= 0
    assert int(hits.sum()) > 200 and bool((want[1][hits] < n_t).all())
    assert int((got[5] > 0).sum()) > 5  # the tie clause replaced a best


def test_route_by_triangle_count_on_the_cpu(monkeypatch):
    """Above BRUTE_FORCE_MAX triangles intersect and occluded take the
    cluster twin, at or below it the dense one; neither raises."""
    calls = {"cull": 0, "mt": 0}
    cull_plain, mt_plain = clas_cull.cull_plain, intersect_sweep.mt_sweep_plain

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(clas_cull, "cull_plain", counted("cull", cull_plain))
    monkeypatch.setattr(intersect_sweep, "mt_sweep_plain",
                        counted("mt", mt_plain))
    ro, rd, tm = (torch.as_tensor(a[:256]) for a in _rays())
    big = _ts()
    small = make_box(tscene, tshapes, 8, 8).build(device="cpu")[0]
    assert big.tri_v0.shape[0] > tisect.BRUTE_FORCE_MAX
    hit = tisect.intersect(big, ro, rd)
    occ = tisect.occluded(big, ro, rd, tm)
    assert calls == {"cull": 2, "mt": 0}
    assert hit["valid"].any() and occ.any() and not occ.all()
    # The dense sweep over the same triangles finds the same closest hits.
    dense = mt_plain(ro, rd, torch.full((256,), clas_cull.INF), big.tri_v0,
                     big.tri_e1, big.tri_e2)
    assert torch.equal(dense["tri"], hit["tri"])
    tisect.intersect(small, ro, rd)
    tisect.occluded(small, ro, rd, tm)
    assert calls == {"cull": 2, "mt": 2}
