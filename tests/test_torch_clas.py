"""Port parity: the cluster build (render/clas.py, ops/clas_cull.py
``build_woop_rows``) and the cluster-cull intersector's plain twin
(``ops/clas_cull.cull_plain``, the CPU route of render/intersect.py above
1024 triangles), sdmm_tpu_torch vs sdmm_tpu.

The scene is tests/test_clas_pallas.py's: the box of tests/test_render.py
plus six spheres of resolution 10 (2,172 triangles), built by both
packages from the same numpy draws. The builds must agree array for array
at the default cluster size (9 clusters of 256) and at t_c = 128. The twin
is held against one interpret-mode call of the reference kernel
``clas_pallas.intersect`` at t_c = 128, as tests/test_clas_pallas.py
forces a multi-cluster build (~40 s, nearly all of it tracing the kernel's
128-way unrolled sweep; it runs in a background thread), and against the
reference's default route for such scenes, the XLA round loop
``clas.intersect`` / ``clas.occluded``. 4,096 random rays, t_max INF on
half of them and finite on the rest, so that one call covers both closest
hit and occlusion: hit ids and valid equal on every ray, t within rtol
2e-4 / atol 2e-5 (tests/test_clas_pallas.py:62-69; XLA's CPU backend may
contract the Woop products into FMAs, and the round loop runs
Möller–Trumbore).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    jax_scene_arrays, make_box, make_sphere_box, random_rays, to_np,
)

from sdmm_tpu.ops import clas_pallas  # noqa: E402
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


def _reference_kernel():
    js = _js()
    c = jclas.build_clusters(*_tris(js), t_c=128)
    js = js._replace(**{f"clas_{k}": jnp.asarray(c[k]) for k in (
        "lo", "hi", "rows", "ids", "woop", "aabb")})
    ro, rd, tm = (jnp.asarray(a) for a in _rays())
    out = clas_pallas.intersect(js, ro, rd, tm, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


def _reference_xla():
    js = _js()
    ro, rd, tm = (jnp.asarray(a) for a in _rays())
    out = {k: np.asarray(v) for k, v in jclas.intersect(js, ro, rd, tm)
           .items()}
    out["occluded"] = np.asarray(jclas.occluded(js, ro, rd, tm))
    return out


@pytest.fixture(scope="module", autouse=True)
def _reference_runs():
    """Starts the reference's calls at the top of the module, so that the
    interpret-mode trace overlaps the port's tests."""
    with ThreadPoolExecutor(2) as ex:
        yield {"kernel": ex.submit(_reference_kernel),
               "xla": ex.submit(_reference_xla)}


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
    for f in ("clas_ids", "clas_woop", "clas_aabb"):
        assert torch.equal(getattr(ts, f), getattr(tj, f)), f


def test_twin_matches_reference_kernel(_reference_runs):
    ts = _ts()
    c = tclas.build_clusters(*_tris(ts), t_c=128)
    ts = ts._replace(clas_ids=torch.as_tensor(c["ids"]),
                     clas_woop=torch.as_tensor(c["woop"]),
                     clas_aabb=torch.as_tensor(c["aabb"]))
    ro, rd, tm = (torch.as_tensor(a) for a in _rays())
    got = clas_cull.intersect(ts, ro, rd, tm)
    want = _reference_runs["kernel"].result()
    _assert_same_hits(got, want, to_np(tm))
    # The reference's occluded is valid & (t < t_max) of the same call.
    np.testing.assert_array_equal(
        to_np(clas_cull.occluded(ts, ro, rd, tm)),
        want["valid"] & (want["t"] < to_np(tm)))


def test_twin_matches_xla_cluster_sweep(_reference_runs):
    ts = _ts()
    ro, rd, tm = (torch.as_tensor(a) for a in _rays())
    want = _reference_runs["xla"].result()
    _assert_same_hits(clas_cull.intersect(ts, ro, rd, tm), want, to_np(tm))
    np.testing.assert_array_equal(to_np(clas_cull.occluded(ts, ro, rd, tm)),
                                  want["occluded"])


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
