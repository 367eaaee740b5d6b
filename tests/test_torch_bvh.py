"""Port parity of the threaded BVH (render/bvh.py) and the native builder
(native/bvh_builder.cpp through sdmm_tpu_torch/native.py), sdmm_tpu_torch
vs sdmm_tpu: ``build_bvh`` array-equal to the reference's on its numpy
path (tests/test_bvh.py's sphere-and-cube scene, 2,316 triangles) and on
its native path (a sphere of 24,000 triangles, past the 20,000 where
both packages build natively); ``traverse`` on that scene's 512 rays of
tests/test_bvh.py against the reference's traverse (hit ids equal, t
within rtol 1e-5, any-hit flags equal) and against the dense sweep twin
(hit ids equal but on equal-distance ties at shared edges, counted: the
reference test allows 3%). Few tests, so that the tier-1 scheduler
(``--dist loadfile``, files with the most tests first) runs the file after
the long reference files."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import jax_scene_arrays, t, to_np  # noqa: E402

from sdmm_tpu.core.frame import normalize  # noqa: E402
from sdmm_tpu.render import bvh as jbvh  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep as tsweep  # noqa: E402
from sdmm_tpu_torch.render import bvh as tbvh  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)


def _sphere_scene(scene_mod, shapes_mod, **kw):
    """tests/test_bvh.py random_sphere_scene in either package."""
    b = scene_mod.SceneBuilder()
    white = b.add_bsdf(scene_mod.BSDF_DIFFUSE)
    b.add_shape(shapes_mod.make_sphere([0.0, 0.0, 0.0], 1.0, n_theta=24,
                                       n_phi=48), white)
    b.add_shape(shapes_mod.make_cube(np.diag([3.0, 3.0, 3.0, 1.0])), white)
    return b.build(**kw)


def _assert_same_tree(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_build_bvh_numpy_path_matches_reference():
    verts = np.concatenate([s.concat()[0] for s in (
        jshapes.make_sphere([0.0, 0.0, 0.0], 1.0, n_theta=24, n_phi=48),
        jshapes.make_cube(np.diag([3.0, 3.0, 3.0, 1.0])))])
    assert len(verts) <= tbvh.NATIVE_FROM
    _assert_same_tree(tbvh.build_bvh(verts), jbvh.build_bvh(verts))
    js, _ = _sphere_scene(jscene, jshapes)
    ts, _ = _sphere_scene(tscene, tshapes, device="cpu")
    ja = jax_scene_arrays(js)
    for f in ("bvh_lo", "bvh_hi", "bvh_leaf_start", "bvh_leaf_count",
              "bvh_miss", "btri_v0", "btri_e1", "btri_e2", "btri_orig"):
        np.testing.assert_array_equal(to_np(getattr(ts, f)), ja[f],
                                      err_msg=f)


def test_build_bvh_native_path_matches_reference():
    """24,000 triangles: both packages take their native builder, built
    from the same native/bvh_builder.cpp; the port's library is compiled
    into build/native/ at first use."""
    verts = jshapes.make_sphere([0.1, -0.2, 0.3], 1.5, n_theta=100,
                                n_phi=120).concat()[0]
    assert len(verts) > tbvh.NATIVE_FROM
    got = tbvh.build_bvh(verts)
    _assert_same_tree(got, jbvh.build_bvh(verts))
    assert got["perm"].size % tbvh.LEAF_SIZE == 0
    assert np.array_equal(np.sort(got["perm"][got["perm"] >= 0]),
                          np.arange(len(verts)))


def test_traverse_matches_reference_and_dense_sweep():
    js, _ = _sphere_scene(jscene, jshapes)
    ts, _ = _sphere_scene(tscene, tshapes, device="cpu")
    assert ts.tri_v0.shape[0] > tisect.BRUTE_FORCE_MAX
    key = jax.random.PRNGKey(0)
    n = 512
    ro = jax.random.normal(key, (n, 3)) * 0.2 + jnp.array([0.0, 0.0, 2.0])
    rd = normalize(jax.random.normal(jax.random.fold_in(key, 1), (n, 3)))
    want = {k: np.asarray(v) for k, v in jbvh.traverse(js, ro, rd).items()}
    got = {k: to_np(v) for k, v in tbvh.traverse(ts, t(ro), t(rd)).items()}
    np.testing.assert_array_equal(got["tri"], want["tri"])
    hit = want["valid"]
    assert hit.mean() > 0.5
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-5)
    np.testing.assert_allclose(got["u"][hit], want["u"][hit], atol=1e-5)
    # The dense sweep twin: the same hits but on ties at shared edges.
    inf = torch.full((n,), 3.4e38)
    dense = {k: to_np(v) for k, v in tsweep.mt_sweep_plain(
        t(ro), t(rd), inf, ts.tri_v0, ts.tri_e1, ts.tri_e2).items()}
    np.testing.assert_array_equal(got["valid"], dense["valid"])
    np.testing.assert_allclose(got["t"][hit], dense["t"][hit], rtol=1e-5)
    ties = got["tri"] != dense["tri"]
    assert ties.mean() <= 0.03, ties.sum()
    np.testing.assert_allclose(got["t"][ties], dense["t"][ties], rtol=1e-6)
    # Any hit, with t_max on both sides of the sphere and the cube.
    for tm in (0.5, 1.5, 4.0):
        jo = np.asarray(jbvh.traverse(js, ro, rd, jnp.full((n,), tm),
                                      any_hit=True))
        to = to_np(tbvh.traverse(ts, t(ro), t(rd), torch.full((n,), tm),
                                 any_hit=True))
        np.testing.assert_array_equal(to, jo)
    assert 0 < to.sum() < n
