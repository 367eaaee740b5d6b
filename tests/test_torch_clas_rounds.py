"""Port parity of the round loop over the clusters (render/clas.py
``intersect`` / ``occluded``, the eager route beside clas_cull and its
dense twin) against the reference's XLA round loop at
tests/test_clas.py's configuration: the box of tests/test_render.py at
64x64 plus 24 spheres of radius 0.1 (95,244 triangles, 373 clusters of
256; the reference test's seed 0), 2,048 rays of each of its two draws.
Closest hit: hit ids and valid equal on every ray, t within rtol 1e-5 (the
same Möller–Trumbore arithmetic on the same rows, which XLA's CPU backend
may contract into FMAs); occluded equal at each of the reference test's
three distances (on the seed-0 scene: one scene a package keeps the
file's time down). tests/test_torch_clas_kernel.py holds the cluster
cull's dense twin against the same round loop. The reference's calls run
in a background thread. Few tests, so that the tier-1 scheduler
(``--dist loadfile``, files with the most tests first) runs the file after
the long reference files."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, t, to_np  # noqa: E402

from sdmm_tpu.render import clas as jclas  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.render import clas as tclas  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
DISTS = (0.3, 0.7, 5.0)


def _sphere_scene(scene_mod, shapes_mod, seed, **kw):
    """tests/test_clas.py _sphere_scene in either package."""
    b = make_box(scene_mod, shapes_mod, 64, 64)
    rng = np.random.default_rng(seed)
    white = b.add_bsdf(scene_mod.BSDF_DIFFUSE, albedo=[0.5, 0.5, 0.5])
    for _ in range(24):
        c = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9])
        b.add_shape(shapes_mod.make_sphere(c, 0.1, np.eye(4)), white)
    return b.build(**kw)[0]


def _rays(n, seed):
    """tests/test_clas.py _rays, as numpy."""
    key = jax.random.PRNGKey(seed)
    ro = jax.random.uniform(key, (n, 3), minval=-0.95, maxval=0.95)
    rd = jax.random.normal(jax.random.fold_in(key, 1), (n, 3))
    return (np.asarray(ro),
            np.asarray(rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)))


def _reference():
    js = _sphere_scene(jscene, jshapes, 0)
    ro, rd = _rays(2048, 1)
    hit = {k: np.asarray(v) for k, v in jclas.intersect(
        js, jnp.asarray(ro), jnp.asarray(rd)).items()}
    ro, rd = _rays(2048, 5)
    occ = [np.asarray(jclas.occluded(js, jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.full((2048,), d))) for d in DISTS]
    return hit, occ


@pytest.fixture(scope="module")
def reference():
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference)


@pytest.fixture(scope="module")
def scene():
    return _sphere_scene(tscene, tshapes, 0, device="cpu")


def test_round_loop_closest_hit_matches_reference(reference, scene):
    assert scene.clas_ids.shape == (373, 256)
    ro, rd = _rays(2048, 1)
    got = {k: to_np(v) for k, v in tclas.intersect(scene, t(ro), t(rd))
           .items()}
    want = reference.result()[0]
    np.testing.assert_array_equal(got["tri"], want["tri"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    hit = want["valid"]
    assert hit.mean() > 0.5
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-5)


def test_round_loop_occluded_matches_reference(reference, scene):
    ro, rd = _rays(2048, 5)
    want = reference.result()[1]
    for d, w in zip(DISTS, want):
        got = to_np(tclas.occluded(scene, t(ro), t(rd),
                                   torch.full((2048,), d)))
        np.testing.assert_array_equal(got, w, err_msg=str(d))
    assert 0 < want[0].sum() < want[2].sum() < 2048
