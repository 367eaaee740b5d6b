"""Port parity of the spherical harmonics and the irradiance cache
(sdmm_tpu_torch/core/sh.py and render/irrcache.py against sdmm_tpu's), on
the reference's own draws and cache.

- core/sh.py on random directions at orders 1-4: eval_basis, eval_function,
  project_dirs (uniform and given weights), project, dot, lambda_l,
  convolve_cosine and rotate_z within rtol 1e-5;
- build_cache on the 32x32 box fed the reference's candidate and gather
  uniforms: the slot hash bit for bit on every cell a probe reaches, the
  slot table (valid, record cells), record positions and normals equal,
  the record radii (first-hit distances) within rtol 1e-5;
- interpolate on the reference's cache, carried across by
  convert.irrcache_from_arrays, at the first hits of camera rays: rtol
  1e-5.

TABLE is set in both modules through monkeypatch for this module's tests
(another file's tests set the reference's by plain assignment); the
reference's jitted build_cache (with the scene's bsdf_types) compiles in a
background thread while the port's parts run.
"""

import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.core import sh as jsh  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.render import irrcache as jic  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import sensor as jsensor  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.core import sh as tsh  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import irrcache as tic  # noqa: E402

torch.set_num_threads(2)
W = H = 32
TABLE = 512
GRID = 10
GATHER = 5
N_CAND = 1 << 11
DEPTH = 4
KEY = 11


def cache_draws(key, n, gather_res):
    """build_cache's uniforms as it draws them (cache_shapes' dict)."""
    k_pix, k_b, k_g = jax.random.split(key, 3)
    bounce = []
    for b in range(2):
        kb = jax.random.fold_in(k_b, b)
        bounce.append(np.concatenate([
            np.asarray(jax.random.uniform(kb, (n,)))[:, None],
            np.asarray(jax.random.uniform(jax.random.fold_in(kb, 1),
                                          (n,)))[:, None],
            np.asarray(jax.random.uniform(jax.random.fold_in(kb, 2),
                                          (n, 2)))], 1))
    g = 2 * gather_res * gather_res
    return {"pix": np.asarray(jax.random.uniform(k_pix, (n, 2))),
            "bounce": np.stack(bounce),
            "gather": np.asarray(jax.random.uniform(k_g, (TABLE, g, 2)))}


def _probe_points(js):
    """First hits of camera rays through every pixel."""
    rs = np.random.RandomState(2)
    pix = (np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
           .reshape(-1, 2) + rs.rand(W * H, 2)).astype(np.float32)
    ro, rd = jsensor.generate_rays(js, jnp.asarray(pix), W, H)
    hit = jisect.intersect(js, ro, rd)
    it = jisect.surface_interaction(js, ro, rd, hit)
    return np.asarray(it["p"]), np.asarray(it["ns"])


def _reference(scene):
    js, cfg = scene
    cache = jic.build_cache(js, jax.random.PRNGKey(KEY), W, H, grid_res=GRID,
                            gather_res=GATHER,
                            bsdf_types=tuple(cfg.bsdf_types),
                            max_depth=DEPTH, n_candidates=N_CAND)
    p, n = _probe_points(js)
    e, cov = jic.interpolate(cache, js, jnp.asarray(p), jnp.asarray(n), GRID)
    return {"cache": {k: np.asarray(v) for k, v in cache.items()},
            "p": p, "n": n, "E": np.asarray(e), "covered": np.asarray(cov)}


@pytest.fixture(scope="module")
def table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jic, "TABLE", TABLE)
        mp.setattr(tic, "TABLE", TABLE)
        yield


@pytest.fixture(scope="module")
def scene():
    return make_box(jscene, jshapes, W, H).build()


@pytest.fixture(scope="module")
def reference(table, scene):
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference, scene)


def test_spherical_harmonics_match_reference():
    rs = np.random.RandomState(0)
    # As many directions as project's 32 x 32 grid: one reference compile
    # of eval_basis an order serves both.
    d = rs.normal(size=(1024, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:2] = [[0, 0, 1], [0, 0, -1]]  # the poles
    td = torch.as_tensor(d)
    for order in (1, 2, 3, 4):
        c = rs.normal(size=tsh.n_coeffs(order)).astype(np.float32)
        vals = rs.rand(1024).astype(np.float32)
        wts = rs.rand(1024).astype(np.float32)
        tc, tv, tw = (torch.as_tensor(a) for a in (c, vals, wts))
        assert tsh.n_coeffs(order) == jsh.n_coeffs(order)
        pairs = [
            (tsh.eval_basis(td, order), jsh.eval_basis(jnp.asarray(d),
                                                       order)),
            (tsh.eval_function(tc, td), jsh.eval_function(jnp.asarray(c),
                                                          jnp.asarray(d))),
            (tsh.project_dirs(tv, td, order),
             jsh.project_dirs(jnp.asarray(vals), jnp.asarray(d), order)),
            (tsh.project_dirs(tv, td, order, tw),
             jsh.project_dirs(jnp.asarray(vals), jnp.asarray(d), order,
                              jnp.asarray(wts))),
            (tsh.project(lambda x: x[:, 2] ** 2 + x[:, 0], order, res=32,
                         device="cpu"),
             jsh.project(lambda x: x[:, 2] ** 2 + x[:, 0], order, res=32)),
            (tsh.dot(tc, tc * 0.5), jsh.dot(jnp.asarray(c),
                                            jnp.asarray(c) * 0.5)),
            (tsh.lambda_l(order, device="cpu"), jsh.lambda_l(order)),
            (tsh.convolve_cosine(tc), jsh.convolve_cosine(jnp.asarray(c))),
            (tsh.rotate_z(tc, 0.7), jsh.rotate_z(jnp.asarray(c), 0.7)),
        ]
        for i, (got, want) in enumerate(pairs):
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"order {order}, pair {i}")
    # The rotation is a rotation: it keeps the function's norm and turns
    # its values about +z.
    c = torch.as_tensor(rs.normal(size=tsh.n_coeffs(3)).astype(np.float32))
    rot = tsh.rotate_z(c, math.pi / 3)
    assert float(tsh.dot(rot, rot)) == pytest.approx(float(tsh.dot(c, c)),
                                                     rel=1e-5)
    a = math.pi / 3
    r = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                      [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(to_np(tsh.eval_function(rot, td @ r.T)),
                               to_np(tsh.eval_function(c, td)), atol=2e-4)


def test_cache_placement_matches_reference(table, scene, reference):
    js, cfg = scene
    # The slot hash on every cell a probe can reach, negative offsets and
    # the int32 wrap of the reference's key included.
    rs = np.random.RandomState(1)
    cells = rs.randint(-1, 4 * 48 + 2, size=(65536, 3)).astype(np.int32)
    nb = rs.randint(0, 6, size=65536).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(tic._slot(torch.as_tensor(cells), torch.as_tensor(nb))),
        np.asarray(jic._slot(jnp.asarray(cells), jnp.asarray(nb))))
    ts = convert.scene_from_arrays(js, device="cpu")
    draws = {k: torch.as_tensor(np.array(v)) for k, v in cache_draws(
        jax.random.PRNGKey(KEY), N_CAND, GATHER).items()}
    got = tic.build_cache(ts, torch.Generator().manual_seed(0), W, H,
                          grid_res=GRID, gather_res=GATHER,
                          bsdf_types=tuple(cfg.bsdf_types), max_depth=DEPTH,
                          n_candidates=N_CAND, rand=draws, device="cpu")
    want = reference.result()["cache"]
    for k in ("valid", "cell_idx", "grid_res"):
        np.testing.assert_array_equal(to_np(got[k]), want[k], err_msg=k)
    # The same candidate holds each slot; its hit point and normal within
    # float32 rounding of the intersection.
    for k in ("pos", "n"):
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in ("R", "cell"):
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)
    valid = want["valid"]
    assert valid.sum() > 100
    # Indirect irradiance: finite, non-negative and present on every wall.
    e = to_np(got["E"])[valid]
    assert np.isfinite(e).all() and (e >= 0).all() and e.max() > 1e-3


def test_interpolate_matches_reference(table, scene, reference):
    js, _ = scene
    ts = convert.scene_from_arrays(js, device="cpu")
    want = reference.result()
    cache = convert.irrcache_from_arrays(want["cache"], device="cpu")
    e, covered = tic.interpolate(cache, ts, torch.as_tensor(want["p"]),
                                 torch.as_tensor(want["n"]), GRID)
    np.testing.assert_array_equal(to_np(covered), want["covered"])
    np.testing.assert_allclose(to_np(e), want["E"], rtol=1e-5, atol=1e-7)
    assert want["covered"].mean() > 0.8
