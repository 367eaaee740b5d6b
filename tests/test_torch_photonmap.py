"""Port parity of photon mapping (sdmm_tpu_torch/render/photonmap.py against
sdmm_tpu/render/photonmap.py), on the reference's own draws and state:

- trace_photons (4,096 paths, depth 3) on the reference's draws: every
  field within rtol 1e-5 (atol 1e-4 on positions, 1e-5 on the rest);
  build_photon_grid with the reference's
  permutation: order and cids equal;
- gather_radiance at the camera rays' first hits, and camera_gather
  (spec_depth 1) on the 16x16 box of torch_parity.make_box, on the
  reference's photons and grid (carried across by
  convert.photons_from_arrays / photon_grid_from_arrays): rtol 1e-5 /
  atol 1e-6 (the port sums a cell's candidates as one block);
- camera_gather at the default spec_depth 4 on the box with a mirror
  sphere (12 x 24 quads, so that the reference takes its dense sweep and
  compiles in seconds), on that scene's reference photons: rtol 1e-5 /
  atol 1e-6.

Every reference call passes the scene's bsdf_types; the reference's jitted
calls compile in a background thread.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_ptracer import bsdf_draws, emission_draws  # noqa: E402
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu import bsdf as jbsdf  # noqa: E402
from sdmm_tpu.core.frame import to_local as jto_local  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.render import photonmap as jpm  # noqa: E402
from sdmm_tpu.render.volpath import shading_frame as jframe  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import sensor as jsensor  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.bsdf import bsdf as tbsdf  # noqa: E402
from sdmm_tpu_torch.core.frame import to_local  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render import photonmap as tpm  # noqa: E402
from sdmm_tpu_torch.render.volpath import shading_frame  # noqa: E402

torch.set_num_threads(2)
W = H = 16
N_PATHS = 4096
DEPTH = 3
RADIUS = 0.1


def mirror_box():
    b = make_box(jscene, jshapes, W, H)
    mirror = b.add_bsdf(jscene.BSDF_CONDUCTOR, albedo=[0.9, 0.9, 0.9])
    b.add_shape(jshapes.make_sphere(np.array([-0.3, 0.45, 0.1]), 0.4,
                                    np.eye(4), n_theta=12, n_phi=24),
                mirror)
    return b


def photon_draws(key, n, depth):
    """trace_photons' uniforms, in the port's rand layout."""
    k_e, k_w = jax.random.split(key)
    walk = [np.concatenate([bsdf_draws(k, n), np.asarray(jax.random.uniform(
        jax.random.fold_in(k, 3), (n,)))[:, None]], 1)
        for k in jax.random.split(k_w, depth)]
    return {"emit": emission_draws(k_e, n), "walk": np.stack(walk)}


def gather_draws(key, n, spec_depth):
    """camera_gather's uniforms: [spec_depth, n, 7]."""
    out = []
    for depth in range(spec_depth):
        k = jax.random.fold_in(key, depth)
        u = [jax.random.uniform(k, (n,))[:, None],
             jax.random.uniform(jax.random.fold_in(k, 1), (n, 2)),
             jax.random.uniform(jax.random.fold_in(k, 4), (n,))[:, None],
             jax.random.uniform(jax.random.fold_in(k, 2), (n,))[:, None],
             jax.random.uniform(jax.random.fold_in(k, 3), (n, 2))]
        out.append(np.concatenate([np.asarray(x) for x in u], 1))
    return np.stack(out)


def _rays(js):
    rs = np.random.RandomState(6)
    pix = (np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
           .reshape(-1, 2) + rs.rand(W * H, 2)).astype(np.float32)
    ro, rd = jsensor.generate_rays(js, jnp.asarray(pix), W, H)
    return np.array(ro), np.array(rd)


def _reference_map(sc, cfg, seed):
    photons = dict(jpm.trace_photons(sc, jax.random.PRNGKey(seed), N_PATHS,
                                     max_depth=DEPTH,
                                     bsdf_types=cfg.bsdf_types))
    raw = {k: np.asarray(v) for k, v in photons.items()}
    photons["power"] = photons["power"] / N_PATHS
    grid = jpm.build_photon_grid(sc, photons, RADIUS)
    return photons, grid, raw


@jax.jit
def _first_hits(sc, ro, rd):
    hit = jisect.intersect(sc, ro, rd)
    return hit, jisect.surface_interaction(sc, ro, rd, hit)


def _reference(scenes):
    (js, jcfg), (jm, mcfg) = scenes
    types = jcfg.bsdf_types
    out = {}
    photons, grid, out["photons"] = _reference_map(js, jcfg, 3)
    out["grid"] = {k: np.asarray(v) for k, v in grid.items()}
    ro, rd = (jnp.asarray(a) for a in _rays(js))
    hit, it = _first_hits(js, ro, rd)
    params = jbsdf.gather_params(js, it["bsdf"], it["uv"], types=types)
    frame = jframe(params, it["ns"], -rd)
    r2 = jnp.full((W * H,), RADIUS * RADIUS)
    out["gather"] = np.asarray(jax.jit(
        jpm.gather_radiance, static_argnames=("bsdf_types",))(
            js, photons, grid, it["p"], jto_local(*frame, -rd), frame,
            params, r2, bsdf_types=types))
    out["camera1"] = [np.asarray(x) for x in jpm.camera_gather(
        js, jax.random.PRNGKey(8), ro, rd, photons, grid,
        jnp.float32(RADIUS ** 2), bsdf_types=types, spec_depth=1)]
    photons, grid, out["photons_m"] = _reference_map(jm, mcfg, 4)
    out["grid_m"] = {k: np.asarray(v) for k, v in grid.items()}
    out["camera4"] = [np.asarray(x) for x in jpm.camera_gather(
        jm, jax.random.PRNGKey(9), ro, rd, photons, grid, r2,
        bsdf_types=mcfg.bsdf_types)]
    return out


@pytest.fixture(scope="module")
def scenes():
    return make_box(jscene, jshapes, W, H).build(), mirror_box().build()


@pytest.fixture(scope="module")
def reference(scenes):
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference, scenes)


def _state(want, suffix=""):
    photons = convert.photons_from_arrays(want["photons" + suffix],
                                          device="cpu")
    photons["power"] = photons["power"] / N_PATHS
    return photons, convert.photon_grid_from_arrays(want["grid" + suffix],
                                                    device="cpu")


def test_photons_and_grid_match_reference(scenes, reference):
    (js, jcfg), _ = scenes
    ts = convert.scene_from_arrays(js, device="cpu")
    rand = {k: torch.as_tensor(v) for k, v in photon_draws(
        jax.random.PRNGKey(3), N_PATHS, DEPTH).items()}
    got = tpm.trace_photons(ts, None, N_PATHS, max_depth=DEPTH,
                            bsdf_types=jcfg.bsdf_types, rand=rand,
                            device="cpu")
    want = reference.result()
    assert set(got) == set(want["photons"])
    for k, v in want["photons"].items():
        # A third bounce carries the rounding of three intersections and
        # two BSDF samples (the packages' sweeps round t apart): atol 1e-4
        # on positions, 1e-5 on the unit vectors.
        np.testing.assert_allclose(to_np(got[k]), v, rtol=1e-5,
                                   atol=1e-4 if k == "p" else 1e-5,
                                   err_msg=k)
    valid = want["photons"]["valid"]
    assert not valid[:N_PATHS].any() and valid.mean() > 0.3
    # The grid on the reference's photons and permutation.
    photons = convert.photons_from_arrays(want["photons"], device="cpu")
    perm = torch.as_tensor(np.array(jax.random.permutation(
        jax.random.PRNGKey(0), valid.size)))
    grid = tpm.build_photon_grid(ts, photons, RADIUS, perm=perm)
    for k in ("order", "cids", "dims"):
        np.testing.assert_array_equal(to_np(grid[k]), want["grid"][k],
                                      err_msg=k)
    np.testing.assert_array_equal(to_np(grid["lo"]), want["grid"]["lo"])
    assert grid["inv_cell"] == pytest.approx(float(want["grid"]["inv_cell"]))
    # A generator's permutation sorts the same cells.
    other = tpm.build_photon_grid(ts, photons, RADIUS)
    np.testing.assert_array_equal(to_np(other["cids"]), want["grid"]["cids"])


def test_gather_radiance_and_camera_gather_match_reference(scenes,
                                                            reference):
    (js, jcfg), _ = scenes
    ts = convert.scene_from_arrays(js, device="cpu")
    types = jcfg.bsdf_types
    want = reference.result()
    photons, grid = _state(want)
    ro, rd = (torch.as_tensor(a) for a in _rays(js))
    hit = tisect.intersect(ts, ro, rd)
    it = tisect.surface_interaction(ts, ro, rd, hit)
    params = tbsdf.gather_params(ts, it["bsdf"], it["uv"], types=types)
    frame = shading_frame(params, it["ns"], -rd)
    r2 = torch.full((W * H,), RADIUS * RADIUS)
    got = to_np(tpm.gather_radiance(ts, photons, grid, it["p"],
                                    to_local(*frame, -rd), frame, params, r2,
                                    bsdf_types=types))
    assert (want["gather"] > 0).all(-1).mean() > 0.5
    np.testing.assert_allclose(got, want["gather"], rtol=1e-5, atol=1e-6)
    got = tpm.camera_gather(ts, None, ro, rd, photons, grid,
                            torch.tensor(RADIUS ** 2), bsdf_types=types,
                            spec_depth=1, rand=torch.as_tensor(gather_draws(
                                jax.random.PRNGKey(8), W * H, 1)),
                            device="cpu")
    for name, g, w in zip(("li", "flux", "m"), got, want["camera1"]):
        np.testing.assert_allclose(to_np(g), w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_camera_gather_through_a_mirror_matches_reference(scenes,
                                                          reference):
    (js, _), (jm, mcfg) = scenes
    tm = convert.scene_from_arrays(jm, device="cpu")
    want = reference.result()
    photons, grid = _state(want, "_m")
    ro, rd = (torch.as_tensor(a) for a in _rays(js))
    got = tpm.camera_gather(tm, None, ro, rd, photons, grid,
                            torch.full((W * H,), RADIUS * RADIUS),
                            bsdf_types=mcfg.bsdf_types,
                            rand=torch.as_tensor(gather_draws(
                                jax.random.PRNGKey(9), W * H, 4)),
                            device="cpu")
    li, _, m = want["camera4"]
    # Some camera points lie behind the mirror.
    assert m.sum() > 0.8 * W * H and (li > 0).all(-1).mean() > 0.8
    for name, g, w in zip(("li", "flux", "m"), got, want["camera4"]):
        np.testing.assert_allclose(to_np(g), w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
