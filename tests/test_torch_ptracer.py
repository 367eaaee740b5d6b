"""Port parity of the particle tracer and the VPL integrator
(sdmm_tpu_torch/render/ptracer.py against sdmm_tpu/render/ptracer.py), on
the reference's own draws: the uniforms each reference function draws are
rebuilt here with jax.random exactly as it splits and folds its key, and
fed to the port as ``rand``.

- sample_emission on the 16x16 box of torch_parity.make_box and on the box
  lit by a point, a spot, a directional and a collimated light: rtol 1e-5;
  camera_connect on points along camera rays: pix equal, d within 1e-5;
- one trace_particles wave (16x16, 4,096 paths, depth 3): the film within
  rtol 1e-4 / atol 1e-6 (index_add_ sums a pixel's splats in another
  order);
- generate_vpls on the reference's draws (rtol 1e-5), and trace_vpl on the
  reference's VPL set, carried across by convert.vpls_from_arrays, in
  chunks of 5 VPLs and in one: rtol 1e-5.

Every reference call passes the scene's bsdf_types; the reference's jitted
calls compile in a background thread while the port's parts run.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.render import ptracer as jpt  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import sensor as jsensor  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import ptracer as tpt  # noqa: E402

torch.set_num_threads(2)
W = H = 16
N_PATHS = 4096
DEPTH = 3
N_VPL_PATHS = 32


def _lit_box():
    b = make_box(jscene, jshapes, W, H)
    b.add_point_light([0.3, 1.5, 0.2], [2.0, 2.0, 2.0])
    b.add_spot_light([-0.5, 1.8, 0.3], [0.2, -1.0, -0.1], [5.0, 4.0, 3.0],
                     cutoff_deg=30.0, beam_deg=20.0)
    b.add_directional_light([0.3, -1.0, -0.2], [1.0, 1.0, 1.0])
    b.add_collimated_light([0.1, 1.9, -0.2], [0.0, -1.0, 0.0], [3.0] * 3)
    return b


def emission_draws(key, n):
    """sample_emission's uniforms as it draws them: [n, 5]."""
    k1, k2, k3 = jax.random.split(key, 3)
    return np.concatenate([
        np.asarray(jax.random.uniform(k1, (n,)))[:, None],
        np.asarray(jax.random.uniform(k2, (n, 2))),
        np.asarray(jax.random.uniform(k3, (n, 2)))], 1)


def bsdf_draws(k, n):
    """u0, u1, u2 of a walk step keyed by ``k``: [n, 4]."""
    return np.concatenate([
        np.asarray(jax.random.uniform(jax.random.fold_in(k, 2), (n,)))[
            :, None],
        np.asarray(jax.random.uniform(k, (n,)))[:, None],
        np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n, 2)))], 1)


def particle_draws(key, n, depth):
    k_e, k_w = jax.random.split(key)
    walk = []
    for k in jax.random.split(k_w, depth):
        k_b, k_rr = jax.random.split(k)
        walk.append(np.concatenate([bsdf_draws(k_b, n), np.asarray(
            jax.random.uniform(k_rr, (n,)))[:, None]], 1))
    return {"emit": emission_draws(k_e, n), "walk": np.stack(walk)}


def vpl_draws(key, n, depth):
    k_e, k_w = jax.random.split(key)
    return {"emit": emission_draws(k_e, n),
            "walk": np.stack([bsdf_draws(jax.random.fold_in(k_w, d), n)
                              for d in range(depth)])}


def _rays(js):
    rs = np.random.RandomState(4)
    pix = (np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
           .reshape(-1, 2) + rs.rand(W * H, 2)).astype(np.float32)
    ro, rd = jsensor.generate_rays(js, jnp.asarray(pix), W, H)
    return np.array(ro), np.array(rd)


def _as_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _reference(scenes):
    (js, jcfg), (jl, lcfg) = scenes
    types = jcfg.bsdf_types
    out = {"emit": _as_np(jpt.sample_emission(js, jax.random.PRNGKey(1),
                                              512)),
           "emit_lit": _as_np(jpt.sample_emission(jl, jax.random.PRNGKey(2),
                                                  512))}
    ro, rd = _rays(js)
    p = ro + 2.5 * rd
    out["cc"] = _as_np(jpt.camera_connect(js, jnp.asarray(p), W, H))
    out["film"] = np.asarray(jpt.trace_particles(
        js, jax.random.PRNGKey(5), N_PATHS, W, H, max_depth=DEPTH,
        rr_depth=2, bsdf_types=types))
    out["film_lit"] = np.asarray(jpt.trace_particles(
        jl, jax.random.PRNGKey(6), N_PATHS, W, H, max_depth=DEPTH,
        rr_depth=2, bsdf_types=lcfg.bsdf_types))
    gen = jax.jit(partial(jpt.generate_vpls, n_light_paths=N_VPL_PATHS,
                          max_depth=DEPTH, bsdf_types=types))
    vpls = gen(js, jax.random.PRNGKey(7))
    out["vpls"] = _as_np(vpls)
    out["vpl_li"] = np.asarray(jpt.trace_vpl(
        js, jax.random.PRNGKey(0), jnp.asarray(ro), jnp.asarray(rd), vpls,
        bsdf_types=types))
    return out


@pytest.fixture(scope="module")
def scenes():
    return (make_box(jscene, jshapes, W, H).build(), _lit_box().build())


@pytest.fixture(scope="module")
def reference(scenes):
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference, scenes)


def _port(js):
    return convert.scene_from_arrays(js, device="cpu")


def _close(got, want, rtol, atol, what):
    for k, v in want.items():
        np.testing.assert_allclose(to_np(got[k]).astype(v.dtype), v,
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def test_emission_and_camera_connect_match_reference(scenes, reference):
    (js, _), (jl, _) = scenes
    ts, tl = _port(js), _port(jl)
    got = tpt.sample_emission(ts, 512, rand=torch.as_tensor(emission_draws(
        jax.random.PRNGKey(1), 512)), device="cpu")
    got_lit = tpt.sample_emission(tl, 512, rand=torch.as_tensor(
        emission_draws(jax.random.PRNGKey(2), 512)), device="cpu")
    want = reference.result()
    _close(got, want["emit"], 1e-5, 1e-6, "box")
    _close(got_lit, want["emit_lit"], 1e-5, 1e-6, "lit box")
    # Every light kind and the area light start paths in the lit box.
    kinds = to_np(tl.pt_kind)[np.clip(np.searchsorted(
        to_np(tl.pt_cdf), emission_draws(jax.random.PRNGKey(2), 512)[:, 1]),
        0, 3)]
    picked = ~want["emit_lit"]["from_area"]
    assert set(kinds[picked]) == {0, 1, 2, 3} and (~picked).sum() > 50
    # Points along camera rays project back onto their pixels.
    ro, rd = _rays(js)
    cc = tpt.camera_connect(ts, torch.as_tensor(ro + 2.5 * rd), W, H)
    np.testing.assert_array_equal(to_np(cc["pix"]), want["cc"]["pix"])
    np.testing.assert_array_equal(to_np(cc["pix"]), np.arange(W * H))
    np.testing.assert_allclose(to_np(cc["d"]), want["cc"]["d"], atol=1e-5)
    np.testing.assert_allclose(to_np(cc["d"]), -rd, atol=1e-5)
    _close(cc, {k: want["cc"][k] for k in ("dist", "we", "valid")}, 1e-5,
           0.0, "camera_connect")


def test_trace_particles_matches_reference(scenes, reference):
    """One wave on the box and on the lit box (every delta light kind)."""
    for (sc, cfg), seed, name in zip(scenes, (5, 6), ("film", "film_lit")):
        rand = {k: torch.as_tensor(v) for k, v in particle_draws(
            jax.random.PRNGKey(seed), N_PATHS, DEPTH).items()}
        got = to_np(tpt.trace_particles(_port(sc), None, N_PATHS, W, H,
                                        max_depth=DEPTH, rr_depth=2,
                                        bsdf_types=cfg.bsdf_types, rand=rand,
                                        device="cpu"))
        want = reference.result()[name]
        assert (want > 0).mean() > 0.9, name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_vpls_match_reference(scenes, reference, monkeypatch):
    (js, jcfg), _ = scenes
    ts = _port(js)
    draws = vpl_draws(jax.random.PRNGKey(7), N_VPL_PATHS, DEPTH)
    got = tpt.generate_vpls(ts, N_VPL_PATHS, DEPTH,
                            bsdf_types=jcfg.bsdf_types,
                            rand={k: torch.as_tensor(v)
                                  for k, v in draws.items()}, device="cpu")
    want = reference.result()
    _close(got, want["vpls"], 1e-5, 1e-6, "generate_vpls")
    vpls = convert.vpls_from_arrays(want["vpls"], device="cpu")
    ro, rd = (torch.as_tensor(a) for a in _rays(js))
    for chunk in (5, None):  # VPLs a chunk; None: all in one
        if chunk:
            monkeypatch.setattr(tpt, "VPL_LANES", chunk * W * H)
        li = to_np(tpt.trace_vpl(ts, None, ro, rd, vpls,
                                 bsdf_types=jcfg.bsdf_types, device="cpu"))
        np.testing.assert_allclose(li, want["vpl_li"], rtol=1e-5, atol=1e-7,
                                   err_msg=f"chunk {chunk}")
        monkeypatch.undo()
    assert (want["vpl_li"] > 0).all(-1).mean() > 0.8
