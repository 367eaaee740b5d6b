"""Port parity: scene building, camera rays, intersection, surface
interaction and film (sdmm_tpu_torch vs sdmm_tpu on the same numpy inputs).
Tolerance: rtol 1e-5 (float32 arithmetic in both; ray-triangle distances
and barycentrics agree to a few ulps)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import jax_scene_arrays, make_box, to_np  # noqa: E402

from sdmm_tpu.render import film as jfilm  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import sensor as jsensor  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.render import film as tfilm  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import sensor as tsensor  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

RTOL = 1e-5
torch.set_num_threads(1)


def _scenes(extra=False):
    js, jcfg = make_box(jscene, jshapes, 16, 12, extra).build()
    ts, tcfg = make_box(tscene, tshapes, 16, 12, extra).build(device="cpu")
    return js, jcfg, ts, tcfg


@pytest.mark.parametrize("extra", [False, True])
def test_scene_builders_give_equal_arrays(extra):
    js, jcfg, ts, tcfg = _scenes(extra)
    ja = jax_scene_arrays(js)
    for name in tscene.SceneData._fields:
        if name in tscene.PORT_FIELDS:  # the reference has no such array
            continue
        np.testing.assert_array_equal(to_np(getattr(ts, name)), ja[name],
                                      err_msg=name)
    assert (tcfg.width, tcfg.height, tcfg.max_depth, tcfg.rr_depth,
            tcfg.fov_axis, tcfg.bsdf_types) == (
        jcfg.width, jcfg.height, jcfg.max_depth, jcfg.rr_depth,
        jcfg.fov_axis, jcfg.bsdf_types)


def test_scene_from_numpy_roundtrip():
    js, _, _, _ = _scenes(True)
    ts = tscene.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    assert ts.tri_bsdf.dtype == torch.int32
    np.testing.assert_array_equal(to_np(ts.tri_v0), np.asarray(js.tri_v0))


def _rays(js, ts, n=777, seed=0):
    rs = np.random.RandomState(seed)
    pxy = (rs.rand(n, 2) * [16, 12]).astype(np.float32)
    jo, jd = jsensor.generate_rays(js, jnp.asarray(pxy), 16, 12, "x")
    to, td = tsensor.generate_rays(ts, torch.as_tensor(pxy), 16, 12, "x")
    return jo, jd, to, td


def test_generate_rays_match():
    js, _, ts, _ = _scenes()
    jo, jd, to, td = _rays(js, ts)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(to_np(td), np.asarray(jd), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("extra", [False, True])
def test_intersect_and_surface_interaction_match(extra):
    js, _, ts, _ = _scenes(extra)
    jo, jd, to, td = _rays(js, ts, seed=1 + int(extra))
    jh = jisect.intersect(js, jo, jd)
    th = tisect.intersect(ts, to, td)
    np.testing.assert_array_equal(to_np(th["tri"]), np.asarray(jh["tri"]))
    np.testing.assert_array_equal(to_np(th["valid"]), np.asarray(jh["valid"]))
    ok = np.asarray(jh["valid"])
    assert ok.mean() > 0.9
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(to_np(th[k])[ok], np.asarray(jh[k])[ok],
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    ji = jisect.surface_interaction(js, jo, jd, jh)
    ti = tisect.surface_interaction(ts, to, td, th)
    for k in ("p", "ng", "ns", "uv"):
        np.testing.assert_allclose(to_np(ti[k]), np.asarray(ji[k]),
                                   rtol=RTOL, atol=1e-5, err_msg=k)
    for k in ("bsdf", "emitter"):
        np.testing.assert_array_equal(to_np(ti[k]), np.asarray(ji[k]))


def test_film_splat_develop_variance_match():
    rs = np.random.RandomState(3)
    n_pix, n = 20, 300
    idx = rs.randint(0, n_pix, size=n).astype(np.int32)
    val = rs.rand(n, 3).astype(np.float32)
    mask = rs.rand(n) < 0.7
    z3 = np.zeros((n_pix, 3), np.float32)
    z1 = np.zeros(n_pix, np.float32)
    ji, jq, jw = jfilm.splat(jnp.asarray(z3), jnp.asarray(z3),
                             jnp.asarray(z1), jnp.asarray(idx),
                             jnp.asarray(val), jnp.asarray(mask))
    ti, tq, tw = tfilm.splat(torch.as_tensor(z3), torch.as_tensor(z3),
                             torch.as_tensor(z1), torch.as_tensor(idx),
                             torch.as_tensor(val), torch.as_tensor(mask))
    for a, b in ((ti, ji), (tq, jq), (tw, jw)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=RTOL,
                                   atol=1e-6)
    np.testing.assert_allclose(to_np(tfilm.develop(ti, tw)),
                               np.asarray(jfilm.develop(ji, jw)), rtol=RTOL)
    np.testing.assert_allclose(to_np(tfilm.variance(ti, tq, tw)),
                               np.asarray(jfilm.variance(ji, jq, jw)),
                               rtol=1e-4, atol=1e-6)
