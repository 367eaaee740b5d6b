"""Port parity of the lights: sample_direct on the box of
tests/torch_parity.py with delta lights (point, spot, directional,
collimated), with an env map, and with both, on identical points and
uniforms; sample_env, pdf_env_dir and env_eval on identical uniforms and
directions; the NEE tables the builders make; the sunsky env map against
the reference's make_sunsky_envmap (rtol 1e-5), and the port's copy of the
Hosek-Wilkie coefficients byte for byte. Tolerance elsewhere: rtol 1e-4,
atol 1e-5 (float32 trigonometry into bilinear texel weights), with the
discrete picks (light, triangle, pixel) and flags equal."""

import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import jax_scene_arrays, make_box, to_np  # noqa: E402

from sdmm_tpu.scene import emitters as jem  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu.scene import sunsky as jsun  # noqa: E402
from sdmm_tpu_torch.scene import emitters as tem  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.scene import sunsky as tsun  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _env_map(seed=0, he=24, we=48):
    rs = np.random.RandomState(seed)
    img = (rs.rand(he, we, 3) * 0.5).astype(np.float32)
    img[5:8, 30:34] = [30.0, 25.0, 20.0]  # a bright patch
    return img


def _lit(mod, shapes_mod, lights, env):
    b = make_box(mod, shapes_mod, 8, 8)
    if lights:
        b.add_point_light([0.3, 1.5, 0.2], [4.0, 3.0, 2.0])
        b.add_spot_light([-0.4, 1.8, 0.3], [0.2, -1.0, -0.1],
                         [6.0, 6.0, 6.0], cutoff_deg=35.0, beam_deg=20.0)
        b.add_directional_light([0.3, -1.0, 0.2], [1.5, 1.5, 1.5])
        b.add_collimated_light([0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                               [2.0, 2.0, 2.0])
    if env:
        b.env_map = _env_map()
        b.env_radiance = np.full(3, 1.7)
        a = np.deg2rad(25.0)
        b.env_to_world = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                   [-np.sin(a), 0, np.cos(a)]])
    return b


CASES = {"delta": (True, False), "env": (False, True), "both": (True, True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def scenes(request):
    lights, env = CASES[request.param]
    js, _ = _lit(jscene, jshapes, lights, env).build()
    ts, _ = _lit(tscene, tshapes, lights, env).build(device="cpu")
    return request.param, js, ts


def test_builders_make_the_same_light_tables(scenes):
    _, js, ts = scenes
    ja = jax_scene_arrays(js)
    for name in ("pt_pos", "pt_intensity", "pt_kind", "pt_dir",
                 "pt_cutoff_cos", "pt_beam_cos", "pt_cdf", "pt_select_prob",
                 "env_map", "env_to_world", "env_radiance", "env_row_cdf",
                 "env_col_cdf", "env_pdf", "env_select_prob"):
        np.testing.assert_array_equal(to_np(getattr(ts, name)), ja[name],
                                      err_msg=name)


def test_sample_direct_matches(scenes):
    case, js, ts = scenes
    rs = np.random.RandomState(5)
    n = 8192
    p = (rs.rand(n, 3) * [1.8, 1.8, 1.8] + [-0.9, 0.05, -0.9]).astype(
        np.float32)
    u1 = rs.rand(n).astype(np.float32)
    u2 = rs.rand(n, 2).astype(np.float32)
    jr = jem.sample_direct(js, jnp.asarray(p), jnp.asarray(u1),
                           jnp.asarray(u2))
    tr = tem.sample_direct(ts, torch.as_tensor(p), torch.as_tensor(u1),
                           torch.as_tensor(u2))
    assert set(tr) == set(jr)
    for k in ("valid", "delta"):
        np.testing.assert_array_equal(to_np(tr[k]), np.asarray(jr[k]), k)
    for k in ("d", "dist", "pdf", "radiance", "n"):
        np.testing.assert_allclose(to_np(tr[k]), np.asarray(jr[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    delta = to_np(tr["delta"])
    valid = to_np(tr["valid"])
    if case != "env":  # every kind of light drawn, the beam never valid
        kinds = set(to_np(ts.pt_kind)[np.searchsorted(
            to_np(ts.pt_cdf), u2[delta, 0])].tolist())
        assert kinds == {0, 1, 2, 3}
        assert valid[delta].mean() < 0.95
    if case != "delta":  # env samples: at distance 1e7, not delta
        env = to_np(tr["dist"]) == 1e7
        assert (env & ~delta).any()
    assert (valid & ~delta).any()


@pytest.fixture(scope="module")
def env_scenes():
    js, _ = _lit(jscene, jshapes, False, True).build()
    ts, _ = _lit(tscene, tshapes, False, True).build(device="cpu")
    return js, ts


def test_sample_env_matches(env_scenes):
    js, ts = env_scenes
    u2 = np.random.RandomState(2).rand(4096, 2).astype(np.float32)
    jd, jrad, jpdf = jem.sample_env(js, jnp.asarray(u2))
    td, trad, tpdf = tem.sample_env(ts, torch.as_tensor(u2))
    for a, b in ((td, jd), (trad, jrad), (tpdf, jpdf)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    # The bright patch draws most samples.
    assert (to_np(trad).max(-1) > 10.0).mean() > 0.5


def test_pdf_env_dir_and_env_eval_match(env_scenes):
    js, ts = env_scenes
    d = np.random.RandomState(3).randn(4096, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        to_np(tem.pdf_env_dir(ts, torch.as_tensor(d))),
        np.asarray(jem.pdf_env_dir(js, jnp.asarray(d))), rtol=RTOL,
        atol=ATOL)
    np.testing.assert_allclose(
        to_np(tem.env_eval(ts, torch.as_tensor(d))),
        np.asarray(jem.env_eval(js, jnp.asarray(d))), rtol=RTOL, atol=ATOL)
    # pdf_env_dir is the density sample_env draws from: its mean over
    # uniform directions is 1 / (4π).
    pdf = to_np(tem.pdf_env_dir(ts, torch.as_tensor(d)))
    assert abs(pdf.mean() * 4 * np.pi - 1.0) < 0.2


@pytest.mark.parametrize("kw", [
    {}, {"with_sky": False}, {"with_sun": False, "extend": True},
    {"turbidity": 6.5, "albedo": [0.1, 0.3, 0.2], "stretch": 1.3,
     "sun_radius_scale": 2.0, "sky_scale": 0.5, "sun_scale": 3.0}],
    ids=["sunsky", "sun", "sky_extended", "options"])
def test_sunsky_envmap_matches(kw):
    for sd in ([0.3, 0.5, -0.4], jsun.sun_coords_to_dir(
            *jsun.compute_sun_coordinates(hour=9.5, month=2))):
        np.testing.assert_allclose(
            tsun.make_sunsky_envmap(sd, resolution=24, **kw),
            jsun.make_sunsky_envmap(sd, resolution=24, **kw), rtol=1e-5,
            atol=0.0)
    assert tsun.compute_sun_coordinates(year=2021, latitude=-33.0) == \
        jsun.compute_sun_coordinates(year=2021, latitude=-33.0)


def test_hosek_coefficients_are_the_reference_file():
    port = ROOT / "sdmm_tpu_torch" / "data" / "hosek_rgb.npz"
    ref = ROOT / "sdmm_tpu" / "data" / "hosek_rgb.npz"
    assert port.read_bytes() == ref.read_bytes()
