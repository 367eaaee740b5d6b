"""Port parity: dipole subsurface scattering (sdmm_tpu_torch/render/
subsurface.py against sdmm_tpu's). The coefficients, the dipole kernel,
the bake's point set (numpy's generator, seeded alike) and the render-time
exitance match at rtol 1e-5 / atol 1e-6; the irradiance gather draws its
own uniforms and is held, as the reference's tests hold it, to the
analytic exitance of a uniformly lit plane (Jensen et al. 2001, eq. 9),
and the rendered plane to 1/π (1 − Fr) M."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import to_np  # noqa: E402

from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.render import subsurface as jsss  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render import subsurface as tsss  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
# mfp ~0.12 scene units, as the reference's plane test.
PARAMS = {"sigma_s": np.array([8.0, 8.0, 8.0]),
          "sigma_a": np.array([0.12, 0.24, 0.48]), "g": np.zeros(3),
          "eta": 1.3, "irr_samples": 4}


@pytest.mark.parametrize("params", [
    PARAMS, {"sigma_s": [1.0, 2.0, 3.0], "sigma_a": [0.5, 0.1, 0.05],
             "g": 0.4, "eta": 1.5}] + [
    dict(zip(("sigma_s", "sigma_a", "eta"), jsss.lookup_material(m)))
    for m in ("skin1", "marble", "ketchup")],
    ids=["plane", "explicit", "skin1", "marble", "ketchup"])
def test_dipole_coefficients_and_kernel_match(params):
    co, ref = tsss.dipole_coeffs(params), jsss.dipole_coeffs(params)
    assert co.keys() == ref.keys()
    for k in co:
        np.testing.assert_array_equal(co[k], ref[k], err_msg=k)
    r2 = (np.linspace(0.0, 8.0 * co["radius"], 4096) ** 2).astype(np.float32)
    args = [co[k].astype(np.float32) for k in ("zr", "zv", "sigma_tr")]
    np.testing.assert_allclose(
        to_np(tsss.dmo(torch.as_tensor(r2), *map(torch.as_tensor, args))),
        np.asarray(jsss.dmo(jnp.asarray(r2), *map(jnp.asarray, args))),
        rtol=2e-5, atol=1e-6)


def test_material_presets_match():
    assert tsss.MATERIALS == jsss.MATERIALS
    for m in tsss.MATERIALS:
        for a, b in zip(tsss.lookup_material(m), jsss.lookup_material(m)):
            np.testing.assert_array_equal(a, b)


def _plane(scene_mod, shapes_mod, side=2.5, n_grid=5, black=True):
    """The reference test's tessellated plane, cut to 5 × 5 units, under a
    constant white environment, one subsurface instance over it."""
    b = scene_mod.SceneBuilder()
    bsdf = b.add_bsdf(scene_mod.BSDF_DIFFUSE,
                      albedo=[0.0] * 3 if black else [0.5] * 3)
    s_id = b.add_subsurface(**PARAMS)
    cell = 2.0 * side / n_grid
    for iy in range(n_grid):
        for ix in range(n_grid):
            m = np.diag([cell / 2.0, cell / 2.0, 1.0, 1.0])
            m[0, 3] = -side + (ix + 0.5) * cell
            m[1, 3] = -side + (iy + 0.5) * cell
            b.add_shape(shapes_mod.make_rectangle(m, False), bsdf, sss=s_id)
    b.env_radiance = np.array([1.0, 1.0, 1.0])
    cam = np.eye(4)
    cam[:3, 3] = [0.0, 0.0, 3.0]
    cam[2, 2] = -1.0
    b.set_sensor(cam, 60.0, 16, 16)
    b.max_depth = b.rr_depth = 3
    return b.build() if scene_mod is jscene else b.build(device="cpu")


def test_surface_points_match():
    ts, _ = _plane(tscene, tshapes)
    arrs = [to_np(x).astype(np.float64) for x in
            (ts.tri_v0, ts.tri_e1, ts.tri_e2, ts.tri_ng)]
    got = tsss.sample_surface_points(*arrs, 0.05, np.random.default_rng(4))
    ref = jsss.sample_surface_points(*arrs, 0.05, np.random.default_rng(4))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 1000


def test_exitance_at_hits_matches():
    """sss_lo_factor on one baked table (random, positive) and the rays
    of both intersectors."""
    js, _ = _plane(jscene, jshapes)
    ts, _ = _plane(tscene, tshapes)
    rs = np.random.RandomState(2)
    m = rs.rand(*ts.sss_M.shape).astype(np.float32)
    n = 2048
    ro = np.concatenate([rs.uniform(-3, 3, (n, 2)), np.full((n, 1), 2.0)],
                        -1).astype(np.float32)
    rd = np.concatenate([rs.uniform(-0.5, 0.5, (n, 2)), -np.ones((n, 1))],
                        -1)
    rd[::7, 2] *= -1  # some rays miss
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    js = js._replace(sss_M=jnp.asarray(m))
    ts = ts._replace(sss_M=torch.as_tensor(m))
    jit = jisect.surface_interaction(
        js, jnp.asarray(ro), jnp.asarray(rd),
        jisect.intersect(js, jnp.asarray(ro), jnp.asarray(rd)))
    tro, trd = torch.as_tensor(ro), torch.as_tensor(rd)
    tit = tisect.surface_interaction(ts, tro, trd,
                                     tisect.intersect(ts, tro, trd))
    got = to_np(tsss.sss_lo_factor(ts, tit, -trd))
    np.testing.assert_allclose(
        got, np.asarray(jsss.sss_lo_factor(js, jit, -jnp.asarray(rd))),
        **TOL)
    assert (got > 0).any() and (got == 0).all(-1).any()


def _analytic_plane_exitance():
    """π L R / α' for L = 1: the baked M of a plane's interior."""
    sigma_tp = PARAMS["sigma_s"] + PARAMS["sigma_a"]
    alpha_p = PARAMS["sigma_s"] / sigma_tp
    fdr = tsss._fresnel_diffuse_reflectance(1.0 / PARAMS["eta"])
    a_const = (1.0 + fdr) / (1.0 - fdr)
    s = np.sqrt(3.0 * (1.0 - alpha_p))
    r = 0.5 * (1.0 + np.exp(-4.0 / 3.0 * a_const * s)) * np.exp(-s)
    return np.pi * r / alpha_p


def test_plane_bake_and_render_match_analytic():
    """The bake's interior corners hold π L R / α' (12%, the reference
    test's limit for the point set and the finite plane), and
    render_wavefront, on the eager pool with the dipole term, renders the
    centre pixels at 1/π (1 − Fr) M (15%) and ignores an unbaked scene's
    zero table only when told it is baked."""
    from sdmm_tpu_torch.bsdf.fresnel import fresnel_dielectric

    ts, tcfg = _plane(tscene, tshapes)
    assert tcfg.has_sss
    # Bake points 0.054 apart (the reference's 0.027 at multiplier 1),
    # still well under the 0.12 mean free path.
    tcfg.sss = ({**tcfg.sss[0], "sample_multiplier": 0.25},)
    baked = tsss.bake_subsurface(ts, tcfg, seed=3, device="cpu")
    corners = to_np(torch.stack([ts.tri_v0, ts.tri_v0 + ts.tri_e1,
                                 ts.tri_v0 + ts.tri_e2], 1))
    interior = np.abs(corners[..., :2]).max(-1) < 1.0
    want = _analytic_plane_exitance()
    np.testing.assert_allclose(to_np(baked.sss_M)[interior].mean(0), want,
                               rtol=0.12)
    out = twf.render_wavefront(ts, tcfg, spp=4, seed=5, device="cpu")
    assert out["pool"] == "eager"
    fr = float(fresnel_dielectric(torch.tensor(1.0), torch.tensor(1.3))[0])
    centre = out["image"][6:10, 6:10].mean((0, 1))
    np.testing.assert_allclose(centre, (1.0 - fr) / np.pi * want, rtol=0.15)
    tcfg.sss_baked = True  # the zero table of the unbaked scene
    dark = twf.render_wavefront(ts, tcfg, spp=1, seed=5, device="cpu")
    assert float(dark["image"].max()) == 0.0
