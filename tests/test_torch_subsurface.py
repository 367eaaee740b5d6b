"""Port parity: dipole subsurface scattering (sdmm_tpu_torch/render/
subsurface.py against sdmm_tpu's). The coefficients, the dipole kernel,
the bake's point set (numpy's generator, seeded alike) and the render-time
exitance match at rtol 1e-5 / atol 1e-6. The render-time exitance and
the bake of a uniformly lit plane are in
tests/test_torch_subsurface_render.py, a file of few tests that the
tier-1 scheduler (``--dist loadfile``, files with the most tests first)
runs after the long reference files."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import to_np  # noqa: E402

from sdmm_tpu.render import subsurface as jsss  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu_torch.render import subsurface as tsss  # noqa: E402
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
