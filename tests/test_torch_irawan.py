"""Port parity of the Irawan woven-cloth BSDF (sdmm_tpu_torch/bsdf/irawan.py
against sdmm_tpu/bsdf/irawan.py), on the same numpy inputs:

- parse_weave (comments, $parameter substitution, both yarn kinds) gives
  the same pattern and tables; specular_normalization on the reference's
  own draws gives the reference's constant (rtol 1e-5);
- eval_irawan on the reference's tables at the same uv, wi and wo (rtol
  1e-5, atol 1e-6, or on an ill-conditioned lane no further than twice
  the reference's own float32 error, measured against a float64
  evaluation: irawan.float32_disagreement), and the BSDF dispatch's
  Irawan branches (eval_pdf_full with the cosine pdf, sample_full with its
  cosine sampling and weight f/pdf) on a scene the reference built, the
  sampled directions and pdfs at tests/test_torch_bsdf.py's rtol 1e-4,
  atol 1e-5 (the cosine warp's z = sqrt(1 - r²) near the horizon);
- a box with a woven back wall (the reference's scene, its normalisation
  carried across by guiding/convert.scene_from_arrays) rendered by the
  port's NEE pool and SDMMTrainer within 4 standard errors of the
  reference's NEE pool.

The reference's normalisation and render compile in a background thread
while the port's parts run.
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
from torch_parity import (  # noqa: E402
    TEST_WEAVE, TEST_WEAVE_PARAMS, film_mean_se, irawan_norm_draws,
    jax_scene_arrays, make_irawan_box, to_np, within_se,
)

from sdmm_tpu.bsdf import bsdf as jbsdf  # noqa: E402
from sdmm_tpu.bsdf import irawan as jirawan  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.bsdf import bsdf as tbsdf  # noqa: E402
from sdmm_tpu_torch.bsdf import irawan as tirawan  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.guiding.convert import scene_from_arrays  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402

torch.set_num_threads(2)
W = H = 16
SPP = 64


def _reference_tables():
    return {name: {k: np.asarray(v) for k, v in jirawan.build_tables(
        jirawan.parse_weave(text, params)).items()}
        for name, (text, params) in {
            "plain": (jirawan.PLAIN_WEAVE, None),
            "test": (TEST_WEAVE, TEST_WEAVE_PARAMS)}.items()}


def _reference_render():
    js, jcfg = make_irawan_box(jscene, jshapes, jirawan, W, H).build()
    out = jwf.render_pool(js, jax.random.PRNGKey(7), n_lanes=4096, spp=SPP,
                          width=W, height=H, max_depth=5, rr_depth=5,
                          nee=True, bsdf_types=jcfg.bsdf_types)
    return js, jcfg, film_mean_se(out["image"], out["sqr"], out["weight"])


@pytest.fixture(scope="module")
def reference():
    with ThreadPoolExecutor(1) as ex:
        tables = ex.submit(_reference_tables)
        render = ex.submit(_reference_render)
        yield {"tables": tables, "render": render}


def _weave_fields(wp):
    return (wp.name, wp.alpha, wp.beta, wp.ss, wp.h_width, wp.warp_area,
            wp.weft_area, wp.tile_width, wp.tile_height, wp.repeat_u,
            wp.repeat_v)


def test_parse_weave_and_normalization_match_reference(reference):
    wi, wo, uv = (torch.tensor(x) for x in irawan_norm_draws())
    tabs = reference["tables"].result()
    for name, (text, params) in {
            "plain": (tirawan.PLAIN_WEAVE, None),
            "test": (TEST_WEAVE, TEST_WEAVE_PARAMS)}.items():
        tp = tirawan.parse_weave(text, params)
        jp = jirawan.parse_weave(text, params)
        assert _weave_fields(tp) == _weave_fields(jp), name
        np.testing.assert_array_equal(tp.pattern, jp.pattern)
        assert tp.yarns == jp.yarns, name
        tt, jt = tp.tables(), jp.tables()
        assert tt.keys() == jt.keys()
        for k in tt:
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
        norm = tirawan.specular_normalization(
            {k: torch.as_tensor(v) for k, v in tt.items()}, wi, wo, uv)
        np.testing.assert_allclose(norm, tabs[name]["consts"][8], rtol=1e-5)
        # The port's own tables draw from a CPU generator seeded 0.
        own = tirawan.build_tables(tp)
        for k in ("pattern", "yarns", "kd", "ks"):
            np.testing.assert_array_equal(own[k], jt[k], err_msg=k)
        np.testing.assert_array_equal(own["consts"][:8], jt["consts"][:8])
        assert 0.0 < own["consts"][8] < np.inf
    assert tp.yarns[0]["psi"] == 0.0 and tp.yarns[1]["psi"] > 0.0


def _lanes(n, seed):
    """uv across several tiles (negative ones too) and directions on both
    sides of the surface, mostly in front."""
    rs = np.random.RandomState(seed)
    uv = (rs.rand(n, 2) * 4.0 - 1.5).astype(np.float32)

    def dirs():
        d = rs.randn(n, 3)
        d[:, 2] = np.abs(d[:, 2]) * np.where(rs.rand(n) < 0.9, 1.0, -1.0)
        return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)

    return uv, dirs(), dirs()


def test_eval_irawan_and_dispatch_match_reference(reference):
    tabs = reference["tables"].result()
    uv, wi, wo = _lanes(16384, 3)
    for name, tab in tabs.items():
        want = np.asarray(jirawan.eval_irawan(
            {k: jnp.asarray(v) for k, v in tab.items()}, jnp.asarray(uv),
            jnp.asarray(wi), jnp.asarray(wo)))
        got = to_np(tirawan.eval_irawan(
            {k: torch.tensor(v) for k, v in tab.items()},
            torch.as_tensor(uv), torch.as_tensor(wi), torch.as_tensor(wo)))
        t64 = {k: torch.tensor(v).double() if v.dtype == np.float32
               else torch.tensor(v) for k, v in tab.items()}
        exact = to_np(tirawan.eval_irawan(
            t64, *(torch.as_tensor(x).double() for x in (uv, wi, wo))))
        bad = tirawan.float32_disagreement(got, want, exact)
        assert not bad.any(), (name, np.argwhere(bad)[:5], got[bad],
                               want[bad])
        assert (want > 0).mean() > 0.5 and np.isfinite(got).all()
        assert (want[..., 0] > want[..., 0].mean() * 20).any()  # highlights

    # The dispatch on a scene the reference built: one woven rectangle.
    b = jscene.SceneBuilder()
    b.irawan_pattern = jirawan.parse_weave(TEST_WEAVE, TEST_WEAVE_PARAMS)
    b.add_shape(jshapes.make_rectangle(np.eye(4)),
                b.add_bsdf(jscene.BSDF_IRAWAN))
    js, _ = b.build()
    ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    n = uv.shape[0]
    idx = np.zeros(n, np.int32)
    types = (jscene.BSDF_IRAWAN,)
    jp = jbsdf.gather_params(js, jnp.asarray(idx), jnp.asarray(uv),
                             types=types)
    tp = tbsdf.gather_params(ts, torch.as_tensor(idx), torch.as_tensor(uv),
                             types=types)
    jf, jpdf = jbsdf.eval_pdf_full(jp, jnp.asarray(wi), jnp.asarray(wo),
                                   types=types)
    tf, tpdf = tbsdf.eval_pdf_full(tp, torch.as_tensor(wi),
                                   torch.as_tensor(wo), types=types)
    np.testing.assert_allclose(to_np(tpdf), np.asarray(jpdf), rtol=1e-6)
    exact = to_np(tirawan.eval_irawan(
        {k: v.double() if v.is_floating_point() else v
         for k, v in tirawan.device_tables(ts).items()},
        *(torch.as_tensor(x).double() for x in (uv, wi, wo))))
    assert not tirawan.float32_disagreement(to_np(tf), np.asarray(jf),
                                            exact).any()
    rs = np.random.RandomState(4)
    u0, u1 = (rs.rand(n).astype(np.float32) for _ in range(2))
    u2 = rs.rand(n, 2).astype(np.float32)
    jbs = jbsdf.sample_full(jp, jnp.asarray(wi), jnp.asarray(u0),
                            jnp.asarray(u1), jnp.asarray(u2), types=types)
    tbs = tbsdf.sample_full(tp, torch.as_tensor(wi), torch.as_tensor(u0),
                            torch.as_tensor(u1), torch.as_tensor(u2),
                            types=types)
    np.testing.assert_allclose(to_np(tbs["wo"]), np.asarray(jbs["wo"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(tbs["pdf"]), np.asarray(jbs["pdf"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(to_np(tbs["delta"]),
                                  np.asarray(jbs["delta"]))
    # The weight is f / pdf at the sampled direction.
    f_s, pdf_s = tbsdf.eval_pdf_full(tp, torch.as_tensor(wi), tbs["wo"],
                                     types=types)
    ok = to_np(pdf_s) > 0
    assert ok.mean() > 0.5
    np.testing.assert_allclose(to_np(tbs["weight"])[ok],
                               to_np(f_s)[ok] / to_np(pdf_s)[ok][:, None],
                               rtol=1e-6)
    ws = to_np(tbs["weight"])
    exact_w = to_np(tirawan.eval_irawan(
        {k: v.double() if v.is_floating_point() else v
         for k, v in tirawan.device_tables(ts).items()},
        torch.as_tensor(uv).double(), torch.as_tensor(wi).double(),
        tbs["wo"].double())) / np.maximum(to_np(tbs["pdf"]), 1e-20)[:, None]
    assert not tirawan.float32_disagreement(
        ws, np.asarray(jbs["weight"]), exact_w, rtol=1e-4, atol=1e-5).any()


def test_irawan_box_renders_match_reference(reference):
    js, jcfg, want = reference["render"].result()
    ts = scene_from_arrays(jax_scene_arrays(js), device="cpu")
    np.testing.assert_array_equal(to_np(ts.iw_consts), np.asarray(
        js.iw_consts))
    assert not twf.fused_supported(ts, jcfg)
    out = twf.render_pool(ts, torch.Generator().manual_seed(7), 4096, SPP,
                          W, H, 5, 5, True, jcfg.bsdf_types, device="cpu")
    got = film_mean_se(to_np(out["image"]), to_np(out["sqr"]),
                       to_np(out["weight"]))
    assert want[0] > 0.05 and within_se(got, want), (got, want)

    # SDMM: two training iterations, then the frozen model.
    cfg = ttrainer.TrainerConfig(max_leaves=16, samples_per_iteration=8,
                                 rays_per_wave=1024, train_fraction=0.5,
                                 em=tem.EMConfig(batch_size=256))
    tr = ttrainer.SDMMTrainer(ts, jcfg, cfg, device="cpu")
    img, iters = tr.run(total_spp=32)
    assert len(iters) == 4 and np.isfinite(img).all()
    # The combined image's standard error from its iterations', with the
    # combination's channel-mean weights.
    ses = [film_mean_se(it["image"], it["sqr"], it["weight"])[1]
           for it in iters]
    iv = np.asarray([1.0 / max(s * s, 1e-30) for s in ses])
    se = float(np.sqrt(((iv / iv.sum()) ** 2 * np.square(ses)).sum()))
    assert within_se((float(img.mean()), se), want), (img.mean(), se, want)
