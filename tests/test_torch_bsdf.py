"""Port parity of the BSDFs: every type but irawan (codes 0-15 and 17;
irawan in tests/test_torch_irawan.py, and its dispatch here) and
the containers (blend with smooth and with delta children, mask, coating,
roughcoating), in ONE BSDF table built by both packages' SceneBuilder.
sample_full takes identical u0/u1/u2 and eval_pdf_full identical
directions; each reference function is called once, on one batch that
mixes every case, and each case's lanes are compared. Also the shading
frame, and the chi-square test of every sampled type through the port's
utils/chisquare.py with the reference test's parameters
(tests/test_bsdf_chisquare.py). Tolerance: rtol 1e-4, atol 1e-5 (float32;
the microfacet terms divide by small cosines)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import to_np  # noqa: E402

from sdmm_tpu.bsdf import bsdf as jbsdf  # noqa: E402
from sdmm_tpu.render import volpath as jvolpath  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.bsdf import bsdf as tbsdf  # noqa: E402
from sdmm_tpu_torch.render import volpath as tvolpath  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.utils.chisquare import chi2_test  # noqa: E402

RTOL = 1e-4
ATOL = 1e-5
TYPES = tuple(range(16)) + (17,)
CASES = TYPES + ("blend", "blend_delta", "mask", "coating", "roughcoating")
TRANSMISSIVE = (2, 6, 7, 13, 15, 17)
# Layered rows shade from the front only, as the shading frame flips them.
FRONT = (14, "coating", "roughcoating")
N = 2048  # lanes a case
# hk's transmission divides exp(-τ/|cos_i|) − exp(-τ/|cos_o|) by
# |cos_i| − |cos_o|: where the two cosines lie within 1e-3, one ulp of
# float32 exp moves the quotient by up to ~2e-4 in either package, and
# those lanes are held to this tolerance instead.
HK_NEAR, HK_NEAR_RTOL = 1e-3, 1e-3
torch.set_num_threads(1)


def _table(mod, shapes_mod):
    """One row of each case (its row id, by case) in one scene."""
    b = mod.SceneBuilder()
    rows = {}
    cu = dict(eta=0.2, k=[3.9, 2.4, 2.1])
    rows[0] = b.add_bsdf(0, albedo=[0.7, 0.5, 0.3])
    rows[1] = b.add_bsdf(1, specular=[0.9, 0.8, 0.7], **cu)
    rows[2] = b.add_bsdf(2, eta=1.5, albedo=[0.9, 0.95, 1.0])
    rows[3] = b.add_bsdf(3, alpha=0.2, **cu)
    rows[4] = b.add_bsdf(4, albedo=[0.4, 0.3, 0.2], specular=[0.3] * 3,
                         exponent=25.0)
    rows[5] = b.add_bsdf(5, albedo=[0.5, 0.2, 0.2], alpha=0.25, eta=1.49)
    rows[6] = b.add_bsdf(6, alpha=0.3, eta=1.5)
    rows[7] = b.add_bsdf(7)
    rows[8] = b.add_bsdf(8, albedo=[0.2, 0.5, 0.3], eta=1.49)
    rows[9] = b.add_bsdf(9, albedo=[0.3, 0.3, 0.4], specular=[0.25] * 3,
                         alpha=0.2, alpha_v=0.45)
    rows[12] = b.add_bsdf(12, albedo=[0.6, 0.5, 0.4], alpha=0.4)
    rows[13] = b.add_bsdf(13, albedo=[0.5, 0.6, 0.7])
    rows[14] = b.add_bsdf(14, child0=rows[0], eta=1.5, alpha=0.5,
                          albedo=[0.2, 0.4, 0.6], alpha_v=0.0)
    rows[15] = b.add_bsdf(15, albedo=[1.5, 1.0, 0.7],
                          specular=[0.05, 0.1, 0.2], alpha=0.8, eta=0.5)
    rows[17] = b.add_bsdf(17, eta=1.5)
    rows[10] = rows["blend"] = b.add_bsdf(10, child0=rows[0],
                                          child1=rows[3], weight=0.35)
    rows["blend_delta"] = b.add_bsdf(10, child0=rows[2], child1=rows[12],
                                     weight=0.6)
    rows[11] = rows["mask"] = b.add_bsdf(11, child0=rows[5],
                                         albedo=[0.6, 0.3, 0.8])
    rows["coating"] = rows[14]
    rows["roughcoating"] = b.add_bsdf(14, child0=rows[3], eta=1.6,
                                      alpha=0.3, albedo=[0.1, 0.2, 0.1],
                                      alpha_v=0.2)
    b.add_shape(shapes_mod.make_rectangle(np.eye(4)), rows[0])
    return b.build(**({} if mod is jscene else {"device": "cpu"}))[0], rows


def _inputs(seed=0):
    """Per-case lanes: row ids, wi (front-biased for reflective models),
    wo (both sides for transmissive ones) and the uniforms."""
    rs = np.random.RandomState(seed)
    n = N * len(CASES)
    wi = rs.randn(n, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = rs.randn(n, 3).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    for c, case in enumerate(CASES):
        s = slice(c * N, (c + 1) * N)
        if case not in TRANSMISSIVE:
            wi[s, 2] = np.where(rs.rand(N) < 0.9, np.abs(wi[s, 2]),
                                wi[s, 2])
            wo[s, 2] = np.abs(wo[s, 2])
        if case in FRONT:
            wi[s, 2] = np.abs(wi[s, 2])
    u = rs.rand(5, n).astype(np.float32)
    return wi, wo, u


@pytest.fixture(scope="module")
def runs():
    """Both packages' sample_full and eval_pdf_full on the mixed batch."""
    js, rows = _table(jscene, jshapes)
    ts, trows = _table(tscene, tshapes)
    assert rows == trows
    idx = np.repeat(np.asarray([rows[c] for c in CASES], np.int32), N)
    wi, wo, u = _inputs()
    u2 = np.ascontiguousarray(u[3:5].T)
    jp = jbsdf.gather_params(js, jnp.asarray(idx), types=TYPES)
    tp = tbsdf.gather_params(ts, torch.as_tensor(idx), types=TYPES)
    out = {"idx": idx, "wi": wi, "jp": jp, "tp": tp}
    out["js"] = jbsdf.sample_full(jp, jnp.asarray(wi), jnp.asarray(u[0]),
                                  jnp.asarray(u[1]), jnp.asarray(u2),
                                  types=TYPES)
    out["ts"] = tbsdf.sample_full(tp, torch.as_tensor(wi),
                                  torch.as_tensor(u[0]), torch.as_tensor(u[1]),
                                  torch.as_tensor(u2), types=TYPES)
    out["je"] = jbsdf.eval_pdf_full(jp, jnp.asarray(wi), jnp.asarray(wo),
                                    types=TYPES)
    out["te"] = tbsdf.eval_pdf_full(tp, torch.as_tensor(wi),
                                    torch.as_tensor(wo), types=TYPES)
    return out


def _lanes(case):
    c = CASES.index(case)
    return slice(c * N, (c + 1) * N)


@pytest.mark.parametrize("btype", CASES)
def test_sample_full_matches(runs, btype):
    s = _lanes(btype)
    jb, tb = runs["js"], runs["ts"]
    near = np.zeros(N, bool)
    if btype == 15:
        near = (np.abs(np.abs(runs["wi"][s, 2])
                       - np.abs(np.asarray(jb["wo"])[s, 2])) < HK_NEAR) \
            & ~np.asarray(jb["delta"])[s]
        assert near.mean() < 0.01
    for k in ("wo", "weight", "pdf", "eta"):
        a, b = to_np(tb[k])[s], np.asarray(jb[k])[s]
        np.testing.assert_allclose(a[~near], b[~near], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(a[near], b[near], rtol=HK_NEAR_RTOL,
                                   atol=ATOL, err_msg=k)
    for k in ("delta", "pass"):
        np.testing.assert_array_equal(to_np(tb[k])[s], np.asarray(jb[k])[s],
                                      err_msg=k)
    assert (to_np(tb["pdf"])[s] > 0).mean() > 0.4  # not vacuous


@pytest.mark.parametrize("btype", CASES)
def test_eval_pdf_full_matches(runs, btype):
    s = _lanes(btype)
    (jf, jpdf), (tf, tpdf) = runs["je"], runs["te"]
    np.testing.assert_allclose(to_np(tf)[s], np.asarray(jf)[s], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(to_np(tpdf)[s], np.asarray(jpdf)[s], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        to_np(tbsdf.is_delta_only(runs["tp"]))[s],
        np.asarray(jbsdf.is_delta_only(runs["jp"]))[s])
    if btype not in (1, 2, 7, 17):  # delta-only rows have no smooth lobe
        assert (to_np(tpdf)[s] > 0).mean() > 0.2  # not vacuous


def test_gather_params_matches(runs):
    """Every gathered field, containers resolved, on the mixed batch."""
    jp, tp = runs["jp"], runs["tp"]
    assert set(tp) == set(jp)
    for k, v in tp.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(to_np(vv),
                                              np.asarray(jp[k][kk]))
        else:
            np.testing.assert_array_equal(to_np(v), np.asarray(jp[k]),
                                          err_msg=k)


@pytest.mark.parametrize("btype", [0, 2, 6, 7, 15])
def test_shading_frame_matches(runs, btype):
    s = _lanes(btype)
    rs = np.random.RandomState(11)
    ns = rs.randn(N, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    wi = runs["wi"][s]
    jf = jvolpath.shading_frame({"type": runs["jp"]["type"][s]},
                                jnp.asarray(ns), jnp.asarray(wi))
    tf = tvolpath.shading_frame({"type": runs["tp"]["type"][s]},
                                torch.as_tensor(ns), torch.as_tensor(wi))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_irawan_is_refused():
    """Irawan is no longer refused. A woven row in a table with a diffuse
    one: each lane takes its own type's lobe; Irawan's eval is eval_irawan
    at the hit's uv with the cosine pdf, its sample is cosine-distributed
    with weight f / pdf."""
    from sdmm_tpu_torch.bsdf import irawan as tirawan

    b = tscene.SceneBuilder()
    b.irawan_pattern = tirawan.parse_weave(tirawan.PLAIN_WEAVE)
    b.add_shape(tshapes.make_rectangle(np.eye(4)),
                b.add_bsdf(0, albedo=[0.7, 0.5, 0.3]))
    b.add_shape(tshapes.make_rectangle(np.eye(4)),
                b.add_bsdf(tscene.BSDF_IRAWAN))
    scene, cfg = b.build(device="cpu")
    assert cfg.bsdf_types == (0, tscene.BSDF_IRAWAN)
    n = 4096
    g = torch.Generator().manual_seed(5)
    idx = (torch.arange(n) % 2).int()
    uv = torch.rand((n, 2), generator=g)
    wi = tbsdf.warp.square_to_cosine_hemisphere(torch.rand((n, 2),
                                                           generator=g))
    wo = tbsdf.warp.square_to_cosine_hemisphere(torch.rand((n, 2),
                                                           generator=g))
    p = tbsdf.gather_params(scene, idx, uv, types=cfg.bsdf_types)
    f, pdf = tbsdf.eval_pdf_full(p, wi, wo, types=cfg.bsdf_types)
    woven = idx == 1
    want = tirawan.eval_irawan(tirawan.device_tables(scene), uv, wi, wo)
    assert torch.equal(f[woven], want[woven])
    assert torch.allclose(f[~woven], torch.tensor([0.7, 0.5, 0.3])
                          * wo[~woven, 2:] / np.pi)
    assert torch.allclose(pdf, wo[:, 2] / np.pi, rtol=1e-6, atol=0.0)
    u = torch.rand((n, 4), generator=g)
    bs = tbsdf.sample_full(p, wi, u[:, 0], u[:, 1], u[:, 2:],
                           types=cfg.bsdf_types)
    assert torch.equal(bs["wo"], tbsdf.warp.square_to_cosine_hemisphere(
        u[:, 2:]))
    f_s, pdf_s = tbsdf.eval_pdf_full(p, wi, bs["wo"], types=cfg.bsdf_types)
    ok = pdf_s > 0
    assert ok.float().mean() > 0.99 and not bs["delta"].any()
    assert torch.allclose(bs["weight"][ok], f_s[ok] / pdf_s[ok, None],
                          rtol=1e-6, atol=0.0)
    assert (f[woven] > 0).all(-1).float().mean() > 0.99


def _params(btype, n, **over):
    """tests/test_bsdf_chisquare.py's make_params, as torch tensors."""
    def rows(v):
        return torch.tensor(v, dtype=torch.float32).expand(n, 3)

    return {
        "type": torch.full((n,), btype, dtype=torch.int32),
        "albedo": rows(over.get("albedo", [0.5, 0.4, 0.3])),
        "specular": rows(over.get("specular", [1.0, 1.0, 1.0])),
        "alpha": torch.full((n,), over.get("alpha", 0.3)),
        "eta": torch.full((n,), over.get("eta", 1.5)),
        "k": rows(over.get("k", [3.9, 2.45, 2.14])),
        "exponent": torch.full((n,), over.get("exponent", 30.0)),
        "alpha_v": torch.full((n,), over.get("alpha_v",
                                             over.get("alpha", 0.3))),
    }


CHI2 = [
    (0, {}), (3, {"alpha": 0.3}), (3, {"alpha": 0.08}),
    (4, {"exponent": 20.0}), (5, {"alpha": 0.25}), (8, {}),
    (6, {"alpha": 0.3}), (9, {"alpha": 0.2, "alpha_v": 0.45}),
    (9, {"alpha": 0.35, "alpha_v": 0.35}), (12, {"alpha": 0.4}), (13, {}),
    (15, {"albedo": [2.0, 2.0, 2.0], "specular": [0.1, 0.1, 0.1],
          "alpha": 0.4, "eta": 0.0}),
    (15, {"albedo": [1.5, 1.0, 0.7], "specular": [0.05, 0.1, 0.2],
          "alpha": 0.8, "eta": 0.5}),
    (6, {"alpha": 0.3, "wi": [0.3, 0.2, -0.9]}),  # from inside
]


@pytest.mark.parametrize("btype,over", CHI2, ids=[
    f"{t}-{i}" for i, (t, _) in enumerate(CHI2)])
def test_bsdf_chi2(btype, over):
    """The reference test's parameters and significance (0.0025): 200,000
    samples at its second wi angle (or from inside)."""
    over = dict(over)
    wi = np.asarray(over.pop("wi", [0.5, 0.1, np.sqrt(1 - 0.26)]))
    wi = (wi / np.linalg.norm(wi)).astype(np.float32)
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    u1 = torch.rand(n, generator=gen)
    u2 = torch.rand((n, 2), generator=gen)
    bs = tbsdf.sample(_params(btype, n, **over),
                      torch.as_tensor(wi).expand(n, 3), u1, u2,
                      types=(btype,))
    accepted = to_np((bs["weight"].max(-1).values > 0) & ~bs["delta"])
    dirs = to_np(bs["wo"])[accepted]

    def pdf_fn(d):
        m = d.shape[0]
        _, pdf = tbsdf.eval_pdf(_params(btype, m, **over),
                                torch.as_tensor(wi).expand(m, 3),
                                torch.as_tensor(d, dtype=torch.float32),
                                types=(btype,))
        return to_np(pdf)

    passed, p, st = chi2_test(dirs, pdf_fn)
    assert passed, (btype, p, st, accepted.mean())
