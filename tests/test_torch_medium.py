"""Port parity: participating media (sdmm_tpu_torch/render/medium.py and
scene/volume.py against sdmm_tpu's, and the media tables of both
SceneBuilders). Functions fed the same uniforms match at rtol 1e-5 / atol
1e-6 in float32; delta tracking, which draws its own uniforms, is held to
the reference's properties in expectation (constant density equals the
homogeneous medium, Beer-Lambert), Henyey-Greenstein sampling to its pdf."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import jax_scene_arrays, make_media_box, to_np  # noqa: E402

from sdmm_tpu.render import medium as jmed  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu.scene import volume as jvol  # noqa: E402
from sdmm_tpu_torch.render import medium as tmed  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.scene import volume as tvol  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _scenes(**kw):
    js, jcfg = make_media_box(jscene, jshapes, **kw).build()
    ts, tcfg = make_media_box(tscene, tshapes, **kw).build(device="cpu")
    return js, jcfg, ts, tcfg


@pytest.mark.parametrize("kw", [
    {}, {"hetero": False}, {"fog": False, "dipole": True}],
    ids=["fog_hetero", "fog_homogeneous", "interior_dipole"])
def test_builders_give_equal_media_tables(kw):
    js, jcfg, ts, tcfg = _scenes(**kw)
    ja = jax_scene_arrays(js)
    for name in tscene.SceneData._fields:
        if name not in tscene.PORT_FIELDS:
            np.testing.assert_array_equal(to_np(getattr(ts, name)), ja[name],
                                          err_msg=name)
    for f in ("has_medium", "has_hetero", "has_sss", "sss_baked"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert len(tcfg.sss) == len(jcfg.sss)


def _rows(n, n_med, seed):
    rs = np.random.RandomState(seed)
    med = rs.randint(0, n_med, n).astype(np.int32)
    u = rs.rand(n).astype(np.float32)
    u[:4] = [0.0, 1.0, 1.0 - 1e-8, 0.5]
    t_surf = (rs.rand(n) * 3.0).astype(np.float32)
    t_surf[4] = np.float32(1e30)  # an escaped ray
    return med, u, t_surf


def test_sample_distance_and_transmittance_match():
    js, _, ts, _ = _scenes(hetero=False)
    med, u, t_surf = _rows(4096, ts.med_sigma_t.shape[0], 0)
    ref = jmed.sample_distance(js, jnp.asarray(med), jnp.asarray(u),
                               jnp.asarray(t_surf))
    got = tmed.sample_distance(ts, torch.as_tensor(med), torch.as_tensor(u),
                               torch.as_tensor(t_surf))
    assert np.array_equal(to_np(got["scattered"]),
                          np.asarray(ref["scattered"]))
    assert got["scattered"].any() and not got["scattered"].all()
    for k in ("t", "weight"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(ref[k]), **TOL)
    dist = np.abs(t_surf[:64]).clip(0, 5)
    np.testing.assert_allclose(
        to_np(tmed.transmittance(ts, torch.as_tensor(med[:64]),
                                 torch.as_tensor(dist))),
        np.asarray(jmed.transmittance(js, jnp.asarray(med[:64]),
                                      jnp.asarray(dist))), **TOL)


def test_update_medium_and_density_match():
    js, _, ts, _ = _scenes()
    rs = np.random.RandomState(1)
    n = 2048
    T = ts.tri_v0.shape[0]
    med = rs.randint(0, ts.med_sigma_t.shape[0], n).astype(np.int32)
    tri = rs.randint(-1, T, n).astype(np.int32)
    wi = rs.randn(n).astype(np.float32)
    wo = rs.randn(n).astype(np.float32)
    mask = rs.rand(n) < 0.8
    ref = jmed.update_medium(js, jnp.asarray(med), jnp.asarray(tri),
                             jnp.asarray(wi), jnp.asarray(wo),
                             jnp.asarray(mask))
    got = tmed.update_medium(ts, torch.as_tensor(med), torch.as_tensor(tri),
                             torch.as_tensor(wi), torch.as_tensor(wo),
                             torch.as_tensor(mask))
    assert np.array_equal(to_np(got), np.asarray(ref))
    assert (to_np(got) != med).any()
    p = (rs.rand(n, 3) * np.array([1.0, 1.2, 1.0]) - [0.5, 0.0, 0.5])
    p = p.astype(np.float32)
    ref = jmed.density_at(js, jnp.asarray(med), jnp.asarray(p))
    got = tmed.density_at(ts, torch.as_tensor(med), torch.as_tensor(p))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)
    vals = to_np(got)
    assert ((vals != 0) & (vals != 1)).any() and (vals == 0).any()


@pytest.mark.parametrize("g", [-0.5, 0.0, 5e-4, 0.3, 0.9])
def test_hg_sample_and_pdf_match(g):
    rs = np.random.RandomState(2)
    n = 4096
    wi = rs.randn(n, 3)
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    u = rs.rand(n, 2).astype(np.float32)
    gg = np.full(n, g, np.float32)
    d_ref, pdf_ref = jmed.hg_sample(jnp.asarray(gg), jnp.asarray(wi),
                                    jnp.asarray(u))
    d, pdf = tmed.hg_sample(torch.as_tensor(gg), torch.as_tensor(wi),
                            torch.as_tensor(u))
    np.testing.assert_allclose(to_np(d), np.asarray(d_ref), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(to_np(pdf), np.asarray(pdf_ref), rtol=1e-5,
                               atol=1e-6)
    cos = rs.uniform(-1, 1, n).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tmed.hg_pdf(torch.as_tensor(gg), torch.as_tensor(cos))),
        np.asarray(jmed.hg_pdf(jnp.asarray(gg), jnp.asarray(cos))), **TOL)


@pytest.mark.parametrize("g", [-0.6, 0.0, 0.7])
def test_hg_sampling_follows_its_pdf(g):
    """Sampled cosines against the pdf integrated over 20 bins (a
    chi-square below the 0.999 quantile of 19 degrees of freedom)."""
    n = 100_000
    gen = torch.Generator().manual_seed(3)
    wi = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                       dim=-1)
    d, pdf = tmed.hg_sample(torch.full((n,), g), wi,
                            torch.rand((n, 2), generator=gen))
    cos = (d * wi).sum(-1).double().numpy()
    edges = np.linspace(-1, 1, 21)
    x = np.linspace(-1, 1, 20001)
    dens = 2 * np.pi * to_np(tmed.hg_pdf(torch.tensor(g, dtype=torch.float64),
                                         torch.as_tensor(x)))
    cdf = np.concatenate([[0], np.cumsum((dens[1:] + dens[:-1]) / 2
                                         * np.diff(x))])
    expect = np.diff(np.interp(edges, x, cdf)) * n
    hist = np.histogram(cos, edges)[0]
    chi2 = ((hist - expect) ** 2 / expect).sum()
    assert chi2 < 43.8, chi2
    np.testing.assert_allclose(
        to_np(pdf), to_np(tmed.hg_pdf(torch.full((n,), g),
                                      torch.as_tensor(cos).float())),
        rtol=1e-3, atol=1e-6)


def _slab(hetero):
    """A slab of sigma_t 0.8 on rays of length 1.5 through it."""
    b = tscene.SceneBuilder()
    if hetero:
        m = b.add_medium([0.8] * 3, [0.0] * 3, density=np.ones((4, 4, 4)),
                         vol_lo=[-5, -5, -5], vol_hi=[5, 5, 5])
    else:
        m = b.add_medium([0.8] * 3, [0.0] * 3)
    b.add_shape(tshapes.make_rectangle(np.eye(4)), 0, interior=m)
    return b.build(device="cpu")[0], m


def test_delta_tracking_matches_homogeneous_and_beer_lambert():
    """Constant density: the scatter share equals 1 - e^{-σd} and the
    binary transmittance averages e^{-σd} (4 standard errors), as the
    analytic homogeneous free flight does."""
    n, d = 40_000, 1.5
    want = np.exp(-0.8 * d)
    ro = torch.zeros((n, 3))
    rd = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    t_surf = torch.full((n,), d)
    se = np.sqrt(want * (1 - want) / n)
    het, m = _slab(True)
    ids = torch.full((n,), m, dtype=torch.int32)
    gen = torch.Generator().manual_seed(4)
    hs = tmed.sample_distance_hetero(het, ids, gen, ro, rd, t_surf)
    assert abs(1.0 - float(hs["scattered"].float().mean()) - want) < 4 * se
    t = hs["t"][hs["scattered"]]
    assert float(t.max()) < d and float(t.min()) > 0
    # Scatter depths follow the truncated exponential: mean below d / 2.
    assert float(t.mean()) < d / 2
    tr = tmed.transmittance_hetero(het, ids, gen, ro, rd, t_surf)
    assert abs(float(tr[:, 0].mean()) - want) < 4 * se
    hom, m0 = _slab(False)
    u = torch.rand(n, generator=gen)
    hs0 = tmed.sample_distance(hom, torch.full((n,), m0, dtype=torch.int32),
                               u, t_surf)
    assert abs(1.0 - float(hs0["scattered"].float().mean()) - want) < 4 * se
    np.testing.assert_allclose(
        to_np(tmed.transmittance(hom, torch.full((1,), m0),
                                 torch.tensor([d]))),
        want, rtol=1e-6)


def test_vol_files_round_trip_across_packages(tmp_path):
    rs = np.random.RandomState(5)
    dens = rs.rand(3, 4, 5).astype(np.float32)
    tvol.save_vol(str(tmp_path / "t.vol"), dens, [0, -1, 0], [1, 2, 3])
    jvol.save_vol(str(tmp_path / "j.vol"), dens, [0, -1, 0], [1, 2, 3])
    assert (tmp_path / "t.vol").read_bytes() == \
        (tmp_path / "j.vol").read_bytes()
    for a, b in zip(tvol.load_vol(str(tmp_path / "j.vol")),
                    jvol.load_vol(str(tmp_path / "t.vol"))):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.vol").write_bytes(b"XYZ\x03")
    with pytest.raises(ValueError):
        tvol.load_vol(str(tmp_path / "bad.vol"))
