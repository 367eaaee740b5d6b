"""Port parity: samplers and reconstruction filters
(sdmm_tpu_torch/core/sampler.py, render/rfilters.py and
film.splat_gaussian against sdmm_tpu's). Deterministic functions match at
rtol 1e-5 / atol 1e-6 in float32 (the integer ones bit for bit, Sobol also
against scipy); the per-pixel rotations, which the reference draws from
its key, are held to their properties: stratification, low discrepancy,
and pixels that decorrelate. Mitchell-Netravali and Catmull-Rom take
Mitsuba's 2-pixel radius, where the reference halves it (ROADMAP §C): they
are held to the reference's formula at that radius. On the box, the image
mean of renderer.render under each sampler and rfilter keeps the
independent/box image's."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (  # noqa: E402
    film_mean_se, make_box, to_np, within_se,
)

from sdmm_tpu.core import sampler as jsamp  # noqa: E402
from sdmm_tpu.render import film as jfilm  # noqa: E402
from sdmm_tpu.render import rfilters as jrf  # noqa: E402
from sdmm_tpu_torch.core import sampler as tsamp  # noqa: E402
from sdmm_tpu_torch.render import film as tfilm  # noqa: E402
from sdmm_tpu_torch.render import renderer as trenderer  # noqa: E402
from sdmm_tpu_torch.render import rfilters as trf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
IDX = np.concatenate([np.arange(4096), [65535, 1 << 20, (1 << 31) - 1]])


@pytest.mark.parametrize("base", [2, 3, 5, 7, 29])
def test_radical_inverse_matches(base):
    got = tsamp.radical_inverse(torch.as_tensor(IDX), base)
    ref = jsamp.radical_inverse(jnp.asarray(IDX, jnp.int32), base)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def test_sobol_nd_matches_reference_and_scipy():
    from scipy.stats import qmc

    got = to_np(tsamp.sobol_nd(torch.arange(1024), 16))
    np.testing.assert_array_equal(
        got, np.asarray(jsamp.sobol_nd(jnp.arange(1024), 16)))
    want = qmc.Sobol(d=16, scramble=False, bits=32).random(1024)
    np.testing.assert_array_equal(got, np.floor(want * 2 ** 24) / 2 ** 24)
    # A digital shift keeps the net: every 1/1024 interval of each
    # dimension holds one point of the first 1024.
    shifted = to_np(tsamp.sobol_nd(torch.arange(1024), 16,
                                   torch.Generator().manual_seed(1)))
    assert not np.array_equal(shifted, got)
    for k in range(16):
        assert len(np.unique(np.floor(shifted[:, k] * 1024))) == 1024


def test_unrotated_2d_points_match():
    """With a zero rotation the port's 2-D points are the reference's
    sequences: Halton's radical inverses, the first two Sobol
    dimensions, the stratified grid's cell corners."""
    idx = torch.as_tensor(IDX)
    zero = torch.zeros((IDX.size, 2))
    h = to_np(tsamp.halton_2d(idx, zero, dim_pair=1))
    np.testing.assert_array_equal(h[:, 0], np.asarray(
        jsamp.radical_inverse(jnp.asarray(IDX, jnp.int32), 5)))
    np.testing.assert_array_equal(h[:, 1], np.asarray(
        jsamp.radical_inverse(jnp.asarray(IDX, jnp.int32), 7)))
    s = to_np(tsamp.sobol_2d(idx, zero))
    ju = jnp.asarray(IDX, jnp.uint32)
    v = jnp.zeros_like(ju)
    for k in range(32):
        v = v ^ ((ju >> k) & 1) * jnp.uint32(jsamp._SOBOL_DIRS[k])
    scale = np.float32(2.0 ** -32)
    np.testing.assert_array_equal(s[:, 0], np.asarray(
        jsamp._bit_reverse32(ju).astype(jnp.float32) * scale) % 1.0)
    np.testing.assert_array_equal(s[:, 1], np.asarray(
        v.astype(jnp.float32) * scale) % 1.0)
    st = to_np(tsamp.stratified_2d(idx[:64], 64, zero[:64]))
    np.testing.assert_array_equal(st * 8, np.stack(
        [np.arange(64) % 8, np.arange(64) // 8], -1))


@pytest.mark.parametrize("kind", ["stratified", "halton", "sobol"])
def test_rotated_samplers_stratify_and_decorrelate(kind):
    """Each pixel's 64 points put one in each cell of the 8×8 grid
    (stratified, and Sobol, a (0, 2)-sequence) or keep a star-type
    discrepancy far below that of 64 random points (Halton); two pixels'
    rotations differ."""
    rot = tsamp.pixel_rotations(torch.Generator().manual_seed(2), 4)
    pix = torch.tensor([1] * 64 + [3] * 64)
    s_idx = torch.arange(128) % 64
    pts = to_np(tsamp.camera_jitter(kind, rot, pix, s_idx, 64))
    assert ((pts >= 0) & (pts < 1)).all()
    assert not np.allclose(pts[:64], pts[64:])
    for p, r in ((pts[:64], to_np(rot[1])), (pts[64:], to_np(rot[3]))):
        if kind == "halton":
            grid = np.linspace(0, 1, 9)[1:]
            disc = max(abs(((p[:, 0] < a) & (p[:, 1] < b)).mean() - a * b)
                       for a in grid for b in grid)
            assert disc < 0.08
        elif kind == "stratified":  # the rotation jitters within a cell
            cells = np.floor(p * 8).astype(int)
            assert len({tuple(c) for c in cells}) == 64
        else:
            # The rotation moves the grid's origin; the unrotated points lie
            # on multiples of 1/64, nudged past float rounding.
            cells = np.floor(((p - r) % 1.0 + 1e-4) * 8).astype(int) % 8
            assert len({tuple(c) for c in cells}) == 64


@pytest.fixture
def mitsuba_radius(monkeypatch):
    """The reference's filters with Mitchell-Netravali over Mitsuba's
    2-pixel radius, the port's departure (its |2x| halves the support)."""
    half = jrf._mitchell_1d
    monkeypatch.setattr(jrf, "_mitchell_1d",
                        lambda x, b=1.0 / 3.0, c=1.0 / 3.0: half(x / 2, b, c))


@pytest.mark.parametrize("name", ["tent", "gaussian", "mitchell",
                                  "catmullrom", "lanczos"])
def test_filter_weights_match(name, mitsuba_radius):
    rs = np.random.RandomState(6)
    dx, dy = (rs.uniform(-3.5, 3.5, 8192).astype(np.float32)
              for _ in range(2))
    dx[:3] = [0.0, 1e-7, 2.0]
    got = trf.filter_weight(name, torch.as_tensor(dx), torch.as_tensor(dy))
    ref = jrf.filter_weight(name, jnp.asarray(dx), jnp.asarray(dy))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


def test_mitchell_kernels_partition_unity():
    """Over integer shifts the Mitchell-Netravali and Catmull-Rom kernels
    sum to 1 at every offset, so a sample's taps never cancel."""
    f = torch.linspace(-0.5, 0.5, 101)
    for b, c in ((1.0 / 3.0, 1.0 / 3.0), (0.0, 0.5)):
        total = sum(trf._mitchell_1d(k - f, b, c) for k in range(-2, 3))
        np.testing.assert_allclose(to_np(total), 1.0, atol=4e-6)


def _wave(n=4096, w=12, h=9, seed=7):
    rs = np.random.RandomState(seed)
    pix = rs.randint(0, w * h, n).astype(np.int32)
    px = ((pix % w) + rs.rand(n)).astype(np.float32)
    py = ((pix // w) + rs.rand(n)).astype(np.float32)
    vals = rs.rand(n, 3).astype(np.float32)
    return pix, px, py, vals, w, h


@pytest.mark.parametrize("name", ["box", "tent", "gaussian", "mitchell",
                                  "catmullrom", "lanczos", "splat_gaussian"])
def test_filtered_splats_match(name, mitsuba_radius):
    pix, px, py, vals, w, h = _wave()
    z = (np.zeros((w * h, 3), np.float32), np.zeros((w * h, 3), np.float32),
         np.zeros(w * h, np.float32))
    args = (pix, vals, px, py)
    if name == "splat_gaussian":
        ref = jfilm.splat_gaussian(*map(jnp.asarray, z + args[:2]),
                                   *map(jnp.asarray, args[2:]), w, h)
        got = tfilm.splat_gaussian(*map(torch.as_tensor, z + args[:2]),
                                   *map(torch.as_tensor, args[2:]), w, h)
    else:
        ref = jrf.splat_filtered(*map(jnp.asarray, z + args), w, h, name)
        got = trf.splat_filtered(*map(torch.as_tensor, z + args), w, h, name)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5,
                                   atol=2e-5)
    # Every sample deposits total weight 1.
    np.testing.assert_allclose(float(got[2].sum()), len(pix), rtol=1e-5)


def _stats(out):
    return film_mean_se(out["raw"], out["sqr"], out["weight"])


@pytest.mark.parametrize("sampler,rfilter", [
    ("stratified", "box"), ("halton", "box"), ("sobol", "box"),
    ("independent", "tent"), ("independent", "gaussian"),
    ("independent", "mitchell"), ("independent", "catmullrom"),
    ("independent", "lanczos")])
def test_samplers_and_rfilters_keep_the_mean(sampler, rfilter):
    """On the plain box the image mean under each sampler and filter lies
    within 4 standard errors of the independent/box image's."""
    ts, tcfg = make_box(tscene, tshapes).build(device="cpu")
    base = _stats(trenderer.render(ts, tcfg, spp=32, seed=8, device="cpu"))
    out = trenderer.render(ts, tcfg, spp=32, seed=9, sampler=sampler,
                           rfilter=rfilter, device="cpu")
    assert np.isfinite(out["image"]).all()
    if rfilter == "box":
        assert (out["weight"] == 32).all()
    got = _stats(out)
    assert within_se(got, base), (got, base)
