"""Port parity of the textures and bump maps: sample_texture,
eval_proc_texture (every kind) and gather_params' textured albedo on
identical uv; surface_interaction's widened uv row (vertex colours and edge
distances); apply_bumpmap with height and normal maps on identical hits;
each against the reference at rtol 1e-4, atol 1e-5 (the bumped normals
atol 1e-4: a finite difference of the texture). And utils/png.py
against PIL's decode on PNGs written here (8- and 16-bit grey, grey+alpha,
RGB, RGBA, palette with and without tRNS, every filter type): the arrays
equal (PIL keeps only the high byte of 16-bit colour, so those compare
as >> 8); an interlaced PNG raises."""

import os
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import compose, to_np  # noqa: E402

from sdmm_tpu.bsdf import bsdf as jbsdf  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.bsdf import bsdf as tbsdf  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.utils.png import read_png  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
# The height map's gradient is a central difference one texel apart: it
# multiplies float32 rounding of the bilinear weights by the texture's
# resolution, so the bumped unit normals are held to 1e-4.
BUMP_ATOL = 1e-4
N = 4096
torch.set_num_threads(1)


def _textured(mod, shapes_mod):
    """Rectangles and a sphere with bitmap, every procedural kind, bump and
    normal maps; the sphere's colours from the curvature bake."""
    rs = np.random.RandomState(0)
    b = mod.SceneBuilder()
    b.texture_res = 32
    bmp = b.add_texture(rs.rand(20, 12, 3).astype(np.float32))
    hgt = b.add_texture(rs.rand(16, 16).astype(np.float32))
    nrm = b.add_texture(rs.rand(8, 8, 3).astype(np.float32))
    procs = [
        b.add_proc_texture(0, [0.9, 0.1, 0.1], [0.1, 0.9, 0.1], uscale=3.0,
                           vscale=2.0, uoffset=-0.3, voffset=0.1),
        b.add_proc_texture(1, [0.2, 0.3, 0.4], [0.8, 0.7, 0.6],
                           line_width=0.08, uscale=2.5),
        b.add_proc_texture(2),
        b.add_proc_texture(3, [0.05, 0.05, 0.05], [0.6, 0.5, 0.4],
                           line_width=0.0, step_width=0.4),
    ]
    rows = [b.add_bsdf(0, tex=bmp), b.add_bsdf(5, tex=bmp, bump=hgt,
                                                bump_scale=0.7),
            b.add_bsdf(4, bump=-(nrm + 2)), b.add_bsdf(0)]
    rows += [b.add_bsdf(0, tex=c) for c in procs]
    for i, r in enumerate(rows):
        tw = compose([0.3 * i - 1.0, 0.5, -0.2 * i], [0.4, 0.3, 1.0],
                     rx=10 * i, ry=-20 + 7 * i)
        b.add_shape(shapes_mod.make_rectangle(tw), r)
    b.add_shape(shapes_mod.bake_curvature(shapes_mod.make_sphere(
        [0.0, 0.0, 0.0], 0.5, n_theta=6, n_phi=10), scale=0.3), rows[6])
    return b.build(**({} if mod is jscene else {"device": "cpu"}))[0]


@pytest.fixture(scope="module")
def scenes():
    return _textured(jscene, jshapes), _textured(tscene, tshapes)


def _uv(seed, n=N, wide=False):
    rs = np.random.RandomState(seed)
    uv = (rs.rand(n, 2) * 3.0 - 1.0).astype(np.float32)  # wraps both ways
    if wide:  # (u, v, vertex colour, edge distance)
        uv = np.concatenate([uv, rs.rand(n, 4).astype(np.float32) * 0.1],
                            axis=1)
    return uv


def test_sample_texture_matches(scenes):
    js, ts = scenes
    uv = _uv(1)
    tid = np.random.RandomState(2).randint(0, 3, N).astype(np.int32)
    np.testing.assert_allclose(
        to_np(tbsdf.sample_texture(ts.textures, torch.as_tensor(tid),
                                   torch.as_tensor(uv))),
        np.asarray(jbsdf.sample_texture(js.textures, jnp.asarray(tid),
                                        jnp.asarray(uv))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wide", [False, True], ids=["uv", "widened_uv"])
def test_eval_proc_texture_matches_every_kind(scenes, wide):
    js, ts = scenes
    uv = _uv(3, wide=wide)
    pidx = np.arange(N, dtype=np.int32) % 4
    got = to_np(tbsdf.eval_proc_texture(ts, torch.as_tensor(pidx),
                                        torch.as_tensor(uv)))
    want = np.asarray(jbsdf.eval_proc_texture(js, jnp.asarray(pidx),
                                              jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # Each kind gives more than one colour (the mesh-attribute kinds only
    # from a widened row: a plain one gives them black and the interior).
    for k in (0, 1, 2, 3) if wide else (0, 1):
        assert len(np.unique(got[pidx == k].round(4), axis=0)) > 1


def test_gather_params_reads_the_textures(scenes):
    js, ts = scenes
    uv = _uv(4, wide=True)
    idx = np.random.RandomState(5).randint(0, 8, N).astype(np.int32)
    jp = jbsdf.gather_params(js, jnp.asarray(idx), jnp.asarray(uv))
    tp = tbsdf.gather_params(ts, torch.as_tensor(idx), torch.as_tensor(uv))
    np.testing.assert_allclose(to_np(tp["albedo"]), np.asarray(jp["albedo"]),
                               rtol=RTOL, atol=ATOL)
    plain = to_np(ts.bsdf_albedo)[idx]
    assert (np.abs(to_np(tp["albedo"]) - plain).max(-1) > 1e-3).mean() > 0.5


def _hits(js, ts, seed):
    """Rays from a ring of origins at the scene's centre; both packages'
    closest hits and interactions."""
    rs = np.random.RandomState(seed)
    d = rs.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rs.randn(N, 3) * 0.05 + [0.0, 0.5, 1.5]).astype(np.float32)
    d = np.where(rs.rand(N, 1) < 0.7, (np.array([0.0, 0.4, 0.0]) - o)
                 + d * 0.8, d).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jh = jisect.intersect(js, jnp.asarray(o), jnp.asarray(d))
    th = tisect.intersect(ts, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(to_np(th["tri"]), np.asarray(jh["tri"]))
    return (jisect.surface_interaction(js, jnp.asarray(o), jnp.asarray(d),
                                       jh),
            tisect.surface_interaction(ts, torch.as_tensor(o),
                                       torch.as_tensor(d), th))


def test_surface_interaction_widens_uv(scenes):
    js, ts = scenes
    assert ts.tri_vc.shape[1] == 9 and ts.tri_eh.shape[1] == 3
    jit, tit = _hits(js, ts, 6)
    valid = to_np(tit["valid"])
    assert valid.mean() > 0.25 and tit["uv"].shape == (N, 6)
    for k in ("uv", "ns", "p"):
        np.testing.assert_allclose(to_np(tit[k])[valid],
                                   np.asarray(jit[k])[valid], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_apply_bumpmap_matches_height_and_normal_maps(scenes):
    js, ts = scenes
    jit, tit = _hits(js, ts, 7)
    valid = to_np(tit["valid"])
    got = to_np(tisect.apply_bumpmap(ts, tit))[valid]
    want = np.asarray(jisect.apply_bumpmap(js, jit))[valid]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=BUMP_ATOL)
    bump = to_np(ts.bsdf_bump)[to_np(tit["bsdf"])][valid]
    moved = np.abs(got - to_np(tit["ns"])[valid]).max(-1) > 1e-3
    assert moved[bump >= 0].mean() > 0.5  # height map
    assert moved[bump <= -2].mean() > 0.5  # normal map
    assert not moved[bump == -1].any()


# --- utils/png.py against PIL ---------------------------------------------

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _png(path, samples, depth, ctype, plte=None, trns=None, interlace=0):
    """A PNG of ``samples`` [H, W, C] with row y on filter type y % 5."""
    h, w, ch = samples.shape
    raw = samples.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = raw.view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = max(1, ch * depth // 8)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows):
        f = y % 5
        filt = np.zeros_like(row)
        for i in range(len(row)):  # the filters byte by byte
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            filt[i] = row[i] - (0, a, b, (a + b) // 2, paeth)[f]
        out += bytes([f]) + (filt & 0xFF).astype(np.uint8).tobytes()
        prev = row
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace)))
    if plte is not None:
        data += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns.tobytes())
    data += _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("ctype,depth", [
    (0, 8), (0, 16), (4, 8), (4, 16), (2, 8), (2, 16), (6, 8), (6, 16)],
    ids=["grey8", "grey16", "greyalpha8", "greyalpha16", "rgb8", "rgb16",
         "rgba8", "rgba16"])
def test_png_matches_pil(tmp_path, ctype, depth):
    ch = {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    rs = np.random.RandomState(ctype * 100 + depth)
    samples = rs.randint(0, 1 << depth, (11, 13, ch))
    # Smooth runs too, where the predictors are exact.
    samples[:5] = (np.arange(13)[None, :, None] * 5 * (1 << (depth - 8))
                   + np.arange(5)[:, None, None])
    path = tmp_path / "t.png"
    _png(path, samples, depth, ctype)
    got = read_png(str(path))
    np.testing.assert_array_equal(got, samples)  # the samples as written
    pil = np.asarray(Image.open(path))
    if pil.ndim == 2:
        pil = pil[..., None]
    if depth == 16 and ctype != 0:  # PIL keeps the high byte
        got = got >> 8
        if ctype == 4:  # and gives grey+alpha as RGBA
            got = got[..., [0, 0, 0, 1]]
    np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("trns", [False, True], ids=["palette", "trns"])
def test_png_palette_matches_pil(tmp_path, trns):
    rs = np.random.RandomState(9)
    plte = rs.randint(0, 256, (7, 3)).astype(np.uint8)
    alpha = rs.randint(0, 256, 5).astype(np.uint8) if trns else None
    idx = rs.randint(0, 7, (10, 9, 1))
    path = tmp_path / "p.png"
    _png(path, idx, 8, 3, plte=plte, trns=alpha)
    pil = np.asarray(Image.open(path).convert("RGBA" if trns else "RGB"))
    np.testing.assert_array_equal(read_png(str(path)), pil)


def test_png_interlaced_raises(tmp_path):
    path = tmp_path / "i.png"
    _png(path, np.zeros((4, 4, 3), np.int64), 8, 2, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(str(path))
