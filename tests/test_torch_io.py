"""Port parity of the output side: EXR files (the same bytes written, each
package's reader reads the other's files and a ZIP-compressed HALF file),
the image metrics of ``all_metrics`` and the mean pixel variance (rtol
1e-12), and ``.asdmm`` guiding checkpoints, which load in either package
into the same tree and parameters."""

import os
import struct
import sys
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.guiding import io as jio  # noqa: E402
from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.guiding import stree as jstree  # noqa: E402
from sdmm_tpu.utils import exr as jexr  # noqa: E402
from sdmm_tpu.utils import metrics as jmetrics  # noqa: E402
from sdmm_tpu_torch.guiding import io as tio  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.utils import exr as texr  # noqa: E402
from sdmm_tpu_torch.utils import metrics as tmetrics  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-12


def _image(h=13, w=21, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.lognormal(-1.0, 1.5, (h, w, 3)).astype(np.float32)
    img[0, 0] = [0.0, 1e-30, 6.5e4]
    return img


def test_write_exr_same_bytes_and_cross_read(tmp_path):
    img = _image()
    jp, tp = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(jp, img)
    texr.write_exr(tp, img)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    np.testing.assert_array_equal(texr.read_exr(jp), img)
    np.testing.assert_array_equal(jexr.read_exr(tp), img)


def _zip_half_exr(path, img):
    """A ZIP-compressed (16 scanlines a block) HALF RGB scanline EXR."""
    h, w, _ = img.shape
    half = img.astype(np.float16)
    head = struct.pack("<ii", 20000630, 2)

    def attr(name, type_, data):
        return (name.encode() + b"\0" + type_.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    chans = b"".join(c + b"\0" + struct.pack("<iiii", 1, 0, 1, 1)
                     for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    head += (attr("channels", "chlist", chans)
             + attr("compression", "compression", b"\x03")
             + attr("dataWindow", "box2i", box)
             + attr("displayWindow", "box2i", box)
             + attr("lineOrder", "lineOrder", b"\0") + b"\0")
    blocks = []
    for y in range(0, h, 16):
        raw = b"".join(half[yy, :, c].tobytes()
                       for yy in range(y, min(y + 16, h)) for c in (2, 1, 0))
        b = np.frombuffer(raw, np.uint8)
        t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
        d = t.copy()
        d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
        data = zlib.compress(d.astype(np.uint8).tobytes())
        blocks.append(struct.pack("<ii", y, len(data)) + data)
    pos = len(head) + 8 * len(blocks)
    offsets = []
    for blk in blocks:
        offsets.append(pos)
        pos += len(blk)
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{len(blocks)}q", *offsets)
                + b"".join(blocks))
    return half.astype(np.float32)


def test_read_zip_half_exr(tmp_path):
    img = _image(h=37, w=9, seed=1)
    path = str(tmp_path / "z.exr")
    want = _zip_half_exr(path, np.minimum(img, 6e4))
    np.testing.assert_array_equal(texr.read_exr(path), want)
    np.testing.assert_array_equal(jexr.read_exr(path), want)


@pytest.mark.parametrize("shape", [(13, 21, 3), (32, 40, 3), (5, 7, 3)])
def test_metrics_match_reference(shape):
    rs = np.random.RandomState(shape[0])
    ref = rs.lognormal(-1.0, 1.0, shape)
    img = np.abs(ref + rs.normal(0.0, 0.3, shape))
    tm, jm = tmetrics.all_metrics(img, ref), jmetrics.all_metrics(img, ref)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
    n = rs.randint(0, 6, shape[:2]).astype(np.float64)
    s = img * n[..., None]
    sq = img * s * 1.3
    np.testing.assert_allclose(tmetrics.mean_pixel_variance(s, sq, n),
                               jmetrics.mean_pixel_variance(s, sq, n),
                               rtol=RTOL)


def _split(tree):
    """Refit a tree with counts that split some leaves twice."""
    counts = np.zeros(tree.max_leaves)
    counts[[0, 2]] = [3.0 * tree.split_threshold, 1.5 * tree.split_threshold]
    counts[1] = 17.0
    tree.refit(counts)
    assert tree.n_leaves > 6


def _assert_same_tree(a, b):
    for k in ("axis", "split", "child", "leaf", "depth", "n_leaves",
              "max_leaves", "split_threshold"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("lo", "hi", "leaf_counts"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for k in ("node_lo", "node_hi"):
        np.testing.assert_array_equal(np.stack(getattr(a, k)),
                                      np.stack(getattr(b, k)))


def test_port_checkpoint_loads_in_reference(tmp_path):
    scene, cfg = make_box(tscene, tshapes, 8, 8).build(device="cpu")
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(
        max_leaves=16, split_threshold=100), device="cpu")
    _split(tr.tree)
    tr.initialized[[0, 3, 5]] = True
    tr.iteration = 3
    path = str(tmp_path / "model_00003.asdmm")
    tio.save_checkpoint(path, tr)
    tree, sdmm, init, meta = jio.load_checkpoint(path)
    _assert_same_tree(tree, tr.tree)
    for a, b in zip(sdmm, tr.sdmm):
        np.testing.assert_array_equal(np.asarray(a), to_np(b))
    np.testing.assert_array_equal(np.asarray(init), to_np(tr.initialized))
    assert meta["iteration"] == 3 and meta["n_components"] == 16
    assert meta["spatial_norm"] == tr.spatial_norm
    np.testing.assert_array_equal(meta["aabb_lo"], to_np(scene.aabb_lo))
    # The port reads its own file back into the same state.
    tree2, sdmm2, init2, meta2 = tio.load_checkpoint(path, device="cpu")
    _assert_same_tree(tree2, tr.tree)
    for a, b in zip(sdmm2, tr.sdmm):
        assert torch.equal(a, b)
    assert torch.equal(init2, tr.initialized)
    np.testing.assert_array_equal(meta2.pop("aabb_lo"), meta.pop("aabb_lo"))
    assert meta2 == meta


def test_reference_checkpoint_loads_in_port(tmp_path):
    """A file written by the reference's save_checkpoint (from a reference
    tree and random mixture parameters) loads into the same state."""
    rs = np.random.RandomState(3)
    tree = jstree.STree(-1e-5 * np.ones(3), np.array([1.0, 0.5, 0.8]),
                        max_leaves=16, split_threshold=100)
    tree.split_to_depth(2)
    _split(tree)
    L, K = 16, 16
    sdmm = jmix.SDMM(weight=jnp.asarray(rs.rand(L, K), jnp.float32),
                     mean=jnp.asarray(rs.randn(L, K, 6), jnp.float32),
                     cov=jnp.asarray(rs.randn(L, K, 5, 5), jnp.float32))
    init = jnp.asarray(rs.rand(L) < 0.5)
    src = types.SimpleNamespace(
        tree=tree, sdmm=sdmm, initialized=init, spatial_norm=2.5,
        iteration=7, cfg=types.SimpleNamespace(n_components=K),
        scene=types.SimpleNamespace(aabb_lo=jnp.asarray([-1.0, 0.0, -2.0])))
    path = str(tmp_path / "model_00007.asdmm")
    jio.save_checkpoint(path, src)
    t_tree, t_sdmm, t_init, meta = tio.load_checkpoint(path, device="cpu")
    _assert_same_tree(t_tree, tree)
    for a, b in zip(t_sdmm, sdmm):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    np.testing.assert_array_equal(to_np(t_init), np.asarray(init))
    assert (meta["iteration"], meta["n_components"], meta["spatial_norm"]) \
        == (7, K, 2.5)
    # Written back by the port, the file is the reference's byte for byte.
    back = types.SimpleNamespace(
        tree=t_tree, sdmm=t_sdmm, initialized=t_init, spatial_norm=2.5,
        iteration=7, cfg=src.cfg,
        scene=types.SimpleNamespace(aabb_lo=torch.tensor([-1.0, 0.0, -2.0])))
    tio.save_checkpoint(str(tmp_path / "back.asdmm"), back)
    assert open(tmp_path / "back.asdmm").read() == open(path).read()
