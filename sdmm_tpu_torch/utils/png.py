"""PNG decoding in numpy and zlib, so that bitmap textures load where PIL is
not installed (host-side).

``read_png`` decodes non-interlaced PNGs: grey, grey+alpha, RGB, RGBA and
palette images, 8- and 16-bit samples (grey and palette also 1, 2 and 4
bits), all five row filters. It returns the samples as stored (uint16 for
16-bit images; sub-byte grey scaled to 0..255; palette indices expanded to
RGB, RGBA where a tRNS chunk gives alpha). An interlaced (Adam7) file
raises. ``load_bitmap`` gives any image as float32 RGB in [0, 1]: a PNG
through ``read_png``, another format through PIL when it is installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Colour type → samples per pixel, and the bit depths the format allows.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _chunks(buf: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if len(data) != length or zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int):
    """Undo the per-row filters. A pixel depends on its left, upper and
    upper-left neighbours only, so the pixels of one anti-diagonal are
    reconstructed together: H + W numpy steps instead of H·W."""
    rows = raw.reshape(height, stride + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    width = stride // bpp
    data = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    # One row and one column of zeros before the image.
    out = np.zeros((height + 1, width + 1, bpp), np.int32)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height, d + 1))
        x = d - r
        a = out[r + 1, x]  # left
        b = out[r, x + 1]  # up
        c = out[r, x]  # upper left
        f = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (data[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(height, stride)


def read_png(path: str) -> np.ndarray:
    """The samples of the PNG at ``path`` as [H, W, C] (see the module
    docstring); raises ValueError for an interlaced or malformed file."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = palette = trns = None
    idat = []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} with bit depth "
                         f"{depth} is not valid")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not "
                         "supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    stride = (width * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    img = _unfilter(raw[:height * (stride + 1)], height, stride, bpp)
    if depth == 16:
        out = img.view(">u2").astype(np.uint16).reshape(height, width, ch)
    elif depth == 8:
        out = img.reshape(height, width, ch)
    else:
        bits = np.unpackbits(img, axis=1)[:, :width * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (bits.reshape(height, width, depth) * weights).sum(
            -1, dtype=np.uint8)[..., None]
        if ctype == 0:  # grey below 8 bits: scaled to 0..255
            out = (out * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype == 3:
        idx = out[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
            return np.concatenate([palette, alpha[:, None]], axis=1)[idx]
        return palette[idx]
    return out


def load_bitmap(path: str) -> np.ndarray:
    """The image at ``path`` as float32 RGB in [0, 1], [H, W, 3]: grey is
    replicated, alpha dropped. PNGs are decoded by ``read_png``; any other
    format needs PIL, and without it raises naming the file."""
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        img = read_png(path)
        scale = 65535.0 if img.dtype == np.uint16 else 255.0
        img = img.astype(np.float32) / scale
    else:
        try:
            from PIL import Image
        except ImportError as exc:
            raise RuntimeError(
                f"{path}: only PNG bitmaps are decoded without PIL, which "
                "is not installed") from exc
        img = np.asarray(Image.open(path).convert("RGB"),
                         dtype=np.float32) / 255.0
    if img.shape[-1] <= 2:  # grey, grey + alpha
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]
