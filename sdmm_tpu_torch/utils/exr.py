"""Minimal OpenEXR scanline I/O (port of sdmm_tpu/utils/exr.py).

Writes uncompressed 32-bit float RGB scanline files; reads uncompressed or
ZIP/ZIPS-compressed FLOAT/HALF scanline images. Host-side numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2


def _write_attr(f, name: str, type_: str, data: bytes):
    f.write(name.encode() + b"\x00" + type_.encode() + b"\x00")
    f.write(struct.pack("<i", len(data)))
    f.write(data)


def write_exr(path: str, image: np.ndarray):
    """Write [H, W, 3] float32 RGB as an uncompressed scanline EXR."""
    img = np.asarray(image, dtype=np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))  # magic, version
        chans = b""
        for name in (b"B", b"G", b"R"):
            chans += name + b"\x00" + struct.pack("<iiii", _PIXELTYPE_FLOAT, 0, 1, 1)
        chans += b"\x00"
        _write_attr(f, "channels", "chlist", chans)
        _write_attr(f, "compression", "compression", b"\x00")  # none
        box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", b"\x00")
        _write_attr(f, "pixelAspectRatio", "float", struct.pack("<f", 1.0))
        _write_attr(f, "screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\x00")  # end of header
        # Scanline offset table.
        offset_pos = f.tell()
        f.write(b"\x00" * (8 * h))
        offsets = []
        for y in range(h):
            offsets.append(f.tell())
            row = img[y]
            data = (
                row[:, 2].tobytes() + row[:, 1].tobytes() + row[:, 0].tobytes()
            )  # B, G, R planes
            f.write(struct.pack("<ii", y, len(data)))
            f.write(data)
        f.seek(offset_pos)
        f.write(struct.pack(f"<{h}q", *offsets))


def _read_attrs(buf, pos):
    attrs = {}
    while True:
        if buf[pos] == 0:
            return attrs, pos + 1
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        end = buf.index(b"\x00", pos)
        type_ = buf[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos : pos + size])
        pos += size


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR (none/zip/zips compression) into [H, W, C] float32."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, _version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    attrs, pos = _read_attrs(buf, 8)
    # Channels.
    chdata = attrs["channels"][1]
    channels = []
    cpos = 0
    while chdata[cpos] != 0:
        end = chdata.index(b"\x00", cpos)
        cname = chdata[cpos:end].decode()
        cpos = end + 1
        ptype, _, _, _ = struct.unpack_from("<iiii", chdata, cpos)
        cpos += 16
        channels.append((cname, ptype))
    channels_sorted = sorted(channels)  # EXR stores channels alphabetically
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines_per_block = {0: 1, 2: 1, 3: 16}.get(comp)
    if lines_per_block is None:
        raise ValueError(f"{path}: unsupported EXR compression {comp}")
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, pos)
    out = np.zeros((h, w, len(channels_sorted)), dtype=np.float32)
    dtype_map = {_PIXELTYPE_HALF: np.float16, _PIXELTYPE_FLOAT: np.float32}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        ny = min(lines_per_block, y1 - y + 1)
        raw_size = sum(
            np.dtype(dtype_map[pt]).itemsize * w * ny for _, pt in channels_sorted
        )
        if comp in (2, 3):
            data = zlib.decompress(data)
            # EXR zip post-process: un-delta (t[i] = t[i] + t[i-1] - 128 mod
            # 256; mod distributes, so a cumsum suffices) then de-interleave.
            arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64).copy()
            arr[1:] -= 128
            rec = np.cumsum(arr) & 0xFF
            half = (len(rec) + 1) // 2
            interleaved = np.zeros(len(rec), dtype=np.uint8)
            interleaved[0::2] = rec[:half].astype(np.uint8)
            interleaved[1::2] = rec[half:].astype(np.uint8)
            data = interleaved.tobytes()
        if len(data) != raw_size:
            data = data[:raw_size]
        dpos = 0
        for line in range(ny):
            for ci, (cname, pt) in enumerate(channels_sorted):
                dt = dtype_map[pt]
                nbytes = w * np.dtype(dt).itemsize
                row = np.frombuffer(data[dpos : dpos + nbytes], dtype=dt)
                out[y - y0 + line, :, ci] = row.astype(np.float32)
                dpos += nbytes
    # Reorder sorted (B, G, R) → (R, G, B) if it's an RGB image.
    names = [c[0] for c in channels_sorted]
    if names == ["B", "G", "R"]:
        out = out[:, :, ::-1]
    return out
