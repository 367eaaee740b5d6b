"""Mitsuba ``.serialized`` and PLY mesh loaders (port of
sdmm_tpu/scene/serialized.py).

A ``.serialized`` file is a little-endian container of zlib streams, one a
mesh, with a trailing offset table (Mitsuba's trimesh.cpp format). PLY is
read in ascii or binary_little_endian. Everything loads into numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .shapes import check_lfs_stub

_EHasNormals = 0x0001
_EHasTexcoords = 0x0002
_EHasColors = 0x0008
_EFaceNormals = 0x0010
_EDoublePrecision = 0x2000


def load_serialized(path: str, shape_index: int = 0) -> dict:
    """Load one mesh from a .serialized container.

    Returns dict(positions [V,3], normals [V,3] | None, uv [V,2] | None,
    faces [F,3], face_normals bool).
    """
    check_lfs_stub(path)
    with open(path, "rb") as f:
        buf = f.read()
    fmt, version = struct.unpack_from("<hh", buf, 0)
    if fmt != 0x041C:
        raise ValueError(f"{path}: not a Mitsuba serialized mesh (format={fmt:#x})")
    if shape_index == 0:
        start = 4
    else:
        (count,) = struct.unpack_from("<I", buf, len(buf) - 4)
        if shape_index >= count:
            raise IndexError(f"{path}: shape index {shape_index} >= {count}")
        if version == 0x0004:
            off_pos = len(buf) - 8 * (count - shape_index) - 4
            (offset,) = struct.unpack_from("<Q", buf, off_pos)
        else:
            off_pos = len(buf) - 4 * (count - shape_index + 1)
            (offset,) = struct.unpack_from("<I", buf, off_pos)
        start = offset + 4  # skip per-mesh header

    data = zlib.decompress(buf[start:])
    pos = 0
    (flags,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if version == 0x0004:
        end = data.index(b"\x00", pos)
        pos = end + 1  # skip name
    v_count, t_count = struct.unpack_from("<QQ", data, pos)
    pos += 16
    double = bool(flags & _EDoublePrecision)
    ftype = np.float64 if double else np.float32
    fsize = 8 if double else 4

    def read_arr(n_elems):
        nonlocal pos
        arr = np.frombuffer(data, dtype=ftype, count=n_elems, offset=pos)
        pos += n_elems * fsize
        return arr.astype(np.float64)

    positions = read_arr(v_count * 3).reshape(-1, 3)
    normals = None
    if flags & _EHasNormals:
        normals = read_arr(v_count * 3).reshape(-1, 3)
    uv = None
    if flags & _EHasTexcoords:
        uv = read_arr(v_count * 2).reshape(-1, 2)
    if flags & _EHasColors:
        read_arr(v_count * 3)
    faces = np.frombuffer(data, dtype=np.uint32, count=t_count * 3, offset=pos)
    faces = faces.reshape(-1, 3).astype(np.int64)
    return {
        "positions": positions,
        "normals": normals,
        "uv": uv,
        "faces": faces,
        "face_normals": bool(flags & _EFaceNormals),
    }


def load_ply(path: str) -> dict:
    """Minimal PLY loader (ascii / binary_little_endian)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = "ascii"
        n_verts = n_faces = 0
        vert_props: list[tuple[str, str]] = []
        cur = None
        for line in header:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                cur = toks[1]
                if cur == "vertex":
                    n_verts = int(toks[2])
                elif cur == "face":
                    n_faces = int(toks[2])
            elif toks[0] == "property" and cur == "vertex":
                vert_props.append((toks[1], toks[2]))
        type_map = {
            "float": "f4", "float32": "f4", "double": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "short": "i2",
            "ushort": "u2", "int": "i4", "int32": "i4", "uint": "u4",
        }
        if fmt == "ascii":
            vals = []
            for _ in range(n_verts):
                vals.append([float(x) for x in f.readline().split()])
            varr = np.asarray(vals)
            names = [n for _, n in vert_props]
            faces = []
            for _ in range(n_faces):
                toks = f.readline().split()
                cnt = int(toks[0])
                idx = [int(x) for x in toks[1 : 1 + cnt]]
                for k in range(1, cnt - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            faces = np.asarray(faces, dtype=np.int64)
        else:
            dt = np.dtype([(n, "<" + type_map[t]) for t, n in vert_props])
            varr_s = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt)
            names = [n for _, n in vert_props]
            varr = np.stack([varr_s[n].astype(np.float64) for n in names], axis=-1)
            # Faces: assume uchar count + int indices (most common).
            rest = f.read()
            faces = []
            off = 0
            for _ in range(n_faces):
                cnt = rest[off]
                off += 1
                idx = np.frombuffer(rest, dtype="<i4", count=cnt, offset=off)
                off += 4 * cnt
                for k in range(1, cnt - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            faces = np.asarray(faces, dtype=np.int64)

    def col(name):
        return varr[:, names.index(name)] if name in names else None

    positions = np.stack([col("x"), col("y"), col("z")], axis=-1)
    normals = None
    if "nx" in names:
        normals = np.stack([col("nx"), col("ny"), col("nz")], axis=-1)
    uv = None
    if "u" in names:
        uv = np.stack([col("u"), col("v")], axis=-1)
    elif "s" in names:
        uv = np.stack([col("s"), col("t")], axis=-1)
    colors = None
    if "red" in names:
        colors = np.stack([col("red"), col("green"), col("blue")], axis=-1)
        # uchar channels come in 0..255; float channels are 0..1.
        ctype = dict((n, t) for t, n in vert_props).get("red", "float")
        if ctype in ("uchar", "uint8", "char"):
            colors = colors / 255.0
    return {
        "positions": positions, "normals": normals, "uv": uv,
        "colors": colors, "faces": faces, "face_normals": normals is None,
    }
