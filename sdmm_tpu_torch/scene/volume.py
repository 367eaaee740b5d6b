"""Mitsuba .vol grid volumes (port of sdmm_tpu/scene/volume.py): the
binary format's 'VOL' magic, version 3, an int32 encoding id (1 =
float32), the resolution, the channel count, a float32 bounding box, then
the samples with x fastest."""

from __future__ import annotations

import struct

import numpy as np


def load_vol(path: str):
    """Returns (density [D, H, W] float32, lo [3], hi [3]); only the first
    channel is kept."""
    with open(path, "rb") as f:
        if f.read(3) != b"VOL":
            raise ValueError(f"{path}: not a VOL file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"{path}: unsupported VOL version {version}")
        enc, xres, yres, zres, channels = struct.unpack("<5i", f.read(20))
        if enc != 1:
            raise ValueError(f"{path}: only float32 encoding supported")
        bbox = struct.unpack("<6f", f.read(24))
        data = np.fromfile(f, dtype="<f4", count=xres * yres * zres * channels)
    grid = data.reshape(zres, yres, xres, channels)[..., 0]
    return (grid.astype(np.float32), np.asarray(bbox[:3], np.float64),
            np.asarray(bbox[3:], np.float64))


def save_vol(path: str, density: np.ndarray, lo, hi):
    """Write a version-3 float32 .vol file of one channel."""
    density = np.asarray(density, dtype=np.float32)
    zres, yres, xres = density.shape
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(bytes([3]))
        f.write(struct.pack("<5i", 1, xres, yres, zres, 1))
        f.write(struct.pack("<6f", *np.asarray(lo, np.float32),
                            *np.asarray(hi, np.float32)))
        density.astype("<f4").tofile(f)
