"""Cluster build for scenes of any size (port of the host side of
sdmm_tpu/render/clas.py: ``_morton3`` and ``build_clusters``).

Triangles are Morton-sorted by centroid and grouped into clusters of
``t_c`` triangles (256, doubled while there would be more than 2048
clusters). ``ops/clas_cull.py`` intersects rays with them. The reference's
XLA round loop over the clusters is not ported. Pure numpy.
"""

from __future__ import annotations

import numpy as np

from ..ops.clas_cull import build_woop_rows

MAX_CLUSTERS = 2048


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantized coords into 30-bit Morton codes."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def build_clusters(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                   t_c: int | None = None) -> dict:
    """Cluster build over original-order float32 triangles.

    Returns a numpy dict: lo/hi [C, 3], rows [C, 9*t_c] (component-major:
    t_c of v0x, then v0y, … e2z), ids [C, t_c] int32 (-1 padding), t_c,
    and ``build_woop_rows``' woop [C, 12, t_c] and aabb [8, Cp].
    """
    t = v0.shape[0]
    if t == 0:
        return {
            "lo": np.zeros((1, 3), np.float32),
            "hi": np.zeros((1, 3), np.float32),
            "rows": np.zeros((1, 9), np.float32),
            "ids": np.full((1, 1), -1, np.int32),
            "t_c": 1,
            "woop": np.zeros((1, 12, 1), np.float32),
            "aabb": np.full((8, 128), 3.4e38, np.float32),
        }
    if t_c is None:
        t_c = 256
        while (t + t_c - 1) // t_c > MAX_CLUSTERS:
            t_c *= 2
    cen = v0 + (e1 + e2) / 3.0
    lo_s = cen.min(0)
    ext = np.maximum(cen.max(0) - lo_s, 1e-9)
    order = np.argsort(_morton3((cen - lo_s) / ext), kind="stable")
    order = order.astype(np.int32)

    c = (t + t_c - 1) // t_c
    pad = c * t_c - t
    idx = np.concatenate([order, np.full(pad, -1, np.int32)]).reshape(c, t_c)

    sv0 = np.zeros((c, t_c, 3), np.float32)
    se1 = np.zeros((c, t_c, 3), np.float32)
    se2 = np.zeros((c, t_c, 3), np.float32)
    valid = idx >= 0
    sv0[valid] = v0[idx[valid]]
    se1[valid] = e1[idx[valid]]
    se2[valid] = e2[idx[valid]]

    p0 = sv0
    p1 = sv0 + se1
    p2 = sv0 + se2
    tl = np.minimum(np.minimum(p0, p1), p2)
    th = np.maximum(np.maximum(p0, p1), p2)
    big = np.float32(3.4e38)
    tl = np.where(valid[..., None], tl, big)
    th = np.where(valid[..., None], th, -big)
    lo = tl.min(axis=1)
    hi = th.max(axis=1)

    rows = np.concatenate(
        [sv0[:, :, 0], sv0[:, :, 1], sv0[:, :, 2],
         se1[:, :, 0], se1[:, :, 1], se1[:, :, 2],
         se2[:, :, 0], se2[:, :, 1], se2[:, :, 2]], axis=1,
    ).astype(np.float32)
    woop, aabb = build_woop_rows(
        lo.astype(np.float32), hi.astype(np.float32), rows, int(t_c))
    return {"lo": lo.astype(np.float32), "hi": hi.astype(np.float32),
            "rows": rows, "ids": idx, "t_c": int(t_c),
            "woop": woop, "aabb": aabb}
