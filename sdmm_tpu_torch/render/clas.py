"""Cluster build and the round loop over the clusters (port of
sdmm_tpu/render/clas.py).

Triangles are Morton-sorted by centroid and grouped into clusters of
``t_c`` triangles (256, doubled while there would be more than 2048
clusters): ``build_clusters``, pure numpy. ``ops/clas_cull.py`` intersects
rays with them on the card. ``intersect`` and ``occluded`` here are the
reference's round loop in eager PyTorch: each round every ray picks its
nearest cluster not yet tested whose box it enters before its best hit
(one int32 key a cluster: the entry distance's float bits, the low
``ID_BITS`` replaced by the cluster id) and tests that cluster's triangles
densely (Möller–Trumbore on the cluster's rows, gathered from
``tri_v0/e1/e2`` through ``clas_ids``). ``PHASE_A_ROUNDS`` full-width
rounds run first; then the rays still looking are compacted and swept in
turns of ``K_INNER`` rounds. Rays are taken in blocks of at most
``BLOCK_CELLS`` ray-cluster cells.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.clas_cull import build_woop_rows

MAX_CLUSTERS = 2048
ID_BITS = 11  # supports C <= 2048 clusters
ID_MASK = (1 << ID_BITS) - 1
KEY_MISS = 2**31 - 1
INF = 3.4e38
EPS = 1e-6
PHASE_A_ROUNDS = 6  # full-width rounds before the tail is compacted
K_INNER = 4  # rounds a compacted turn
BLOCK_CELLS = 1 << 25  # rays x max(clusters, 9 t_c) a block at most


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


def _cluster_tables(scene):
    """The round loop's tables: cluster boxes lo, hi [C, 3] (the AABB
    table's rows) and the component-major MT rows [C, 9, t_c] (0 on
    padding slots), as the reference's ``clas_lo/hi/rows``."""
    c = scene.clas_ids.shape[0]
    lo = scene.clas_aabb[0:3, :c].T.contiguous()
    hi = scene.clas_aabb[3:6, :c].T.contiguous()
    ids = scene.clas_ids.long()
    ok = (ids >= 0)[..., None]
    safe = ids.clamp_min(0)
    rows = torch.stack([
        torch.where(ok, a[safe], 0.0)
        for a in (scene.tri_v0, scene.tri_e1, scene.tri_e2)], 2)  # [C,t,3,3]
    rows = rows.permute(0, 2, 3, 1).reshape(c, 9, ids.shape[1])
    return lo, hi, rows.contiguous()


def _round_key(lo, hi, ro, inv_d, limit_t, prev_key):
    """Per ray, the least key over the clusters whose box it enters before
    ``limit_t``, among keys above ``prev_key`` (KEY_MISS: none)."""
    rox, roy, roz = (ro[:, i:i + 1] for i in range(3))
    ix, iy, iz = (inv_d[:, i:i + 1] for i in range(3))
    ax0 = (lo[None, :, 0] - rox) * ix
    ax1 = (hi[None, :, 0] - rox) * ix
    ay0 = (lo[None, :, 1] - roy) * iy
    ay1 = (hi[None, :, 1] - roy) * iy
    az0 = (lo[None, :, 2] - roz) * iz
    az1 = (hi[None, :, 2] - roz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(ax0, ax1),
                                       torch.minimum(ay0, ay1)),
                         torch.minimum(az0, az1))
    tmax = torch.minimum(torch.minimum(torch.maximum(ax0, ax1),
                                       torch.maximum(ay0, ay1)),
                         torch.maximum(az0, az1))
    tent = tmin.clamp_min(0.0)
    hit = (tmax >= tent) & (tmin < limit_t[:, None])
    cid = torch.arange(lo.shape[0], dtype=torch.int32, device=ro.device)
    key = (tent.view(torch.int32) & ~ID_MASK) | cid[None, :]
    key = torch.where(hit & (key > prev_key[:, None]), key, KEY_MISS)
    return key.amin(1)


def _test_cluster(rows, ids, ro, rd, cluster, t_lim):
    """Dense MT test of each ray's cluster; returns (t, tri, u, v) of the
    nearest hit before ``t_lim`` (t = INF and any slot's id where none)."""
    row = rows[cluster.long()]  # [N, 9, t_c]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row.unbind(1)
    rox, roy, roz = (ro[:, i:i + 1] for i in range(3))
    rdx, rdy, rdz = (rd[:, i:i + 1] for i in range(3))
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > EPS) & (t < t_lim[:, None]))
    t = torch.where(hit, t, INF)
    arg = t.argmin(1, keepdim=True)
    slot = ids[cluster.long()].gather(1, arg)[:, 0]
    return (t.gather(1, arg)[:, 0], slot, u.gather(1, arg)[:, 0],
            v.gather(1, arg)[:, 0])


def _sweep_round(tables, ro, rd, inv_d, t_max, c):
    """One selection + cluster test for every ray of ``ro``."""
    lo, hi, rows, ids = tables
    active, prev_key, best_t, best_i, best_u, best_v = c
    limit = torch.minimum(best_t, t_max)
    key = _round_key(lo, hi, ro, inv_d, limit, prev_key)
    act = active & (key != KEY_MISS)
    cluster = torch.where(act, key & ID_MASK, 0)
    ct, ci, cu, cv = _test_cluster(rows, ids, ro, rd, cluster, limit)
    better = act & (ci >= 0) & (ct < best_t)
    return (act, torch.where(act, key, prev_key),
            torch.where(better, ct, best_t), torch.where(better, ci, best_i),
            torch.where(better, cu, best_u), torch.where(better, cv, best_v))


def _inv_dir(rd):
    safe = torch.where(rd.abs() > 1e-12, rd,
                       torch.where(rd >= 0, 1e-12, -1e-12))
    return 1.0 / safe


def _block(scene) -> int:
    """Rays a block: BLOCK_CELLS over the widest per-ray intermediate."""
    c, t_c = scene.clas_ids.shape
    return max(1024, BLOCK_CELLS // max(c, 9 * t_c))


def _intersect_block(tables, ro, rd, t_max):
    n = ro.shape[0]
    dev = ro.device
    inv_d = _inv_dir(rd)
    c = (torch.ones(n, dtype=torch.bool, device=dev),
         torch.full((n,), -2**31, dtype=torch.int32, device=dev),
         torch.full((n,), INF, device=dev),
         torch.full((n,), -1, dtype=torch.int32, device=dev),
         torch.zeros(n, device=dev), torch.zeros(n, device=dev))
    for _ in range(PHASE_A_ROUNDS):
        c = _sweep_round(tables, ro, rd, inv_d, t_max, c)
    c = [x.clone() for x in c]
    idx = c[0].nonzero()[:, 0]
    while idx.numel():
        sub = tuple(x[idx] for x in c)
        sro, srd, sinv, stm = ro[idx], rd[idx], inv_d[idx], t_max[idx]
        for _ in range(K_INNER):
            sub = _sweep_round(tables, sro, srd, sinv, stm, sub)
        for x, y in zip(c, sub):
            x[idx] = y
        idx = idx[sub[0]]
    return tuple(c[2:])


def intersect(scene, ro, rd, t_max=None):
    """Closest hit by the round loop: the hit record of
    render/intersect.py (t, tri, u, v, valid)."""
    n = ro.shape[0]
    if t_max is None:
        t_max = torch.full((n,), INF, device=ro.device)
    tables = _cluster_tables(scene) + (scene.clas_ids,)
    b = _block(scene)
    parts = [_intersect_block(tables, ro[s:s + b], rd[s:s + b],
                              t_max[s:s + b]) for s in range(0, max(n, 1), b)]
    t, tri, u, v = (torch.cat(x) for x in zip(*parts))
    return {"t": t, "tri": tri, "u": u, "v": v, "valid": tri >= 0}


def _occluded_block(tables, ro, rd, t_max):
    lo, hi, rows, ids = tables
    n = ro.shape[0]
    dev = ro.device
    inv_d = _inv_dir(rd)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    prev_key = torch.full((n,), -2**31, dtype=torch.int32, device=dev)
    idx = torch.arange(n, device=dev)
    while idx.numel():
        key = _round_key(lo, hi, ro[idx], inv_d[idx], t_max[idx],
                         prev_key[idx])
        act = key != KEY_MISS
        cluster = torch.where(act, key & ID_MASK, 0)
        ct, ci, _, _ = _test_cluster(rows, ids, ro[idx], rd[idx], cluster,
                                     t_max[idx])
        # ci is an argmin slot: a real hit is one that beat t_max.
        hit = act & (ci >= 0) & (ct < t_max[idx])
        occ[idx] = hit
        prev_key[idx] = torch.where(act, key, prev_key[idx])
        idx = idx[act & ~hit]
    return occ


def occluded(scene, ro, rd, t_max):
    """Any hit within (EPS, t_max) by the round loop. Returns bool [N]."""
    tables = _cluster_tables(scene) + (scene.clas_ids,)
    b = _block(scene)
    return torch.cat([_occluded_block(tables, ro[s:s + b], rd[s:s + b],
                                      t_max[s:s + b])
                      for s in range(0, max(ro.shape[0], 1), b)])
