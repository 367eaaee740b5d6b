"""The cluster-cull intersector for scenes above ``BRUTE_FORCE_MAX``
triangles (port of sdmm_tpu/ops/clas_pallas.py).

``build_woop_rows`` turns the Morton-sorted clusters of
``render/clas.build_clusters`` into the Woop rows [C, 12, t_c] (B =
[e1 e2 n]^-1 row-major, then c = -B v0, per triangle slot) and the padded
AABB table [8, Cp] (rows 0-2 lo, 3-5 hi). ``cull`` launches
``csrc/clas_cull.cu`` for tensors on the card: per block of rays, a slab
test of every cluster's box against each ray's current best distance, and
a Woop sweep of the clusters some ray of the block enters. For tensors on
the CPU it runs ``cull_plain``, a dense Woop sweep over every slot of every
cluster without culling, which gives the same winner. ``intersect`` and
``occluded`` give the reference's hit record.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .bounce import CHUNK, EPS, INF, _woop_tri


def build_woop_rows(lo: np.ndarray, hi: np.ndarray, rows: np.ndarray,
                    t_c: int) -> tuple[np.ndarray, np.ndarray]:
    """Host side: cluster MT rows [C, 9*t_c] → Woop rows [C, 12, t_c]
    (the precompute of ops/bounce.build_tables) plus the padded AABB table
    [8, Cp].

    Padding triangles (all-zero rows) give d'_z = 0 → never hit; padding
    clusters get lo = +INF, hi = -INF → never entered.
    """
    c = rows.shape[0]
    r = rows.reshape(c, 9, t_c)
    v0 = np.stack([r[:, 0], r[:, 1], r[:, 2]], axis=-1)  # [C, Tc, 3]
    e1 = np.stack([r[:, 3], r[:, 4], r[:, 5]], axis=-1)
    e2 = np.stack([r[:, 6], r[:, 7], r[:, 8]], axis=-1)
    n = np.cross(e1, e2)
    a = np.stack([e1, e2, n], axis=-1)  # [C, Tc, 3, 3]
    det = np.linalg.det(a)
    ok = np.abs(det) > 1e-24
    a_safe = np.where(ok[..., None, None], a, np.eye(3))
    b = np.where(ok[..., None, None], np.linalg.inv(a_safe), 0.0)
    cvec = np.where(ok[..., None], -np.einsum("ctij,ctj->cti", b, v0), 0.0)
    woop = np.ascontiguousarray(np.concatenate(
        [b.reshape(c, t_c, 9), cvec], axis=-1
    ).transpose(0, 2, 1), dtype=np.float32)  # [C, 12, Tc]

    cp = max(128, -(-c // 128) * 128)
    aabb = np.full((8, cp), np.float32(3.4e38))
    aabb[0:3, :c] = lo.T
    aabb[3:6, :c] = hi.T
    aabb[3:6, c:] = -np.float32(3.4e38)
    aabb[6:] = 0.0
    return woop, aabb.astype(np.float32)


def cull_plain(ro, rd, t_max, woop, ids, chunk: int = CHUNK):
    """Plain twin of the kernel: the closest hit within (EPS, t_max) over
    every column of ``woop`` in (cluster, slot) order, [chunk, N] at a
    time. argmin takes the first minimum in a block, and a strict < against
    the earlier blocks keeps theirs: the kernel's ordered sweep with a
    strict t < best_t. Returns (t, tri, u, v) as ``cull`` does."""
    n, dev = ro.shape[0], ro.device
    cols = woop.permute(1, 0, 2).reshape(12, -1)
    rox, roy, roz = ro.unbind(1)
    rdx, rdy, rdz = rd.unbind(1)
    best_t = torch.full((n,), INF, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    code = torch.full((n,), -1, dtype=torch.long, device=dev)
    for j0 in range(0, cols.shape[1], chunk):
        t, u, v, okg = _woop_tri(rox, roy, roz, rdx, rdy, rdz,
                                 cols[:, j0:j0 + chunk, None], slice(None))
        t = torch.where(okg & (t > EPS) & (t < t_max), t, INF)
        jmin = t.argmin(0, keepdim=True)
        tmin = t.gather(0, jmin)[0]
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        bu = torch.where(better, u.gather(0, jmin)[0], bu)
        bv = torch.where(better, v.gather(0, jmin)[0], bv)
        code = torch.where(better, j0 + jmin[0], code)
    tri = torch.where(code >= 0, ids.reshape(-1)[code.clamp_min(0)], -1)
    return (torch.where(tri >= 0, best_t, INF), tri.to(torch.int32), bu, bv)


def cull(ro, rd, t_max, aabb, woop, ids):
    """Closest hit of rays ro, rd [N, 3] f32 within (EPS, t_max [N]) over
    the clusters: aabb [8, Cp], woop [C, 12, t_c] f32, ids [C, t_c] int32.
    Returns (t [N], tri [N] int32, u [N], v [N]); t = INF, tri = -1 and
    u = v = 0 on a miss."""
    if ro.device.type == "cpu":
        return cull_plain(ro, rd, t_max, woop, ids)
    n = ro.shape[0]
    c, _, t_c = woop.shape
    if aabb.shape[1] < c:
        raise ValueError(f"clas_cull: {aabb.shape[1]} AABB columns for {c} "
                         "clusters")
    f32 = torch.float32
    _build.check_inputs("clas_cull", (
        ("ro", ro, (n, 3), f32), ("rd", rd, (n, 3), f32),
        ("t_max", t_max, (n,), f32), ("aabb", aabb, (8, aabb.shape[1]), f32),
        ("woop", woop, (c, 12, t_c), f32),
        ("ids", ids, (c, t_c), torch.int32)))
    t = torch.empty(n, device=ro.device)
    tri = torch.empty(n, dtype=torch.int32, device=ro.device)
    u = torch.empty(n, device=ro.device)
    v = torch.empty(n, device=ro.device)
    if n > 0:
        fn = _build.load("clas_cull").clas_cull_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        rc = fn(ro.data_ptr(), rd.data_ptr(), t_max.data_ptr(),
                aabb.data_ptr(), woop.data_ptr(), ids.data_ptr(), t.data_ptr(),
                tri.data_ptr(), u.data_ptr(), v.data_ptr(), n, c, t_c,
                aabb.shape[1], stream)
        _build.check(rc, "clas_cull")
        cull.launches += 1
    return t, tri, u, v


cull.launches = 0


def intersect(scene, ro, rd, t_max=None):
    """Closest hit over the scene's clusters: the hit record of
    render/intersect.py (t, tri, u, v, valid)."""
    if t_max is None:
        t_max = torch.full((ro.shape[0],), INF, device=ro.device)
    t, tri, u, v = cull(ro, rd, t_max, scene.clas_aabb, scene.clas_woop,
                        scene.clas_ids)
    return {"t": t, "tri": tri, "u": u, "v": v, "valid": tri >= 0}


def occluded(scene, ro, rd, t_max):
    """Any hit within (EPS, t_max): the closest hit bounded by t_max."""
    res = intersect(scene, ro, rd, t_max)
    return res["valid"] & (res["t"] < t_max)
