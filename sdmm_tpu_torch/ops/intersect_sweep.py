"""The dense Möller–Trumbore closest-hit sweep for scenes of at most
``BRUTE_FORCE_MAX`` triangles (port of sdmm_tpu/ops/intersect_pallas.py
``mt_sweep``).

``mt_sweep`` launches ``csrc/mt_sweep.cu`` for tensors on the card and runs
``mt_sweep_plain`` for tensors on the CPU. The kernel reads the scene's
[T, 3] triangle arrays as they lie (the reference's transposed, padded copy
was a TPU layout) and stages them once a block. Below ``DEFER_FROM``
triangles a thread sweeps one ray; from it on four, with the reciprocal
behind an exact pre-test and a warp vote (``rays_per_thread``).
Both return the hit record of ``render/intersect.py``: t (INF on a miss),
tri (int32, -1 on a miss), u, v (0 on a miss), valid.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .bounce import EPS, INF

CHUNK = 128  # triangles per [N, CHUNK] block of the plain sweep
DEFER_FROM = 100  # triangles from which the kernel votes (the .cu's)


def _mt_chunk(ro, rd, v0, e1, e2, t_max):
    """Möller–Trumbore for [N] rays × [C] tris → per-pair (t, u, v, hit)."""
    rox, roy, roz = (ro[:, i:i + 1] for i in range(3))
    rdx, rdy, rdz = (rd[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))

    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det.abs() > 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
           & (t < t_max[:, None]))
    return t, u, v, hit


def _record(t, tri, u, v):
    return {"t": t, "tri": tri, "u": u, "v": v, "valid": tri >= 0}


def mt_sweep_plain(ro, rd, t_max, v0, e1, e2, chunk: int = CHUNK):
    """Plain twin of the kernel: the closest hit within (EPS, t_max) over
    [N, chunk] blocks. argmin takes the first minimum in a block, and a
    strict < against the earlier blocks keeps theirs, so the lowest
    triangle index wins among equal t, as in the kernel's ordered sweep."""
    n, dev = ro.shape[0], ro.device
    best_t = torch.full((n,), INF, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    for sl in range(0, v0.shape[0], chunk):
        t, u, v, hit = _mt_chunk(ro, rd, v0[sl:sl + chunk],
                                 e1[sl:sl + chunk], e2[sl:sl + chunk], t_max)
        t = torch.where(hit, t, INF)
        cand_t, arg = t.min(dim=-1)
        better = cand_t < best_t
        best_t = torch.where(better, cand_t, best_t)
        best_i = torch.where(better, (arg + sl).to(torch.int32), best_i)
        best_u = torch.where(better, u.gather(1, arg[:, None])[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, arg[:, None])[:, 0], best_v)
    return _record(best_t, best_i, best_u, best_v)


def mt_sweep(ro, rd, t_max, v0, e1, e2):
    """Closest hit of rays ro, rd [N, 3] f32 within (EPS, t_max [N]) over the
    triangles v0, e1, e2 [T, 3] f32. Returns the hit record."""
    if ro.device.type == "cpu":
        return mt_sweep_plain(ro, rd, t_max, v0, e1, e2)
    n, n_tris = ro.shape[0], v0.shape[0]
    f32 = torch.float32
    _build.check_inputs("mt_sweep", (
        ("ro", ro, (n, 3), f32), ("rd", rd, (n, 3), f32),
        ("t_max", t_max, (n,), f32), ("v0", v0, (n_tris, 3), f32),
        ("e1", e1, (n_tris, 3), f32), ("e2", e2, (n_tris, 3), f32)))
    t = torch.empty(n, device=ro.device)
    tri = torch.empty(n, dtype=torch.int32, device=ro.device)
    u = torch.empty(n, device=ro.device)
    v = torch.empty(n, device=ro.device)
    if n > 0:
        fn = _build.load("mt_sweep").mt_sweep_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        rc = fn(ro.data_ptr(), rd.data_ptr(), t_max.data_ptr(),
                v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), t.data_ptr(),
                tri.data_ptr(), u.data_ptr(), v.data_ptr(), n, n_tris, stream)
        _build.check(rc, "mt_sweep")
        mt_sweep.launches += 1
    return _record(t, tri, u, v)


mt_sweep.launches = 0


def rays_per_thread(n_tris: int) -> int:
    """Rays a thread of the sweep kernel that a scene of ``n_tris``
    triangles takes: 4 for the warp-voted kernel, 1 for the other."""
    fn = _build.load("mt_sweep").mt_sweep_rays
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(n_tris)


def kernel_info(n_tris: int) -> dict[str, dict[str, int]]:
    """Registers, spilled (local) bytes, static shared bytes and resident
    blocks an SM of the sweep kernel, as built, with the shared memory it
    takes for a scene of ``n_tris`` triangles."""
    return _build.kernel_info("mt_sweep", "mt_sweep_info", ("mt_sweep",),
                              n_tris)
