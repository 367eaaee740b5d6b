"""The cluster-cull intersector for scenes above ``BRUTE_FORCE_MAX``
triangles (port of sdmm_tpu/ops/clas_pallas.py).

``build_woop_rows`` turns the Morton-sorted clusters of
``render/clas.build_clusters`` into the Woop rows [C, 12, t_c] (B =
[e1 e2 n]^-1 row-major, then c = -B v0, per triangle slot) and the padded
AABB table [8, Cp] (rows 0-2 lo, 3-5 hi), as the reference does.
``build_tree`` and ``slot_rows`` derive what the kernel reads from them: a
binary tree over the clusters' boxes and the same Woop rows slot by slot.

``cull`` launches ``csrc/clas_cull.cu`` for tensors on the card: each ray
walks the tree nearer child first, prunes what lies past its best hit and
sweeps the clusters it reaches. ``any_hit`` launches the same kernel in its
any-hit form, which stops at a ray's first hit. Both first order the
queries (``query_order``: direction octant, then the origin's Morton code),
so that the lanes of a warp walk alike; the kernel reads each query and
writes its result in place through that order. For tensors on the CPU both
run ``cull_plain``, a dense Woop sweep over every slot of every cluster
without culling, which gives the same winner. ``intersect`` and
``occluded`` give the reference's hit record.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .bounce import CHUNK, EPS, INF, _woop_tri

# The kernel's traversal stack holds one entry a tree level.
MAX_LEAVES = 1 << 12
_BIG = np.float32(3.4e38)


def _spread_bits() -> np.ndarray:
    """The 10-bit integers with two zero bits after each bit (the Morton
    interleave of render/clas._morton3), as a table of 1024."""
    v = np.arange(1024, dtype=np.int64)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


_SPREAD = _spread_bits()
_spread_on: dict = {}


def build_woop_rows(lo: np.ndarray, hi: np.ndarray, rows: np.ndarray,
                    t_c: int) -> tuple[np.ndarray, np.ndarray]:
    """Host side: cluster MT rows [C, 9*t_c] → Woop rows [C, 12, t_c]
    (the precompute of ops/bounce.build_tables) plus the padded AABB table
    [8, Cp].

    Padding triangles (all-zero rows) give d'_z = 0 → never hit; padding
    clusters get lo = +INF, hi = -INF.
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
    aabb = np.full((8, cp), _BIG)
    aabb[0:3, :c] = lo.T
    aabb[3:6, :c] = hi.T
    aabb[3:6, c:] = -_BIG
    aabb[6:] = 0.0
    return woop, aabb.astype(np.float32)


def build_tree(aabb: np.ndarray, c: int) -> np.ndarray:
    """Host side: the binary tree over the first ``c`` boxes of the AABB
    table [8, Cp], as [2P, 8] f32.

    The clusters are in Morton order, so a complete binary tree over
    consecutive clusters is a linear BVH with nothing to sort. P, the least
    power of two >= max(2, c), is the number of leaves; node 1 is the root,
    node k's children are 2k and 2k + 1, and leaf P + j is cluster j. Row k
    is node k's box (lo x y z, 0, hi x y z, 0), the union of its children's.
    Row 0, the padding leaves and the nodes over padding alone are empty:
    lo = +BIG > hi = -BIG, which the kernel never enters.
    """
    leaves = 2
    while leaves < c:
        leaves *= 2
    lo = np.full((2 * leaves, 3), _BIG, np.float32)
    hi = np.full((2 * leaves, 3), -_BIG, np.float32)
    lo[leaves:leaves + c] = aabb[0:3, :c].T
    hi[leaves:leaves + c] = aabb[3:6, :c].T
    level = leaves // 2
    while level >= 1:
        k = np.arange(level, 2 * level)
        lo[k] = np.minimum(lo[2 * k], lo[2 * k + 1])
        hi[k] = np.maximum(hi[2 * k], hi[2 * k + 1])
        level //= 2
    z = np.zeros((2 * leaves, 1), np.float32)
    return np.ascontiguousarray(np.concatenate([lo, z, hi, z], axis=1))


def slot_rows(woop: np.ndarray) -> np.ndarray:
    """Host side: the Woop rows [C, 12, t_c] slot by slot, [C, t_c, 12], so
    that one lane reads one triangle's 48 bytes as three 16-byte loads."""
    return np.ascontiguousarray(np.asarray(woop).transpose(0, 2, 1))


def cull_plain(ro, rd, t_max, woop, ids, chunk: int = CHUNK):
    """Plain twin of the kernel: the closest hit within (EPS, t_max) over
    every column of ``woop`` [C, 12, t_c] in (cluster, slot) order,
    [chunk, N] at a time. argmin takes the first minimum in a block, and a
    strict < against the earlier blocks keeps theirs: the first minimum in
    (cluster, slot) order, which the kernel's tie rule also returns.
    Returns (t, tri, u, v) as ``cull`` does."""
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


def query_order(ro, rd, tree):
    """The order in which the kernel takes the queries ro, rd [N, 3]:
    sorted by the octant of the direction, then by the 30-bit Morton code
    of the origin in the root box of ``tree``. int32 [N]."""
    dev = ro.device
    spread = _spread_on.get(dev)
    if spread is None:
        spread = _spread_on[dev] = torch.as_tensor(_SPREAD, device=dev)
    lo, hi = tree[1, 0:3], tree[1, 4:7]
    q = ((ro - lo) * (1024.0 / (hi - lo).clamp_min(1e-9))).nan_to_num(0.0)
    q = q.clamp(0.0, 1023.0).long()  # a NaN origin must not index past 1023
    key = spread[q[:, 0]] | (spread[q[:, 1]] << 1) | (spread[q[:, 2]] << 2)
    neg = (rd < 0).long()
    key |= ((neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]) << 30
    return torch.argsort(key).to(torch.int32)


def _launch(any_hit, ro, rd, t_max, tree, woop, ids, tests=None):
    """Check the inputs, order the queries (``query_order``) and launch the
    kernel in its closest-hit or any-hit form; returns its output tensors
    in the queries' own order."""
    n = ro.shape[0]
    c, t_c, _ = woop.shape
    leaves = tree.shape[0] // 2
    if leaves & (leaves - 1) or not max(2, c) <= leaves <= MAX_LEAVES:
        raise ValueError(f"clas_cull: a tree of {leaves} leaves for {c} "
                         f"clusters (a power of two, at most {MAX_LEAVES})")
    f32 = torch.float32
    specs = [("ro", ro, (n, 3), f32), ("rd", rd, (n, 3), f32),
             ("t_max", t_max, (n,), f32), ("tree", tree, (2 * leaves, 8), f32),
             ("woop", woop, (c, t_c, 12), f32),
             ("ids", ids, (c, t_c), torch.int32)]
    if tests is not None:
        specs.append(("tests", tests, (1,), torch.int64))
    _build.check_inputs("clas_cull", specs)
    if tree.data_ptr() % 16 or woop.data_ptr() % 16:
        raise ValueError("clas_cull: tree and woop must be 16-byte aligned")
    order = query_order(ro, rd, tree)
    dev = ro.device
    if any_hit:
        outs = (torch.empty(n, dtype=torch.bool, device=dev),)
        ptrs = [None] * 4 + [outs[0].data_ptr()]
    else:
        outs = (torch.empty(n, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, device=dev), torch.empty(n, device=dev))
        ptrs = [o.data_ptr() for o in outs] + [None]
    if n > 0:
        fn = _build.load("clas_cull").clas_cull_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ro.data_ptr(), rd.data_ptr(), t_max.data_ptr(),
                tree.data_ptr(), woop.data_ptr(), ids.data_ptr(),
                order.data_ptr(), *ptrs, n, t_c, leaves, int(any_hit),
                None if tests is None else tests.data_ptr(), stream)
        _build.check(rc, "clas_cull")
        cull.launches += 1
    return outs


def cull(ro, rd, t_max, tree, woop, ids, tests=None):
    """Closest hit of rays ro, rd [N, 3] f32 within (EPS, t_max [N]) over
    the clusters: tree [2P, 8] (``build_tree``), woop [C, t_c, 12] f32
    (``slot_rows``), ids [C, t_c] int32. Returns (t [N], tri [N] int32,
    u [N], v [N]); t = INF, tri = -1 and u = v = 0 on a miss. ``tests``,
    an int64 [1] CUDA tensor, gets the kernel's count of Woop tests added
    (32 for every slot step of a warp in which a lane tested)."""
    if ro.device.type == "cpu":
        return cull_plain(ro, rd, t_max, woop.transpose(1, 2), ids)
    return _launch(False, ro, rd, t_max, tree, woop, ids, tests)


def any_hit(ro, rd, t_max, tree, woop, ids, tests=None):
    """Whether each ray has a hit within (EPS, t_max): bool [N], on the
    tensors ``cull`` takes. The kernel stops a ray at its first hit; on the
    CPU the closest hit of ``cull_plain`` answers."""
    if ro.device.type == "cpu":
        t, tri, _, _ = cull_plain(ro, rd, t_max, woop.transpose(1, 2), ids)
        return (tri >= 0) & (t < t_max)
    return _launch(True, ro, rd, t_max, tree, woop, ids, tests)[0]


cull.launches = 0  # launches of the kernel, by cull and any_hit


def intersect(scene, ro, rd, t_max=None):
    """Closest hit over the scene's clusters: the hit record of
    render/intersect.py (t, tri, u, v, valid)."""
    if t_max is None:
        t_max = torch.full((ro.shape[0],), INF, device=ro.device)
    t, tri, u, v = cull(ro, rd, t_max, scene.clas_tree, scene.clas_woop_slot,
                        scene.clas_ids)
    return {"t": t, "tri": tri, "u": u, "v": v, "valid": tri >= 0}


def occluded(scene, ro, rd, t_max):
    """Any hit within (EPS, t_max)."""
    return any_hit(ro, rd, t_max, scene.clas_tree, scene.clas_woop_slot,
                   scene.clas_ids)
