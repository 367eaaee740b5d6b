"""Bounding-volume hierarchy: host median-split build and a threaded,
stackless traversal (port of sdmm_tpu/render/bvh.py).

The tree is laid out depth first and each node carries a ``miss`` link
(escape pointer), so a ray walks it holding one node index: an inner node
whose box it enters sends it to node + 1, anything else to the miss link.
Triangles are permuted into leaf-contiguous order at build time
(``SceneData.btri_*``, ``btri_orig`` the original ids), each leaf padded to
``LEAF_SIZE`` slots. ``build_bvh`` runs the numpy build up to 20,000
triangles and the native builder (``native.bvh_build_native``, compiled
from ``native/bvh_builder.cpp``) above, unless SDMM_TPU_NO_NATIVE is set.
``traverse`` is eager PyTorch: one node a ray per step, the rays still
walking compacted every ``COMPACT_EVERY`` steps. ``render/intersect.py``
takes it above ``BRUTE_FORCE_MAX`` triangles when SDMM_TPU_BVH is set.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF_SIZE = 4
INF = 3.4e38
EPS = 1e-6
NATIVE_FROM = 20000  # above this many triangles the native builder runs
COMPACT_EVERY = 16  # traversal steps between host checks and compactions


def build_bvh(verts: np.ndarray, leaf_size: int = LEAF_SIZE) -> dict:
    """Median-split BVH over verts [T, 3, 3]. Returns numpy arrays: lo/hi
    [M, 3] float32, leaf_start [M] (-1 inner), leaf_count [M], miss [M],
    perm [T'] (triangle order, leaves padded to ``leaf_size`` with -1)."""
    from ..native import bvh_build_native, disabled

    t = len(verts)
    if t > NATIVE_FROM and not disabled():
        return bvh_build_native(np.asarray(verts, np.float32), leaf_size)
    if t == 0:
        return {"lo": np.zeros((1, 3), np.float32),
                "hi": np.zeros((1, 3), np.float32),
                "leaf_start": np.zeros(1, np.int32),
                "leaf_count": np.zeros(1, np.int32),
                "miss": np.full(1, -1, np.int32),
                "perm": np.zeros(0, np.int32)}
    centroids = verts.mean(axis=1)
    tri_lo = verts.min(axis=1)
    tri_hi = verts.max(axis=1)

    lo_l, hi_l, leaf_start_l, leaf_count_l, end_l = [], [], [], [], []
    perm: list[int] = []
    # Depth first with an explicit stack; (None, node) marks the end of
    # node's subtree.
    stack = [(np.arange(t), None)]
    while stack:
        idx, parent_done = stack.pop()
        if idx is None:
            end_l[parent_done] = len(lo_l)
            continue
        node = len(lo_l)
        lo_l.append(tri_lo[idx].min(axis=0))
        hi_l.append(tri_hi[idx].max(axis=0))
        leaf_start_l.append(-1)
        leaf_count_l.append(0)
        end_l.append(-1)
        if len(idx) <= leaf_size:
            start = len(perm)
            perm.extend(idx.tolist())
            while len(perm) % leaf_size:
                perm.append(-1)
            leaf_start_l[node] = start
            leaf_count_l[node] = len(idx)
            end_l[node] = node + 1
            continue
        axis = int(np.argmax(hi_l[node] - lo_l[node]))
        order = idx[np.argsort(centroids[idx, axis], kind="stable")]
        half = len(order) // 2
        stack.append((None, node))
        stack.append((order[half:], None))
        stack.append((order[:half], None))

    m = len(lo_l)
    # Miss links: an inner node's left child is node + 1, its right child
    # the end of the left subtree, and the right child escapes to the
    # parent's escape.
    miss = np.full(m, -1, np.int32)
    st = [(0, -1)]
    while st:
        node, escape = st.pop()
        miss[node] = escape
        if leaf_start_l[node] < 0:
            left = node + 1
            right = end_l[left]
            st.append((left, right))
            st.append((right, escape))
    return {"lo": np.asarray(lo_l, np.float32),
            "hi": np.asarray(hi_l, np.float32),
            "leaf_start": np.asarray(leaf_start_l, np.int32),
            "leaf_count": np.asarray(leaf_count_l, np.int32),
            "miss": miss,
            "perm": np.asarray(perm, np.int32)}


def _step(scene, ro, rd, inv_d, t_max, node, best_t, best_i, best_u,
          best_v, occ, any_hit: bool):
    """One node for every ray of the wave; returns the new carry."""
    nid = node.clamp_min(0).long()
    nlo = scene.bvh_lo[nid]
    nhi = scene.bvh_hi[nid]
    t0 = (nlo - ro) * inv_d
    t1 = (nhi - ro) * inv_d
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    lim = torch.minimum(best_t, t_max)
    hit_box = (tmax >= tmin.clamp_min(0.0)) & (tmin < lim)
    ls = scene.bvh_leaf_start[nid]
    is_leaf = ls >= 0
    do_leaf = hit_box & is_leaf & (node >= 0)

    start = torch.where(do_leaf, ls, 0).long()
    offs = torch.arange(LEAF_SIZE, device=ro.device)
    tid = start[:, None] + offs[None, :]
    in_leaf = offs[None, :] < torch.where(
        do_leaf, scene.bvh_leaf_count[nid], 0)[:, None]
    v0 = scene.btri_v0[tid]
    e1 = scene.btri_e1[tid]
    e2 = scene.btri_e2[tid]
    rdb = rd[:, None, :].expand_as(e2)
    pvec = torch.linalg.cross(rdb, e2)
    det = (e1 * pvec).sum(-1)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tvec = ro[:, None, :] - v0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = (rdb * qvec).sum(-1) * inv_det
    t = (e2 * qvec).sum(-1) * inv_det
    tri_hit = (in_leaf & (det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0)
               & (u + v <= 1.0) & (t > EPS) & (t < lim[:, None]))
    t = torch.where(tri_hit, t, INF)
    arg = t.argmin(-1)[:, None]
    cand_t = t.gather(1, arg)[:, 0]
    better = do_leaf & (cand_t < best_t)
    best_t = torch.where(better, cand_t, best_t)
    best_i = torch.where(better, tid.gather(1, arg)[:, 0].int(), best_i)
    best_u = torch.where(better, u.gather(1, arg)[:, 0], best_u)
    best_v = torch.where(better, v.gather(1, arg)[:, 0], best_v)
    if any_hit:
        occ = occ | better
    enter = hit_box & ~is_leaf
    nxt = torch.where(enter, nid.int() + 1, scene.bvh_miss[nid])
    node = torch.where(node >= 0, nxt, node)
    return node, best_t, best_i, best_u, best_v, occ


def traverse(scene, ro: torch.Tensor, rd: torch.Tensor, t_max=None,
             any_hit: bool = False):
    """Threaded-BVH closest hit (dict t, tri [-1 = miss], u, v, valid) or,
    with ``any_hit``, the occlusion flags [N] within (EPS, t_max). Every
    COMPACT_EVERY steps the rays still walking are gathered into a smaller
    wave (a host check)."""
    n = ro.shape[0]
    dev = ro.device
    if t_max is None:
        t_max = torch.full((n,), INF, device=dev)
    safe_d = torch.where(rd.abs() > 1e-12, rd,
                         torch.where(rd >= 0, 1e-12, -1e-12))
    inv_d = 1.0 / safe_d
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    best_t = torch.full((n,), INF, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    idx = torch.arange(n, device=dev)  # the wave's rays, by original id
    w = (ro, rd, inv_d, t_max, node, best_t.clone(), best_i.clone(),
         best_u.clone(), best_v.clone(), occ.clone())
    while idx.numel():
        wro, wrd, winv, wtm, *carry = w
        for _ in range(COMPACT_EVERY):
            carry = list(_step(scene, wro, wrd, winv, wtm, *carry,
                               any_hit=any_hit))
        wnode, wbt, wbi, wbu, wbv, wocc = carry
        best_t[idx], best_i[idx], best_u[idx], best_v[idx], occ[idx] = \
            wbt, wbi, wbu, wbv, wocc
        live = wnode >= 0
        if any_hit:
            live = live & ~wocc
        keep = live.nonzero()[:, 0]
        idx = idx[keep]
        w = tuple(a[keep] for a in (wro, wrd, winv, wtm, wnode, wbt, wbi,
                                    wbu, wbv, wocc))
    if any_hit:
        return occ
    tri = torch.where(best_i >= 0,
                      scene.btri_orig[best_i.clamp_min(0).long()], -1)
    return {"t": best_t, "tri": tri, "u": best_u, "v": best_v,
            "valid": tri >= 0}
