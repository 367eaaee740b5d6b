"""Adaptive binary spatial tree over the canonical scene domain (port of
sdmm_tpu/guiding/stree.py).

Tree construction (≤ 2048 leaves) runs on the host in numpy between
iterations; the per-ray ``find_leaf`` is one gather from a dense dyadic
grid on the device. Leaves are slots into the ``[L, K]`` mixture arrays: on
a split one child keeps the parent's slot and the sibling takes a fresh
slot, which the trainer fills with a copy of the parent's state.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_TREE_DEPTH = 24


class STree:
    def __init__(self, lo, hi, max_leaves: int = 2048,
                 split_threshold: int = 4000):
        self.lo = np.asarray(lo, dtype=np.float64)
        self.hi = np.asarray(hi, dtype=np.float64)
        self.max_leaves = max_leaves
        self.split_threshold = split_threshold
        # Flat node arrays.
        self.axis = [0]
        self.split = [0.0]
        self.child = [-1]  # left child index; right = left + 1; -1 = leaf
        self.leaf = [0]  # leaf slot (-1 for internal nodes)
        self.depth = [0]
        self.node_lo = [self.lo.copy()]
        self.node_hi = [self.hi.copy()]
        self.n_leaves = 1
        self.leaf_counts = np.zeros(max_leaves, dtype=np.float64)
        # Copies performed at the last refit: list of (dst_slot, src_slot).
        self.pending_copies: list[tuple[int, int]] = []

    # -- construction -------------------------------------------------------

    def _split_node(self, i: int) -> bool:
        """Split leaf node i; returns False if out of leaf slots."""
        if self.n_leaves >= self.max_leaves:
            return False
        lo, hi = self.node_lo[i], self.node_hi[i]
        axis = int(np.argmax(hi - lo))
        split = 0.5 * (lo[axis] + hi[axis])
        slot = self.leaf[i]
        left = len(self.axis)
        for side in range(2):
            c_lo, c_hi = lo.copy(), hi.copy()
            if side == 0:
                c_hi[axis] = split
            else:
                c_lo[axis] = split
            self.axis.append(0)
            self.split.append(0.0)
            self.child.append(-1)
            self.depth.append(self.depth[i] + 1)
            self.node_lo.append(c_lo)
            self.node_hi.append(c_hi)
            if side == 0:
                self.leaf.append(slot)
            else:
                new_slot = self.n_leaves
                self.leaf.append(new_slot)
                self.pending_copies.append((new_slot, slot))
                self.leaf_counts[new_slot] = 0.0
        self.n_leaves += 1
        half = self.leaf_counts[slot] * 0.5
        self.leaf_counts[slot] = half
        self.leaf_counts[self.leaf[left + 1]] = half
        self.axis[i] = axis
        self.split[i] = split
        self.child[i] = left
        self.leaf[i] = -1
        return True

    def split_to_depth(self, depth: int):
        """Pre-split uniformly to ``depth``."""
        changed = True
        while changed:
            changed = False
            for i in range(len(self.axis)):
                if self.child[i] < 0 and self.depth[i] < depth:
                    if self._split_node(i):
                        changed = True

    def refit(self, new_counts: np.ndarray):
        """Accumulate counts and split leaves at or over the threshold;
        returns the (dst_slot, src_slot) copies the splits need."""
        self.pending_copies = []
        self.leaf_counts[: len(new_counts)] += np.asarray(new_counts,
                                                          dtype=np.float64)
        changed = True
        while changed and self.n_leaves < self.max_leaves:
            changed = False
            for i in range(len(self.axis)):
                if (
                    self.child[i] < 0
                    and self.depth[i] < MAX_TREE_DEPTH
                    and self.leaf_counts[self.leaf[i]] >= self.split_threshold
                ):
                    if self._split_node(i):
                        changed = True
                    else:
                        break
        return list(self.pending_copies)

    # -- device tables ------------------------------------------------------

    def device_tables(self, device) -> dict:
        """Leaf boxes and the dense dyadic lookup grid as tensors on
        ``device``. Node arrays pad to 2·max_leaves and the flat grid to a
        power-of-4 bucket (≥ 2^20 cells), the reference package's static
        shapes."""
        leaf_lo = np.zeros((self.max_leaves, 3))
        leaf_hi = np.ones((self.max_leaves, 3))
        for i in range(len(self.axis)):
            if self.child[i] < 0:
                leaf_lo[self.leaf[i]] = self.node_lo[i]
                leaf_hi[self.leaf[i]] = self.node_hi[i]
        pad_n = max(0, 2 * self.max_leaves - len(self.axis))

        def i32(a, fill):
            return torch.as_tensor(
                np.pad(np.asarray(a, np.int32), (0, pad_n),
                       constant_values=fill), device=device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        tables = {
            "axis": i32(self.axis, 0),
            "split": f32(np.pad(np.asarray(self.split, np.float32),
                                (0, pad_n))),
            "child": i32(self.child, -1),
            "leaf": i32(self.leaf, 0),
            "leaf_lo": f32(leaf_lo),
            "leaf_hi": f32(leaf_hi),
        }
        grid, res = self._leaf_grid()
        if grid is not None:
            flat = grid.reshape(-1)
            cap = 1 << 20
            while cap < flat.size:
                cap *= 4
            tables["grid"] = torch.as_tensor(
                np.pad(flat, (0, cap - flat.size)).astype(np.int32),
                device=device)
            tables["grid_lo"] = f32(self.lo)
            tables["grid_scale"] = f32(np.asarray(res, np.float64)
                                       / (self.hi - self.lo))
            tables["grid_res"] = torch.as_tensor(
                np.asarray(res, np.int32), device=device)
        return tables

    _GRID_CELL_CAP = 1 << 24  # 16M cells = 64 MB i32 upper bound

    def _leaf_grid(self):
        """Box-fill leaf slots into a dense [R0, R1, R2] grid whose per-axis
        resolution is the finest split level present; (None, None) past the
        cell cap, where ``find_leaf`` takes the node-table descent."""
        ext = self.hi - self.lo
        res = np.ones(3, dtype=np.int64)
        leaves = [i for i in range(len(self.axis)) if self.child[i] < 0]
        for i in leaves:
            for a in range(3):
                leaf_ext = self.node_hi[i][a] - self.node_lo[i][a]
                k = int(round(np.log2(max(ext[a] / max(leaf_ext, 1e-12),
                                          1.0))))
                res[a] = max(res[a], 1 << k)
        if int(np.prod(res)) > self._GRID_CELL_CAP:
            return None, None
        grid = np.zeros(tuple(int(r) for r in res), dtype=np.int32)
        for i in leaves:
            i_lo = np.floor((self.node_lo[i] - self.lo) / ext * res
                            + 0.5).astype(int)
            i_hi = np.floor((self.node_hi[i] - self.lo) / ext * res
                            + 0.5).astype(int)
            if not (i_hi > i_lo).all():
                raise AssertionError(
                    "leaf does not cover a full grid cell — resolution "
                    "derivation is inconsistent with the split planes")
            grid[i_lo[0]:i_hi[0], i_lo[1]:i_hi[1], i_lo[2]:i_hi[2]] = \
                self.leaf[i]
        return grid, res


def find_leaf(tables: dict, p: torch.Tensor) -> torch.Tensor:
    """Canonical positions [N, 3] → leaf slots [N] (int32)."""
    if "grid" in tables:
        res = tables["grid_res"]
        c = ((p - tables["grid_lo"]) * tables["grid_scale"]).to(torch.int32)
        c = torch.minimum(c.clamp_min(0), res - 1)
        lin = (c[..., 0] * res[1] + c[..., 1]) * res[2] + c[..., 2]
        return tables["grid"][lin.long()]
    return _find_leaf_descent(tables, p)


def find_leaf_with_bounds(tables: dict, p: torch.Tensor):
    """Canonical positions [N, 3] → (leaf slots [N], their leaves' lower
    and upper corners [N, 3] each)."""
    leaf = find_leaf(tables, p)
    li = leaf.long()
    return leaf, tables["leaf_lo"][li], tables["leaf_hi"][li]


def _find_leaf_descent(tables: dict, p: torch.Tensor) -> torch.Tensor:
    """Vectorized node-table descent: positions [N, 3] → leaf slots [N]."""
    node = torch.zeros(p.shape[0], dtype=torch.long, device=p.device)
    for _ in range(MAX_TREE_DEPTH):
        child = tables["child"][node].long()
        axis = tables["axis"][node].long()
        split = tables["split"][node]
        px = p.gather(1, axis[:, None])[:, 0]
        nxt = child + (px > split).long()
        node = torch.where(child < 0, node, nxt)
    return tables["leaf"][node]
