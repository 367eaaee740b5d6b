"""Sample reservoir with prioritized replay (port of
sdmm_tpu/guiding/reservoir.py).

A fixed-capacity structure of arrays merged once per iteration:

1. stored sample priorities decay by ``decay`` (age-weighted replay),
2. the new batch is appended,
3. if over capacity, each sample survives Russian roulette with
   probability p_i = min(1, cap·pr_i/Σpr) and surviving weights are divided
   by p_i (unbiased), then survivors are compacted to the fixed capacity.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device


def make_reservoir(capacity: int, device: str | torch.device = "cuda"):
    """An empty reservoir of ``capacity`` rows on ``device``. ``lookup_pos``
    is the position the leaf lookup uses: ``pos`` for ordinary samples, the
    jittered position that picked the destination leaf for a replica, so a
    re-derived leaf still routes the replica to its neighbouring leaf."""
    device = resolve_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "pos": z(capacity, 3),
        "lookup_pos": z(capacity, 3),
        "dir": z(capacity, 3),
        "weight": z(capacity),
        "priority": z(capacity),
        "valid": z(capacity, dtype=torch.bool),
    }


def reservoir_update(res: dict, pos, d, wgt, valid, u, capacity: int,
                     decay: float = 0.5, lookup_pos=None) -> dict:
    """Merge a new sample batch into the reservoir; returns the new
    reservoir. ``u`` holds the Russian-roulette uniforms, one per row of
    the merged buffer (capacity + batch), or is a ``torch.Generator`` they
    are drawn from. New samples enter with priority |weight| + 1e-6."""
    if lookup_pos is None:
        lookup_pos = pos
    dev = pos.device
    all_pos = torch.cat([res["pos"], pos])
    all_lookup = torch.cat([res["lookup_pos"], lookup_pos])
    all_dir = torch.cat([res["dir"], d])
    all_w = torch.cat([res["weight"], wgt])
    all_valid = torch.cat([res["valid"], valid])
    all_pr = torch.cat([res["priority"] * decay,
                        torch.where(valid, wgt.abs() + 1e-6, 0.0)])
    all_pr = torch.where(all_valid, all_pr, 0.0)

    over = all_valid.sum() > capacity
    p = torch.where(
        over,
        (capacity * all_pr / all_pr.sum().clamp_min(1e-30)).clamp_max(1.0),
        1.0)
    if isinstance(u, torch.Generator):
        u = torch.rand(all_valid.shape, generator=u, device=dev)
    survive = all_valid & (u < p)
    w_corr = torch.where(survive, all_w / p.clamp_min(1e-12), 0.0)

    # Survivors first, in their order (a stable sort: torch's default
    # sort is not).
    take = torch.argsort((~survive).to(torch.int8), stable=True)[:capacity]
    kept = survive[take]
    k1 = kept[:, None]
    return {
        "pos": torch.where(k1, all_pos[take], 0.5),
        "lookup_pos": torch.where(k1, all_lookup[take], 0.5),
        "dir": torch.where(k1, all_dir[take],
                           torch.tensor([0.0, 0.0, 1.0], device=dev)),
        # -1 marks invalid rows for the EM.
        "weight": torch.where(kept, w_corr[take], -1.0),
        "priority": torch.where(kept, all_pr[take], 0.0),
        "valid": kept,
    }
