"""SVD component splitting for the batched stepwise EM (port of
sdmm_tpu/guiding/split.py).

A component splits along the dominant directional axis of its covariance
(the axis's spatial rows zeroed) into two children that keep the parent's
first two moments: weight w/2 each, tangent means ∓u·a, covariance
cov − u²·a·aᵀ (u = 1/2). Every leaf picks its single best candidate and
moves one child into a dead slot (weight 0), all leaves at once; a leaf
without a dead slot, or whose best score is at most ``min_score``, is left
as it is.
"""

from __future__ import annotations

import torch

from . import mixture as mix
from . import tangent as tg
from .em import EMState

SPLIT_WEIGHT = 0.5
SPLIT_U = 0.5


def _leading_scaled_axis(cov: torch.Tensor) -> torch.Tensor:
    """Leading column of U·sqrt(S) per component (the split axis a). The
    sign of a singular vector is arbitrary: it only decides which child
    takes which of the two slots."""
    u, s, _ = torch.linalg.svd(cov)
    return u[..., :, 0] * torch.sqrt(s[..., 0:1].clamp_min(0.0))


def svd_split(sdmm: mix.SDMM, em: EMState, active: torch.Tensor,
              min_score: float = 1e-3):
    """One batched split round. Returns (sdmm, em, did_split [L] bool).

    active [L]: the leaves eligible this round. Score = weight × the
    directional variance along the split axis; the leaf's argmax component
    splits into its lowest-index dead slot if the score exceeds
    ``min_score``."""
    L, K = sdmm.weight.shape
    dev = sdmm.weight.device
    alive = sdmm.weight > 0.0
    a = _leading_scaled_axis(sdmm.cov)  # [L, K, 5]
    a = torch.cat([torch.zeros_like(a[..., :3]), a[..., 3:]], -1)
    score = torch.where(alive, sdmm.weight * (a * a).sum(-1), -1.0)
    j = score.argmax(-1)
    best = score.gather(-1, j[:, None])[:, 0]
    dead_rank = torch.where(alive, float("inf"),
                            torch.arange(K, device=dev).float()[None, :])
    k = dead_rank.argmin(-1)
    do = active & (~alive).any(-1) & (best > min_score)

    ar = torch.arange(L, device=dev)
    a_j = a[ar, j]  # [L, 5]
    w_j = sdmm.weight[ar, j]
    mean_j = sdmm.mean[ar, j]
    cov_j = sdmm.cov[ar, j]
    rot = tg.make_rotation(mean_j[..., 3:6])
    t_off = SPLIT_U * a_j[..., 3:5]
    dir_a, _, ok_a = tg.exp_map(rot, -t_off)
    dir_b, _, ok_b = tg.exp_map(rot, t_off)
    mean_a = torch.cat([mean_j[..., :3], dir_a], -1)
    mean_b = torch.cat([mean_j[..., :3], dir_b], -1)
    cov_c = cov_j - (SPLIT_U * SPLIT_U) * a_j[..., :, None] * a_j[..., None, :]
    cov_c = cov_c + 1e-8 * torch.eye(5, device=dev)
    do = do & ok_a & ok_b

    def put(arr, idx, val):
        sel = do.reshape((L,) + (1,) * (val.ndim - 1))
        out = arr.clone()
        out[ar, idx] = torch.where(sel, val, arr[ar, idx])
        return out

    w_half = 0.5 * w_j
    new_sdmm = mix.SDMM(
        weight=put(put(sdmm.weight, j, w_half), k, w_half),
        mean=put(put(sdmm.mean, j, mean_a), k, mean_b),
        cov=put(put(sdmm.cov, j, cov_c), k, cov_c),
    )
    # Running statistics: the parent's mass halves; each child's follow
    # the M-step convention (tangent mean re-centred to 0 in its own frame,
    # covariance statistics w·(cov + m̃·m̃ᵀ) with m̃ = (spatial mean, 0, 0)).
    sw_half = 0.5 * em.stats_w[ar, j]
    m_tilde = torch.cat([mean_j[..., :3], torch.zeros_like(mean_j[..., :2])],
                        -1)
    sm_child = sw_half[..., None] * m_tilde
    sc_child = sw_half[..., None, None] * (
        cov_c + m_tilde[..., :, None] * m_tilde[..., None, :])
    new_em = EMState(
        stats_w=put(put(em.stats_w, j, sw_half), k, sw_half),
        stats_mean=put(put(em.stats_mean, j, sm_child), k, sm_child),
        stats_cov=put(put(em.stats_cov, j, sc_child), k, sc_child),
        total_weight=em.total_weight, iterations=em.iterations,
    )
    return new_sdmm, new_em, do
