"""Batched stepwise (streaming) MAP-EM for all tree leaves at once (port of
sdmm_tpu/guiding/em.py).

The E-step is one pass over the global sample buffer: per-sample
responsibilities against the sample's own leaf mixture, summed per (leaf,
component) into 21 sufficient statistics (``ops.em_suffstats``: the CUDA
kernel on the card, the plain twin on the CPU; mixtures of K != 16
components and SDMM_TPU_NO_EM_KERNEL=1 take the twin's math on the card,
``use_em_kernel``). The M-step runs on the
whole [L, K] array with masks for inactive leaves and dead components,
including the batched-eigh PSD repair and the kill rule.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core.device import resolve_device
from ..ops import em_suffstats
from . import mixture as mix
from . import tangent as tg


class EMConfig(NamedTuple):
    alpha: float = 0.9  # stepwise decay exponent
    learning_rate: float = 0.2  # η = (lr·t + 1)^-α
    ni_prior: float = 6e-5  # Dirichlet weight prior - 1
    a_prior: float = 100.0  # (a_prior / K) = inverse-Wishart dof - 2
    b_prior_diag: float = 1e-5  # isotropic covariance prior scale
    spatial_eps: float = 1e-8  # extra spatial diagonal prior
    spatial_floor_frac: float = 0.2  # non-decaying spatial covariance floor
    # as a fraction of the leaf extent (per axis), applied when m_step
    # receives leaf extents
    training_cutoff: int = 32  # prior decay clamp
    jacobian_correction: bool = True  # transport covs between tangent frames
    batch_size: int = 1 << 16  # plain E-step sample chunk


class EMState(NamedTuple):
    """Running (global) sufficient statistics per leaf-component."""

    stats_w: torch.Tensor  # [L, K]
    stats_mean: torch.Tensor  # [L, K, 5]
    stats_cov: torch.Tensor  # [L, K, 5, 5]
    total_weight: torch.Tensor  # [L]
    iterations: torch.Tensor  # [L] int32


def init_em_state(n_leaves: int, n_components: int, device="cpu") -> EMState:
    def z(*shape):
        return torch.zeros(shape, device=device)

    return EMState(
        stats_w=z(n_leaves, n_components),
        stats_mean=z(n_leaves, n_components, 5),
        stats_cov=z(n_leaves, n_components, 5, 5),
        total_weight=z(n_leaves),
        iterations=torch.zeros(n_leaves, dtype=torch.int32, device=device),
    )


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _sandwich(j, c):
    """j @ c @ jᵀ for batched square matrices."""
    return j @ c @ j.transpose(-1, -2)


def _sym(c):
    return 0.5 * (c + c.transpose(-1, -2))


# cuSOLVER's batched symmetric eigensolver rejects batches of 32,768 or
# more matrices (CUSOLVER_STATUS_INVALID_VALUE on an H100, CUDA 12.8), and
# the [2048, 16] component grid is exactly that many.
_EIGH_CHUNK = 16384


def _eigh(c):
    """Batched ``torch.linalg.eigh`` in chunks of at most _EIGH_CHUNK."""
    flat = c.reshape(-1, *c.shape[-2:])
    parts = [torch.linalg.eigh(flat[i:i + _EIGH_CHUNK])
             for i in range(0, flat.shape[0], _EIGH_CHUNK)]
    evals = torch.cat([p[0] for p in parts])
    evecs = torch.cat([p[1] for p in parts])
    return (evals.reshape(*c.shape[:-1]), evecs.reshape(c.shape))


def m_step(
    sdmm: mix.SDMM,
    prep: mix.Prepared,
    em: EMState,
    stats_w: torch.Tensor,
    stats_mean: torch.Tensor,
    stats_cov: torch.Tensor,
    weight_sum: torch.Tensor,
    active: torch.Tensor,  # [L] bool: leaves to update this iteration
    cfg: EMConfig = EMConfig(),
    leaf_ext: torch.Tensor | None = None,  # [L, 3] leaf extents (canonical)
):
    """One stepwise M-step; returns (new_sdmm, new_em_state)."""
    L, K = sdmm.weight.shape
    act = active & (weight_sum > 0.0)
    a1 = act[:, None]

    # Stepwise blend of the running statistics.
    it = em.iterations.float()
    eta = torch.where(act, (cfg.learning_rate * it + 1.0) ** (-cfg.alpha), 0.0)
    keep = 1.0 - eta
    g_w = keep[:, None] * em.stats_w + eta[:, None] * stats_w
    g_mean = keep[:, None, None] * em.stats_mean \
        + eta[:, None, None] * stats_mean
    g_cov = keep[:, None, None, None] * em.stats_cov \
        + eta[:, None, None, None] * stats_cov
    total_w = keep * em.total_weight + eta * weight_sum

    inv_total = torch.where(total_w > 0.0, 1.0 / total_w, 0.0)
    sb_w = g_w * inv_total[:, None]
    sb_mean = g_mean * inv_total[:, None, None]
    sb_cov = g_cov * inv_total[:, None, None, None]

    # Decayed MAP priors.
    it_c = em.iterations.clamp_max(cfg.training_cutoff).float()
    inv_g = torch.pow(3.0, -it_c)[:, None]
    inv_m = torch.pow(2.0, -it_c)[:, None]
    ni = cfg.ni_prior * inv_g
    a_m2 = (cfg.a_prior / K) * inv_m
    b_prior = (a_m2[..., None, None] * cfg.b_prior_diag) * _eye(5, sb_cov)

    alive = sdmm.weight > 0.0
    weak = sb_w <= 1e-30  # no mass this round: keep shape, bump weight only
    w_new = torch.where(alive, ni + sb_w, 0.0)

    inv_sb_w = torch.where(weak, 0.0, 1.0 / sb_w.clamp_min(1e-30))
    m_new = sb_mean * inv_sb_w[..., None]  # [L, K, 5]
    c_new = sb_cov - sb_mean[..., :, None] * m_new[..., None, :] + b_prior
    c_new = c_new * (1.0 / (0.05 * a_m2 + sb_w))[..., None, None]
    eye5 = _eye(5, c_new)
    spatial = torch.zeros_like(eye5)
    spatial[:3, :3] = _eye(3, c_new)
    c_new = _sym(c_new + cfg.spatial_eps * spatial)

    # New embedded mean: exp-map directional part in the OLD tangent frame.
    mu_dir_new, _, exp_ok = tg.exp_map(prep.rot, m_new[..., 3:5])
    mean_new = torch.cat([m_new[..., :3], mu_dir_new], dim=-1)

    # Covariance transport old frame → new frame.
    if cfg.jacobian_correction:
        rot_new = tg.make_rotation(mu_dir_new)
        jexp = tg.exp_jacobian(m_new[..., 3:5])  # [L, K, 3, 2]
        jlog = tg.log_jacobian(rot_new, mu_dir_new)  # [L, K, 2, 3]
        j2 = jlog @ prep.rot @ jexp
    else:
        j2 = _eye(2, c_new).expand(L, K, 2, 2)
    jfull = torch.zeros_like(c_new)
    jfull[..., :3, :3] = _eye(3, c_new)
    jfull[..., 3:, 3:] = j2
    c_new = _sym(_sandwich(jfull, c_new))

    # Non-decaying per-leaf spatial floor.
    if leaf_ext is not None and cfg.spatial_floor_frac > 0.0:
        floor = (cfg.spatial_floor_frac * leaf_ext) ** 2  # [L, 3]
        fl = torch.zeros(L, 5, device=c_new.device)
        fl[:, :3] = floor
        c_new = c_new + torch.diag_embed(fl)[:, None]

    # PD repair: clamp eigenvalues to a relative floor; kill only genuinely
    # broken components (min eig < −25% of max, non-finite, or ≤ 0).
    # torch.linalg.eigh raises where JAX returns NaNs, so non-finite
    # matrices are swapped for the identity and flagged first.
    finite = torch.isfinite(c_new).all(-1).all(-1)
    evals, evecs = _eigh(torch.where(finite[..., None, None], c_new, eye5))
    lam_max = evals[..., -1]
    lam_min = evals[..., 0]
    shape_ok = (finite & torch.isfinite(evals).all(-1) & (lam_max > 0.0)
                & (lam_min > -0.25 * lam_max))
    evals_c = torch.maximum(evals, 1e-6 * lam_max[..., None] + 1e-12)
    c_new = _sym((evecs * evals_c[..., None, :]) @ evecs.transpose(-1, -2))
    chol_test, info = torch.linalg.cholesky_ex(c_new)
    diag = torch.diagonal(chol_test, dim1=-2, dim2=-1)
    pd_ok = (shape_ok & (info == 0) & torch.isfinite(chol_test).all(-1).all(-1)
             & (diag > 0.0).all(-1))
    good = alive & ~weak & pd_ok & exp_ok & a1
    kill = alive & ~weak & ~(pd_ok & exp_ok)  # broken update kills component
    w_new = torch.where(kill, 0.0, w_new)
    w_new = torch.where(a1, w_new, sdmm.weight)

    mean_out = torch.where(good[..., None], mean_new, sdmm.mean)
    cov_out = torch.where(good[..., None, None], c_new, sdmm.cov)

    # Renormalize weights per leaf.
    norm = w_new.sum(-1, keepdim=True)
    w_out = torch.where(norm > 0.0, w_new / norm.clamp_min(1e-30), w_new)
    w_out = torch.where(a1, w_out, sdmm.weight)

    # Recentre + transport running covariance stats around the new mean.
    sb_cov2 = sb_cov - sb_mean[..., :, None] * m_new[..., None, :]
    cm_stat = torch.cat([sb_mean[..., :3], torch.zeros_like(sb_mean[..., 3:])],
                        -1)
    cm_new = torch.cat([m_new[..., :3], torch.zeros_like(m_new[..., 3:])], -1)
    sb_cov2 = sb_cov2 + cm_stat[..., :, None] * cm_new[..., None, :]
    sb_cov2 = _sandwich(jfull, sb_cov2)
    g_cov_out = torch.where(good[..., None, None],
                            sb_cov2 * total_w[:, None, None, None], g_cov)
    g_mean0 = torch.cat([g_mean[..., :3], torch.zeros_like(g_mean[..., 3:])],
                        -1)
    g_mean_out = torch.where(good[..., None], g_mean0, g_mean)
    g_w_out = torch.where(alive, g_w, 0.0)

    new_sdmm = mix.SDMM(weight=w_out, mean=mean_out, cov=cov_out)
    new_em = EMState(
        stats_w=torch.where(a1, g_w_out, em.stats_w),
        stats_mean=torch.where(a1[..., None], g_mean_out, em.stats_mean),
        stats_cov=torch.where(a1[..., None, None], g_cov_out, em.stats_cov),
        total_weight=torch.where(act, total_w, em.total_weight),
        iterations=em.iterations + act.to(torch.int32),
    )
    return new_sdmm, new_em


def use_em_kernel(sdmm) -> bool:
    """Whether the E-step takes ``em_suffstats.e_step`` (the kernels on
    the card, the twin on the CPU): the kernel is specialised to K = 16
    components, and SDMM_TPU_NO_EM_KERNEL=1 asks for the twin's math on
    the card, as the reference's ``_use_pallas_e_step`` routes. Otherwise
    ``e_step_plain`` runs on any device."""
    return (sdmm.weight.shape[-1] == em_suffstats.K
            and os.environ.get("SDMM_TPU_NO_EM_KERNEL") != "1")


def em_step(sdmm, em, pos, d, weight, leaf, active, cfg: EMConfig = EMConfig(),
            leaf_ext=None, device: str | torch.device = "cuda"):
    """Full EM iteration: prepare → E-step → M-step on ``device``.
    Returns (sdmm, em, count)."""
    dev = resolve_device(device)

    def mv(x):
        return None if x is None else x.to(dev)

    sdmm = mix.SDMM(*(mv(x) for x in sdmm))
    em = EMState(*(mv(x) for x in em))
    pos, d, weight, leaf, active, leaf_ext = (
        mv(x) for x in (pos, d, weight, leaf, active, leaf_ext))
    n_leaves = sdmm.weight.shape[0]
    prep = mix.prepare(sdmm)
    e_step = em_suffstats.e_step if use_em_kernel(sdmm) \
        else em_suffstats.e_step_plain
    sw, sm, sc, ws, cnt = e_step(
        sdmm, prep, pos, d, weight, leaf, n_leaves, batch_size=cfg.batch_size)
    new_sdmm, new_em = m_step(sdmm, prep, em, sw, sm, sc, ws, active, cfg,
                              leaf_ext=leaf_ext)
    return new_sdmm, new_em, cnt


def batch_em(sdmm, pos, d, weight, leaf, active, n_iters: int = 8,
             cfg: EMConfig = EMConfig(), device: str | torch.device = "cuda"):
    """Full-batch (non-stepwise) EM: every iteration refits from the whole
    sample set with a fresh EMState, so no running statistics blend in
    (eta = 1, full MAP priors each pass). For offline fits; the online
    path stays stepwise. Returns the fitted mixtures."""
    L, K = sdmm.weight.shape
    for _ in range(n_iters):
        em = init_em_state(L, K, device)
        sdmm, em, _ = em_step(sdmm, em, pos, d, weight, leaf, active, cfg,
                              device=device)
    return sdmm
