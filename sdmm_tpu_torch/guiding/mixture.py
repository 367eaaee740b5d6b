"""Spatio-directional Gaussian mixtures, batched ``[L leaves, K components]``
(port of sdmm_tpu/guiding/mixture.py), and the products of directional
mixtures that learned-BSDF product sampling draws from.

The 5-D model: 3 Euclidean (canonical position) + 2 tangent dims at a unit
mean direction on S². Dead components carry weight 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import warp
from . import tangent as tg

INV_SQRT_TWO_PI = 0.3989422804014327
Z_TRUST = 3.0  # whitened-sigma trust radius for conditional extrapolation
# (see create_conditional; mirrored in ops/guided_sample.py)


class SDMM(NamedTuple):
    """Primary mixture parameters (the trainable state)."""

    weight: torch.Tensor  # [L, K]
    mean: torch.Tensor  # [L, K, 6] canonical pos (3) + unit dir (3)
    cov: torch.Tensor  # [L, K, 5, 5] joint tangent covariance


class Prepared(NamedTuple):
    """Derived quantities recomputed after every EM update."""

    rot: torch.Tensor  # [L, K, 3, 3] tangent frame at dir mean
    chol: torch.Tensor  # [L, K, 5, 5]
    inv_chol: torch.Tensor  # [L, K, 5, 5]
    inv_det_chol: torch.Tensor  # [L, K] det(cov)^-1/2
    mu_a: torch.Tensor  # [L, K, 3] spatial mean
    premult: torch.Tensor  # [L, K, 2, 3] Σ_BA Σ_AA⁻¹
    cond_chol: torch.Tensor  # [L, K, 2, 2]
    cond_inv_chol: torch.Tensor  # [L, K, 2, 2]
    cond_inv_det: torch.Tensor  # [L, K]
    marg_inv_chol: torch.Tensor  # [L, K, 3, 3]
    marg_inv_det: torch.Tensor  # [L, K]
    valid: torch.Tensor  # [L, K] alive & numerically sound


def _eye(n, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _tri_inv(chol: torch.Tensor) -> torch.Tensor:
    """Batched lower-triangular inverse."""
    eye = _eye(chol.shape[-1], chol).expand_as(chol)
    return torch.linalg.solve_triangular(chol, eye, upper=False)


def _chol_safe(cov: torch.Tensor, alive: torch.Tensor):
    """Cholesky with dead/non-PD masking; returns (chol, ok).

    ``torch.linalg.cholesky_ex`` reports a failed factorization in ``info``
    where the reference's JAX cholesky returns NaNs; both are masked the
    same way: the failed component gets an identity factor and ok=False.
    """
    eye = _eye(cov.shape[-1], cov)
    safe_cov = torch.where(alive[..., None, None], cov, eye)
    chol, info = torch.linalg.cholesky_ex(safe_cov)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    ok = ((info == 0) & torch.isfinite(chol).all(-1).all(-1)
          & (diag > 0.0).all(-1))
    chol = torch.where(ok[..., None, None], chol, eye)
    return chol, ok & alive


def chol2x2(cov: torch.Tensor):
    """Closed-form lower Cholesky factor of [..., 2, 2] covariances (of
    their symmetric part, as JAX's cholesky takes it) and whether it
    exists; where it does not, the factor is the identity."""
    a = cov[..., 0, 0]
    b = 0.5 * (cov[..., 0, 1] + cov[..., 1, 0])
    l00 = torch.sqrt(a.clamp_min(0.0))
    l10 = b / torch.where(l00 > 0.0, l00, 1.0)
    d = cov[..., 1, 1] - l10 * l10
    l11 = torch.sqrt(d.clamp_min(0.0))
    ok = (a > 0.0) & (d > 0.0) & torch.isfinite(l10) & torch.isfinite(l11)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    chol = torch.stack([
        torch.stack([torch.where(ok, l00, one), zero], -1),
        torch.stack([torch.where(ok, l10, zero), torch.where(ok, l11, one)],
                    -1)], -2)
    return chol, ok


def inv_lower2x2(chol: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 2, 2] lower-triangular factors."""
    i00 = 1.0 / chol[..., 0, 0]
    i11 = 1.0 / chol[..., 1, 1]
    return torch.stack([
        torch.stack([i00, torch.zeros_like(i00)], -1),
        torch.stack([-chol[..., 1, 0] * i00 * i11, i11], -1)], -2)


def prepare(m: SDMM) -> Prepared:
    alive = m.weight > 0.0
    rot = tg.make_rotation(m.mean[..., 3:6])
    chol, ok = _chol_safe(m.cov, alive)
    inv_chol = _tri_inv(chol)
    inv_det = 1.0 / torch.diagonal(chol, dim1=-2, dim2=-1).prod(-1)

    cov_aa = m.cov[..., :3, :3]
    cov_ab = m.cov[..., :3, 3:]
    cov_ba = m.cov[..., 3:, :3]
    cov_bb = m.cov[..., 3:, 3:]
    marg_chol, marg_ok = _chol_safe(cov_aa, alive)
    marg_inv_chol = _tri_inv(marg_chol)
    marg_inv_det = 1.0 / torch.diagonal(marg_chol, dim1=-2, dim2=-1).prod(-1)
    # Σ_AA⁻¹ = inv_cholᵀ · inv_chol
    cov_aa_inv = marg_inv_chol.transpose(-1, -2) @ marg_inv_chol
    premult = cov_ba @ cov_aa_inv
    cond_cov = cov_bb - premult @ cov_ab
    cond_chol, cond_ok = _chol_safe(cond_cov, alive)
    cond_inv_chol = _tri_inv(cond_chol)
    cond_inv_det = 1.0 / torch.diagonal(cond_chol, dim1=-2, dim2=-1).prod(-1)
    return Prepared(
        rot=rot, chol=chol, inv_chol=inv_chol, inv_det_chol=inv_det,
        mu_a=m.mean[..., :3], premult=premult,
        cond_chol=cond_chol, cond_inv_chol=cond_inv_chol,
        cond_inv_det=cond_inv_det,
        marg_inv_chol=marg_inv_chol, marg_inv_det=marg_inv_det,
        valid=ok & marg_ok & cond_ok,
    )


def _matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched a @ x for x [..., n] (einsum '...ij,...j->...i')."""
    return (a * x[..., None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Joint 5-D pdf / posterior
# ---------------------------------------------------------------------------


def joint_tangent(mean, rot, pos, d):
    """Per-component joint tangent coords of a sample. mean/rot:
    [..., K, 6] / [..., K, 3, 3]; pos/d: [..., 3]. Returns (t [..., K, 5]
    with ABSOLUTE spatial coords, log_jac [..., K], valid [..., K])."""
    t_dir, aos, valid = tg.log_map(rot, d[..., None, :])
    t = torch.cat([pos[..., None, :].expand_as(mean[..., :3]), t_dir], -1)
    return t, aos, valid


def component_pdf(mean, inv_chol, inv_det, rot, pos, d):
    """Per-component joint pdf and tangent coords (absolute spatial coords).
    Returns (pdf [..., K], t_abs [..., K, 5])."""
    t_abs, aos, valid = joint_tangent(mean, rot, pos, d)
    centered = torch.cat([t_abs[..., :3] - mean[..., :3], t_abs[..., 3:]], -1)
    z = _matvec(inv_chol, centered)
    pdf = (INV_SQRT_TWO_PI ** 5) * torch.exp(-0.5 * (z * z).sum(-1)) \
        * inv_det * aos
    return torch.where(valid, pdf, 0.0), t_abs


def posterior_and_log(weight, mean, inv_chol, inv_det, rot, pos, d):
    """Responsibilities + tangent coords in one pass. weight [..., K];
    pos, d [..., 3]. Returns (pdf_k, posterior_k, t_abs)."""
    pdf, t_abs = component_pdf(mean, inv_chol, inv_det, rot, pos, d)
    post = weight * pdf
    total = post.sum(-1)
    inv_total = torch.where(total > 0.0, 1.0 / total, 0.0)
    posterior = post * inv_total[..., None]
    posterior = torch.where(torch.isfinite(inv_total)[..., None], posterior,
                            0.0)
    return pdf, posterior, t_abs


# ---------------------------------------------------------------------------
# Conditioning
# ---------------------------------------------------------------------------


class Conditional(NamedTuple):
    """Per-sample directional mixture conditioned on position."""

    weight: torch.Tensor  # [..., K]
    mu_dir: torch.Tensor  # [..., K, 3]
    rot: torch.Tensor  # [..., K, 3, 3]
    chol: torch.Tensor  # [..., K, 2, 2]
    inv_chol: torch.Tensor  # [..., K, 2, 2]
    inv_det: torch.Tensor  # [..., K]
    valid: torch.Tensor  # [...]


def marginal_pdf(mu_a, marg_inv_chol, marg_inv_det, pos):
    """Spatial marginal N(pos; μ_A, Σ_AA) per component; pos [..., 3]."""
    z = _matvec(marg_inv_chol, pos[..., None, :] - mu_a)
    return (INV_SQRT_TWO_PI ** 3) * torch.exp(-0.5 * (z * z).sum(-1)) \
        * marg_inv_det


def create_conditional(prep_g: Prepared, weight_g: torch.Tensor,
                       pos: torch.Tensor) -> Conditional:
    """Condition gathered mixture components on position ``pos``.

    Weights are computed in LOG space with max-subtraction: the linear
    marginal exp(-z²/2) underflows f32 past ~13 whitened σ, which
    invalidates the conditional at most protocol-scale lookups. The
    conditioning offset is clamped to the Z_TRUST·σ surface per component
    (the weights keep the true distances).
    """
    centered = pos[..., None, :] - prep_g.mu_a
    z = _matvec(prep_g.marg_inv_chol, centered)
    q = (z * z).sum(-1)
    logm = torch.log(prep_g.marg_inv_det.clamp_min(1e-38)) - 0.5 * q
    logw = torch.where(
        prep_g.valid & (weight_g > 0.0),
        torch.log(weight_g.clamp_min(1e-38)) + logm,
        float("-inf"),
    )
    m = logw.max(-1).values
    valid = torch.isfinite(m)
    w = torch.where(valid[..., None],
                    torch.exp(logw - torch.where(valid, m, 0.0)[..., None]),
                    0.0)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-38)

    zn = torch.sqrt(q.clamp_min(1e-30))
    cl = (Z_TRUST / zn).clamp_max(1.0)
    t_mean = cl[..., None] * _matvec(prep_g.premult, centered)
    mu_dir, _, exp_ok = tg.exp_map(prep_g.rot, t_mean)
    w = torch.where(exp_ok, w, 0.0)
    rot = tg.make_rotation(mu_dir)
    return Conditional(
        weight=w, mu_dir=mu_dir, rot=rot,
        chol=prep_g.cond_chol, inv_chol=prep_g.cond_inv_chol,
        inv_det=prep_g.cond_inv_det, valid=valid,
    )


def pack_conditioning(prep: Prepared, weight: torch.Tensor,
                      initialized: torch.Tensor) -> torch.Tensor:
    """Row-pack everything ``create_conditional`` needs into one [L, C]
    array (C = 625 for K = 16)."""
    L = weight.shape[0]
    parts = [
        weight,
        prep.mu_a.reshape(L, -1),
        prep.marg_inv_chol.reshape(L, -1),
        prep.marg_inv_det,
        prep.premult.reshape(L, -1),
        prep.rot.reshape(L, -1),
        prep.cond_chol.reshape(L, -1),
        prep.cond_inv_chol.reshape(L, -1),
        prep.cond_inv_det,
        prep.valid.float(),
        initialized.float()[:, None],
    ]
    return torch.cat(parts, dim=-1)


def unpack_conditioning(rows: torch.Tensor, k: int):
    """Inverse of pack_conditioning for gathered rows [..., C]. Returns
    (weight [..., K], Prepared with the conditioning fields set,
    initialized [...] bool)."""
    off = 0
    batch = rows.shape[:-1]

    def take(n, shape):
        nonlocal off
        out = rows[..., off:off + n].reshape(batch + shape)
        off += n
        return out

    weight = take(k, (k,))
    mu_a = take(3 * k, (k, 3))
    marg_inv_chol = take(9 * k, (k, 3, 3))
    marg_inv_det = take(k, (k,))
    premult = take(6 * k, (k, 2, 3))
    rot = take(9 * k, (k, 3, 3))
    cond_chol = take(4 * k, (k, 2, 2))
    cond_inv_chol = take(4 * k, (k, 2, 2))
    cond_inv_det = take(k, (k,))
    valid = take(k, (k,)) > 0.5
    initialized = take(1, (1,))[..., 0] > 0.5
    prep = Prepared(
        rot=rot, chol=None, inv_chol=None, inv_det_chol=None,
        mu_a=mu_a, premult=premult, cond_chol=cond_chol,
        cond_inv_chol=cond_inv_chol, cond_inv_det=cond_inv_det,
        marg_inv_chol=marg_inv_chol, marg_inv_det=marg_inv_det, valid=valid,
    )
    return weight, prep, initialized


def conditional_pdf(c: Conditional, d: torch.Tensor) -> torch.Tensor:
    """Mixture pdf over directions (solid-angle measure); d [..., 3]."""
    t, aos, ok = tg.log_map(c.rot, d[..., None, :])
    z = _matvec(c.inv_chol, t)
    pdf_k = (INV_SQRT_TWO_PI ** 2) * torch.exp(-0.5 * (z * z).sum(-1)) \
        * c.inv_det * aos
    pdf_k = torch.where(ok, pdf_k, 0.0)
    return (c.weight * pdf_k).sum(-1)


def conditional_sample_from_uniforms(c: Conditional, u_sel: torch.Tensor,
                                     u: torch.Tensor):
    """One direction per sample from the conditional mixture with explicit
    uniforms (u_sel [...], u [..., 2]). Returns (dir [..., 3], ok [...])."""
    K = c.weight.shape[-1]
    cdf = torch.cumsum(c.weight, dim=-1)
    sel = (u_sel[..., None] > cdf).sum(-1).clamp(0, K - 1)
    z = warp.square_to_std_normal(u)
    idx = sel[..., None, None, None]
    chol_s = torch.gather(c.chol, -3, idx.expand(sel.shape + (1, 2, 2)))[..., 0, :, :]
    rot_s = torch.gather(c.rot, -3, idx.expand(sel.shape + (1, 3, 3)))[..., 0, :, :]
    t = _matvec(chol_s, z)
    d, _, ok = tg.exp_map(rot_s, t)
    return d, ok


# ---------------------------------------------------------------------------
# Products of directional mixtures
# ---------------------------------------------------------------------------


def prune_conditional(c: Conditional, k: int) -> Conditional:
    """Keep the top-k components by weight, renormalized (the learned-BSDF
    conditional is pruned to its top 2 before the product, so products are
    K_guide × 2)."""
    w, idx = torch.topk(c.weight, k, dim=-1)
    wsum = w.sum(-1, keepdim=True).clamp_min(1e-20)
    nb = idx.ndim

    def gather(a):
        ix = idx.reshape(idx.shape + (1,) * (a.ndim - nb))
        ix = ix.expand(idx.shape + a.shape[nb:])
        return torch.gather(a, nb - 1, ix)

    return Conditional(
        weight=w / wsum, mu_dir=gather(c.mu_dir), rot=gather(c.rot),
        chol=gather(c.chol), inv_chol=gather(c.inv_chol),
        inv_det=gather(c.inv_det), valid=c.valid,
    )


def product(a: Conditional, b: Conditional) -> Conditional:
    """Pairwise mixture product a×b → Conditional with K_a·K_b components:
    each pair of Gaussians multiplied in a's tangent frame, b's covariance
    transported there through the exp/log Jacobian chain."""
    ka = a.weight.shape[-1]
    kb = b.weight.shape[-1]
    batch = a.weight.shape[:-1]
    a_rot = a.rot[..., :, None, :, :]
    b_rot = b.rot[..., None, :, :, :]
    mm = tg.mm
    a_cov = mm(a.chol, a.chol.transpose(-1, -2))[..., :, None, :, :]
    b_cov = mm(b.chol, b.chol.transpose(-1, -2))[..., None, :, :, :]
    b_mu = b.mu_dir[..., None, :, :]

    # b's mean in a's tangent space; b's covariance transported there:
    # J = J_log_a(world) ∘ R_b ∘ J_exp_b(0).
    t_b, aos, log_ok = tg.log_map(a_rot, b_mu)
    exp_j = tg.exp_jacobian(torch.zeros_like(t_b))
    log_j = tg.log_jacobian(a_rot, b_mu)
    j = mm(mm(log_j, b_rot), exp_j)
    b_cov_t = mm(mm(j, b_cov), j.transpose(-1, -2))

    cov_sum = a_cov + b_cov_t
    det = cov_sum[..., 0, 0] * cov_sum[..., 1, 1] \
        - cov_sum[..., 0, 1] * cov_sum[..., 1, 0]
    inv_det_sum = torch.where(det.abs() > 1e-38, 1.0 / det, 0.0)
    adj = torch.stack([
        torch.stack([cov_sum[..., 1, 1], -cov_sum[..., 0, 1]], -1),
        torch.stack([-cov_sum[..., 1, 0], cov_sum[..., 0, 0]], -1),
    ], dim=-2)
    inv_sum = adj * inv_det_sum[..., None, None]

    # New mean in a's tangent frame: A (A+B)⁻¹ t_b.
    a_inv = mm(a_cov, inv_sum)
    mean_new_t = _matvec(a_inv, t_b)
    cov_new_t = mm(a_inv, b_cov_t)
    cov_new_t = 0.5 * (cov_new_t + cov_new_t.transpose(-1, -2))

    mu_new, _, exp_ok = tg.exp_map(a_rot, mean_new_t)
    rot_new = tg.make_rotation(mu_new)
    j2 = mm(mm(tg.log_jacobian(rot_new, mu_new), a_rot),
            tg.exp_jacobian(mean_new_t))
    cov_new = mm(mm(j2, cov_new_t), j2.transpose(-1, -2))
    cov_new = 0.5 * (cov_new + cov_new.transpose(-1, -2))

    # Pair weight: N(t_b; 0, A+B) times the Jacobian factor.
    z_det = torch.sqrt(det.clamp_min(1e-38))
    maha = (t_b * _matvec(inv_sum, t_b)).sum(-1)
    s_ij = (INV_SQRT_TWO_PI ** 2) * torch.exp(-0.5 * maha) / z_det * aos
    w = a.weight[..., :, None] * b.weight[..., None, :] * s_ij
    w = torch.where(log_ok & exp_ok, w, 0.0)

    flat = batch + (ka * kb,)
    w = w.reshape(flat)
    total = w.sum(-1)
    valid = (total > 0.0) & torch.isfinite(total) & a.valid & b.valid
    w = torch.where(valid[..., None],
                    w / total[..., None].clamp_min(1e-38), 0.0)
    alive = w > 0.0
    chol, ok = chol2x2(torch.where(alive[..., None, None],
                                   cov_new.reshape(flat + (2, 2)),
                                   torch.eye(2, device=w.device)))
    ok = ok & alive
    w = torch.where(ok | ~alive, w, 0.0)
    return Conditional(
        weight=w, mu_dir=mu_new.reshape(flat + (3,)),
        rot=rot_new.reshape(flat + (3, 3)), chol=chol,
        inv_chol=inv_lower2x2(chol),
        inv_det=1.0 / (chol[..., 0, 0] * chol[..., 1, 1]),
        valid=valid,
    )
