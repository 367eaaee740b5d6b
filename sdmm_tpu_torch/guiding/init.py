"""Mixture initialization for tree leaves (port of sdmm_tpu/guiding/init.py):
``init_leaf_params`` stratifies spatial groups inside each leaf's box, each
carrying a Fibonacci ring of directions over the sphere; the data-driven
init reseeds a leaf's spatial means by batched k-means++ over its samples
(``kmeanspp_centers``, ``reseed_spatial_means``)."""

from __future__ import annotations

import numpy as np
import torch

from .mixture import SDMM


def _sphere_dirs(n: int) -> np.ndarray:
    """Fibonacci-spiral directions covering S²."""
    i = np.arange(n) + 0.5
    phi = np.pi * (1.0 + 5.0**0.5) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


def init_leaf_params(
    generator: torch.Generator,
    leaf_lo: torch.Tensor,  # [L, 3]
    leaf_hi: torch.Tensor,  # [L, 3]
    n_components: int = 16,
    n_spatial: int = 2,
    dir_std: float = 1.0,
) -> SDMM:
    """Initial mixtures for all L leaf slots; the group centres and the
    directional jitter are drawn from ``generator`` (on the leaves'
    device)."""
    L = leaf_lo.shape[0]
    K = n_components
    per = K // n_spatial
    dev = leaf_lo.device
    dirs = torch.as_tensor(_sphere_dirs(per), dtype=torch.float32,
                           device=dev).repeat(n_spatial, 1)  # [K, 3]

    centers = 0.25 + 0.5 * torch.rand((L, n_spatial, 3), generator=generator,
                                      device=dev)
    centers = leaf_lo[:, None, :] + centers * (leaf_hi - leaf_lo)[:, None, :]
    pos = centers.repeat_interleave(per, dim=1)  # [L, K, 3]
    jit = torch.randn((L, K, 3), generator=generator, device=dev) * 0.05
    d = dirs[None] + jit
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    mean = torch.cat([pos, d], dim=-1)
    spatial_std = ((leaf_hi - leaf_lo) * 0.35).clamp_min(1e-4)  # [L, 3]
    diag = torch.cat([
        (spatial_std ** 2)[:, None, :].expand(L, K, 3),
        torch.full((L, K, 2), dir_std ** 2, device=dev),
    ], dim=-1)
    cov = torch.diag_embed(diag)
    weight = torch.full((L, K), 1.0 / K, device=dev)
    return SDMM(weight=weight, mean=mean, cov=cov)


def _segment_argmax(score: torch.Tensor, leaf: torch.Tensor,
                    n_leaves: int) -> torch.Tensor:
    """Index of the max-score sample per leaf (the lowest index on ties);
    n_samples marks a leaf with no finite score."""
    s = score.shape[0]
    dev = score.device
    leaf = leaf.long()
    mx = torch.full((n_leaves,), float("-inf"), device=dev).scatter_reduce(
        0, leaf, score, "amax", include_self=True)
    is_max = torch.isfinite(score) & (score >= mx[leaf])
    idx = torch.where(is_max, torch.arange(s, device=dev), s)
    return torch.full((n_leaves,), s, dtype=torch.long,
                      device=dev).scatter_reduce(0, leaf, idx, "amin",
                                                 include_self=True)


def _gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log u)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(1e-38, 1.0 - 1e-7)))


def kmeanspp_centers(generator, pos: torch.Tensor, leaf: torch.Tensor,
                     valid: torch.Tensor, n_leaves: int, n_centers: int,
                     gumbels: torch.Tensor | None = None):
    """Batched per-leaf k-means++ seeding: the draw ∝ min-distance² becomes
    a Gumbel-max over log(d_min²) within each leaf's samples. ``gumbels``
    [n_centers, S] are the Gumbel draws, else drawn from ``generator``.
    Returns (centers [L, C, 3], has_center [L] bool)."""
    s = pos.shape[0]
    dev = pos.device
    leaf = leaf.long()
    if gumbels is None:
        gumbels = _gumbel(generator, (n_centers, s), dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    sel = _segment_argmax(torch.where(valid, gumbels[0], neg_inf), leaf,
                          n_leaves)
    has = sel < s
    c = pos[sel.clamp_max(s - 1)]
    centers = [c]
    d_min = ((pos - c[leaf]) ** 2).sum(-1)
    for j in range(1, n_centers):
        score = torch.where(valid & (d_min > 0.0),
                            torch.log(d_min.clamp_min(1e-30)) + gumbels[j],
                            neg_inf)
        sel = _segment_argmax(score, leaf, n_leaves)
        # A leaf with no remaining distinct sample reuses the last centre.
        c = torch.where((sel < s)[:, None], pos[sel.clamp_max(s - 1)], c)
        centers.append(c)
        d_min = torch.minimum(d_min, ((pos - c[leaf]) ** 2).sum(-1))
    return torch.stack(centers, dim=1), has


def reseed_spatial_means(sdmm: SDMM, centers: torch.Tensor,
                         reseed: torch.Tensor, n_spatial: int) -> SDMM:
    """Replace the spatial part of the means of the ``reseed`` leaves by
    k-means++ centres [L, n_spatial, 3]; directions and covariances keep
    the stratified init."""
    K = sdmm.weight.shape[1]
    pos = centers.repeat_interleave(K // n_spatial, dim=1)[:, :K]
    mean = torch.cat([torch.where(reseed[:, None, None], pos,
                                  sdmm.mean[..., :3]), sdmm.mean[..., 3:]],
                     dim=-1)
    return SDMM(weight=sdmm.weight, mean=mean, cov=sdmm.cov)
