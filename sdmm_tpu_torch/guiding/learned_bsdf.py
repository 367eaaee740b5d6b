"""Learned directional mixture models of BSDFs, for product sampling (port
of sdmm_tpu/guiding/learned_bsdf.py).

Each BSDF of a scene that has a smooth lobe gets its own mixture of
tangent Gaussians on S², fitted by a small weighted EM to samples of the
analytic BSDF in its local shading frame (z up). Glossy lobes get one
mixture per incidence-angle bin. At render time the mixture is rotated into
the world frame at each vertex (``to_world_conditional``), pruned to its
top ``PRODUCT_TOP_K`` components and multiplied with the position-
conditioned guiding mixture.

The table is fitted once per scene, on ``device`` (the card by default);
every random draw comes from a ``torch.Generator`` seeded from the fit's
own seed.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from ..bsdf import bsdf as bsdf_mod
from ..core import warp
from ..core.device import resolve_device
from ..core.frame import coordinate_system, reflect, to_world
from ..scene.scene import (
    BSDF_BLEND, BSDF_DIFFUSE, BSDF_PHONG, BSDF_ROUGHCONDUCTOR,
    BSDF_ROUGHDIELECTRIC, BSDF_ROUGHPLASTIC,
)
from . import mixture as mix
from . import tangent as tg

N_THETA_BINS = 8  # incidence-angle bins of the glossy lobes
# Types fitted to the scene's own BSDF row, one mixture per theta_i bin.
_GENERIC_HOOKED = {int(BSDF_ROUGHPLASTIC), int(BSDF_ROUGHDIELECTRIC),
                   int(BSDF_BLEND)}
PRODUCT_TOP_K = 2  # components of the learned conditional kept for the
# product


def fit_directional_mixture(dirs, weights, n_components: int = 4,
                            iters: int = 30, seed: int = 0, init_idx=None):
    """Weighted intrinsic EM for a mixture of tangent Gaussians on S².

    dirs: [N, 3] unit vectors; weights: [N] non-negative. The means start
    at the data points ``init_idx`` [K] (else K distinct points drawn with
    a generator seeded by ``seed``). Returns (w [K], mu [K, 3],
    cov [K, 2, 2]) float32 tensors on the device of ``dirs``."""
    dirs = torch.as_tensor(dirs, dtype=torch.float32)
    dev = dirs.device
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    k = n_components
    if init_idx is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        init_idx = torch.randperm(dirs.shape[0], generator=gen,
                                  device=dev)[:k]
    mu = dirs[torch.as_tensor(init_idx, device=dev).long()]
    eye = torch.eye(2, device=dev)
    cov = (eye * 0.25).expand(k, 2, 2)
    w = torch.full((k,), 1.0 / k, device=dev)
    for _ in range(iters):
        rot = tg.make_rotation(mu)  # [K, 3, 3]
        t, aos, ok = tg.log_map(rot[None], dirs[:, None, :])  # [N, K, 2]
        chol, c_ok = mix.chol2x2(cov)
        inv_chol = mix.inv_lower2x2(chol)
        inv_det = 1.0 / (chol[..., 0, 0] * chol[..., 1, 1])
        z = (inv_chol[None] * t[..., None, :]).sum(-1)
        pdf = (1.0 / (2 * math.pi)) * torch.exp(-0.5 * (z * z).sum(-1)) \
            * inv_det * aos
        pdf = torch.where(ok & c_ok, pdf, 0.0)
        post = w * pdf
        post = post / post.sum(-1, keepdim=True).clamp_min(1e-20)
        gw = weights[:, None] * post  # [N, K]
        wk = gw.sum(0)
        # Spherical mean, then the covariance about it.
        mu_new = gw.T @ dirs
        mu_new = mu_new / torch.linalg.vector_norm(
            mu_new, dim=-1, keepdim=True).clamp_min(1e-12)
        t_new, _, _ = tg.log_map(tg.make_rotation(mu_new)[None],
                                 dirs[:, None, :])
        cov = torch.einsum("nk,nki,nkj->kij", gw, t_new, t_new) \
            / wk[:, None, None].clamp_min(1e-12) + eye * 1e-4
        mu = mu_new
        w = wk / wk.sum().clamp_min(1e-20)
    return w, mu, cov


def _gen(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _local_wi(b: int, n: int, dev) -> torch.Tensor:
    """wi at the centre of theta_i bin ``b``, in the local xz-plane."""
    theta = (b + 0.5) / N_THETA_BINS * (math.pi / 2)
    return torch.tensor([math.sin(theta), 0.0, math.cos(theta)],
                        device=dev).expand(n, 3)


@lru_cache(maxsize=8)
def _cosine_dmm(n_components: int, n_samples: int, device: str):
    dev = torch.device(device)
    u = torch.rand((n_samples, 2), generator=_gen(1, dev), device=dev)
    d = warp.square_to_cosine_hemisphere(u)
    return fit_directional_mixture(d, torch.ones(n_samples, device=dev),
                                   n_components)


def cosine_dmm(n_components: int = 4, n_samples: int = 20000,
               device: str | torch.device = "cuda"):
    """The fixed DMM of the cosine lobe around +z (diffuse)."""
    return _cosine_dmm(n_components, n_samples, str(resolve_device(device)))


@lru_cache(maxsize=32)
def _roughconductor_dmm(alpha: float, n_components: int, n_samples: int,
                        device: str):
    dev = torch.device(device)
    n = n_samples
    params = {
        "type": torch.full((n,), BSDF_ROUGHCONDUCTOR, dtype=torch.int32,
                           device=dev),
        "albedo": torch.ones((n, 3), device=dev),
        "specular": torch.ones((n, 3), device=dev),
        "alpha": torch.full((n,), alpha, device=dev),
        "alpha_v": torch.full((n,), alpha, device=dev),
        "eta": torch.zeros((n,), device=dev),
        "k": torch.ones((n, 3), device=dev),
        "exponent": torch.full((n,), 30.0, device=dev),
    }
    out = []
    for b in range(N_THETA_BINS):
        g = _gen(100 + b, dev)
        u1 = torch.rand((n,), generator=g, device=dev)
        u2 = torch.rand((n, 2), generator=g, device=dev)
        bs = bsdf_mod.sample(params, _local_wi(b, n, dev), u1, u2,
                             types=(BSDF_ROUGHCONDUCTOR,))
        w_samp = bs["weight"].max(-1).values
        out.append(fit_directional_mixture(
            bs["wo"], torch.where(w_samp > 0, w_samp, 0.0), n_components,
            iters=25, seed=b))
    return tuple(torch.stack(x) for x in zip(*out))


def roughconductor_dmm(alpha: float, n_components: int = 4,
                       n_samples: int = 12000,
                       device: str | torch.device = "cuda"):
    """Incidence-conditioned DMMs of the GGX reflection lobe: one mixture
    per theta_i bin, fitted to sampled reflection directions for wi in the
    local xz-plane (the runtime rotates by wi's azimuth). Returns
    (w [NB, K], mu [NB, K, 3], cov [NB, K, 2, 2])."""
    return _roughconductor_dmm(alpha, n_components, n_samples,
                               str(resolve_device(device)))


@lru_cache(maxsize=32)
def _phong_lobe_dmm(exponent: float, n_components: int, n_samples: int,
                    device: str):
    dev = torch.device(device)
    u = torch.rand((n_samples, 2), generator=_gen(2, dev), device=dev)
    cos_a = u[:, 0] ** (1.0 / (exponent + 1.0))
    sin_a = torch.sqrt((1.0 - cos_a ** 2).clamp_min(0.0))
    phi = 2 * math.pi * u[:, 1]
    d = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi), cos_a],
                    -1)
    return fit_directional_mixture(d, torch.ones(n_samples, device=dev),
                                   n_components)


def phong_lobe_dmm(exponent: float, n_components: int = 4,
                   n_samples: int = 20000,
                   device: str | torch.device = "cuda"):
    """DMM of a power-cosine lobe around +z (rotated to reflect(wi) at
    render time)."""
    return _phong_lobe_dmm(exponent, n_components, n_samples,
                           str(resolve_device(device)))


def scene_bsdf_dmm(scene, bsdf_id: int, n_components: int = 4,
                   n_samples: int = 12000):
    """Incidence-conditioned DMMs fitted to the scene's BSDF row
    ``bsdf_id`` by sampling it (container and texture parameters resolved
    by gather_params at uv 0.5), one mixture per theta_i bin, delta lobes
    left out. Runs on the scene's device. Returns (w [NB, K],
    mu [NB, K, 3], cov [NB, K, 2, 2])."""
    dev = scene.bsdf_type.device
    types = tuple(sorted({int(t) for t in scene.bsdf_type.cpu().numpy()}))
    n = n_samples
    idx = torch.full((n,), int(bsdf_id), dtype=torch.int32, device=dev)
    uv = torch.full((n, 2), 0.5, device=dev)
    params = bsdf_mod.gather_params(scene, idx, uv, types=types)
    out = []
    for b in range(N_THETA_BINS):
        g = _gen(1000 + 17 * int(bsdf_id) + b, dev)
        u0 = torch.rand((n,), generator=g, device=dev)
        u1 = torch.rand((n,), generator=g, device=dev)
        u2 = torch.rand((n, 2), generator=g, device=dev)
        bs = bsdf_mod.sample_full(params, _local_wi(b, n, dev), u0, u1, u2,
                                  types=types)
        w_samp = bs["weight"].max(-1).values
        ok = (w_samp > 0) & ~bs["delta"]
        out.append(fit_directional_mixture(
            bs["wo"], torch.where(ok, w_samp, 0.0), n_components, iters=25,
            seed=int(bsdf_id)))
    return tuple(torch.stack(x) for x in zip(*out))


def build_learned_table(scene, n_components: int = 4,
                        device: str | torch.device = "cuda") -> dict:
    """Per-scene-BSDF learned mixtures in the LOCAL frame, fitted on
    ``device``: has [B], mode [B], weight [B, NB, Kb], mu_local
    [B, NB, Kb, 3], cov [B, NB, Kb, 2, 2]. Unconditioned models (diffuse,
    phong) replicate their single mixture across the bins. mode: 0 orients
    to the shading normal, 1 to reflect(wi), 2 is theta-binned and rotated
    by wi's azimuth."""
    from ..scene.scene import scene_to

    dev = resolve_device(device)
    btypes = scene.bsdf_type.cpu().numpy()
    exps = scene.bsdf_exponent.cpu().numpy()
    alphas = scene.bsdf_alpha.cpu().numpy()
    b, kb, nb = len(btypes), n_components, N_THETA_BINS
    has = torch.zeros(b, dtype=torch.bool, device=dev)
    mode = torch.zeros(b, dtype=torch.int32, device=dev)
    weight = torch.zeros((b, nb, kb), device=dev)
    mu = torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(b, nb, kb, 1)
    cov = (torch.eye(2, device=dev) * 0.5).repeat(b, nb, kb, 1, 1)
    dscene = None
    for i in range(b):
        t = int(btypes[i])
        if t == BSDF_DIFFUSE:
            fit, m = cosine_dmm(kb, device=dev), 0
        elif t == BSDF_PHONG:
            fit, m = phong_lobe_dmm(float(round(float(exps[i]), 1)), kb,
                                    device=dev), 1
        elif t == BSDF_ROUGHCONDUCTOR:
            fit, m = roughconductor_dmm(float(round(float(alphas[i]), 3)),
                                        kb, device=dev), 2
        elif t in _GENERIC_HOOKED:
            if dscene is None:
                dscene = scene_to(scene, dev)
            fit, m = scene_bsdf_dmm(dscene, i, kb), 2
        else:
            continue
        has[i], mode[i] = True, m
        weight[i], mu[i], cov[i] = fit  # broadcast over the bins
    return {"has": has, "mode": mode, "weight": weight, "mu_local": mu,
            "cov": cov}


def to_world_conditional(table: dict, bsdf_idx, s_ax, t_ax, n_ax, wi_local):
    """Gather the learned mixtures of ``bsdf_idx`` and rotate them into the
    world frame as a Conditional. Returns (conditional, has [...])."""
    idx = bsdf_idx.long()
    has = table["has"][idx]
    mode = table["mode"][idx]
    cos_i = wi_local[..., 2].abs().clamp(0.0, 1.0)
    theta = torch.arccos(cos_i)
    tbin = (theta / (math.pi / 2) * N_THETA_BINS).to(torch.int64).clamp(
        0, N_THETA_BINS - 1)
    tbin = torch.where(mode == 2, tbin, 0)
    w = table["weight"][idx, tbin]
    mu_l = table["mu_local"][idx, tbin]
    cov = table["cov"][idx, tbin]
    # Mode 2 was fitted with wi in the xz-plane: rotate about local z by
    # wi's azimuth.
    phi = torch.atan2(wi_local[..., 1], wi_local[..., 0])
    cphi, sphi = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
    mu_rot = torch.stack([cphi * mu_l[..., 0] - sphi * mu_l[..., 1],
                          sphi * mu_l[..., 0] + cphi * mu_l[..., 1],
                          mu_l[..., 2]], -1)
    mu_l = torch.where((mode == 2)[..., None, None], mu_rot, mu_l)
    # The local target of +z: the normal (modes 0, 2) or reflect(wi).
    z_loc = torch.where((mode == 1)[..., None], reflect(wi_local),
                        torch.tensor([0.0, 0.0, 1.0], device=wi_local.device))
    s2, t2 = coordinate_system(z_loc)
    mu_orient = mu_l[..., 0:1] * s2[..., None, :] \
        + mu_l[..., 1:2] * t2[..., None, :] \
        + mu_l[..., 2:3] * z_loc[..., None, :]
    mu_world = to_world(s_ax[..., None, :], t_ax[..., None, :],
                        n_ax[..., None, :], mu_orient)
    chol, _ = mix.chol2x2(cov)
    inv_det = 1.0 / (chol[..., 0, 0] * chol[..., 1, 1]).clamp_min(1e-12)
    return mix.Conditional(
        weight=torch.where(has[..., None], w, 0.0), mu_dir=mu_world,
        rot=tg.make_rotation(mu_world), chol=chol,
        inv_chol=mix.inv_lower2x2(chol), inv_det=inv_det, valid=has,
    ), has

