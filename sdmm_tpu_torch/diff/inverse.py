"""Differentiable rendering and inverse-rendering optimisation on torch
autograd (port of sdmm_tpu/diff/inverse.py).

The wave tracer ``render/volpath.trace_wave`` is eager PyTorch, so pixel
values are differentiable in scene parameters (BSDF albedo and roughness,
emitter radiance) given as tensors that require a gradient. The GGX/VNDF
warp is a differentiable function of the roughness, Russian roulette's
probability is detached, and the intersection kernels' hits are re-attached
to autograd by ``render/intersect.intersect``. An integer seed (or a tuple
of them) takes the place of the reference's ``PRNGKey``: pass ``i`` of
``spp`` draws from a generator seeded (seed, i). ``torch.optim.Adam``,
whose defaults are optax's, takes the place of ``optax.adam``.

With a ``parallel/mesh.Mesh``, ``make_render_fn_multi`` renders this rank's
contiguous block of the pixels, drawing each pass's uniforms as one process
would for those rows (``core/draws.WaveBlock``); ``pixel_mean`` and
``all_reduce_grads`` turn per-rank partial losses into the global loss's
gradient on every rank.
"""

from __future__ import annotations

import torch

from ..core import draws
from ..core.device import resolve_device
from ..render.volpath import trace_wave
from ..scene.scene import scene_to
from ..scene.sensor import pixel_rays

ALPHA_RANGE = (1e-3, 1.0)  # optimize_parameters keeps bsdf_alpha in it


def _seed_parts(seed) -> tuple:
    return tuple(seed) if isinstance(seed, tuple) else (seed,)


def _render_passes(scene, cfg, pix, spp: int, nee: bool, block=None):
    """The mean radiance of ``spp`` passes over the pixels ``pix``:
    fn(scene with the parameters substituted, seed) → [len(pix), 3].
    ``block``: (first, total) of ``pix`` in the whole pixel array."""
    dev = pix.device

    def render(s, seed):
        acc = torch.zeros((pix.shape[0], 3), device=dev)
        for i in range(spp):
            gen = draws.seeded(dev, *_seed_parts(seed), i)
            g = gen if block is None else draws.WaveBlock(gen, *block)
            ro, rd = pixel_rays(s, pix, g, cfg.width, cfg.height,
                                cfg.fov_axis)
            acc = acc + trace_wave(
                s, g, ro, rd, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                nee=nee, bsdf_types=cfg.bsdf_types or None)
        return acc / spp

    return render


def make_render_fn(scene, cfg, pixel_idx, param_name: str, spp: int = 4,
                   nee: bool = True, device: str | torch.device = "cuda"):
    """fn(param, seed) → per-pixel radiance [N, 3], differentiable in
    ``param``, the SceneData field ``param_name`` (e.g. 'bsdf_albedo',
    'bsdf_alpha', 'emitter_radiance')."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    passes = _render_passes(scene, cfg, torch.as_tensor(pixel_idx, device=dev),
                            spp, nee)

    def render(param, seed):
        return passes(scene._replace(**{param_name: param}), seed)

    return render


def pixel_gradients(scene, cfg, pixel_idx, param_name: str, seed,
                    spp: int = 4, device: str | torch.device = "cuda"):
    """Gradient of the mean pixel value w.r.t. a scene parameter array."""
    dev = resolve_device(device)
    render = make_render_fn(scene, cfg, pixel_idx, param_name, spp,
                            device=dev)
    param = getattr(scene, param_name).detach().to(dev).requires_grad_(True)
    render(param, seed).mean().backward()
    return param.grad


def make_render_fn_multi(scene, cfg, pixel_idx, spp: int = 4,
                         nee: bool = True, mesh=None,
                         device: str | torch.device = "cuda"):
    """fn(params dict, seed) → per-pixel radiance, differentiable in every
    entry of ``params`` (SceneData field names). With ``mesh`` (which then
    names the device) the result is this rank's block of the pixels
    (``mesh.block``: their count must split evenly over the ranks), drawn
    as one process draws those rows."""
    dev = resolve_device(device if mesh is None else mesh.device)
    scene = scene_to(scene, dev)
    pix = torch.as_tensor(pixel_idx, device=dev)
    block = None
    if mesh is not None:
        blk = mesh.block(pix.shape[0])
        block = (blk.start, pix.shape[0])
        pix = pix[blk]
    passes = _render_passes(scene, cfg, pix, spp, nee, block)

    def render(params, seed):
        return passes(scene._replace(**params), seed)

    return render


def pixel_mean(img: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of the whole image from this rank's block ``img``: its sum
    over every rank's element count, so that the ranks' values (and, after
    ``all_reduce_grads``, their gradients) sum to the mean's."""
    return img.sum() / (img.numel() * (1 if mesh is None
                                       else mesh.world_size))


def all_reduce_grads(params, mesh) -> None:
    """Sum the gradients of ``params`` (tensors) over the mesh's ranks."""
    for p in params:
        if p.grad is not None:
            mesh.all_reduce(p.grad)


def clamp_roughness(params: dict) -> None:
    """Keep ``bsdf_alpha`` in ALPHA_RANGE, in place."""
    if "bsdf_alpha" in params:
        with torch.no_grad():
            params["bsdf_alpha"].clamp_(*ALPHA_RANGE)


def _fit(render, params: dict, target, steps, lr, seed, resample, clamp):
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        img = render(params, (seed, i) if resample else seed)
        loss = ((img - target) ** 2).mean()
        loss.backward()
        opt.step()
        if clamp:
            clamp_roughness(params)
        losses.append(float(loss.detach()))
    return losses


def _pixels_and_target(cfg, target_image, pixel_idx, dev):
    if pixel_idx is None:
        pixel_idx = torch.arange(cfg.width * cfg.height, device=dev)
    pix = torch.as_tensor(pixel_idx, device=dev)
    target = torch.as_tensor(target_image, dtype=torch.float32,
                             device=dev).reshape(-1, 3)[pix]
    return pix, target


def optimize_parameter(scene, cfg, target_image, param_name: str, init_value,
                       steps: int = 60, lr: float = 5e-2, spp: int = 4,
                       seed: int = 0, pixel_idx=None, resample: bool = False,
                       device: str | torch.device = "cuda"):
    """Adam inverse rendering: fit one scene parameter to a target image.

    With ``resample=False`` every step reuses the paths of ``seed`` (a
    correlated estimator: the loss is deterministic and has an exact zero
    at the true parameters when the target was rendered with that seed);
    ``resample=True`` draws step i's paths from (seed, i). Returns
    (optimized value, loss history)."""
    dev = resolve_device(device)
    pix, target = _pixels_and_target(cfg, target_image, pixel_idx, dev)
    render = make_render_fn(scene, cfg, pix, param_name, spp, device=dev)
    params = {param_name: torch.as_tensor(init_value, device=dev).detach()
              .clone().requires_grad_(True)}
    losses = _fit(lambda p, s: render(p[param_name], s), params, target,
                  steps, lr, seed, resample, clamp=False)
    return params[param_name].detach(), losses


def optimize_parameters(scene, cfg, target_image, param_names, init_values,
                        steps: int = 60, lr: float = 5e-2, spp: int = 4,
                        seed: int = 0, pixel_idx=None, resample: bool = False,
                        device: str | torch.device = "cuda"):
    """Joint Adam inverse rendering over several scene parameters (e.g.
    albedo and GGX roughness), ``bsdf_alpha`` clamped to ALPHA_RANGE after
    every step. ``param_names`` documents the optimized fields; the keys of
    ``init_values`` drive the update. ``resample`` as in
    ``optimize_parameter``. Returns (dict of optimized values, loss
    history)."""
    dev = resolve_device(device)
    pix, target = _pixels_and_target(cfg, target_image, pixel_idx, dev)
    render = make_render_fn_multi(scene, cfg, pix, spp=spp, device=dev)
    params = {k: torch.as_tensor(v, device=dev).detach().clone()
              .requires_grad_(True) for k, v in init_values.items()}
    losses = _fit(render, params, target, steps, lr, seed, resample,
                  clamp=True)
    return {k: v.detach() for k, v in params.items()}, losses
