"""The wave renderer (port of sdmm_tpu/render/renderer.py ``render``): the
image's samples, pixel-major within each sample index, are split into waves
of camera rays, each wave traced by ``volpath.trace_wave`` (or the caller's
``trace_fn``, such as the classic integrators of ``render/classic.py``) and
splatted into the film with the chosen reconstruction filter. Every pixel gets
exactly ``spp`` samples (the reference pads its last wave with a second
sample of the first pixels). It renders everything the lane pools do not
carry: participating media, and the samplers and rfilters other than
independent and box.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.sampler import camera_jitter, pixel_rotations
from ..scene.scene import scene_to
from ..scene.sensor import generate_rays
from . import film as film_mod
from .rfilters import splat_filtered
from .volpath import trace_wave


def render(scene, cfg, spp: int = 16, seed: int = 1234,
           rays_per_wave: int = 1 << 18, nee: bool = True,
           sampler: str = "independent", rfilter: str = "box",
           trace_fn=None, device: str | torch.device = "cuda") -> dict:
    """Render ``scene`` at ``cfg``'s size and depth on ``device``. sampler:
    independent | stratified | halton | sobol (the camera dimension);
    rfilter: box | tent | gaussian | mitchell | catmullrom | lanczos;
    ``trace_fn(scene, generator, ro, rd) -> [N, 3]`` replaces the path
    tracer (``volpath.trace_wave`` with ``nee``). A scene with subsurface
    instances is baked first unless ``cfg.sss_baked``.

    Returns dict(image [H, W, 3] (the mean), sqr [H, W, 3], weight [H, W],
    raw [H, W, 3] (the sum), as numpy; n_vertices and steps 0, pool
    "scan")."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    if cfg.has_sss and not cfg.sss_baked:
        from .subsurface import bake_subsurface

        scene = bake_subsurface(scene, cfg, seed=seed, device=dev)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    gen = torch.Generator(device=dev).manual_seed(seed)
    rotations = pixel_rotations(
        torch.Generator(device=dev).manual_seed(seed + 77), n_pix, dev)
    image = torch.zeros((n_pix, 3), device=dev)
    sqr = torch.zeros((n_pix, 3), device=dev)
    weight = torch.zeros(n_pix, device=dev)
    total = n_pix * spp
    for start in range(0, total, rays_per_wave):
        # Sample g of the render is pixel g % n_pix, its sample g // n_pix:
        # a wave of a small image holds several samples of every pixel.
        g = torch.arange(start, min(start + rays_per_wave, total),
                         device=dev)
        idx = g % n_pix
        u = camera_jitter(sampler, rotations, idx, g // n_pix, spp, gen)
        px = (idx % w).float() + u[:, 0]
        py = (idx // w).float() + u[:, 1]
        ro, rd = generate_rays(scene, torch.stack([px, py], -1), w, h,
                               cfg.fov_axis)
        if trace_fn is not None:
            li = trace_fn(scene, gen, ro, rd)
        else:
            li = trace_wave(scene, gen, ro, rd, max_depth=cfg.max_depth,
                            rr_depth=cfg.rr_depth, nee=nee,
                            bsdf_types=cfg.bsdf_types or None,
                            has_medium=cfg.has_medium,
                            has_hetero=cfg.has_hetero, has_bump=cfg.has_bump,
                            has_sss=cfg.has_sss)
        li = torch.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)
        if rfilter == "gaussian":
            image, sqr, weight = film_mod.splat_gaussian(
                image, sqr, weight, idx, li, px, py, w, h)
        else:
            image, sqr, weight = splat_filtered(
                image, sqr, weight, idx, li, px, py, w, h, rfilter)

    def host(x, *shape):
        return x.reshape(*shape).cpu().numpy()

    return {
        "image": host(film_mod.develop(image, weight), h, w, 3),
        "sqr": host(sqr, h, w, 3),
        "weight": host(weight, h, w),
        "raw": host(image, h, w, 3),
        "n_vertices": 0,
        "steps": 0,
        "pool": "scan",
    }
