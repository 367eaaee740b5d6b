"""The classic integrators (port of sdmm_tpu/render/classic.py): direct, ao,
field, multichannel, adaptive and motion.

``trace_direct``, ``trace_ao``, ``trace_field`` and ``trace_motion`` trace a
flat wave of rays and return its radiance [N, 3]; the wave renderer
``renderer.render`` takes them as its ``trace_fn``. ``render_multichannel``
renders several fields in one call each, ``render_adaptive`` renders in
passes and stops each pixel on its relative standard error. The sampling
functions take their uniforms (``rand``) or draw them from a
``torch.Generator``; every function runs on the card unless the caller
passes ``device="cpu"``, and moves the scene and rays there.
"""

from __future__ import annotations

import torch

from ..bsdf import bsdf as bsdf_mod
from ..core import warp
from ..core.device import resolve_device
from ..core.frame import coordinate_system, to_local, to_world
from ..scene import emitters
from ..scene.scene import scene_to
from . import intersect as isect
from .volpath import RAY_EPS, mi_weight, shading_frame

FIELDS = ("position", "relPosition", "distance", "geoNormal", "shNormal",
          "uv", "albedo", "shapeIndex", "primIndex")


def _on(device, scene, *rays):
    dev = resolve_device(device)
    return (dev, scene_to(scene, dev)) + tuple(r.to(dev) for r in rays)


def _uniforms(rand, generator, n, k, dev):
    """``rand`` [N, k] as given, else drawn from ``generator``."""
    if rand is None:
        return torch.rand((n, k), generator=generator, device=dev)
    if tuple(rand.shape) != (n, k):
        raise ValueError(f"rand must be [{n}, {k}], got {tuple(rand.shape)}")
    return rand.to(dev)


def _spawn(it, d):
    """A ray origin off the hit on the side of ``d``."""
    return it["p"] + it["ng"] * torch.where(
        (it["ng"] * d).sum(-1) > 0, RAY_EPS, -RAY_EPS)[:, None]


def trace_direct(scene, generator, ro, rd, emitter_samples: int = 1,
                 bsdf_samples: int = 1, bsdf_types: tuple | None = None,
                 has_bump: bool = False, rand: torch.Tensor | None = None,
                 device="cuda") -> torch.Tensor:
    """Direct illumination with multi-sample MIS: ``emitter_samples`` light
    samples and ``bsdf_samples`` BSDF samples per hit, each MIS-weighted
    with the fractional weights 1/m and 1/n in the power heuristic; the
    visible emitters and the environment are added unweighted. ``rand``:
    [N, 3m + 4n] uniforms (u1, u2 of each light sample, then u0, u1, u2 of
    each BSDF sample)."""
    dev, scene, ro, rd = _on(device, scene, ro, rd)
    n = ro.shape[0]
    rnd = _uniforms(rand, generator, n,
                    3 * emitter_samples + 4 * bsdf_samples, dev)
    pdf_over_area = emitters.tri_pdf_over_area(scene)
    hit = isect.intersect(scene, ro, rd)
    it = isect.surface_interaction(scene, ro, rd, hit)
    if has_bump:
        it["ns"] = isect.apply_bumpmap(scene, it)
    valid = hit["valid"][:, None]
    li = torch.where(valid, emitters.eval_emitter(scene, it, -rd), 0.0)
    li = li + torch.where(~valid, emitters.env_eval(scene, rd), 0.0)

    params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                    types=bsdf_types)
    s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
    wi_local = to_local(s_ax, t_ax, n_ax, -rd)
    on_surface = hit["valid"] & bsdf_mod.has_smooth(params)
    w_lum = 1.0 / max(emitter_samples, 1)
    w_bsdf = 1.0 / max(bsdf_samples, 1)

    for i in range(emitter_samples):
        u = rnd[:, 3 * i:3 * i + 3]
        ls = emitters.sample_direct(scene, it["p"], u[:, 0], u[:, 1:3])
        wo_l = to_local(s_ax, t_ax, n_ax, ls["d"])
        f, pdf_b = bsdf_mod.eval_pdf_full(params, wi_local, wo_l,
                                          types=bsdf_types)
        cand = on_surface & ls["valid"] & (ls["pdf"] > 0.0)
        occ = isect.occluded(scene, _spawn(it, ls["d"]), ls["d"],
                             ls["dist"] * (1.0 - 1e-3))
        w = torch.where(ls["delta"], 1.0,
                        mi_weight(ls["pdf"] * w_lum, pdf_b * w_bsdf))
        contrib = f * ls["radiance"] * (
            w / ls["pdf"].clamp_min(1e-20))[:, None]
        li = li + torch.where((cand & ~occ)[:, None], contrib * w_lum, 0.0)

    env_mis = scene.env_pdf.shape[0] > 1
    base = 3 * emitter_samples
    for i in range(bsdf_samples):
        u = rnd[:, base + 4 * i:base + 4 * i + 4]
        bs = bsdf_mod.sample_full(params, wi_local, u[:, 0], u[:, 1],
                                  u[:, 2:4], types=bsdf_types)
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        good = hit["valid"] & (bs["weight"] > 0.0).any(-1)
        o2 = _spawn(it, wo_world)
        hit2 = isect.intersect(scene, o2, wo_world)
        it2 = isect.surface_interaction(scene, o2, wo_world, hit2)
        le2 = emitters.eval_emitter(scene, it2, -wo_world)
        pdf_nee = emitters.pdf_direct_hit(scene, pdf_over_area, hit2["tri"],
                                          wo_world, hit2["t"])
        w = torch.where(bs["delta"], 1.0,
                        mi_weight(bs["pdf"] * w_bsdf, pdf_nee * w_lum))
        li = li + torch.where((good & hit2["valid"])[:, None],
                              bs["weight"] * le2 * w[:, None] * w_bsdf, 0.0)
        if env_mis:
            pdf_env = emitters.pdf_env_dir(scene, wo_world) \
                * scene.env_select_prob
            w_env = torch.where(bs["delta"], 1.0,
                                mi_weight(bs["pdf"] * w_bsdf,
                                          pdf_env * w_lum))
        else:
            w_env = torch.ones(n, device=dev)
        li = li + torch.where(
            (good & ~hit2["valid"])[:, None],
            bs["weight"] * emitters.env_eval(scene, wo_world)
            * w_env[:, None] * w_bsdf, 0.0)
    return li


def trace_ao(scene, generator, ro, rd, ray_length: float = -1.0,
             shading_samples: int = 1, rand: torch.Tensor | None = None,
             device="cuda") -> torch.Tensor:
    """Ambient occlusion: the share of cosine-sampled rays about the shading
    normal (turned to the viewer) that reach ``ray_length`` unoccluded (a
    negative length is half the scene's bounding-sphere radius); 0 on a
    miss. ``rand``: [N, 2 · shading_samples] uniforms."""
    dev, scene, ro, rd = _on(device, scene, ro, rd)
    n = ro.shape[0]
    rnd = _uniforms(rand, generator, n, 2 * shading_samples, dev)
    if ray_length < 0:
        radius = 0.5 * torch.linalg.vector_norm(
            scene.aabb_hi - scene.aabb_lo) * 0.5
    else:
        radius = torch.tensor(float(ray_length), device=dev)
    hit = isect.intersect(scene, ro, rd)
    it = isect.surface_interaction(scene, ro, rd, hit)
    cos_i = (it["ns"] * -rd).sum(-1)
    nrm = torch.where(cos_i[:, None] < 0, -it["ns"], it["ns"])
    s_ax, t_ax = coordinate_system(nrm)
    o = it["p"] + nrm * RAY_EPS
    t_max = radius.expand(n).contiguous()
    acc = torch.zeros(n, device=dev)
    for i in range(shading_samples):
        d = to_world(s_ax, t_ax, nrm, warp.square_to_cosine_hemisphere(
            rnd[:, 2 * i:2 * i + 2]))
        occ = isect.occluded(scene, o, d, t_max)
        acc = acc + (hit["valid"] & ~occ).float()
    return (acc / shading_samples)[:, None].expand(n, 3)


def trace_field(scene, generator, ro, rd, field: str = "shNormal",
                bsdf_types: tuple | None = None,
                device="cuda") -> torch.Tensor:
    """One field of the first hit (0 on a miss), no Monte Carlo: the
    position, the camera-space position, the distance, the geometric or
    shading normal, the uv, the albedo, or the triangle id (shapeIndex and
    primIndex alike, the scene being flat triangles)."""
    if field not in FIELDS:
        raise ValueError(f"unknown field {field!r} (one of {FIELDS})")
    del generator
    dev, scene, ro, rd = _on(device, scene, ro, rd)
    n = ro.shape[0]
    hit = isect.intersect(scene, ro, rd)
    it = isect.surface_interaction(scene, ro, rd, hit)
    if field == "position":
        val = it["p"]
    elif field == "relPosition":
        val = (it["p"] - scene.cam_to_world[:3, 3]) @ scene.cam_to_world[:3,
                                                                         :3]
    elif field == "distance":
        val = hit["t"][:, None].expand(n, 3)
    elif field == "geoNormal":
        val = it["ng"]
    elif field == "shNormal":
        val = it["ns"]
    elif field == "uv":
        val = torch.cat([it["uv"][:, :2], torch.zeros((n, 1), device=dev)],
                        -1)
    elif field == "albedo":
        val = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                     types=bsdf_types)["albedo"]
    else:  # shapeIndex, primIndex
        val = hit["tri"].float()[:, None].expand(n, 3)
    return torch.where(hit["valid"][:, None], val, 0.0)


def render_multichannel(scene, cfg, fields=("position", "shNormal", "albedo",
                                            "distance"), spp: int = 4,
                        seed: int = 1234, device="cuda") -> dict:
    """Each field of ``fields`` rendered by the wave renderer; returns
    {name: [H, W, 3]} as numpy."""
    from .renderer import render

    dev = resolve_device(device)
    out = {}
    for f in fields:
        def trace(scene_, gen, ro, rd, _f=f):
            return trace_field(scene_, gen, ro, rd, field=_f,
                               bsdf_types=cfg.bsdf_types or None, device=dev)

        out[f] = render(scene, cfg, spp=spp, seed=seed, trace_fn=trace,
                        device=dev)["image"]
    return out


def render_adaptive(scene, cfg, max_spp: int = 64, seed: int = 1234,
                    pass_spp: int = 4, max_error: float = 0.05,
                    nee: bool = True, rays_per_wave: int = 1 << 18,
                    device="cuda") -> dict:
    """Path tracing (``volpath.trace_wave``) in passes of ``pass_spp``
    samples: after each pass, the pixels whose relative standard error of
    the mean (over the channel mean, with the mean floored at 1e-3) is at
    most ``max_error`` stop, up to ``max_spp``. Every active pixel takes
    exactly ``pass_spp`` samples a pass. Returns dict(image [H, W, 3],
    spp_map [H, W], sqr [H, W, 3] the sum of squared samples) as numpy."""
    from ..scene.sensor import generate_rays
    from .volpath import trace_wave

    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    gen = torch.Generator(device=dev).manual_seed(seed)
    img = torch.zeros((n_pix, 3), dtype=torch.float64, device=dev)
    sqr = torch.zeros_like(img)
    cnt = torch.zeros(n_pix, dtype=torch.float64, device=dev)
    active = torch.arange(n_pix, device=dev)
    spp_done = 0
    while spp_done < max_spp and active.numel():
        for _ in range(pass_spp):
            for start in range(0, active.numel(), rays_per_wave):
                idx = active[start:start + rays_per_wave]
                u = torch.rand((idx.numel(), 2), generator=gen, device=dev)
                px = (idx % w).float() + u[:, 0]
                py = (idx // w).float() + u[:, 1]
                ro, rd = generate_rays(scene, torch.stack([px, py], -1), w,
                                       h, cfg.fov_axis)
                li = torch.nan_to_num(trace_wave(
                    scene, gen, ro, rd, max_depth=cfg.max_depth,
                    rr_depth=cfg.rr_depth, nee=nee,
                    bsdf_types=cfg.bsdf_types or None,
                    has_medium=cfg.has_medium, has_hetero=cfg.has_hetero,
                    has_bump=cfg.has_bump)).double()
                img.index_add_(0, idx, li)
                sqr.index_add_(0, idx, li * li)
                cnt.index_add_(0, idx, torch.ones_like(li[:, 0]))
        spp_done += pass_spp
        n = cnt.clamp_min(1.0)
        mean = img / n[:, None]
        var = (sqr / n[:, None] - mean ** 2).clamp_min(0.0)
        sem = torch.sqrt(var.mean(-1) / n)
        rel = sem / mean.mean(-1).clamp_min(1e-3)
        active = torch.nonzero(rel > max_error)[:, 0]
    image = img / cnt.clamp_min(1.0)[:, None]
    return {"image": image.reshape(h, w, 3).cpu().numpy(),
            "spp_map": cnt.reshape(h, w).cpu().numpy(),
            "sqr": sqr.reshape(h, w, 3).cpu().numpy()}


def _project(scene, p, width: int, height: int, fov_axis: str = "x"):
    """World points → fractional pixel coordinates through the perspective
    sensor (the inverse of ``sensor.generate_rays``), and whether each
    lies in front of the camera."""
    v = (p - scene.cam_to_world[:3, 3]) @ scene.cam_to_world[:3, :3]
    z = v[..., 2].clamp_min(1e-6)
    aspect = width / height
    tan_half = scene.cam_tan_half_fov
    if fov_axis == "x":
        tx, ty = tan_half, tan_half / aspect
    else:
        ty, tx = tan_half, tan_half * aspect
    px = (1.0 - v[..., 0] / (z * tx)) * 0.5 * width
    py = (1.0 - v[..., 1] / (z * ty)) * 0.5 * height
    return px, py, v[..., 2] > 0


def trace_motion(scene, generator, ro, rd, width: int, height: int,
                 time: float = 1.0, fov_axis: str = "x",
                 device="cuda") -> torch.Tensor:
    """Screen-space motion vectors (dx, dy, 0) of the first hit: the hit
    point moved to ``time`` by its shape's keyframes, p1 = M(t) · M0⁻¹ ·
    p0 with M(t) the linear blend (1 − t)·M0 + t·M1 of the two keyframe
    matrices (the geometry is baked at M0), both points projected through
    the sensor. Each shape's M(t) · M0⁻¹ is formed once a call and
    gathered by the lanes; a shape whose M0 is singular does not move."""
    del generator
    dev, scene, ro, rd = _on(device, scene, ro, rd)
    hit = isect.intersect(scene, ro, rd)
    it = isect.surface_interaction(scene, ro, rd, hit)
    p0 = it["p"]
    m0_inv, info = torch.linalg.inv_ex(scene.mot_m0)
    m_t = scene.mot_m0 * (1.0 - time) + scene.mot_m1 * time
    adv = m_t @ m0_inv  # [Ms, 4, 4]
    mot = scene.tri_mot[it["tri"]].long()
    mi = mot.clamp_min(0)
    has_mot = hit["valid"] & (mot >= 0) & (info[mi] == 0)
    a = adv[mi]
    p1 = (a[:, :3, :3] @ p0[:, :, None])[..., 0] + a[:, :3, 3]
    p1 = torch.where(has_mot[:, None], p1, p0)
    x0, y0, ok0 = _project(scene, p0, width, height, fov_axis)
    x1, y1, ok1 = _project(scene, p1, width, height, fov_axis)
    ok = hit["valid"] & ok0 & ok1
    dx = torch.where(ok, x1 - x0, 0.0)
    dy = torch.where(ok, y1 - y0, 0.0)
    return torch.stack([dx, dy, torch.zeros_like(dx)], -1)

