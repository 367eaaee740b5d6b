"""Photon mapping: the photon mapper, PPM and SPPM (port of
sdmm_tpu/render/photonmap.py).

The photon map is a sorted uniform grid whose cell is the gather radius:
photons are keyed by cell id, sorted once (a random permutation, then a
stable sort, so that a cell's photons come in random order), and a query
takes each of the 27 neighbour cells' range by two ``searchsorted`` calls.
``gather_radiance`` reads at most ``k_per_cell`` photons a cell, as one
[k_per_cell · N]-lane block per cell (the reference scans them one by one),
and scales a cell's sum by count / min(count, k_per_cell).

The estimator splits as the reference's photon mapper with direct sampling:
the camera pass adds the emission seen through delta chains and NEE at the
gather point, and the photon density estimate covers indirect light only
(photons are deposited from the second light-path vertex on). Photons start
on area emitters and delta lights; environment maps and sun/sky emit none,
as in the reference. Sampling functions take their uniforms (``rand``) or
draw them from a ``torch.Generator``; every entry point runs on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bsdf import bsdf as bsdf_mod
from ..core.device import resolve_device
from ..core.frame import to_local, to_world
from ..scene import emitters
from ..scene.scene import scene_to
from . import intersect as isect
from .ptracer import sample_emission, uniforms
from .volpath import RAY_EPS, shading_frame, spawn


def scene_diagonal(scene) -> float:
    """The length of the scene's bounding-box diagonal, as the reference
    takes it (a float32 norm, then a Python float)."""
    return float(np.linalg.norm((scene.aabb_hi - scene.aabb_lo).cpu()
                                .numpy()))


def trace_photons(scene, generator, n_paths: int, max_depth: int = 8,
                  bsdf_types: tuple | None = None, rand: dict | None = None,
                  device="cuda") -> dict:
    """A light random walk that deposits a photon at every smooth-surface
    vertex from depth 1 on (direct light is the camera pass's NEE), with
    Russian roulette from depth 3. ``rand``: {"emit": [n, 5] (see
    ptracer.sample_emission), "walk": [max_depth, n, 5] (u0, u1, u2 of the
    BSDF sample, then the roulette's)}. Returns dict of [max_depth · n]
    tensors, depth-major: p, wi (unit, back along the incoming segment), n,
    power [., 3], valid."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    n = n_paths
    u = uniforms(rand, generator, {"emit": (n, 5),
                                   "walk": (max_depth, n, 5)}, dev)
    em = sample_emission(scene, n, rand=u["emit"], device=dev)
    ro = em["p"] + em["n"] * RAY_EPS
    rd, beta, active = em["d"], em["beta"], em["valid"]
    out = {"p": [], "wi": [], "n": [], "power": [], "valid": []}
    for depth in range(max_depth):
        w = u["walk"][depth]
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        active = active & hit["valid"]
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        out["p"].append(it["p"])
        out["wi"].append(-rd)
        out["n"].append(it["ns"])
        out["power"].append(beta)
        out["valid"].append(active & bsdf_mod.has_smooth(params)
                            & (depth >= 1))
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        bs = bsdf_mod.sample_full(params, wi_local, w[:, 0], w[:, 1],
                                  w[:, 2:4], types=bsdf_types)
        rd_n = to_world(s_ax, t_ax, n_ax, bs["wo"])
        beta = beta * bs["weight"]
        active = active & (bs["weight"] > 0.0).any(-1)
        # Roulette keeps the photons' powers bounded.
        if depth >= 3:
            q = bs["weight"].amax(-1).clamp(0.05, 0.95)
            active = active & ~(w[:, 4] >= q)
            beta = torch.where(active[:, None],
                               beta / q.clamp_min(1e-6)[:, None], beta)
        ro = spawn(it["p"], it["ng"], rd_n)
        rd = rd_n
    return {k: torch.cat(v) for k, v in out.items()}


def cell_id(p, lo, inv_cell, dims):
    """The grid cell of points p [..., 3] (int32)."""
    ijk = torch.minimum(((p - lo) * inv_cell).to(torch.int32).clamp_min(0),
                        dims - 1)
    return ijk[..., 0] + dims[0] * (ijk[..., 1] + dims[1] * ijk[..., 2])


def build_photon_grid(scene, photons: dict, radius: float,
                      generator: torch.Generator | None = None,
                      perm: torch.Tensor | None = None) -> dict:
    """Sort the photons by the cell of a uniform grid of cell size
    ``radius`` over the scene's box grown by it; invalid photons take a
    sentinel cell past every real one. The photons are first permuted by
    ``perm`` (default torch.randperm from ``generator``, itself seeded 0 by
    default), then stably sorted. Returns dict(order, cids (int32, sorted),
    dims, lo, inv_cell)."""
    p = photons["p"]
    dev = p.device
    lo = scene.aabb_lo.to(dev) - radius
    hi = scene.aabb_hi.to(dev) + radius
    inv_cell = 1.0 / radius
    dims = torch.ceil((hi - lo) * inv_cell).to(torch.int32).clamp_min(1)
    cid = cell_id(p, lo, inv_cell, dims)
    sentinel = dims[0] * dims[1] * dims[2] + 1
    cid = torch.where(photons["valid"], cid, sentinel)
    if perm is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        perm = torch.randperm(cid.shape[0], generator=generator, device=dev)
    perm = perm.to(dev).long()
    order = perm[torch.argsort(cid[perm], stable=True)]
    return {"order": order, "cids": cid[order].contiguous(), "dims": dims,
            "lo": lo, "inv_cell": inv_cell}


def gather_radiance(scene, photons: dict, grid: dict, p, wi_local, frame,
                    params: dict, r2, bsdf_types: tuple | None = None,
                    k_per_cell: int = 16) -> torch.Tensor:
    """The photon density estimate Σ f·Φ / (π r²) at points p [N, 3] with
    the shading frame ``frame``, the outgoing direction ``wi_local`` and
    the BSDF ``params`` there. Each of the 27 neighbour cells gives at most
    ``k_per_cell`` photons (its first ones in the grid's random order),
    filtered by distance and by the normal (> 0.7), each f divided by its
    cosine; a cell's sum is scaled by count / min(count, k_per_cell)."""
    del scene
    s_ax, t_ax, n_ax = frame
    n = p.shape[0]
    dev = p.device
    k = k_per_cell
    dims, lo, inv_cell = grid["dims"], grid["lo"], grid["inv_cell"]
    order, cids = grid["order"], grid["cids"]
    n_ph = order.shape[0]
    ijk = torch.minimum(((p - lo) * inv_cell).to(torch.int32).clamp_min(0),
                        dims - 1)
    r2n = r2.expand(n) if torch.is_tensor(r2) else torch.full(
        (n,), float(r2), device=dev)
    # Every lane's inputs, once for each of its k candidates.
    params_k = bsdf_mod.repeat_params(params, k)
    wi_k = wi_local.repeat(k, 1)
    s_k, t_k, n_k = s_ax.repeat(k, 1), t_ax.repeat(k, 1), n_ax.repeat(k, 1)
    ks = torch.arange(k, device=dev, dtype=torch.int32)[:, None]
    acc = torch.zeros((n, 3), device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                q = ijk + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                       device=dev)
                in_grid = ((q >= 0) & (q < dims)).all(-1)
                qc = torch.minimum(q.clamp_min(0), dims - 1)
                cid = (qc[:, 0] + dims[0] * (qc[:, 1] + dims[1] * qc[:, 2])
                       ).contiguous()
                start = torch.searchsorted(cids, cid).to(torch.int32)
                end = torch.searchsorted(cids, cid, right=True).to(
                    torch.int32)
                count = end - start
                idx = order[(start[None] + ks).clamp(0, n_ph - 1).long()]
                ok = in_grid[None] & (ks < count[None])  # [k, n]
                dp = photons["p"][idx] - p[None]
                d2 = (dp * dp).sum(-1)
                ok = ok & photons["valid"][idx] & (d2 < r2n[None])
                # Photons on disagreeing surfaces are rejected (leaks
                # across perpendicular walls).
                ok = ok & ((photons["n"][idx] * n_ax[None]).sum(-1) > 0.7)
                wi_ph = to_local(s_k, t_k, n_k,
                                 photons["wi"][idx].reshape(k * n, 3))
                f, _ = bsdf_mod.eval_pdf_full(params_k, wi_k, wi_ph,
                                              types=bsdf_types)
                # eval gives f·cos(wi_ph); the density estimate wants the
                # cosine-free f (the photon's power carries the arrival
                # geometry), so the cosine is divided back out.
                cos_ph = wi_ph[..., 2].abs().clamp_min(1e-4)
                contrib = (f / cos_ph[:, None]
                           * photons["power"][idx].reshape(k * n, 3))
                cell = torch.where(ok.reshape(k * n)[:, None], contrib,
                                   0.0).view(k, n, 3).sum(0)
                # The scanned photons are an unbiased subset of the cell.
                corr = count.float() / torch.minimum(
                    count, torch.full_like(count, k)).float().clamp_min(1.0)
                acc = acc + cell * corr[:, None]
    return acc / (math.pi * r2n[:, None])


def camera_gather(scene, generator, ro, rd, photons: dict, grid: dict, r2,
                  bsdf_types: tuple | None = None, k_per_cell: int = 16,
                  spec_depth: int = 4, rand: torch.Tensor | None = None,
                  device="cuda"):
    """The camera pass: a walk through delta surfaces (at most
    ``spec_depth`` hits) adding the emission seen along delta chains, then
    at the first smooth surface NEE and the photon gather; the walk stops
    once no lane continues (the reference runs its fixed steps on lanes
    that all add nothing). ``rand``:
    [spec_depth, N, 7] (u1, u2 of the light sample, then u0, u1, u2 of the
    BSDF sample). Returns (li, flux, m_count): flux and m_count feed the
    SPPM statistics (flux without the 1/(πr²)); li holds everything, for
    the plain photon mapper."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    ro, rd = ro.to(dev), rd.to(dev)
    n = ro.shape[0]
    u = uniforms(None if rand is None else {"u": rand}, generator,
                 {"u": (spec_depth, n, 7)}, dev)["u"]
    r2v = r2.to(dev).expand(n) if torch.is_tensor(r2) else torch.full(
        (n,), float(r2), device=dev)
    li = torch.zeros((n, 3), device=dev)
    flux = torch.zeros((n, 3), device=dev)
    m_cnt = torch.zeros(n, device=dev)
    beta = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(spec_depth):
        w = u[depth]
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        le = emitters.eval_emitter(scene, it, -rd)
        # Only on delta chains (NEE covers the rest); the camera ray
        # counts as delta.
        li = li + torch.where((active & hit["valid"])[:, None], beta * le,
                              0.0)
        li = li + torch.where((active & ~hit["valid"])[:, None],
                              beta * emitters.env_eval(scene, rd), 0.0)
        active = active & hit["valid"]
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        smooth = bsdf_mod.has_smooth(params)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        at_gather = active & smooth

        # NEE at the gather point.
        ls = emitters.sample_direct(scene, it["p"], w[:, 0], w[:, 1:3])
        f_d, _ = bsdf_mod.eval_pdf_full(
            params, wi_local, to_local(s_ax, t_ax, n_ax, ls["d"]),
            types=bsdf_types)
        occ = isect.occluded(scene, spawn(it["p"], it["ng"], ls["d"]),
                             ls["d"], ls["dist"] * (1.0 - 1e-3))
        cand = at_gather & ls["valid"] & (ls["pdf"] > 0.0) & ~occ
        li = li + torch.where(
            cand[:, None],
            beta * f_d * ls["radiance"] / ls["pdf"].clamp_min(1e-20)[:, None],
            0.0)

        # The photon gather (indirect light).
        ind = gather_radiance(scene, photons, grid, it["p"], wi_local,
                              (s_ax, t_ax, n_ax), params, r2v,
                              bsdf_types=bsdf_types, k_per_cell=k_per_cell)
        li = li + torch.where(at_gather[:, None], beta * ind, 0.0)
        flux = flux + torch.where(at_gather[:, None],
                                  beta * ind * (math.pi * r2v)[:, None], 0.0)
        m_cnt = m_cnt + torch.where(at_gather, 1.0, 0.0)

        # Continue through delta surfaces only.
        bs = bsdf_mod.sample_full(params, wi_local, w[:, 3], w[:, 4],
                                  w[:, 5:7], types=bsdf_types)
        active = active & ~smooth & (bs["weight"] > 0.0).any(-1)
        beta = beta * torch.where(active[:, None], bs["weight"], 1.0)
        if depth + 1 < spec_depth and not bool(active.any()):
            break  # no lane continues: the later steps would add nothing
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        ro = spawn(it["p"], it["ng"], wo_world)
        rd = wo_world
    return li, flux, m_cnt


def render_photonmap(scene, cfg, spp: int = 4, seed: int = 1234,
                     n_photon_paths: int = 1 << 17,
                     radius: float | None = None, photon_depth: int = 8,
                     device="cuda") -> dict:
    """The plain photon mapper: one global map of ``n_photon_paths`` light
    paths (drawn from seed ``seed ^ 0x9E37``), a fixed gather radius
    (default 0.02 · the scene's diagonal), the camera pass through the wave
    renderer."""
    from .renderer import render

    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    types = cfg.bsdf_types or None
    if radius is None:
        radius = 0.02 * scene_diagonal(scene)
    photons = trace_photons(
        scene, torch.Generator(device=dev).manual_seed(seed ^ 0x9E37),
        n_photon_paths, max_depth=photon_depth, bsdf_types=types,
        device=dev)
    # Powers normalised by the emitted path count.
    photons["power"] = photons["power"] / n_photon_paths
    grid = build_photon_grid(scene, photons, radius)
    r2 = torch.tensor(radius * radius, device=dev)

    def trace(sc, gen, ro, rd):
        return camera_gather(sc, gen, ro, rd, photons, grid, r2,
                             bsdf_types=types, device=dev)[0]

    return render(scene, cfg, spp=spp, seed=seed, trace_fn=trace, device=dev)


def render_sppm(scene, cfg, iterations: int = 8, seed: int = 1234,
                photon_paths_per_iter: int = 1 << 16,
                initial_radius: float | None = None, alpha: float = 0.7,
                photon_depth: int = 8, device="cuda") -> dict:
    """Stochastic progressive photon mapping: per-pixel statistics r², N
    and τ with the update r'² = r²(N + αM)/(N + M), τ' = (τ + Φ)·r'²/r²;
    the camera points are jittered anew every iteration, a new photon map
    is traced each time and gridded at the initial radius (default 0.03 ·
    the scene's diagonal), and the direct and emitted light are averaged
    apart. Returns dict(image [H, W, 3], r2 [H, W]) as numpy."""
    from ..scene.sensor import generate_rays

    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    types = cfg.bsdf_types or None
    w, h = cfg.width, cfg.height
    n_pix = w * h
    if initial_radius is None:
        initial_radius = 0.03 * scene_diagonal(scene)
    r2 = torch.full((n_pix,), initial_radius * initial_radius, device=dev)
    n_acc = torch.zeros(n_pix, device=dev)
    tau = torch.zeros((n_pix, 3), device=dev)
    direct = torch.zeros((n_pix, 3), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pix = torch.arange(n_pix, device=dev)
    for _ in range(iterations):
        u = torch.rand((n_pix, 2), generator=gen, device=dev)
        px = (pix % w).float() + u[:, 0]
        py = (pix // w).float() + u[:, 1]
        ro, rd = generate_rays(scene, torch.stack([px, py], -1), w, h,
                               cfg.fov_axis)
        photons = trace_photons(scene, gen, photon_paths_per_iter,
                                max_depth=photon_depth, bsdf_types=types,
                                device=dev)
        photons["power"] = photons["power"] / photon_paths_per_iter
        # The grid's cell must cover the largest radius, the initial one.
        grid = build_photon_grid(scene, photons, float(initial_radius))
        li, flux, m = camera_gather(scene, gen, ro, rd, photons, grid, r2,
                                    bsdf_types=types, device=dev)
        # li holds the gather at the current r²; the rest is direct light.
        direct = direct + torch.nan_to_num(li - flux / (math.pi * r2)[:, None])
        m = m.clamp_max(1.0)
        n_new = n_acc + alpha * m
        shrink = torch.where(m > 0, (n_acc + alpha * m)
                             / (n_acc + m).clamp_min(1e-6), 1.0)
        r2 = r2 * shrink
        tau = (tau + torch.nan_to_num(flux)) * shrink[:, None]
        n_acc = n_new
    # The photon powers are already normalised per path.
    img = direct / iterations + tau / (math.pi * r2)[:, None] / iterations
    return {"image": img.reshape(h, w, 3).cpu().numpy(),
            "r2": r2.reshape(h, w).cpu().numpy()}
