"""The adjoint particle tracer and the instant-radiosity VPL integrator (port
of sdmm_tpu/render/ptracer.py).

``trace_particles`` walks a wave of light paths from the emitters and splats
every vertex onto the film through a camera connection (``index_add_`` by
pixel, whose atomic adds on the card sum in no fixed order);
``render_ptracer`` runs ``spp`` · W · H of them in waves. ``generate_vpls``
turns every vertex of a few light paths into a virtual point light, and
``trace_vpl`` shades a camera wave against that set, with the geometry term
clamped at ``clamp_rel`` · the scene radius; ``render_vpl`` runs it through
the wave renderer. The lights that start a path are the area emitters and
the point, spot, directional and collimated lights; environment maps and
sun/sky emit no particles, as in the reference. The shading-normal
asymmetry of the adjoint BSDF is not applied, as in the reference.

Sampling functions take their uniforms (``rand``) or draw them from a
``torch.Generator``; every entry point runs on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from ..bsdf import bsdf as bsdf_mod
from ..core import warp
from ..core.device import resolve_device
from ..core.frame import coordinate_system, normalize, to_local, to_world
from ..scene import emitters
from ..scene.scene import scene_to
from . import intersect as isect
from .volpath import RAY_EPS, shading_frame, spawn

# Lanes of one trace_vpl chunk: the VPLs of a chunk share one occlusion
# query and one BSDF evaluation over chunk · N lanes.
VPL_LANES = 1 << 22


def uniforms(rand, generator, shapes: dict, dev) -> dict:
    """The uniforms of ``shapes`` ({name: shape}): ``rand[name]`` as given,
    else drawn from ``generator`` in the order of ``shapes``."""
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        if rand is None:
            out[name] = torch.rand(shape, generator=generator, device=dev)
            continue
        r = rand[name]
        if tuple(r.shape) != shape:
            raise ValueError(f"rand[{name!r}] must be {list(shape)}, got "
                             f"{list(r.shape)}")
        out[name] = r.to(dev, torch.float32)
    return out


def sample_emission(scene, n: int, rand: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    device="cuda") -> dict:
    """Emission positions and directions with their path weights. Area
    emitters: a triangle by ``em_tri_cdf``, a uniform point on it and a
    cosine direction (beta = Le·π/pdf_A); point lights a uniform sphere
    (beta = 4π·I/pmf); spots a uniform cone over the cutoff with the
    linear falloff; directional lights a disk over the scene's bounding
    sphere; collimated beams the beam itself. ``rand``: [n, 5] uniforms
    (u1, then u2 and u3 of two each). Returns dict(p, n, d, beta, Le,
    from_area, valid, beta_A)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    u = uniforms(None if rand is None else {"u": rand}, generator,
                 {"u": (n, 5)}, dev)["u"]
    u1, u2, u3 = u[:, 0], u[:, 1:3], u[:, 3:5]
    m = scene.em_tri_idx.shape[0]
    n_pt = scene.pt_pos.shape[0]
    pt_prob = scene.pt_select_prob if n_pt else torch.zeros((), device=dev)
    pick_pt = (u1 < pt_prob) if n_pt else torch.zeros(
        n, dtype=torch.bool, device=dev)
    z3 = torch.zeros((n, 3), device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    out = {"p": z3, "n": z3, "d": z3, "beta": z3, "Le": z3,
           "from_area": zb, "valid": zb, "beta_A": z3}

    if m:
        sel = torch.searchsorted(scene.em_tri_cdf,
                                 u1.contiguous()).clamp(0, m - 1)
        tri = scene.em_tri_idx.long()[sel]
        b = warp.square_to_uniform_triangle(u2)
        p = (scene.tri_v0[tri] + b[..., 0:1] * scene.tri_e1[tri]
             + b[..., 1:2] * scene.tri_e2[tri])
        nrm = scene.tri_ng[tri]
        pdf_a = (scene.em_tri_pdf[sel]
                 / scene.em_tri_area[sel].clamp_min(1e-20)
                 ) * (1.0 - pt_prob).clamp_min(1e-9)
        le = scene.emitter_radiance[scene.tri_emitter[tri].long()]
        d_local = warp.square_to_cosine_hemisphere(u3)
        s_ax, t_ax = coordinate_system(nrm)
        d = to_world(s_ax, t_ax, nrm, d_local)
        # beta = Le·cosθ / (pdf_A · cosθ/π) = Le·π/pdf_A
        beta_area = le * (math.pi / pdf_a.clamp_min(1e-20))[:, None]
        beta_a_only = 1.0 / pdf_a.clamp_min(1e-20)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        out = {"p": p, "n": nrm, "d": d, "beta": beta_area, "Le": le,
               "from_area": ones, "valid": ones,
               "beta_A": beta_a_only[:, None].expand(n, 3)}

    if n_pt:
        sel_pt = torch.searchsorted(scene.pt_cdf, u2[..., 0].contiguous()
                                    ).clamp(0, n_pt - 1)
        pmf = scene.pt_cdf[sel_pt] - torch.where(
            sel_pt > 0, scene.pt_cdf[(sel_pt - 1).clamp_min(0)], 0.0)
        pmf = pmf * pt_prob.clamp_min(1e-9)
        kind = scene.pt_kind[sel_pt]
        inten = scene.pt_intensity[sel_pt]
        # point (kind 0): uniform sphere
        d_sph = warp.square_to_uniform_sphere(u3)
        beta_pt = inten * (4.0 * math.pi / pmf.clamp_min(1e-9))[:, None]
        # spot (kind 1): uniform cone about pt_dir, linear falloff
        co = scene.pt_cutoff_cos[sel_pt]
        cb = scene.pt_beam_cos[sel_pt]
        cos_c = 1.0 - u3[..., 0] * (1.0 - co)
        sin_c = torch.sqrt((1.0 - cos_c * cos_c).clamp_min(0.0))
        phi = 2.0 * math.pi * u3[..., 1]
        ax = scene.pt_dir[sel_pt]
        s_ax, t_ax = coordinate_system(ax)
        d_cone = (s_ax * (sin_c * torch.cos(phi))[:, None]
                  + t_ax * (sin_c * torch.sin(phi))[:, None]
                  + ax * cos_c[:, None])
        pdf_cone = 1.0 / (2.0 * math.pi * (1.0 - co)).clamp_min(1e-9)
        fall = ((cos_c - co) / (cb - co).clamp_min(1e-6)).clamp(0.0, 1.0)
        beta_spot = inten * (fall / (pdf_cone * pmf.clamp_min(1e-9)))[:, None]
        # directional (kind 2): pt_pos holds the direction toward the
        # light; emit from a bounding-sphere disk along -pt_pos.
        center = 0.5 * (scene.aabb_lo + scene.aabb_hi)
        radius = 0.5 * torch.linalg.vector_norm(
            scene.aabb_hi - scene.aabb_lo) + 1e-3
        d_dir = -normalize(scene.pt_pos[sel_pt])
        s_d, t_d = coordinate_system(d_dir)
        disk = warp.square_to_uniform_disk_concentric(u3) * radius
        p_dir = (center[None] - d_dir * radius
                 + s_d * disk[..., 0:1] + t_d * disk[..., 1:2])
        beta_dir = inten * (math.pi * radius * radius
                            / pmf.clamp_min(1e-9))[:, None]
        # collimated (kind 3): doubly delta, the beam ray itself with its
        # power carried verbatim.
        beta_col = inten / pmf.clamp_min(1e-9)[:, None]

        is_spot = (kind == 1)[:, None]
        is_dir = (kind == 2)[:, None]
        is_col = (kind == 3)[:, None]
        d_pt = torch.where(is_dir, d_dir, torch.where(is_spot, d_cone,
                                                      d_sph))
        d_pt = torch.where(is_col, scene.pt_dir[sel_pt], d_pt)
        p_pt = torch.where(is_dir, p_dir, scene.pt_pos[sel_pt])
        beta_k = torch.where(is_dir, beta_dir,
                             torch.where(is_spot, beta_spot, beta_pt))
        beta_k = torch.where(is_col, beta_col, beta_k)
        pick = pick_pt[:, None]
        out["p"] = torch.where(pick, p_pt, out["p"])
        out["d"] = torch.where(pick, d_pt, out["d"])
        out["n"] = torch.where(pick, d_pt, out["n"])
        out["beta"] = torch.where(pick, beta_k, out["beta"])
        out["from_area"] = out["from_area"] & ~pick_pt
        out["valid"] = out["valid"] | pick_pt
        out["Le"] = torch.where(pick, 0.0, out["Le"])
        out["beta_A"] = torch.where(pick, 0.0, out["beta_A"])
    return out


def camera_connect(scene, p: torch.Tensor, width: int, height: int,
                   fov_axis: str = "x") -> dict:
    """Project world points onto the film of the perspective pinhole.
    Returns dict(pix [N], d [N, 3] the unit direction point → camera, dist,
    we, valid); ``we`` is the importance W·H/(4·tx·ty·cos³θ)/r², so that
    pixel_j += beta · f(ω to the camera) · we estimates what a camera ray
    through pixel j measures."""
    rot = scene.cam_to_world[:3, :3]
    cam_o = scene.cam_to_world[:3, 3]
    v = p - cam_o
    d_cam = v @ rot  # R^T v
    z = d_cam[..., 2]
    aspect = width / height
    tan_half = scene.cam_tan_half_fov
    if fov_axis == "x":
        tx, ty = tan_half, tan_half / aspect
    else:
        tx, ty = tan_half * aspect, tan_half
    sx = d_cam[..., 0] / z.clamp_min(1e-12) / tx
    sy = d_cam[..., 1] / z.clamp_min(1e-12) / ty
    px = (1.0 - sx) * 0.5 * width
    py = (1.0 - sy) * 0.5 * height
    inside = (z > 1e-6) & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pix = (py.to(torch.int32).clamp(0, height - 1) * width
           + px.to(torch.int32).clamp(0, width - 1))
    dist2 = (v * v).sum(-1)
    dist = torch.sqrt(dist2.clamp_min(1e-20))
    cos_t = z / dist
    we = (width * height) / (4.0 * tx * ty * cos_t.clamp_min(1e-6) ** 3)
    we = we / dist2.clamp_min(1e-12)
    return {"pix": pix, "d": -v / dist[:, None], "dist": dist,
            "we": torch.where(inside, we, 0.0), "valid": inside}


def trace_particles(scene, generator, n_paths: int, width: int, height: int,
                    max_depth: int = 10, rr_depth: int = 10,
                    bsdf_types: tuple | None = None, fov_axis: str = "x",
                    rand: dict | None = None, device="cuda") -> torch.Tensor:
    """One wave of light paths; returns the film's sum [W·H, 3], to be
    divided by the number of paths over all waves. The emission vertex of
    an area light is splatted first, then each of ``max_depth`` steps
    splats its vertex through camera_connect and samples the BSDF, with
    Russian roulette from ``rr_depth``. ``rand``: {"emit": [n, 5] (see
    sample_emission), "walk": [max_depth, n, 5] (u0, u1, u2 of the BSDF
    sample, then the roulette's)}."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    n = n_paths
    u = uniforms(rand, generator, {"emit": (n, 5),
                                   "walk": (max_depth, n, 5)}, dev)
    em = sample_emission(scene, n, rand=u["emit"], device=dev)
    film = torch.zeros((width * height, 3), device=dev)

    # The emission vertex seen by the camera (area lights only).
    cc0 = camera_connect(scene, em["p"], width, height, fov_axis)
    cos_e = (em["n"] * cc0["d"]).sum(-1)
    o0 = em["p"] + em["n"] * torch.where(cos_e > 0, RAY_EPS,
                                         -RAY_EPS)[:, None]
    occ0 = isect.occluded(scene, o0, cc0["d"], cc0["dist"] * (1.0 - 1e-3))
    c0 = em["beta_A"] * em["Le"] * (cc0["we"] * cos_e.clamp_min(0.0))[:, None]
    good0 = em["valid"] & em["from_area"] & cc0["valid"] & ~occ0 & (cos_e > 0)
    film.index_add_(0, cc0["pix"].long(), torch.where(good0[:, None], c0,
                                                      0.0))

    ro = em["p"] + em["n"] * RAY_EPS
    rd, beta, active = em["d"], em["beta"], em["valid"]
    for depth in range(max_depth):
        w = u["walk"][depth]
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        active = active & hit["valid"]
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)

        # Connect this vertex to the camera.
        cc = camera_connect(scene, it["p"], width, height, fov_axis)
        wo_cam = to_local(s_ax, t_ax, n_ax, cc["d"])
        f, _ = bsdf_mod.eval_pdf_full(params, wi_local, wo_cam,
                                      types=bsdf_types)
        occ = isect.occluded(scene, spawn(it["p"], it["ng"], cc["d"]),
                             cc["d"], cc["dist"] * (1.0 - 1e-3))
        contrib = beta * f * cc["we"][:, None]
        good = active & cc["valid"] & ~occ
        film.index_add_(0, cc["pix"].long(),
                        torch.where(good[:, None], contrib, 0.0))

        # Continue the walk.
        bs = bsdf_mod.sample_full(params, wi_local, w[:, 0], w[:, 1],
                                  w[:, 2:4], types=bsdf_types)
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        beta = beta * bs["weight"]
        active = active & (bs["weight"] > 0.0).any(-1)
        if depth + 1 >= rr_depth:
            q = bs["weight"].amax(-1).clamp(0.05, 0.95)
            active = active & ~(w[:, 4] >= q)
            beta = torch.where(active[:, None],
                               beta / q.clamp_min(1e-6)[:, None], beta)
        ro = spawn(it["p"], it["ng"], wo_world)
        rd = wo_world
    return film


def render_ptracer(scene, cfg, spp: int = 16, seed: int = 1234,
                   paths_per_wave: int = 1 << 16, device="cuda") -> dict:
    """Particle-traced render: ``spp`` · W · H light paths (the reference's
    sampleCount accounting), rounded up to whole waves of
    ``paths_per_wave``. Returns dict(image [H, W, 3] as numpy, n_paths)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    w, h = cfg.width, cfg.height
    total = spp * w * h
    n_waves = max(1, (total + paths_per_wave - 1) // paths_per_wave)
    gen = torch.Generator(device=dev).manual_seed(seed)
    film = torch.zeros((w * h, 3), device=dev)
    for _ in range(n_waves):
        film += trace_particles(
            scene, gen, paths_per_wave, w, h, max_depth=cfg.max_depth,
            rr_depth=cfg.rr_depth, bsdf_types=cfg.bsdf_types or None,
            fov_axis=cfg.fov_axis, device=dev)
    img = (film / (n_waves * paths_per_wave)).reshape(h, w, 3)
    return {"image": img.cpu().numpy(), "n_paths": n_waves * paths_per_wave}


def generate_vpls(scene, n_light_paths: int, max_depth: int,
                  bsdf_types: tuple | None = None, rand: dict | None = None,
                  generator: torch.Generator | None = None,
                  device="cuda") -> dict:
    """Every vertex of ``n_light_paths`` light walks becomes a virtual
    point light: V = n_light_paths · (max_depth + 1) of them, the emitter
    VPLs (kind 0) first, then the surface VPLs (kind 1) depth by depth,
    their weights already divided by n_light_paths. ``rand``: {"emit":
    [n, 5], "walk": [max_depth, n, 4] (u0, u1, u2)}. Returns dict of [V, ...]
    tensors p, n, wi, beta, kind, bsdf, uv, valid."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    n = n_light_paths
    u = uniforms(rand, generator, {"emit": (n, 5),
                                   "walk": (max_depth, n, 4)}, dev)
    em = sample_emission(scene, n, rand=u["emit"], device=dev)
    inv_n = 1.0 / n
    vp, vn, vwi, vbeta, vbsdf, vuv, vvalid = ([em["p"]], [em["n"]],
                                              [em["d"]], [], [], [], [])
    vbeta.append(em["Le"] * em["beta_A"] * inv_n)
    vbsdf.append(torch.zeros(n, dtype=torch.int32, device=dev))
    vvalid.append(em["valid"] & em["from_area"])
    ro = em["p"] + em["n"] * RAY_EPS
    rd, beta, active = em["d"], em["beta"], em["valid"]
    for depth in range(max_depth):
        w = u["walk"][depth]
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        active = active & hit["valid"]
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        vp.append(it["p"])
        vn.append(it["ns"])
        vwi.append(-rd)
        vbeta.append(beta * inv_n)
        vbsdf.append(it["bsdf"])
        vuv.append(it["uv"])
        vvalid.append(active & bsdf_mod.has_smooth(params))

        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        bs = bsdf_mod.sample_full(params, wi_local, w[:, 0], w[:, 1],
                                  w[:, 2:4], types=bsdf_types)
        rd = to_world(s_ax, t_ax, n_ax, bs["wo"])
        beta = beta * bs["weight"]
        active = active & (bs["weight"] > 0.0).any(-1)
        ro = spawn(it["p"], it["ng"], rd)
    # The emitter VPLs' uv rows are 0, as wide as the hits' (a scene with
    # mesh attributes carries 6 columns).
    uv_w = vuv[0].shape[1] if vuv else 2
    vuv.insert(0, torch.zeros((n, uv_w), device=dev))
    kind = torch.ones(n * (max_depth + 1), dtype=torch.int32, device=dev)
    kind[:n] = 0
    return {"p": torch.cat(vp), "n": torch.cat(vn), "wi": torch.cat(vwi),
            "beta": torch.cat(vbeta), "kind": kind, "bsdf": torch.cat(vbsdf),
            "uv": torch.cat(vuv), "valid": torch.cat(vvalid)}


def trace_vpl(scene, generator, ro, rd, vpls: dict,
              bsdf_types: tuple | None = None, clamp_rel: float = 0.05,
              device="cuda") -> torch.Tensor:
    """Instant-radiosity shading of a camera wave against a VPL set: the
    emission seen, then per VPL f_x · (Le·cosθ_y or f_y) · beta / max(r²,
    (clamp_rel · scene radius)²) where unoccluded. The VPLs go in chunks of
    as many as fit VPL_LANES lanes, each chunk one occlusion query and one
    BSDF evaluation a side over chunk · N lanes; each lane sums the VPLs in
    their order. No uniforms are drawn."""
    del generator
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    ro, rd = ro.to(dev), rd.to(dev)
    vpls = {k: v.to(dev) for k, v in vpls.items()}
    n = ro.shape[0]
    hit = isect.intersect(scene, ro, rd)
    it = isect.surface_interaction(scene, ro, rd, hit)
    valid = hit["valid"][:, None]
    li = torch.where(valid, emitters.eval_emitter(scene, it, -rd), 0.0)
    li = li + torch.where(~valid, emitters.env_eval(scene, rd), 0.0)

    params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                    types=bsdf_types)
    s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
    wi_local = to_local(s_ax, t_ax, n_ax, -rd)
    on_surface = hit["valid"] & bsdf_mod.has_smooth(params)
    scene_r = 0.5 * torch.linalg.vector_norm(scene.aabb_hi - scene.aabb_lo)
    d_min2 = (clamp_rel * scene_r) ** 2

    n_vpl = vpls["p"].shape[0]
    m = min(max(1, VPL_LANES // max(n, 1)), max(n_vpl, 1))
    cam_rows = None
    for c0 in range(0, n_vpl, m):
        j = torch.arange(c0, min(c0 + m, n_vpl), device=dev)
        k = j.numel()
        if cam_rows is None or cam_rows[0] != k:
            def rep(x):
                return x.repeat(k, *([1] * (x.ndim - 1)))

            cam_rows = (k, bsdf_mod.repeat_params(params, k), rep(wi_local),
                        rep(s_ax), rep(t_ax), rep(n_ax), rep(it["p"]),
                        rep(it["ng"]), rep(on_surface))
        _, p_x, wi_x, s_x, t_x, n_x, pos, ng, on_x = cam_rows

        def per(x):
            return x[j].repeat_interleave(n, 0)

        yp, yn, ywi = per(vpls["p"]), per(vpls["n"]), per(vpls["wi"])
        to_y = yp - pos
        r2 = (to_y * to_y).sum(-1)
        r = torch.sqrt(r2.clamp_min(1e-20))
        d = to_y / r[:, None]
        # f at the camera vertex (includes cosθ_x).
        f_x, _ = bsdf_mod.eval_pdf_full(p_x, wi_x, to_local(s_x, t_x, n_x,
                                                            d),
                                        types=bsdf_types)
        # The factor at the VPL: Le·cosθ_y for an emitter VPL, f_y
        # (including cosθ_y) for a surface VPL.
        cos_y = (yn * -d).sum(-1)
        pb = bsdf_mod.gather_params(scene, per(vpls["bsdf"]),
                                    per(vpls["uv"]), types=bsdf_types)
        sy, ty, ny = shading_frame(pb, yn, ywi)
        f_y, _ = bsdf_mod.eval_pdf_full(pb, to_local(sy, ty, ny, ywi),
                                        to_local(sy, ty, ny, -d),
                                        types=bsdf_types)
        factor_y = torch.where((per(vpls["kind"]) == 0)[:, None],
                               cos_y.clamp_min(0.0)[:, None], f_y)
        occ = isect.occluded(scene, spawn(pos, ng, d), d, r * (1.0 - 1e-3))
        g = 1.0 / torch.maximum(r2, d_min2)
        contrib = (per(vpls["beta"]) * f_x * factor_y * g[:, None]).view(
            k, n, 3)
        good = (on_x & per(vpls["valid"]) & ~occ & (r2 > 1e-12)).view(k, n)
        for q in range(k):
            li = li + torch.where(good[q][:, None], contrib[q], 0.0)
    return li


def render_vpl(scene, cfg, spp: int = 4, seed: int = 1234,
               n_light_paths: int = 32, vpl_depth: int = 4,
               device="cuda") -> dict:
    """VPL render: one VPL set for every pixel, drawn from seed
    ``seed ^ 0x5BD1``, shaded through the wave renderer."""
    from .renderer import render

    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    types = cfg.bsdf_types or None
    vpls = generate_vpls(
        scene, n_light_paths, vpl_depth, bsdf_types=types,
        generator=torch.Generator(device=dev).manual_seed(seed ^ 0x5BD1),
        device=dev)

    def trace(sc, gen, ro, rd):
        return trace_vpl(sc, gen, ro, rd, vpls, bsdf_types=types, device=dev)

    return render(scene, cfg, spp=spp, seed=seed, trace_fn=trace, device=dev)

