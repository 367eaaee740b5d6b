"""Path-space Metropolis light transport, Veach's MLT (port of
sdmm_tpu/render/mlt.py).

Unlike pssmlt.py this module mutates explicit transport paths: many chains
hold their vertex arrays as [N, D, ...] tensors and advance in lockstep;
specular-chain re-traces are intersection sweeps over all chains at once.
Paths are eye-ordered (slot 0 the camera-visible vertex, slot length - 1 on
an emitter): the unidirectional subspace, with no NEE. In the screen
parameterisation the target is

    pi(s, e2..) ∝ lum[f1·G(e1,e2)·f2·G(e2,e3)···G(e_{len-1},e_len)·Le].

Every chain computes all three proposals each step and keeps one (the dense
choice of the reference):

- a large step: an independent path-traced proposal, accepted by the ratio
  of the path tracer's luminance estimates W;
- a lens perturbation: the screen position moves by an exponentially
  distributed radius, the eye-side delta chain is re-traced to the first
  connectable vertex e_j and reconnected to e_{j+1}; accepted by the ratio
  of the respan weights (``lens_respan``);
- a caustic perturbation: the outgoing direction at the last connectable
  vertex e_m before the delta chain that ends at e_1 is cone-perturbed,
  the chain re-traced down to a new e_1 and reprojected onto the film;
  accepted by the ratio of ``caustic_respan``.

The reference's detailed-balance deviations are kept: curved specular
chains use the flat-geometry Jacobian, and a lens or caustic proposal whose
recomputed path-tracer weight is 0 is rejected (``a = where(wl > 0, a,
0)``). Per-chain slot reads clamp their index into the path (the
reference's reads past the end give NaN; every such lane is masked out in
both packages).

The functions that sample take their uniforms (``rand``) or draw them from a
``torch.Generator``; every entry point runs on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bsdf import bsdf as bsdf_mod
from ..bsdf.fresnel import fresnel_conductor, fresnel_dielectric
from ..core.device import resolve_device
from ..core.frame import coordinate_system, to_local, to_world
from ..core.spectrum import luminance
from ..scene import emitters
from ..scene.scene import BSDF_CONDUCTOR, BSDF_DIELECTRIC, scene_to
from ..scene.sensor import generate_rays
from . import intersect as isect
from .ptracer import uniforms
from .volpath import shading_frame, spawn

P_LARGE = 0.4  # the mutation mix
P_LENS = 0.3

LENS_R1 = 0.1     # pixels (Mitsuba mlt.cpp minJump)
LENS_AREA = 0.05  # the film-area share the lens radius covers
CAUSTIC_R1 = 0.1  # pixels, turned into radians by the per-pixel angle
CAUSTIC_R2 = 50.0

PATH_FIELDS = ("pos", "ns", "ng", "uv", "bsdf", "delta", "emitter", "length",
               "spos", "valid", "rgb", "wlum")


def _norm(v, eps=1e-20):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True).clamp_min(eps))


def empty_paths(n: int, d: int, device="cuda") -> dict:
    """n paths of d slots: pos, ns, ng [n, d, 3], uv [n, d, 2], bsdf and
    emitter int32 [n, d] (emitter -1), delta bool [n, d], length int32 [n],
    spos [n, 2], valid bool [n], rgb [n, 3] (the contribution's colour) and
    wlum [n] (the path tracer's luminance estimate W)."""
    dev = resolve_device(device)
    z = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, d, 3).clone()
    return {
        "pos": torch.zeros((n, d, 3), device=dev),
        "ns": z, "ng": z.clone(),
        "uv": torch.zeros((n, d, 2), device=dev),
        "bsdf": torch.zeros((n, d), dtype=torch.int32, device=dev),
        "delta": torch.zeros((n, d), dtype=torch.bool, device=dev),
        "emitter": torch.full((n, d), -1, dtype=torch.int32, device=dev),
        "length": torch.zeros(n, dtype=torch.int32, device=dev),
        "spos": torch.zeros((n, 2), device=dev),
        "valid": torch.zeros(n, dtype=torch.bool, device=dev),
        "rgb": torch.zeros((n, 3), device=dev),
        "wlum": torch.zeros(n, device=dev),
    }


def trace_path_record(scene, generator, spos: torch.Tensor, width: int,
                      height: int, max_depth: int,
                      bsdf_types: tuple | None, fov_axis: str = "x",
                      rand: torch.Tensor | None = None,
                      device="cuda") -> dict:
    """Path-trace from screen positions ``spos`` [N, 2], recording every
    vertex; ``wlum`` holds the path tracer's luminance estimate f/p.
    ``rand``: [max_depth, N, 4] uniforms, a bounce's u0, u1 and u2 of
    ``sample_full``."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    spos = spos.to(dev, torch.float32)
    n = spos.shape[0]
    u = uniforms(None if rand is None else {"walk": rand}, generator,
                 {"walk": (max_depth, n, 4)}, dev)["walk"]
    ro, rd = generate_rays(scene, spos, width, height, fov_axis)
    thr = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    w_out = torch.zeros((n, 3), device=dev)
    recs = {k: [] for k in ("pos", "ns", "ng", "uv", "bsdf", "delta",
                            "emitter", "done")}
    for depth in range(max_depth):
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        le = emitters.eval_emitter(scene, it, -rd)
        done_now = active & (le > 0.0).any(-1) & hit["valid"]
        w_out = torch.where(done_now[:, None], thr * le, w_out)

        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        active = active & hit["valid"] & ~done_now
        ud = u[depth]
        bs = bsdf_mod.sample_full(params, wi_local, ud[:, 0], ud[:, 1],
                                  ud[:, 2:4], types=bsdf_types)
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        ok = (bs["weight"] > 0.0).any(-1)
        thr = thr * torch.where((active & ok)[:, None], bs["weight"], 1.0)
        active = active & ok
        # Fixed-width slots keep the plain (u, v): mesh-attribute channels
        # of a widened uv row do not survive a mutation.
        for k, v in (("pos", it["p"]), ("ns", it["ns"]), ("ng", it["ng"]),
                     ("uv", it["uv"][..., :2]), ("bsdf", it["bsdf"]),
                     ("delta", bs["delta"]), ("emitter", it["emitter"]),
                     ("done", done_now)):
            recs[k].append(v)
        ro = spawn(it["p"], it["ng"], wo_world)
        rd = wo_world

    path = {k: torch.stack(v, 1) for k, v in recs.items() if k != "done"}
    path["bsdf"] = path["bsdf"].to(torch.int32)
    path["emitter"] = path["emitter"].to(torch.int32)
    done = torch.stack(recs["done"], 1)
    first_done = done.to(torch.int8).argmax(1).to(torch.int32)
    has_done = done.any(1)
    path["length"] = torch.where(has_done, first_done + 1, 0).to(torch.int32)
    lum = luminance(w_out)
    path["valid"] = has_done & (lum > 0.0)
    path["rgb"] = torch.where(path["valid"][:, None], w_out, 0.0)
    path["wlum"] = torch.where(path["valid"], lum, 0.0)
    path["spos"] = spos
    return path


def _slot(path, field, i):
    """path[field][n, i[n]] for per-chain slot indices i (clamped into the
    path)."""
    a = path[field]
    idx = i.long().clamp(0, a.shape[1] - 1).reshape(-1, 1, *(
        [1] * (a.ndim - 2))).expand(-1, 1, *a.shape[2:])
    return torch.gather(a, 1, idx)[:, 0]


def _delta_value(scene, bsdf_id, uv, ns, wi, wo, bsdf_types):
    """The delta BSDF's coefficient (the value, not value/pdf): conductor
    spec·F; dielectric reflection spec·F, refraction trans·(1-F)·eta_ti²."""
    params = bsdf_mod.gather_params(scene, bsdf_id, uv, types=bsdf_types)
    s_ax, t_ax, n_ax = shading_frame(params, ns, wi)
    wil = to_local(s_ax, t_ax, n_ax, wi)
    wol = to_local(s_ax, t_ax, n_ax, wo)
    cos_i = wil[..., 2].abs()
    out = torch.zeros(wi.shape[:-1] + (3,), device=wi.device)
    t = params["type"]
    if BSDF_CONDUCTOR in (bsdf_types or (BSDF_CONDUCTOR,)):
        f_c = fresnel_conductor(cos_i, params["eta"][..., None], params["k"])
        out = torch.where((t == BSDF_CONDUCTOR)[..., None],
                          params["specular"] * f_c, out)
    if BSDF_DIELECTRIC in (bsdf_types or (BSDF_DIELECTRIC,)):
        fr, _, _, eta_ti = fresnel_dielectric(wil[..., 2], params["eta"])
        refl = wil[..., 2] * wol[..., 2] > 0.0
        v = torch.where(
            refl[..., None], params["specular"] * fr[..., None],
            params["albedo"] * ((1.0 - fr) * eta_ti * eta_ti)[..., None])
        out = torch.where((t == BSDF_DIELECTRIC)[..., None], v, out)
    return out


def _smooth_f(scene, bsdf_id, uv, ns, wi, wo, bsdf_types):
    """The BSDF's value f(wi, wo) without cosines at a connectable vertex
    (eval_pdf_full's f·|cos wo| with the cosine divided out: the G terms
    carry the cosines)."""
    params = bsdf_mod.gather_params(scene, bsdf_id, uv, types=bsdf_types)
    s_ax, t_ax, n_ax = shading_frame(params, ns, wi)
    wol = to_local(s_ax, t_ax, n_ax, wo)
    f, _ = bsdf_mod.eval_pdf_full(params, to_local(s_ax, t_ax, n_ax, wi),
                                  wol, types=bsdf_types)
    return f / wol[..., 2:3].abs().clamp_min(1e-9)


def _geom(pa, na, pb, nb):
    """G(a, b) with both cosines; also the direction a → b and the
    distance."""
    d = pb - pa
    dist2 = (d * d).sum(-1).clamp_min(1e-20)
    dist = torch.sqrt(dist2)
    w = d / dist[..., None]
    g = (na * w).sum(-1).abs() * (nb * w).sum(-1).abs() / dist2
    return g, w, dist


def _occluded(scene, pa, ng_a, dir_ab, dist):
    hit = isect.intersect(scene, spawn(pa, ng_a, dir_ab), dir_ab)
    return hit["valid"] & (hit["t"] < dist * (1.0 - 1e-3))


def _emitter_le(scene, path, idx, toward):
    """Le of the emitter vertex at slot idx, emitted toward ``toward``."""
    em = _slot(path, "emitter", idx)
    front = (_slot(path, "ng", idx) * toward).sum(-1) > 0.0
    le = torch.where((em >= 0)[:, None],
                     scene.emitter_radiance[em.long().clamp_min(0)], 0.0)
    return le * front[:, None]


def _first_connectable(path):
    """The index j of the first non-delta vertex (the end of the eye-side
    chain), and whether there is one."""
    d = path["delta"].shape[1]
    in_range = (torch.arange(d, device=path["delta"].device)[None, :]
                < path["length"][:, None])
    connectable = ~path["delta"] & in_range
    return connectable.to(torch.int8).argmax(1), connectable.any(1)


def _cam(scene, n):
    return scene.cam_to_world[:3, 3].expand(n, 3)


def path_pt_weight(scene, path: dict, bsdf_types: tuple):
    """The path tracer's estimate W (luminance and rgb) of a stored path:
    the product over its vertices of the sampling weight (f·cos/pdf at a
    smooth vertex, the delta weight with the component probability
    cancelled at a specular one) times Le. Recomputed after a perturbation,
    so that a mutated path carries the W path tracing would have given
    it."""
    n = path["length"].shape[0]
    d = path["pos"].shape[1]
    w = torch.ones((n, 3), device=path["pos"].device)
    prev = _cam(scene, n)
    for i in range(d - 1):
        interior = (i + 1) < path["length"]
        pos_i = path["pos"][:, i]
        wi = _norm(prev - pos_i)
        wo = _norm(path["pos"][:, i + 1] - pos_i)
        params = bsdf_mod.gather_params(scene, path["bsdf"][:, i],
                                        path["uv"][:, i], types=bsdf_types)
        s_ax, t_ax, n_ax = shading_frame(params, path["ns"][:, i], wi)
        wil = to_local(s_ax, t_ax, n_ax, wi)
        wol = to_local(s_ax, t_ax, n_ax, wo)
        f, pdf = bsdf_mod.eval_pdf_full(params, wil, wol, types=bsdf_types)
        smooth_w = torch.where((pdf > 0)[:, None],
                               f / pdf.clamp_min(1e-20)[:, None], 0.0)
        # A delta vertex: sample_full's weight (conductor spec·F;
        # dielectric reflection spec, refraction trans·eta_ti²).
        t = params["type"]
        dw = torch.zeros((n, 3), device=w.device)
        if BSDF_CONDUCTOR in bsdf_types:
            f_c = fresnel_conductor(wil[..., 2].abs(),
                                    params["eta"][..., None], params["k"])
            dw = torch.where((t == BSDF_CONDUCTOR)[:, None],
                             params["specular"] * f_c, dw)
        if BSDF_DIELECTRIC in bsdf_types:
            _, _, _, eta_ti = fresnel_dielectric(wil[..., 2], params["eta"])
            refl = wil[..., 2] * wol[..., 2] > 0.0
            v = torch.where(refl[:, None], params["specular"],
                            params["albedo"] * (eta_ti * eta_ti)[:, None])
            dw = torch.where((t == BSDF_DIELECTRIC)[:, None], v, dw)
        fac = torch.where(path["delta"][:, i][:, None], dw, smooth_w)
        w = torch.where(interior[:, None], w * fac, w)
        prev = torch.where(interior[:, None], pos_i, prev)

    last = (path["length"] - 1).clamp_min(0)
    toward = _norm(prev - _slot(path, "pos", last))
    w = w * _emitter_le(scene, path, last, toward)
    w = torch.where(path["valid"][:, None], w, 0.0)
    return luminance(w), w


def lens_respan(scene, path: dict, j, upto_valid, bsdf_types):
    """The lens mutation's respan weight of a stored path:
    Π_{i<j}[w_i·cos(ns_i, ω_out)] · f_j · G(e_j, e_{j+1}) · fac_{j+1}, with
    j the reconnection vertex of each chain. Returns (lum, rgb)."""
    n = path["length"].shape[0]
    d = path["pos"].shape[1]
    w = torch.ones((n, 3), device=path["pos"].device)
    prev = _cam(scene, n)
    for i in range(d - 1):
        below = i < j
        active = below & upto_valid
        pos_i = path["pos"][:, i]
        wo = _norm(path["pos"][:, i + 1] - pos_i)
        val = _delta_value(scene, path["bsdf"][:, i], path["uv"][:, i],
                           path["ns"][:, i], _norm(prev - pos_i), wo,
                           bsdf_types)
        cos_out = (path["ns"][:, i] * wo).sum(-1).abs()
        w = torch.where(active[:, None], w * val * cos_out[:, None], w)
        prev = torch.where(below[:, None], pos_i, prev)

    # The reconnection (e_j, e_{j+1}).
    pj = _slot(path, "pos", j)
    nj = _slot(path, "ns", j)
    jp1 = j + 1
    pj1 = _slot(path, "pos", jp1)
    nj1 = _slot(path, "ns", jp1)
    g, w_jj1, _ = _geom(pj, nj, pj1, nj1)
    f_j = _smooth_f(scene, _slot(path, "bsdf", j), _slot(path, "uv", j), nj,
                    _norm(prev - pj), w_jj1, bsdf_types)
    w = w * f_j * g[:, None]

    # At e_{j+1}: Le if it is the emitter vertex, else its BSDF toward the
    # unchanged e_{j+2} from the new incident direction.
    is_emitter = (jp1 + 1) == path["length"]
    le = _emitter_le(scene, path, jp1, -w_jj1)
    pj2 = _slot(path, "pos", (jp1 + 1).clamp_max(d - 1))
    f_j1 = _smooth_f(scene, _slot(path, "bsdf", jp1), _slot(path, "uv", jp1),
                     nj1, -w_jj1, _norm(pj2 - pj1), bsdf_types)
    w = w * torch.where(is_emitter[:, None], le, f_j1)
    w = torch.where(upto_valid[:, None], w, 0.0)
    return luminance(w), w


def _propagate(scene, params, it, rd, transmit, bsdf_types):
    """The deterministic delta bounce at ``it``: the mirror direction, or
    the refraction where the stored geometry transmits; returns (the world
    direction, total internal reflection)."""
    wi = -rd
    s_ax, t_ax, n_ax = shading_frame(params, it["ns"], wi)
    wil = to_local(s_ax, t_ax, n_ax, wi)
    refl = torch.stack([-wil[..., 0], -wil[..., 1], wil[..., 2]], -1)
    fr, cos_t, _, eta_ti = fresnel_dielectric(wil[..., 2], params["eta"])
    refr = torch.stack([-wil[..., 0] * eta_ti, -wil[..., 1] * eta_ti, cos_t],
                       -1)
    wol = torch.where(transmit[:, None], refr, refl)
    return to_world(s_ax, t_ax, n_ax, wol), fr >= 1.0 - 1e-6


def retrace_chain(scene, path: dict, spos_new, j, width: int, height: int,
                  bsdf_types, fov_axis: str = "x"):
    """Re-trace the eye prefix from a new screen position through the stored
    delta chain, slots 0..j (Mitsuba's perturbDirection +
    propagatePerturbation); the configuration must match (the same BSDF at
    every re-traced slot, no total internal reflection where the stored
    path refracts). Returns (the path with slots 0..j replaced, ok)."""
    n = spos_new.shape[0]
    d = path["pos"].shape[1]
    ro, rd = generate_rays(scene, spos_new, width, height, fov_axis)
    new = dict(path)
    for f in ("pos", "ns", "ng", "uv"):
        new[f] = path[f].clone()
    new["spos"] = spos_new
    ok = torch.ones(n, dtype=torch.bool, device=spos_new.device)
    for i in range(d):
        step_active = i <= j
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        same = hit["valid"] & (it["bsdf"] == path["bsdf"][:, i])
        ok = ok & torch.where(step_active, same, True)
        upd = (step_active & ok)[:, None]
        for f, v in (("pos", it["p"]), ("ns", it["ns"]), ("ng", it["ng"]),
                     ("uv", it["uv"][..., :2])):
            new[f][:, i] = torch.where(upd, v, new[f][:, i])
        if i + 1 >= d:
            break
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        # Transmission as the stored geometry at slot i has it.
        prev_src = path["pos"][:, i - 1] if i > 0 else _cam(scene, n)
        wi_src = _norm(prev_src - path["pos"][:, i])
        wo_src = _norm(path["pos"][:, i + 1] - path["pos"][:, i])
        transmit = ((wi_src * path["ns"][:, i]).sum(-1)
                    * (wo_src * path["ns"][:, i]).sum(-1)) < 0.0
        wo_world, tir = _propagate(scene, params, it, rd, transmit,
                                   bsdf_types)
        ok = ok & torch.where(step_active & (i < j) & transmit, ~tir, True)
        ro = spawn(it["p"], it["ng"], wo_world)
        rd = torch.where((i < j)[:, None], wo_world, rd)
    return new, ok


def project_to_screen(scene, p, width: int, height: int, fov_axis: str = "x"):
    """World points → (screen xy [N, 2], in front, cos³θ, distance): the
    inverse of the perspective generate_rays."""
    rot = scene.cam_to_world[:3, :3]
    rel = p - scene.cam_to_world[:3, 3]
    d_cam = rel @ rot  # R^T (p - o)
    z = d_cam[..., 2]
    in_front = z > 1e-6
    aspect = width / height
    tan_half = scene.cam_tan_half_fov
    tx = tan_half if fov_axis == "x" else tan_half * aspect
    ty = tan_half / aspect if fov_axis == "x" else tan_half
    zs = torch.where(in_front, z, 1.0)
    px = (1.0 - d_cam[..., 0] / (zs * tx)) * 0.5 * width
    py = (1.0 - d_cam[..., 1] / (zs * ty)) * 0.5 * height
    dist = torch.sqrt((rel * rel).sum(-1).clamp_min(1e-20))
    cos_cam = zs / dist
    return torch.stack([px, py], -1), in_front, cos_cam ** 3, dist


def _second_connectable(path):
    """The caustic structure: slot 0 (e_1) connectable, slots 1..m-1 delta,
    slot m connectable and interior. Returns (m, ok)."""
    d = path["delta"].shape[1]
    ar = torch.arange(d, device=path["delta"].device)[None, :]
    conn = ~path["delta"] & (ar < path["length"][:, None]) & (ar >= 1)
    m = conn.to(torch.int8).argmax(1)
    ok = ~path["delta"][:, 0] & conn.any(1) & ((m + 1) < path["length"])
    return m, ok


def retrace_down(scene, path: dict, m, wo_new, bsdf_types):
    """Re-trace from vertex e_m along wo_new down the stored delta chain,
    replacing slots m-1..0 (Mitsuba's mut_caustic.cpp:126-158); the
    configuration must match as in retrace_chain. Returns (path, ok)."""
    n = wo_new.shape[0]
    d = path["pos"].shape[1]
    new = dict(path)
    for f in ("pos", "ns", "ng", "uv"):
        new[f] = path[f].clone()
    ok = torch.ones(n, dtype=torch.bool, device=wo_new.device)
    ro = spawn(_slot(path, "pos", m), _slot(path, "ng", m), wo_new)
    rd = wo_new
    for step in range(d - 1):
        slot = m - 1 - step
        step_active = slot >= 0
        sl = slot.clamp_min(0)
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        same = hit["valid"] & (it["bsdf"] == _slot(path, "bsdf", sl))
        ok = ok & torch.where(step_active, same, True)
        upd = (step_active & ok)[:, None]
        for f, v in (("pos", it["p"]), ("ns", it["ns"]), ("ng", it["ng"]),
                     ("uv", it["uv"][..., :2])):
            merged = torch.where(upd, v, _slot(new, f, sl))
            idx = sl.long().reshape(-1, 1, 1).expand(-1, 1, v.shape[-1])
            new[f] = new[f].scatter(1, idx, merged[:, None])
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=bsdf_types)
        # Transmission as the stored geometry at this slot has it.
        pos_src = _slot(path, "pos", sl)
        ns_src = _slot(path, "ns", sl)
        wi_src = _norm(_slot(path, "pos", (sl + 1).clamp_max(d - 1))
                       - pos_src)
        wo_src = _norm(_slot(path, "pos", (sl - 1).clamp_min(0)) - pos_src)
        transmit = ((wi_src * ns_src).sum(-1) * (wo_src * ns_src).sum(-1)
                    ) < 0.0
        wo_world, tir = _propagate(scene, params, it, rd, transmit,
                                   bsdf_types)
        ok = ok & torch.where(step_active & (slot > 0) & transmit, ~tir, True)
        ro = spawn(it["p"], it["ng"], wo_world)
        rd = torch.where((slot > 0)[:, None], wo_world, rd)
    return new, ok


def caustic_respan(scene, path: dict, m, valid, width: int, height: int,
                   bsdf_types, fov_axis: str = "x"):
    """The caustic mutation's respan weight: f_m·cos(ns_m, ω_out) ·
    Π_{i=m-1..1}[w_i·cos(ns_i, ω_out)] · f_1 · d_cam²·cos³θ_cam /
    cos(ns_1, ω_cam). Returns (lum, rgb)."""
    n = path["length"].shape[0]
    d = path["pos"].shape[1]
    pm = _slot(path, "pos", m)
    nsm = _slot(path, "ns", m)
    wo_m = _norm(_slot(path, "pos", (m - 1).clamp_min(0)) - pm)
    wi_m = _norm(_slot(path, "pos", (m + 1).clamp_max(d - 1)) - pm)
    f_m = _smooth_f(scene, _slot(path, "bsdf", m), _slot(path, "uv", m), nsm,
                    wi_m, wo_m, bsdf_types)
    w = f_m * (nsm * wo_m).sum(-1).abs()[:, None]
    # The delta chain, slots m-1..1.
    for i in range(d - 2, 0, -1):
        active = (i < m) & valid
        pos_i = path["pos"][:, i]
        wo = _norm(path["pos"][:, i - 1] - pos_i)
        val = _delta_value(scene, path["bsdf"][:, i], path["uv"][:, i],
                           path["ns"][:, i], _norm(path["pos"][:, i + 1]
                                                   - pos_i), wo, bsdf_types)
        cos_out = (path["ns"][:, i] * wo).sum(-1).abs()
        w = torch.where(active[:, None], w * val * cos_out[:, None], w)
    # The camera-visible vertex e_1 (slot 0) and the screen Jacobian.
    p1 = path["pos"][:, 0]
    ns1 = path["ns"][:, 0]
    wo_cam = _norm(_cam(scene, n) - p1)
    f_1 = _smooth_f(scene, path["bsdf"][:, 0], path["uv"][:, 0], ns1,
                    _norm(path["pos"][:, 1] - p1), wo_cam, bsdf_types)
    _, in_front, cos3, dist = project_to_screen(scene, p1, width, height,
                                                fov_axis)
    jac = dist * dist * cos3 / (ns1 * wo_cam).sum(-1).abs().clamp_min(1e-9)
    w = w * f_1 * jac[:, None]
    w = torch.where((valid & in_front)[:, None], w, 0.0)
    return luminance(w), w


def _inside(spos, width, height):
    return ((spos[:, 0] > 0) & (spos[:, 0] < width) & (spos[:, 1] > 0)
            & (spos[:, 1] < height))


def _chain_length(path, m, n):
    """Σ_{i<m} |e_{i+1} - e_i| of the stored positions."""
    out = torch.zeros(n, device=path["pos"].device)
    for i in range(path["pos"].shape[1] - 1):
        seg = torch.sqrt(((path["pos"][:, i + 1] - path["pos"][:, i]) ** 2
                          ).sum(-1).clamp_min(1e-12))
        out = out + torch.where(i < m, seg, 0.0)
    return out


def step_shapes(n: int, max_depth: int, n_steps: int) -> dict:
    """The uniforms mlt_chain_step draws for n chains: each step's mutation
    pick, the large step's screen position and walk, the lens and caustic
    offsets and the acceptance."""
    return {"sel": (n_steps, n), "large_spos": (n_steps, n, 2),
            "large_walk": (n_steps, max_depth, n, 4),
            "lens": (n_steps, n, 2), "caustic": (n_steps, n, 2),
            "accept": (n_steps, n)}


def mlt_chain_step(scene, paths: dict, generator, width: int, height: int,
                   max_depth: int, bsdf_types: tuple, fov_axis: str = "x",
                   n_steps: int = 8, rand: dict | None = None,
                   device="cuda"):
    """Advance every chain n_steps mutations. ``rand``: the dict of
    step_shapes(N, max_depth, n_steps). Returns (paths, the splats' screen
    positions [n_steps · 2N, 2] and values [n_steps · 2N, 3], the large
    steps' W sum and count for the normalisation)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    n = paths["length"].shape[0]
    u = uniforms(rand, generator, step_shapes(n, max_depth, n_steps), dev)
    cam = _cam(scene, n)
    size = torch.tensor([float(width), float(height)], device=dev)
    rad_per_pixel = 2.0 * scene.cam_tan_half_fov / width

    def do_large(paths, s):
        prop = trace_path_record(scene, None, u["large_spos"][s] * size,
                                 width, height, max_depth, bsdf_types,
                                 fov_axis, rand=u["large_walk"][s],
                                 device=dev)
        a = torch.where(
            paths["wlum"] > 0.0,
            (prop["wlum"] / paths["wlum"].clamp_min(1e-30)).clamp_max(1.0),
            torch.where(prop["valid"], 1.0, 0.0))
        return prop, a, prop["wlum"]

    def do_lens(paths, s):
        r2 = math.sqrt(LENS_AREA * width * height / math.pi)
        ul = u["lens"][s]
        r = r2 * torch.exp(math.log(LENS_R1 / r2) * ul[:, 0])
        phi = 2.0 * math.pi * ul[:, 1]
        spos_new = paths["spos"] + torch.stack(
            [r * torch.cos(phi), r * torch.sin(phi)], -1)
        j, has_j = _first_connectable(paths)
        # Suitable: e_j and e_{j+1} exist; e_{j+1} connectable or the
        # emitter vertex.
        jp1_in = (j + 1) < paths["length"]
        jp1_conn = ~_slot(paths, "delta", torch.minimum(
            j + 1, paths["length"].long() - 1)) | ((j + 2) == paths["length"])
        suitable = (paths["valid"] & has_j & jp1_in & jp1_conn
                    & _inside(spos_new, width, height))
        prop, ok = retrace_chain(scene, paths, spos_new, j, width, height,
                                 bsdf_types, fov_axis)
        pj = _slot(prop, "pos", j)
        ngj = _slot(prop, "ng", j)
        _, dir_jj1, dist = _geom(pj, ngj, _slot(prop, "pos", j + 1),
                                 _slot(prop, "ns", j + 1))
        valid = suitable & ok & ~_occluded(scene, pj, ngj, dir_jj1, dist)
        lum_y, _ = lens_respan(scene, prop, j, valid, bsdf_types)
        lum_x, _ = lens_respan(scene, paths, j, suitable, bsdf_types)
        a = torch.where(valid & (lum_x > 0.0),
                        (lum_y / lum_x.clamp_min(1e-30)).clamp_max(1.0), 0.0)
        prop["valid"] = paths["valid"]
        prop["length"] = paths["length"]
        # The proposal's W and colour from its geometry, so that later
        # large-step acceptances compare like with like.
        wl, rgb = path_pt_weight(scene, prop, bsdf_types)
        prop["wlum"] = torch.where(valid, wl, paths["wlum"])
        prop["rgb"] = torch.where(valid[:, None], rgb, paths["rgb"])
        return prop, torch.where(wl > 0.0, a, 0.0)

    def do_caustic(paths, s):
        m, ok_struct = _second_connectable(paths)
        suitable = paths["valid"] & ok_struct
        # Veach's heuristic angle scaling: the eye edge's length over the
        # chain's.
        len_e = torch.sqrt(((paths["pos"][:, 0] - cam) ** 2).sum(-1)
                           .clamp_min(1e-12))
        factor = len_e / _chain_length(paths, m, n).clamp_min(1e-9)
        th1 = CAUSTIC_R1 * rad_per_pixel * factor
        th2 = CAUSTIC_R2 * rad_per_pixel * factor
        pm = _slot(paths, "pos", m)
        wo_src = _norm(_slot(paths, "pos", (m - 1).clamp_min(0)) - pm)
        uc = u["caustic"][s]
        theta = th2 * torch.exp(torch.log(th1 / th2.clamp_min(1e-12))
                                * uc[:, 0])
        phi = 2.0 * math.pi * uc[:, 1]
        s_ax, t_ax = coordinate_system(wo_src)
        st = torch.sin(theta)
        wo_new = (s_ax * (st * torch.cos(phi))[:, None]
                  + t_ax * (st * torch.sin(phi))[:, None]
                  + wo_src * torch.cos(theta)[:, None])
        prop, ok = retrace_down(scene, paths, m, wo_new, bsdf_types)
        # Reproject e_1' onto the film, visible from the camera.
        p1 = prop["pos"][:, 0]
        spos_new, in_front, _, dist_cam = project_to_screen(
            scene, p1, width, height, fov_axis)
        hitc = isect.intersect(scene, cam, _norm(p1 - cam))
        vis = hitc["valid"] & ((hitc["t"] - dist_cam).abs()
                               < 1e-3 * dist_cam + 1e-4)
        valid = (suitable & ok & in_front & _inside(spos_new, width, height)
                 & vis)
        # The proposal's own angle range (mut_caustic.cpp:137-141).
        len_e_y = torch.sqrt(((prop["pos"][:, 0] - cam) ** 2).sum(-1)
                             .clamp_min(1e-12))
        fac_y = len_e_y / _chain_length(prop, m, n).clamp_min(1e-9)
        valid = (valid & (theta > CAUSTIC_R1 * rad_per_pixel * fac_y)
                 & (theta < CAUSTIC_R2 * rad_per_pixel * fac_y))
        prop["spos"] = torch.where(valid[:, None], spos_new, paths["spos"])
        prop["valid"] = paths["valid"]
        prop["length"] = paths["length"]
        lum_y, _ = caustic_respan(scene, prop, m, valid, width, height,
                                  bsdf_types, fov_axis)
        lum_x, _ = caustic_respan(scene, paths, m, suitable, width, height,
                                  bsdf_types, fov_axis)
        a = torch.where(valid & (lum_x > 0.0),
                        (lum_y / lum_x.clamp_min(1e-30)).clamp_max(1.0), 0.0)
        wl, rgb = path_pt_weight(scene, prop, bsdf_types)
        prop["wlum"] = torch.where(valid, wl, paths["wlum"])
        prop["rgb"] = torch.where(valid[:, None], rgb, paths["rgb"])
        return prop, torch.where(wl > 0.0, a, 0.0)

    def pick(mask, a, b):
        return torch.where(mask.reshape(-1, *([1] * (a.ndim - 1))), a, b)

    wsum = torch.zeros((), device=dev)
    wcount = torch.zeros((), device=dev)
    pix_s, val_s = [], []
    for s in range(n_steps):
        large, a_l, w_l = do_large(paths, s)
        lens, a_lens = do_lens(paths, s)
        caustic, a_c = do_caustic(paths, s)
        sel = u["sel"][s]
        pick_large = sel < P_LARGE
        pick_lens = (sel >= P_LARGE) & (sel < P_LARGE + P_LENS)
        a = torch.where(pick_large, a_l, torch.where(pick_lens, a_lens, a_c))
        prop = {k: pick(pick_large, large[k], pick(pick_lens, lens[k],
                                                     caustic[k]))
                for k in PATH_FIELDS}
        wsum = wsum + torch.where(pick_large, w_l, 0.0).sum()
        wcount = wcount + pick_large.float().sum()

        # Expected-value splats (Veach 11.3.1): both states deposit.
        lum_cur = luminance(paths["rgb"])
        lum_prop = luminance(prop["rgb"])
        cur_color = torch.where((lum_cur > 0)[:, None], paths["rgb"]
                                / lum_cur.clamp_min(1e-30)[:, None], 0.0)
        prop_color = torch.where((lum_prop > 0)[:, None], prop["rgb"]
                                 / lum_prop.clamp_min(1e-30)[:, None], 0.0)
        pix_s += [paths["spos"], prop["spos"]]
        val_s += [cur_color * (1.0 - a)[:, None], prop_color * a[:, None]]
        accept = u["accept"][s] < a
        paths = {k: pick(accept, prop[k], paths[k]) for k in PATH_FIELDS}
    return paths, torch.cat(pix_s), torch.cat(val_s), wsum, wcount


def render_mlt(scene, cfg, spp: int = 16, seed: int = 1234,
               n_chains: int = 8192, bsdf_types: tuple | None = None,
               device="cuda") -> dict:
    """Render with path-space MLT: b = E[W] from path-traced bootstrap
    paths, which also seed the chains ∝ W; rounds of 8 mutations a chain
    until spp · W · H mutations; b refreshed with the run's large steps.
    Returns dict(image [H, W, 3] float32 numpy, b); b = 0 and a black image
    when no bootstrap path reaches an emitter (an environment-lit scene)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    width, height = cfg.width, cfg.height
    n_pix = width * height
    bsdf_types = tuple(bsdf_types or cfg.bsdf_types)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.max_depth
    size = torch.tensor([float(width), float(height)], device=dev)

    n_boot = max(n_chains * 4, 1 << 15)
    spos = torch.rand((n_boot, 2), generator=gen, device=dev) * size
    boot = trace_path_record(scene, gen, spos, width, height, d, bsdf_types,
                             cfg.fov_axis, device=dev)
    w = boot["wlum"]
    b = float(w.mean())
    if b <= 0.0:
        return {"image": np.zeros((height, width, 3), np.float32), "b": 0.0}
    idx = torch.multinomial(w.clamp_min(1e-30), n_chains, replacement=True,
                            generator=gen)
    paths = {k: v[idx] for k, v in boot.items()}
    del boot

    steps_per_round = 8
    rounds = max(1, n_pix * spp // (n_chains * steps_per_round))
    film = torch.zeros((n_pix, 3), device=dev)
    wsum_t = torch.zeros((), dtype=torch.float64, device=dev)
    wcount_t = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(rounds):
        paths, pix_s, val_s, wsum, wcount = mlt_chain_step(
            scene, paths, gen, width, height, d, bsdf_types, cfg.fov_axis,
            n_steps=steps_per_round, device=dev)
        px = pix_s[:, 0].to(torch.int32).clamp(0, width - 1)
        py = pix_s[:, 1].to(torch.int32).clamp(0, height - 1)
        film.index_add_(0, (py * width + px).long(), val_s)
        wsum_t += wsum
        wcount_t += wcount

    # b refreshed with the run's large steps (more samples than the
    # bootstrap's).
    wsum_t, wcount_t = float(wsum_t), float(wcount_t)
    if wcount_t > 0:
        b = 0.5 * b + 0.5 * (wsum_t / wcount_t)
    n_mut = rounds * steps_per_round * n_chains
    img = film.reshape(height, width, 3).cpu().numpy()
    img = img * (b * n_pix / max(n_mut, 1))
    return {"image": img.astype(np.float32), "b": b}
