"""The bidirectional path tracer with the balance heuristic over every
strategy (port of sdmm_tpu/render/bdpt.py).

Two vectorised random walks give dense vertex arrays [N, V, ...]: the eye
subpath from the camera and the light subpath from a point on an area
emitter. A Python loop then evaluates every (s, t) strategy over the whole
wave: s = 0 (the eye path hits an emitter, or the environment with weight
1), s = 1 (a fresh emitter sample joined to eye vertex t − 1), t = 1 (light
vertex s − 1 joined to the camera, splatted into a shared light image by
``index_add_``) and the s, t ≥ 2 connections, each weighted by PBRT's
balance heuristic. The (1, 1) strategy is never executed, so s + t = 2
has weight 1. Light subpaths start on area emitters only: delta lights and
environment maps start none (as in the reference).

The connections evaluate BSDFs at stored vertices; each stored vertex's
parameters are gathered once per wave and reused (the reference gathers
them again for every connection; the values are the same). Sampling
functions take their uniforms (``rand``) or draw them from a
``torch.Generator``; every entry point runs on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bsdf import bsdf as bsdf_mod
from ..core import warp
from ..core.device import resolve_device
from ..core.frame import coordinate_system, to_local, to_world
from ..scene import emitters
from ..scene.scene import scene_to
from ..scene.sensor import generate_rays
from . import intersect as isect
from .ptracer import camera_connect, uniforms
from .volpath import RAY_EPS, shading_frame, spawn


def _convert(pdf_dir, from_p, to_p, to_n):
    """Solid-angle pdf at from_p → area pdf at to_p."""
    d = to_p - from_p
    r2 = (d * d).sum(-1)
    r = torch.sqrt(r2.clamp_min(1e-20))
    cos_t = ((to_n * d).sum(-1) / r).abs()
    return pdf_dir * cos_t / r2.clamp_min(1e-20)


def _eval(params, ns, wi_world, wo_world, types):
    """(f·cos, pdf) at a stored vertex for arbitrary directions, in the
    shading frame turned to ``wi_world``'s side."""
    s_ax, t_ax, n_ax = shading_frame(params, ns, wi_world)
    return bsdf_mod.eval_pdf_full(params, to_local(s_ax, t_ax, n_ax,
                                                   wi_world),
                                  to_local(s_ax, t_ax, n_ax, wo_world),
                                  types=types)


class _Vertices:
    """A subpath's arrays with each stored vertex's BSDF parameters
    gathered on first use."""

    def __init__(self, scene, arrays: dict, types):
        self.a = arrays
        self.scene = scene
        self.types = types
        self._params = {}

    def __getitem__(self, k):
        return self.a[k]

    def params(self, i):
        if i not in self._params:
            self._params[i] = bsdf_mod.gather_params(
                self.scene, self.a["bsdf"][:, i], self.a["uv"][:, i],
                types=self.types)
        return self._params[i]

    def bsdf_f(self, i, wi_world, wo_world):
        """f·cos at stored vertex i (wi: toward the previous vertex)."""
        return _eval(self.params(i), self.a["ns"][:, i], wi_world, wo_world,
                     self.types)[0]

    def bsdf_pdf(self, i, wi_world, wo_world):
        """The scattering pdf at stored vertex i."""
        return _eval(self.params(i), self.a["ns"][:, i], wi_world, wo_world,
                     self.types)[1]


def _walk(scene, ro, rd, beta0, pdf_dir0, n_verts: int, types,
          u: torch.Tensor) -> dict:
    """A random walk storing vertices 1..n_verts (0, the origin, is not
    stored), on the uniforms ``u`` [n_verts, N, 4] (u0, u1, u2 of each
    BSDF sample). Returns dict of [N, n_verts, ...]: p, ns, ng, bsdf, uv,
    wi (unit, toward the previous vertex), beta (the throughput up to this
    vertex's arrival), pdf_fwd and pdf_rev (area measure; pdf_rev
    backfilled one step behind), pdf_rev_dir_to_prev, prev_p, delta (the
    bounce that left this vertex was delta), prev_delta, vdelta (the BSDF
    is delta only), valid, miss_env, emitter (the hit triangle's emitter
    id, -1 for none) and tri."""
    n = ro.shape[0]
    dev = ro.device
    recs = []
    beta, pdf_dir = beta0, pdf_dir0
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_p = ro
    prev_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(n_verts):
        w = u[i]
        hit = isect.intersect(scene, ro, rd)
        it = isect.surface_interaction(scene, ro, rd, hit)
        entered = active
        active = active & hit["valid"]
        pdf_fwd = _convert(pdf_dir, prev_p, it["p"], it["ns"])
        params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"],
                                        types=types)
        s_ax, t_ax, n_ax = shading_frame(params, it["ns"], -rd)
        wi_local = to_local(s_ax, t_ax, n_ax, -rd)
        bs = bsdf_mod.sample_full(params, wi_local, w[:, 0], w[:, 1],
                                  w[:, 2:4], types=types)
        wo_world = to_world(s_ax, t_ax, n_ax, bs["wo"])
        # The reverse pdf of sampling the previous vertex from here.
        _, pdf_rev_dir = bsdf_mod.eval_pdf_full(params, bs["wo"], wi_local,
                                                types=types)
        recs.append({
            "p": it["p"], "ns": it["ns"], "ng": it["ng"],
            "bsdf": it["bsdf"], "uv": it["uv"][..., :2], "wi": -rd,
            "beta": beta, "pdf_fwd": pdf_fwd,
            "pdf_rev_dir_to_prev": pdf_rev_dir, "prev_p": prev_p,
            "delta": bs["delta"], "prev_delta": prev_delta,
            "vdelta": bsdf_mod.is_delta_only(params), "valid": active,
            "miss_env": entered & ~hit["valid"],
            "emitter": torch.where(hit["valid"], scene.tri_emitter[
                hit["tri"].long().clamp_min(0)], -1),
            "tri": hit["tri"],
        })
        beta = beta * bs["weight"]
        active = active & (bs["weight"] > 0.0).any(-1)
        prev_p = it["p"]
        prev_delta = bs["delta"]
        ro = spawn(it["p"], it["ng"], wo_world)
        rd = wo_world
        pdf_dir = bs["pdf"]

    out = {k: torch.stack([r[k] for r in recs], 1) for k in recs[0]}
    # Backfill pdf_rev in area measure: vertex i's reverse pdf is the pdf
    # of sampling it from vertex i + 1.
    pdf_rev = [torch.zeros(n, device=dev) for _ in range(n_verts)]
    for i in range(n_verts - 1):
        pdf_rev[i] = _convert(out["pdf_rev_dir_to_prev"][:, i + 1],
                              out["p"][:, i + 1], out["p"][:, i],
                              out["ns"][:, i])
    out["pdf_rev"] = torch.stack(pdf_rev, 1)
    return out


def _remap0(x):
    """Zero pdfs → 1, so that delta segments drop out of the ratios (PBRT's
    remap0)."""
    return torch.where(x > 0, x, 1.0)


def _mis_weight(ev, lv, s: int, t: int, pt_rev, ptm_rev, qs_rev, qsm_rev):
    """The balance-heuristic weight of strategy (s, t) over the wave. Eye
    vertex j ≥ 1 is ev index j − 1 (the camera is not stored; it is never
    delta); light vertex j is lv index j (0 the emitter point).
    pt_rev, ptm_rev, qs_rev and qsm_rev are the connection's reverse area
    pdfs of eye[t − 1], eye[t − 2], light[s − 1] and light[s − 2] (None out
    of range). PBRT's MISWeight."""
    n = ev["p"].shape[0]
    dev = ev["p"].device
    if s + t == 2:
        # The directly visible light: (1, 1) is never executed, so (0, 2)
        # carries the whole weight.
        return torch.ones(n, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    sum_ri = torch.zeros(n, device=dev)

    def ev_delta(i):  # the vertex's BSDF is delta only
        return ev["vdelta"][:, i - 1]

    ri = torch.ones(n, device=dev)
    for i in range(t - 1, 0, -1):
        rev = pt_rev if i == t - 1 else (ptm_rev if i == t - 2
                                         else ev["pdf_rev"][:, i - 1])
        ri = ri * _remap0(rev) / _remap0(ev["pdf_fwd"][:, i - 1])
        d_i = no if i == t - 1 else ev_delta(i)
        d_prev = ev_delta(i - 1) if i - 1 >= 1 else no
        sum_ri = sum_ri + torch.where(d_i | d_prev, 0.0, ri)

    ri = torch.ones(n, device=dev)
    for i in range(s - 1, -1, -1):
        rev = qs_rev if i == s - 1 else (qsm_rev if i == s - 2
                                         else lv["pdf_rev"][:, i])
        ri = ri * _remap0(rev) / _remap0(lv["pdf_fwd"][:, i])
        d_i = no if i == s - 1 else lv["vdelta"][:, i]
        d_prev = lv["vdelta"][:, i - 1] if i >= 1 else no
        sum_ri = sum_ri + torch.where(d_i | d_prev, 0.0, ri)
    return 1.0 / (1.0 + sum_ri)


def _we_dir(scene, d_world, width: int, height: int, fov_axis: str):
    """The camera's direction pdf (its importance) for unit directions:
    W·H/(4·tx·ty·cos³θ) inside the frustum, 0 outside."""
    d_cam = d_world @ scene.cam_to_world[:3, :3]
    z = d_cam[..., 2]
    aspect = width / height
    tan_half = scene.cam_tan_half_fov
    if fov_axis == "x":
        tx, ty = tan_half, tan_half / aspect
    else:
        tx, ty = tan_half * aspect, tan_half
    sx = d_cam[..., 0] / z.clamp_min(1e-12) / tx
    sy = d_cam[..., 1] / z.clamp_min(1e-12) / ty
    inside = (z > 1e-6) & (sx.abs() <= 1.0) & (sy.abs() <= 1.0)
    we = (width * height) / (4.0 * tx * ty * z.clamp_min(1e-6) ** 3)
    return torch.where(inside, we, 0.0)


def _sample_light_origin(scene, u: torch.Tensor) -> dict:
    """The start vertex of light subpaths on ``u`` [N, 5] (u1, u2, u3): a
    point on an area emitter (its area pdf folded with the triangle's
    selection) and a cosine emission direction. Without area emitters
    every sample is invalid."""
    n = u.shape[0]
    dev = u.device
    m = scene.em_tri_idx.shape[0]
    if m == 0:
        z3 = torch.zeros((n, 3), device=dev)
        z = torch.zeros(n, device=dev)
        return {"p": z3, "n": z3, "d": z3, "Le": z3, "pdf_pos": z,
                "pdf_dir": z,
                "valid": torch.zeros(n, dtype=torch.bool, device=dev)}
    u1, u2, u3 = u[:, 0], u[:, 1:3], u[:, 3:5]
    sel = torch.searchsorted(scene.em_tri_cdf, u1.contiguous()).clamp(0,
                                                                     m - 1)
    tri = scene.em_tri_idx.long()[sel]
    b = warp.square_to_uniform_triangle(u2)
    p = (scene.tri_v0[tri] + b[..., 0:1] * scene.tri_e1[tri]
         + b[..., 1:2] * scene.tri_e2[tri])
    nrm = scene.tri_ng[tri]
    pdf_pos = scene.em_tri_pdf[sel] / scene.em_tri_area[sel].clamp_min(1e-20)
    le = scene.emitter_radiance[scene.tri_emitter[tri].long()]
    d_local = warp.square_to_cosine_hemisphere(u3)
    s_ax, t_ax = coordinate_system(nrm)
    d = to_world(s_ax, t_ax, nrm, d_local)
    pdf_dir = d_local[..., 2].clamp_min(0.0) / math.pi
    return {"p": p, "n": nrm, "d": d, "Le": le, "pdf_pos": pdf_pos,
            "pdf_dir": pdf_dir,
            "valid": torch.ones(n, dtype=torch.bool, device=dev)}


def _prepend_light_origin(l0: dict, lw: dict, n_light_surf: int) -> dict:
    """The light subpath's arrays with the emitter point as index 0."""
    n = l0["p"].shape[0]
    dev = l0["p"].device

    def cat(a, b):
        return torch.cat([a[:, None], b], 1)

    lv = {"p": cat(l0["p"], lw["p"]), "ns": cat(l0["n"], lw["ns"]),
          "ng": cat(l0["n"], lw["ng"]),
          "beta": cat(l0["Le"] / l0["pdf_pos"].clamp_min(1e-20)[:, None],
                      lw["beta"]),
          "pdf_fwd": cat(l0["pdf_pos"], lw["pdf_fwd"])}
    # The emitter vertex's reverse pdf: sampled back from light vertex 1.
    if n_light_surf > 0:
        rev0 = _convert(lw["pdf_rev_dir_to_prev"][:, 0], lw["p"][:, 0],
                        l0["p"], l0["n"])
    else:
        rev0 = torch.zeros(n, device=dev)
    lv["pdf_rev"] = cat(rev0, lw["pdf_rev"])
    lv["vdelta"] = cat(torch.zeros(n, dtype=torch.bool, device=dev),
                       lw["vdelta"])
    lv["valid"] = cat(l0["valid"], lw["valid"])
    lv["wi"] = cat(l0["d"] * 0, lw["wi"])
    lv["bsdf"] = cat(torch.zeros(n, dtype=lw["bsdf"].dtype, device=dev),
                     lw["bsdf"])
    lv["uv"] = cat(torch.zeros((n, 2), device=dev), lw["uv"])
    lv["prev_p"] = cat(l0["p"] * 0, lw["prev_p"])
    return lv


def _vis(scene, a, a_ng, b_p):
    """Mutual visibility a → b with normal-offset origins; returns
    (unoccluded, unit direction a → b, distance)."""
    d = b_p - a
    r = torch.sqrt((d * d).sum(-1).clamp_min(1e-20))
    dn = d / r[:, None]
    occ = isect.occluded(scene, spawn(a, a_ng, dn), dn, r * (1.0 - 1e-3))
    return ~occ, dn, r


def rand_shapes(n: int, max_depth: int) -> dict:
    """The uniforms trace_bdpt draws for a wave of n: the eye walk's and
    the light walk's u0, u1, u2 per vertex, the light origin's u1, u2, u3,
    and each s = 1 strategy's (t = 2..max_depth) fresh emitter sample."""
    return {"eye": (max_depth, n, 4), "light_origin": (n, 5),
            "light": (max_depth - 1, n, 4), "s1": (max_depth - 1, n, 5)}


def trace_bdpt(scene, generator, pix_xy: torch.Tensor, width: int,
               height: int, max_depth: int = 6,
               bsdf_types: tuple | None = None, fov_axis: str = "x",
               rand: dict | None = None, device="cuda"):
    """Every BDPT strategy for one wave of pixel samples ``pix_xy`` [N, 2].
    ``rand``: the dict of rand_shapes(N, max_depth). Returns (li [N, 3],
    the t ≥ 2 strategies, owned by the sample's pixel; splat [W·H, 3], the
    t = 1 strategies, for the caller to normalise over all light
    subpaths)."""
    if max_depth < 2:
        raise ValueError("trace_bdpt needs max_depth >= 2")
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    pix_xy = pix_xy.to(dev)
    n = pix_xy.shape[0]
    types = bsdf_types
    u = uniforms(rand, generator, rand_shapes(n, max_depth), dev)

    # The eye subpath: the camera is vertex 0, surfaces 1..max_depth.
    ro, rd = generate_rays(scene, pix_xy, width, height, fov_axis)
    we0 = _we_dir(scene, rd, width, height, fov_axis)
    ev = _Vertices(scene, _walk(scene, ro, rd, torch.ones((n, 3), device=dev),
                                we0, max_depth, types, u["eye"]), types)
    cam_p = scene.cam_to_world[:3, 3].expand(n, 3)

    # The light subpath: the emitter point is vertex 0, surfaces
    # 1..max_depth − 1.
    l0 = _sample_light_origin(scene, u["light_origin"])
    n_light_surf = max_depth - 1
    beta1 = l0["Le"] * (math.pi / l0["pdf_pos"].clamp_min(1e-20))[:, None]
    lw = _walk(scene, l0["p"] + l0["n"] * RAY_EPS, l0["d"], beta1,
               l0["pdf_dir"], n_light_surf, types, u["light"])
    lv = _Vertices(scene, _prepend_light_origin(l0, lw, n_light_surf), types)
    pdf_over_area = emitters.tri_pdf_over_area(scene)

    li = torch.zeros((n, 3), device=dev)
    splat = torch.zeros((width * height, 3), device=dev)
    zero = torch.zeros(n, device=dev)

    # s = 0: the eye path alone (the environment on a miss, weight 1).
    for t in range(2, max_depth + 2):
        i = t - 2  # the ev index of eye vertex t − 1
        # The environment: no competing strategy (light walks never start
        # at infinity), so weight 1.
        li = li + torch.where(ev["miss_env"][:, i][:, None],
                              ev["beta"][:, i]
                              * emitters.env_eval(scene, -ev["wi"][:, i]),
                              0.0)
        em_id = ev["emitter"][:, i]
        on_em = ev["valid"][:, i] & (em_id >= 0)
        front = (ev["ns"][:, i] * ev["wi"][:, i]).sum(-1) > 0
        c = ev["beta"][:, i] * scene.emitter_radiance[em_id.long()
                                                      .clamp_min(0)]
        # MIS: the emitter point could have been the light path's origin
        # (pt_rev, its position pdf) emitting toward the previous vertex
        # (ptm_rev).
        pt_rev = pdf_over_area[ev["tri"][:, i].long().clamp_min(0)]
        cos_e = (ev["ns"][:, i] * ev["wi"][:, i]).sum(-1).clamp_min(0.0)
        if i >= 1:
            ptm_rev = _convert(cos_e / math.pi, ev["p"][:, i],
                               ev["prev_p"][:, i], ev["ns"][:, i - 1])
        else:
            # The previous vertex is the camera, which never enters the
            # walk.
            ptm_rev = zero
        w = _mis_weight(ev, lv, 0, t, pt_rev, ptm_rev, None, None)
        li = li + torch.where((on_em & front)[:, None], c * w[:, None], 0.0)

    # s = 1: a fresh emitter sample joined to eye vertex t − 1.
    if scene.em_tri_idx.shape[0] > 0:
        for t in range(2, max_depth + 1):
            i = t - 2
            y = _sample_light_origin(scene, u["s1"][t - 2])
            ok, d_xy, r = _vis(scene, ev["p"][:, i], ev["ng"][:, i],
                               y["p"])  # d_xy: eye → light
            cos_y = (y["n"] * -d_xy).sum(-1).clamp_min(0.0)
            f_pt = ev.bsdf_f(i, ev["wi"][:, i], d_xy)
            c = (ev["beta"][:, i] * f_pt * y["Le"]
                 * (cos_y / y["pdf_pos"].clamp_min(1e-20)
                    / (r * r).clamp_min(1e-20))[:, None])
            good = (ev["valid"][:, i] & y["valid"] & ok & (cos_y > 0)
                    & (c > 0).any(-1))
            qs_rev = _convert(ev.bsdf_pdf(i, ev["wi"][:, i], d_xy),
                              ev["p"][:, i], y["p"], y["n"])
            pt_rev = _convert(cos_y / math.pi, y["p"], ev["p"][:, i],
                              ev["ns"][:, i])
            if i >= 1:
                ptm_rev = _convert(ev.bsdf_pdf(i, d_xy, ev["wi"][:, i]),
                                   ev["p"][:, i], ev["prev_p"][:, i],
                                   ev["ns"][:, i - 1])
            else:
                ptm_rev = zero
            lv1 = {"pdf_fwd": y["pdf_pos"][:, None],
                   "pdf_rev": torch.zeros((n, 1), device=dev),
                   "vdelta": torch.zeros((n, 1), dtype=torch.bool,
                                         device=dev),
                   "p": y["p"][:, None]}
            w = _mis_weight(ev, lv1, 1, t, pt_rev, ptm_rev, qs_rev, None)
            li = li + torch.where(good[:, None], c * w[:, None], 0.0)

    # t = 1: light vertex s − 1 splatted through the camera.
    for s in range(2, max_depth + 1):
        j = s - 1  # the lv index of light vertex s − 1 (a surface)
        cc = camera_connect(scene, lv["p"][:, j], width, height, fov_axis)
        ok, _, _ = _vis(scene, lv["p"][:, j], lv["ng"][:, j], cam_p)
        f_qs = lv.bsdf_f(j, lv["wi"][:, j], cc["d"])
        c = lv["beta"][:, j] * f_qs * cc["we"][:, None]
        good = lv["valid"][:, j] & cc["valid"] & ok & (c > 0).any(-1)
        # MIS: the camera re-samples qs (qs_rev), qs re-samples its
        # predecessor given the camera direction (qsm_rev).
        we_q = _we_dir(scene, -cc["d"], width, height, fov_axis)
        qs_rev = _convert(we_q, cam_p, lv["p"][:, j], lv["ns"][:, j])
        qsm_rev = _convert(lv.bsdf_pdf(j, cc["d"], lv["wi"][:, j]),
                           lv["p"][:, j], lv["prev_p"][:, j],
                           lv["ns"][:, j - 1])
        w = _mis_weight(ev, lv, s, 1, None, None, qs_rev, qsm_rev)
        splat.index_add_(0, cc["pix"].long(),
                         torch.where(good[:, None], c * w[:, None], 0.0))

    # s ≥ 2, t ≥ 2: the connections.
    for t in range(2, max_depth + 1):
        for s in range(2, max_depth + 1):
            if s + t - 1 > max_depth:
                continue
            i, j = t - 2, s - 1
            ok, d_pq, r = _vis(scene, ev["p"][:, i], ev["ng"][:, i],
                               lv["p"][:, j])  # eye → light
            f_pt = ev.bsdf_f(i, ev["wi"][:, i], d_pq)
            f_qs = lv.bsdf_f(j, lv["wi"][:, j], -d_pq)
            c = (ev["beta"][:, i] * f_pt * f_qs * lv["beta"][:, j]
                 / (r * r).clamp_min(1e-20)[:, None])
            good = (ev["valid"][:, i] & lv["valid"][:, j] & ok
                    & (c > 0).any(-1))
            qs_rev = _convert(ev.bsdf_pdf(i, ev["wi"][:, i], d_pq),
                              ev["p"][:, i], lv["p"][:, j], lv["ns"][:, j])
            pt_rev = _convert(lv.bsdf_pdf(j, lv["wi"][:, j], -d_pq),
                              lv["p"][:, j], ev["p"][:, i], ev["ns"][:, i])
            qsm_rev = _convert(lv.bsdf_pdf(j, -d_pq, lv["wi"][:, j]),
                               lv["p"][:, j], lv["prev_p"][:, j],
                               lv["ns"][:, j - 1])
            if i >= 1:
                ptm_rev = _convert(ev.bsdf_pdf(i, d_pq, ev["wi"][:, i]),
                                   ev["p"][:, i], ev["prev_p"][:, i],
                                   ev["ns"][:, i - 1])
            else:
                ptm_rev = zero
            w = _mis_weight(ev, lv, s, t, pt_rev, ptm_rev, qs_rev, qsm_rev)
            li = li + torch.where(good[:, None], c * w[:, None], 0.0)

    return (torch.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0),
            torch.nan_to_num(splat, nan=0.0, posinf=0.0, neginf=0.0))


def render_bdpt(scene, cfg, spp: int = 8, seed: int = 1234,
                rays_per_wave: int = 1 << 15, device="cuda") -> dict:
    """BDPT render: depth min(cfg.max_depth, 8); the per-pixel strategies
    averaged as the camera tracer averages, the light-image splats divided
    by the total light-subpath count and added. Waves of
    min(rays_per_wave, W·H) samples, the pixels taken in order and
    wrapped. Returns dict(image [H, W, 3] as numpy)."""
    dev = resolve_device(device)
    scene = scene_to(scene, dev)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    depth = min(cfg.max_depth, 8)
    eye_film = torch.zeros((n_pix, 3), device=dev)
    weight = torch.zeros(n_pix, device=dev)
    splat_film = torch.zeros((n_pix, 3), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wave = min(rays_per_wave, n_pix)
    n_waves = (n_pix + wave - 1) // wave
    pix = torch.arange(n_waves * wave, device=dev) % n_pix
    ones = torch.ones(wave, device=dev)
    for _ in range(spp):
        for wv in range(n_waves):
            idx = pix[wv * wave:(wv + 1) * wave]
            u = torch.rand((wave, 2), generator=gen, device=dev)
            px = (idx % w).float() + u[:, 0]
            py = (idx // w).float() + u[:, 1]
            li, sp = trace_bdpt(scene, gen, torch.stack([px, py], -1), w, h,
                                max_depth=depth,
                                bsdf_types=cfg.bsdf_types or None,
                                fov_axis=cfg.fov_axis, device=dev)
            eye_film.index_add_(0, idx, li)
            weight.index_add_(0, idx, ones)
            splat_film += sp
    total_light_paths = spp * n_waves * wave
    img = (eye_film / weight.clamp_min(1.0)[:, None]
           + splat_film / total_light_paths)
    return {"image": np.asarray(img.reshape(h, w, 3).cpu())}
