"""The Irawan & Marschner woven-cloth BRDF (port of sdmm_tpu/bsdf/irawan.py).

A weave pattern tiles the surface's uv: the hit's uv picks a yarn segment
of the tile, and the specular term integrates the fiber highlight over the
yarn's curved spine (filament yarns reflect along a cylinder, staple yarns
along twisted fibers), with a von Mises phase term and Seeliger
attenuation; a diffuse term adds kd/pi. Sampling is cosine-weighted
(``bsdf.sample``), so the pdf is the cosine pdf.

Per-yarn values are gathers over [Y]-row tables, every branch of the
curvature radius is evaluated guarded and selected by mask, and the
specular normalisation is the same 10,000-sample cosine Monte Carlo
estimate as the reference's. That estimate depends on its random draws:
``specular_normalization`` takes them (``wi``, ``wo``, ``uv``) or a
``torch.Generator``, and ``build_tables`` draws them from a CPU generator
seeded 0, so a scene built by the port carries another (equally valid)
constant than the reference's. Weave patterns load from the weave-DSL text
format with ``$parameter`` substitution, or the built-in ``PLAIN_WEAVE``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import warp

PI = math.pi
INV_PI = 1.0 / math.pi

# Yarn row layout in the [Y, 10] table.
_Y_TYPE = 0  # 0 = warp, 1 = weft
_Y_PSI = 1
_Y_UMAX = 2
_Y_KAPPA = 3
_Y_WIDTH = 4
_Y_LENGTH = 5
_Y_CU = 6
_Y_CV = 7

# Consts row layout ([12]).
_C_ALPHA = 0
_C_BETA = 1
_C_SS = 2
_C_HWIDTH = 3
_C_WARPAREA = 4
_C_WEFTAREA = 5
_C_REPEATU = 6
_C_REPEATV = 7
_C_NORM = 8

N_NORM_SAMPLES = 10_000


@dataclass
class WeavePattern:
    """A weave: global parameters, the tile of 1-based yarn ids and the
    yarns (dicts with angles in radians)."""

    name: str = ""
    alpha: float = 0.0
    beta: float = 0.0
    ss: float = 0.0
    h_width: float = 0.0
    warp_area: float = 0.0
    weft_area: float = 0.0
    tile_width: int = 1
    tile_height: int = 1
    pattern: np.ndarray = field(
        default_factory=lambda: np.ones((1, 1), np.int32))
    yarns: list = field(default_factory=list)
    repeat_u: float = 1.0
    repeat_v: float = 1.0

    def tables(self) -> dict:
        """(pattern [th, tw] int32 0-based, yarns [Y, 10], kd [Y, 3],
        ks [Y, 3], consts [12]) as numpy float32; the normalisation is 1."""
        ny = max(len(self.yarns), 1)
        y = np.zeros((ny, 10), np.float32)
        kd = np.zeros((ny, 3), np.float32)
        ks = np.zeros((ny, 3), np.float32)
        for i, yarn in enumerate(self.yarns):
            y[i, _Y_TYPE] = 0.0 if yarn["type"] == "warp" else 1.0
            y[i, _Y_PSI] = yarn.get("psi", 0.0)
            y[i, _Y_UMAX] = yarn.get("umax", 0.5)
            y[i, _Y_KAPPA] = yarn.get("kappa", 0.0)
            y[i, _Y_WIDTH] = yarn.get("width", 1.0)
            y[i, _Y_LENGTH] = yarn.get("length", 1.0)
            y[i, _Y_CU] = yarn.get("centerU", 0.5)
            y[i, _Y_CV] = yarn.get("centerV", 0.5)
            kd[i] = np.asarray(yarn.get("kd", [0.5, 0.5, 0.5]))
            ks[i] = np.asarray(yarn.get("ks", [0.5, 0.5, 0.5]))
        consts = np.zeros(12, np.float32)
        consts[_C_ALPHA] = self.alpha
        consts[_C_BETA] = self.beta
        consts[_C_SS] = self.ss
        consts[_C_HWIDTH] = self.h_width
        consts[_C_WARPAREA] = self.warp_area
        consts[_C_WEFTAREA] = self.weft_area
        consts[_C_REPEATU] = self.repeat_u
        consts[_C_REPEATV] = self.repeat_v
        consts[_C_NORM] = 1.0
        return {"pattern": np.asarray(self.pattern, np.int32) - 1,
                "yarns": y, "kd": kd, "ks": ks, "consts": consts}


# Built-in plain weave: alternating warp and weft in a 2x2 tile of staple
# cotton-like yarns (the reference's own built-in pattern).
PLAIN_WEAVE = """
weave {
    name = "Built-in plain weave",
    alpha = 0.3, beta = 4.0, ss = 0.0, hWidth = 0.6,
    warpArea = 0.5, weftArea = 0.5,
    tileWidth = 2, tileHeight = 2,
    pattern { 1, 2, 3, 4 },
    yarn { type = warp, psi = 30, umax = 40, kappa = -0.5,
           width = 1, length = 1, centerU = 0.25, centerV = 0.25,
           kd = {0.45, 0.4, 0.35}, ks = {0.4, 0.4, 0.4} },
    yarn { type = weft, psi = 30, umax = 40, kappa = -0.5,
           width = 1, length = 1, centerU = 0.75, centerV = 0.25,
           kd = {0.45, 0.4, 0.35}, ks = {0.4, 0.4, 0.4} },
    yarn { type = weft, psi = 30, umax = 40, kappa = -0.5,
           width = 1, length = 1, centerU = 0.25, centerV = 0.75,
           kd = {0.45, 0.4, 0.35}, ks = {0.4, 0.4, 0.4} },
    yarn { type = warp, psi = 30, umax = 40, kappa = -0.5,
           width = 1, length = 1, centerU = 0.75, centerV = 0.75,
           kd = {0.45, 0.4, 0.35}, ks = {0.4, 0.4, 0.4} }
}
"""


def parse_weave(text: str, params: dict | None = None) -> WeavePattern:
    """Parse the weave DSL: ``weave { key = value, ..., pattern { ints },
    yarn { ... }, ... }``, with ``/* */`` and ``//`` comments. ``$name``
    tokens resolve from ``params``; psi and umax are given in degrees."""
    params = params or {}

    def subst(tok: str):
        return params[tok[1:]] if tok.startswith("$") else tok

    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    body = text[text.index("weave") + 5:]
    body = body[body.index("{") + 1:body.rindex("}")]

    m = re.search(r"pattern\s*\{([^}]*)\}", body)
    ints = [int(subst(t.strip())) for t in m.group(1).split(",")
            if t.strip()]
    yarn_texts = re.findall(r"yarn\s*\{((?:[^{}]|\{[^}]*\})*)\}", body)
    rest = re.sub(r"pattern\s*\{[^}]*\}", "", body)
    rest = re.sub(r"yarn\s*\{(?:[^{}]|\{[^}]*\})*\}", "", rest)

    def parse_kv(block: str) -> dict:
        out = {}
        for m2 in re.finditer(
                r"(\w+)\s*=\s*(\{[^}]*\}|\"[^\"]*\"|[^,\s][^,]*)", block):
            k, v = m2.group(1), m2.group(2).strip()
            if v.startswith("{"):
                out[k] = [float(subst(x.strip()))
                          for x in v[1:-1].split(",") if x.strip()]
            elif v.startswith('"'):
                out[k] = v[1:-1]
            else:
                v = subst(v)
                try:
                    out[k] = float(v)
                except (TypeError, ValueError):
                    out[k] = v
        return out

    kv = parse_kv(rest)
    wp = WeavePattern()
    wp.name = str(kv.get("name", ""))
    wp.alpha = float(kv.get("alpha", 0.0))
    wp.beta = float(kv.get("beta", 0.0))
    wp.ss = float(kv.get("ss", 0.0))
    wp.h_width = float(kv.get("hWidth", 0.0))
    wp.warp_area = float(kv.get("warpArea", 1.0))
    wp.weft_area = float(kv.get("weftArea", 1.0))
    wp.tile_width = int(kv.get("tileWidth", 1))
    wp.tile_height = int(kv.get("tileHeight", 1))
    wp.pattern = np.asarray(ints, np.int32).reshape(wp.tile_height,
                                                    wp.tile_width)
    for yt in yarn_texts:
        yv = parse_kv(yt)
        yarn = {
            "type": str(yv.get("type", "warp")).strip(),
            "width": float(yv.get("width", 1.0)),
            "length": float(yv.get("length", 1.0)),
            "centerU": float(yv.get("centerU", 0.5)),
            "centerV": float(yv.get("centerV", 0.5)),
            "kappa": float(yv.get("kappa", 0.0)),
            "kd": yv.get("kd", [0.5, 0.5, 0.5]),
            "ks": yv.get("ks", [0.5, 0.5, 0.5]),
        }
        for k in ("psi", "umax"):
            if k in yv:
                yarn[k] = float(yv[k]) * PI / 180.0
        wp.yarns.append(yarn)
    return wp


def _von_mises(cos_x, b):
    """exp(b cos x) / (2 pi I0(b)), I0 by the Abramowitz & Stegun
    polynomials."""
    ab = b.abs()
    ts = (ab / 3.75) ** 2
    i0_small = 1.0 + ts * (3.5156229 + ts * (3.0899424 + ts * (
        1.2067492 + ts * (0.2659732 + ts * (0.0360768 + ts * 0.0045813)))))
    tb = 3.75 / ab.clamp_min(1e-6)
    i0_big = torch.exp(ab) / torch.sqrt(ab.clamp_min(1e-6)) * (
        0.39894228 + tb * (0.01328592 + tb * (0.00225319 + tb * (
            -0.00157565 + tb * (0.00916281 + tb * (-0.02057706 + tb * (
                0.02635537 + tb * (-0.01647633 + tb * 0.00392377))))))))
    i0 = torch.where(ab <= 3.75, i0_small, i0_big)
    return torch.exp(b * cos_x) / (2.0 * PI * i0)


def _seeliger(c1, c2):
    c1 = c1.clamp_min(0.0)
    c2 = c2.clamp_min(0.0)
    ok = (c1 > 0.0) & (c2 > 0.0)
    return torch.where(ok, c1 * c2 / (4.0 * PI * (c1 + c2)).clamp_min(1e-12),
                       0.0)


def _radius_of_curvature(u, umax, kappa, w, l):
    """The yarn spine's radius of curvature at u: a circle, an ellipse, a
    hyperbola or a parabola by rhat, each evaluated guarded."""
    rhat = 1.0 + kappa * (1.0 + 1.0 / torch.tan(umax))
    a = 0.5 * w
    sin_umax = torch.sin(umax)
    r_circle = (0.5 * l - a * sin_umax) / sin_umax.clamp_min(1e-6)

    rhat_e = torch.where(rhat.abs() > 1e-6, rhat, 1.0)
    tmax_e = torch.atan(rhat_e * torch.tan(umax))
    s_te = torch.sin(tmax_e)
    bhat_e = (0.5 * l - a * sin_umax) / s_te.abs().clamp_min(1e-6) \
        * torch.sign(s_te)
    ahat_e = bhat_e / rhat_e
    t_e = torch.atan(rhat_e * torch.tan(u))
    r_ellipse = torch.pow(
        (bhat_e ** 2 * torch.cos(t_e) ** 2
         + ahat_e ** 2 * torch.sin(t_e) ** 2).clamp_min(0.0), 1.5
    ) / (ahat_e * bhat_e).abs().clamp_min(1e-12) * torch.sign(ahat_e * bhat_e)

    arg_h = (rhat_e * torch.tan(umax)).clamp(-0.999999, 0.999999)
    tmax_h = -torch.atanh(arg_h)
    sinh_t = torch.sinh(tmax_h)
    bhat_h = (0.5 * l - a * sin_umax) / torch.where(sinh_t.abs() > 1e-6,
                                                    sinh_t, 1e-6)
    ahat_h = bhat_h / rhat_e
    t_h = -torch.atanh((rhat_e * torch.tan(u)).clamp(-0.999999, 0.999999))
    ab_h = ahat_h * bhat_h
    r_hyper = -torch.pow(
        (bhat_h ** 2 * torch.cosh(t_h) ** 2
         + ahat_h ** 2 * torch.sinh(t_h) ** 2).clamp_min(0.0), 1.5
    ) / torch.where(ab_h.abs() > 1e-12, ab_h, 1e-12)

    tmax_p = torch.tan(umax)
    ahat_p = (0.5 * l - a * sin_umax) / (2.0 * tmax_p).clamp_min(1e-6)
    t_p = torch.tan(u)
    r_par = 2.0 * ahat_p * torch.pow(1.0 + t_p * t_p, 1.5)

    return torch.where((rhat - 1.0).abs() < 1e-6, r_circle,
                       torch.where(rhat > 1e-6, r_ellipse,
                                   torch.where(rhat < -1e-6, r_hyper, r_par)))


def _clip(x, lo, hi):
    """min(max(x, lo), hi): hi wins where lo > hi, as in numpy's clip."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _half(wi, wo):
    h = wi + wo
    return h / torch.linalg.vector_norm(h, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def _filament_integrand(u, v, wi, wo, alpha, beta, ss, umax, kappa, w, l,
                        h_width):
    h = _half(wi, wo)
    u_of_v = torch.atan(h[..., 1] / h[..., 2].abs().clamp_min(1e-9)
                        * torch.sign(h[..., 2]))
    in_range = u_of_v.abs() < umax
    nx = torch.sin(v)
    ny = torch.sin(u_of_v) * torch.cos(v)
    nz = torch.cos(u_of_v) * torch.cos(v)
    ty = torch.cos(u_of_v)
    tz = -torch.sin(u_of_v)
    r_c = _radius_of_curvature(
        torch.minimum(u_of_v.abs(), (1.0 - ss) * umax), (1.0 - ss) * umax,
        kappa, w, l)
    a = 0.5 * w
    sum_len = torch.linalg.vector_norm(wi + wo, dim=-1)
    # t x h with t = (0, ty, tz): x component = ty*hz - tz*hy.
    t_cross_h_x = ty * h[..., 2] - tz * h[..., 1]
    gu = a * (r_c + a * torch.cos(v)) / (
        sum_len * t_cross_h_x.abs()).clamp_min(1e-9)
    fc = alpha + _von_mises(-(wi * wo).sum(-1), beta)
    att = _seeliger(nx * wi[..., 0] + ny * wi[..., 1] + nz * wi[..., 2],
                    nx * wo[..., 0] + ny * wo[..., 1] + nz * wo[..., 2])
    sm = ((u_of_v.abs() - (1.0 - ss) * umax)
          / (ss * umax).clamp_min(1e-9)).clamp(0.0, 1.0)
    smoothstep = sm * sm * (3.0 - 2.0 * sm)
    att = torch.where(ss > 0.0, att * (1.0 - smoothstep), att)
    fs = gu * fc * att * PI * l
    delta_y = l * h_width
    y_of_v = _clip(u_of_v * 0.5 * l / umax, 0.5 * (delta_y - l),
                   0.5 * (l - delta_y))
    hit_band = (y_of_v - u * 0.5 * l / umax).abs() < 0.5 * delta_y
    valid = (in_range & hit_band & (w * torch.sin(umax) < l)
             & (kappa >= -1.0) & (ss >= 0.0) & (ss < 1.0))
    return torch.where(valid, fs / delta_y.clamp_min(1e-9), 0.0)


def _staple_integrand(u, v, wi, wo, alpha, beta, psi, umax, kappa, w, l,
                      h_width):
    h = _half(wi, wo)
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    denom = torch.sqrt((hx * hx + (hy * torch.sin(u) + hz * torch.cos(u))
                        ** 2).clamp_min(1e-12)) * torch.tan(psi)
    d = (hy * torch.cos(u) - hz * torch.sin(u)) / denom.abs().clamp_min(
        1e-9) * torch.sign(denom)
    v_of_u = torch.atan2(-hy * torch.sin(u) - hz * torch.cos(u), hx) \
        + torch.acos(d.clamp(-1.0, 1.0))
    in_range = (d.abs() < 1.0) & (v_of_u.abs() < PI / 2.0)
    nx = torch.sin(v_of_u)
    ny = torch.sin(u) * torch.cos(v_of_u)
    nz = torch.cos(u) * torch.cos(v_of_u)
    r_c = _radius_of_curvature(u.abs(), umax, kappa, w, l)
    a = 0.5 * w
    sum_len = torch.linalg.vector_norm(wi + wo, dim=-1)
    ndoth = nx * hx + ny * hy + nz * hz
    gv = a * (r_c + a * torch.cos(v_of_u)) / (
        sum_len * ndoth.abs() * torch.sin(psi).abs()).clamp_min(1e-9)
    fc = alpha + _von_mises(-(wi * wo).sum(-1), beta)
    att = _seeliger(nx * wi[..., 0] + ny * wi[..., 1] + nz * wi[..., 2],
                    nx * wo[..., 0] + ny * wo[..., 1] + nz * wo[..., 2])
    fs = gv * fc * att * 2.0 * w * umax
    delta_x = w * h_width
    x_of_u = _clip(v_of_u * w / PI, 0.5 * (delta_x - w),
                   0.5 * (w - delta_x))
    hit_band = (x_of_u - v * w / PI).abs() < 0.5 * delta_x
    valid = in_range & hit_band & (w * torch.sin(umax) < l) & (kappa >= -1.0)
    return torch.where(valid, fs / delta_x.clamp_min(1e-9), 0.0)


def _yarn_at(tables: dict, uv: torch.Tensor):
    """The yarn under each uv: its id, its [.., 10] row, whether it is a
    weft, and the lane's position (u along the spine, v across it)."""
    c = tables["consts"]
    pattern = tables["pattern"]
    th, tw = pattern.shape
    x = uv[..., 0] * c[_C_REPEATU] * tw
    y = (1.0 - uv[..., 1]) * c[_C_REPEATV] * th
    lx = torch.remainder(torch.floor(x).to(torch.int32), tw)
    ly = torch.remainder(torch.floor(y).to(torch.int32), th)
    yid = pattern[ly.long(), lx.long()].long()

    yr = tables["yarns"][yid]
    is_weft = yr[..., _Y_TYPE] > 0.5
    cx = torch.floor(x / tw) * tw + yr[..., _Y_CU] * tw
    cy = torch.floor(y / th) * th + (1.0 - yr[..., _Y_CV]) * th
    xx = x - cx
    yy = -(y - cy)
    # Weft yarns: positions rotated by pi/2 about z.
    rx = torch.where(is_weft, -yy, xx)
    ry = torch.where(is_weft, xx, yy)
    u_c = ry / (yr[..., _Y_LENGTH] / 2.0) * yr[..., _Y_UMAX]
    v_c = rx * PI / yr[..., _Y_WIDTH].clamp_min(1e-9)
    return yid, yr, is_weft, u_c, v_c


def eval_irawan(tables: dict, uv: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor, include_diffuse: bool = True):
    """f(wi, wo)·cos θo [N, 3] at ``uv`` for pairs on the front side (0
    elsewhere). ``tables``: pattern [th, tw] int (0-based yarn ids), yarns
    [Y, 10], kd and ks [Y, 3], consts [12], tensors on the lanes'
    device."""
    c = tables["consts"]
    yid, yr, is_weft, u_c, v_c = _yarn_at(tables, uv)
    w = yr[..., _Y_WIDTH]
    l = yr[..., _Y_LENGTH]  # noqa: E741
    psi = yr[..., _Y_PSI]
    umax = yr[..., _Y_UMAX]
    kappa = yr[..., _Y_KAPPA]

    def rot(d):
        # Weft yarns: directions rotated by pi/2 about z.
        return torch.stack([torch.where(is_weft, -d[..., 1], d[..., 0]),
                            torch.where(is_weft, d[..., 0], d[..., 1]),
                            d[..., 2]], -1)

    wi_r, wo_r = rot(wi), rot(wo)
    int_staple = _staple_integrand(u_c, v_c, wi_r, wo_r, c[_C_ALPHA],
                                   c[_C_BETA], psi, umax, kappa, w, l,
                                   c[_C_HWIDTH])
    int_fil = _filament_integrand(u_c, v_c, wi_r, wo_r, c[_C_ALPHA],
                                  c[_C_BETA], c[_C_SS], umax, kappa, w, l,
                                  c[_C_HWIDTH])
    integrand = torch.where(psi != 0.0, int_staple, int_fil)
    area = c[_C_WARPAREA] + c[_C_WEFTAREA]
    area_scale = torch.where(is_weft, area / c[_C_WEFTAREA].clamp_min(1e-9),
                             area / c[_C_WARPAREA].clamp_min(1e-9))
    f = (integrand * c[_C_NORM] * area_scale)[..., None] * tables["ks"][yid]
    if include_diffuse:
        f = f + tables["kd"][yid] * INV_PI
    cos_o = wo[..., 2].clamp_min(0.0)
    front = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(front[..., None], f * cos_o[..., None], 0.0)


def normalization_draws(generator: torch.Generator,
                        n_samples: int = N_NORM_SAMPLES):
    """(wi, wo, uv) of the normalisation estimate: two cosine-sampled
    directions and a uniform uv per sample, on the generator's device."""
    dev = generator.device
    u = torch.rand((3, n_samples, 2), generator=generator, device=dev)
    return (warp.square_to_cosine_hemisphere(u[0]),
            warp.square_to_cosine_hemisphere(u[1]), u[2])


def specular_normalization(tables: dict, wi=None, wo=None, uv=None,
                           generator: torch.Generator | None = None) -> float:
    """The specular normalisation N / (pi · Σ raw specular integrand) over
    cosine-sampled ``wi``, ``wo`` and uniform ``uv`` [N, 2/3] (drawn by
    ``normalization_draws`` from ``generator``, or a CPU generator seeded
    0, when not given); 0 where the sum is not positive."""
    if wi is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        wi, wo, uv = normalization_draws(generator)
    dev = wi.device
    t = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v, device=dev) for k, v in tables.items()}
    consts = t["consts"].clone().float()
    consts[_C_NORM] = 1.0
    t["consts"] = consts
    t["ks"] = torch.ones_like(t["ks"], dtype=torch.float32)
    t["kd"] = torch.zeros_like(t["ks"])
    f = eval_irawan(t, uv, wi, wo, include_diffuse=False)
    # eval returns f·cos θo; the estimate sums f.
    total = float((f[..., 0] / wo[..., 2].clamp_min(1e-6)).sum())
    if total <= 0.0:
        return 0.0
    return wi.shape[0] / (total * PI)


def build_tables(pattern: WeavePattern) -> dict:
    """The pattern's numpy tables with the normalisation in consts."""
    t = pattern.tables()
    t["consts"][_C_NORM] = specular_normalization(
        {k: torch.as_tensor(v) for k, v in t.items()})
    return t


def device_tables(scene) -> dict:
    """The weave tables of a ``SceneData``, as ``eval_irawan`` takes them."""
    return {"pattern": scene.iw_pattern, "yarns": scene.iw_yarns,
            "kd": scene.iw_kd, "ks": scene.iw_ks, "consts": scene.iw_consts}


def spine_pole_margin(tables: dict, uv: torch.Tensor) -> torch.Tensor:
    """|1 - |r̂·tan u|| [N] for staple yarns whose spine is a hyperbola
    (r̂ < 0, as with kappa = -0.5): at r̂·tan u = -1 its radius of
    curvature, and with it the specular term, has a pole (the guarded
    atanh holds it finite), and f there grows as the margin's -1.5th
    power. +inf on other lanes."""
    _, yr, _, u_c, _ = _yarn_at(tables, uv)
    umax, kappa = yr[..., _Y_UMAX], yr[..., _Y_KAPPA]
    rhat = 1.0 + kappa * (1.0 + 1.0 / torch.tan(umax))
    margin = (1.0 - (rhat * torch.tan(u_c.abs())).abs()).abs()
    hyper = (rhat < -1e-6) & (yr[..., _Y_PSI] != 0.0)
    return torch.where(hyper, margin, torch.full_like(margin, math.inf))


def ulp_sensitivity(tables: dict, uv: torch.Tensor, wi: torch.Tensor,
                    wo: torch.Tensor) -> torch.Tensor:
    """The largest change [N] of eval_irawan, in float64, when one
    coordinate of the float32 ``uv``, ``wi`` or ``wo`` moves by one ulp
    either way: how far apart two float32 evaluations of a lane may fall
    when they round its inputs or intermediates differently (at a yarn
    band's or a fiber angle's edge, or near a pole of the spine's
    curvature or of a highlight's Jacobian)."""
    t = {k: v.double() if v.is_floating_point() else v
         for k, v in tables.items()}
    x = [a.float() for a in (uv, wi, wo)]
    base = eval_irawan(t, *(a.double() for a in x))
    worst = torch.zeros(base.shape[:-1], dtype=torch.float64,
                        device=base.device)
    for i, a in enumerate(x):
        for c in range(a.shape[-1]):
            for to in (math.inf, -math.inf):
                moved = a.clone()
                moved[..., c] = torch.nextafter(
                    a[..., c], torch.full_like(a[..., c], to))
                args = [y.double() for y in x]
                args[i] = moved.double()
                worst = torch.maximum(
                    worst, (eval_irawan(t, *args) - base).abs().amax(-1))
    return worst


def float32_disagreement(got, want, exact, rtol=1e-5, atol=1e-6):
    """Elements where ``got`` and ``want`` (two float32 evaluations, numpy)
    differ by more than atol + rtol·|want| and by more than twice
    ``want``'s own distance from ``exact`` (a float64 evaluation): an
    ill-conditioned lane (a lane near the spine's pole, a grazing fiber)
    is held to the float32 error it has on the side of ``want``."""
    got, want, exact = (np.asarray(x, np.float64) for x in (got, want, exact))
    tol = atol + rtol * np.abs(want)
    return np.abs(got - want) > np.maximum(tol, 2.0 * np.abs(want - exact))


def lanes_off(tables: dict, uv: torch.Tensor, wi: torch.Tensor,
              wo: torch.Tensor, got, want, exact):
    """The lanes where ``got`` and ``want``, two float32 evaluations [N, 3]
    (numpy) of ``eval_irawan`` on ``uv``, ``wi`` and ``wo``, disagree
    (float32_disagreement against ``exact``, a float64 evaluation), and
    the ulp_sensitivity of each."""
    idx = np.nonzero(float32_disagreement(got, want, exact).any(-1))[0]
    sel = torch.as_tensor(idx, dtype=torch.long)
    return idx, ulp_sensitivity(tables, uv[sel], wi[sel],
                                wo[sel]).cpu().numpy()
