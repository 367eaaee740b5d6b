"""Host side of the fused bounce kernels: the constants, the scene tables
and plain per-lane helpers (port of the host code and helpers of
sdmm_tpu/ops/bounce_pallas.py).

``build_tables`` packs the scene into the attribute-major tables the kernels
read: ``tri_rows [43, T]`` (the Woop affine transform in rows 0-11, then the
surface attributes), ``em_rows [18, E]`` (the emissive-triangle
distribution) and ``env_row [1, 128]`` (the constant environment in its
first three entries). The helpers are the plain PyTorch twins of the
``__device__`` functions in ``csrc/bounce_math.cuh``, elementwise over
tensors of any shape.
"""

from __future__ import annotations

import math

import torch

from ..scene import emitters as em_mod

INF = 3.4e38  # miss sentinel of the closest-hit sweep
EPS = 1e-6  # smallest hit distance (intersect.EPS)
RAY_EPS = 1e-4  # spawn offset along the geometric normal
INV_PI = 1.0 / math.pi
PI = math.pi

# BSDF type codes handled in-kernel (scene.BSDF_*).
T_DIFFUSE = 0
T_CONDUCTOR = 1
T_DIELECTRIC = 2
T_ROUGHCONDUCTOR = 3
SUPPORTED_TYPES = (T_DIFFUSE, T_CONDUCTOR, T_DIELECTRIC, T_ROUGHCONDUCTOR)

# Lane meta word (int32): pixel | depth << 20 | ALIVE | EXH.
_DEPTH_SHIFT = 20
_ALIVE = 1 << 24
_EXH = 1 << 25
_PIX_MASK = (1 << 20) - 1
_DEPTH_MASK = 0xF

MAX_UNROLL_TRIS = 96  # above it the table is padded to a CHUNK multiple
CHUNK = 128
MAX_TRIS = 4096

# Triangle rows of the [43, T] table. Rows 0-11: B = [e1 e2 n]^-1
# row-major (0-8) and c = -B v0 (9-11), so o' = B ro + c, d' = B rd,
# t = -o'_z / d'_z and (u, v) = o'_xy + t d'_xy are exact barycentrics.
_TW = 0
_TNG = 12  # 12-14: geometric normal
_TNS = 15  # 15-23: vertex shading normals n0.xyz n1.xyz n2.xyz
_TEM = 24  # 24-26: emitted radiance rgb
_TPA = 27  # NEE selection pdf / area (0 for non-emitters)
_TAL = 28  # 28-30: diffuse albedo rgb
_TTY = 31  # bsdf type code (as f32)
_TALP = 32  # GGX roughness
_TETA = 33  # ior / conductor eta (scalar)
_TK = 34  # 34-36: conductor absorption k rgb
_TSP = 37  # 37-39: specular reflectance rgb
TRI_ROWS = 43

# Emitter rows of the [18, E] table.
_ECDF = 0
_EV = 1  # 1-9: v0 / e1 / e2
_ENG = 10  # 10-12
_ERAD = 13  # 13-15
_EPA = 16  # selection pdf / area
EM_ROWS = 18


def build_tables(scene):
    """Pack ``scene`` into (tri_rows [43, T_pad], em_rows [18, E],
    env_row [1, 128]) float32 on the scene's device. T is padded to a CHUNK
    multiple past MAX_UNROLL_TRIS triangles; padding and degenerate
    triangles have all-zero Woop rows, so they are never hit."""
    dev = scene.tri_v0.device
    t = scene.tri_v0.shape[0]
    tri = torch.zeros((TRI_ROWS, t), device=dev)
    v0 = scene.tri_v0.float()
    e1 = scene.tri_e1.float()
    e2 = scene.tri_e2.float()
    a = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)  # [T, 3, 3]
    ok = torch.linalg.det(a).abs() > 1e-24
    eye = torch.eye(3, device=dev).expand_as(a)
    b = torch.where(ok[:, None, None],
                    torch.linalg.inv(torch.where(ok[:, None, None], a, eye)),
                    0.0)
    c = torch.where(ok[:, None], -torch.einsum("tij,tj->ti", b, v0), 0.0)
    tri[_TW:_TW + 9] = b.reshape(t, 9).T
    tri[_TW + 9:_TW + 12] = c.T
    tri[_TNG:_TNG + 3] = scene.tri_ng.T
    tri[_TNS:_TNS + 9] = scene.tri_ns.reshape(t, 9).T
    em_id = scene.tri_emitter.long()
    rad = torch.where((em_id >= 0)[:, None],
                      scene.emitter_radiance[em_id.clamp_min(0)], 0.0)
    tri[_TEM:_TEM + 3] = rad.T
    tri[_TPA] = em_mod.tri_pdf_over_area(scene)
    bid = scene.tri_bsdf.long()
    tri[_TAL:_TAL + 3] = scene.bsdf_albedo[bid].T
    tri[_TTY] = scene.bsdf_type[bid].float()
    tri[_TALP] = scene.bsdf_alpha[bid]
    tri[_TETA] = scene.bsdf_eta[bid]
    tri[_TK:_TK + 3] = scene.bsdf_k[bid].T
    tri[_TSP:_TSP + 3] = scene.bsdf_specular[bid].T
    if t > MAX_UNROLL_TRIS and t % CHUNK != 0:
        tri = torch.nn.functional.pad(tri, (0, CHUNK - t % CHUNK))

    m = scene.em_tri_idx.shape[0]
    em = torch.zeros((EM_ROWS, max(m, 1)), device=dev)
    if m:
        idx = scene.em_tri_idx.long()
        em[_ECDF] = scene.em_tri_cdf
        em[_EV + 0:_EV + 3] = scene.tri_v0[idx].T
        em[_EV + 3:_EV + 6] = scene.tri_e1[idx].T
        em[_EV + 6:_EV + 9] = scene.tri_e2[idx].T
        em[_ENG:_ENG + 3] = scene.tri_ng[idx].T
        em[_ERAD:_ERAD + 3] = \
            scene.emitter_radiance[scene.tri_emitter[idx].long()].T
        em[_EPA] = scene.em_tri_pdf / scene.em_tri_area.clamp_min(1e-20)
    env = torch.zeros((1, 128), device=dev)
    env[0, 0:3] = scene.env_radiance.expand(3)
    return tri, em, env


# ---- plain per-lane helpers (twins of csrc/bounce_math.cuh) ----
#
# The twins of coordinate_system, disk_concentric, fresnel_dielectric and
# fresnel_conductor_1 are the port's core/frame.py, core/warp.py and
# bsdf/fresnel.py functions, whose math is the same line for line. The
# helpers below have no such counterpart: the Woop test, and GGX in the
# per-lane scalar form of bounce_pallas (bsdf/microfacet.py works on stacked
# local vectors, and its sample_vndf normalises by division where the
# kernel takes rsqrt).


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _woop_tri(rox, roy, roz, rdx, rdy, rdz, tri, j):
    """Woop-transform intersection of the lanes against triangle column j
    of ``tri`` [43, T]. Returns (t, u, v, ok_geo); ok_geo leaves out the
    t-range test. Degenerate triangles have d'_z = 0 and ok_geo False."""
    b0, b1, b2, b3, b4, b5, b6, b7, b8, c0, c1, c2 = (
        tri[_TW + r, j] for r in range(12))
    dpz = b6 * rdx + b7 * rdy + b8 * rdz
    opz = b6 * rox + b7 * roy + b8 * roz + c2
    good = dpz.abs() > 1e-12
    inv = torch.where(good, 1.0 / torch.where(good, dpz, 1.0), 0.0)
    t = -opz * inv
    u = (b0 * rox + b1 * roy + b2 * roz + c0) + t * (
        b0 * rdx + b1 * rdy + b2 * rdz)
    v = (b3 * rox + b4 * roy + b5 * roz + c1) + t * (
        b3 * rdx + b4 * rdy + b5 * rdz)
    ok = good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def _ggx_d(mz, alpha):
    cos_t = mz.clamp_min(0.0)
    a2 = alpha * alpha
    den = cos_t * cos_t * (a2 - 1.0) + 1.0
    return torch.where(cos_t > 0.0, a2 / (PI * den * den).clamp_min(1e-20),
                       0.0)


def _smith_g1(vx, vy, vz, mx, my, mz, alpha):
    chi = _dot3(vx, vy, vz, mx, my, mz) * vz > 0.0
    cos2 = vz * vz
    tan2 = (1.0 - cos2).clamp_min(0.0) / cos2.clamp_min(1e-12)
    lam = 0.5 * (torch.sqrt(1.0 + alpha * alpha * tan2) - 1.0)
    return torch.where(chi, 1.0 / (1.0 + lam), 0.0)


def _sample_vndf(wix, wiy, wiz, alpha, u0, u1):
    """Heitz's visible-normal sampling of GGX, per lane."""
    vx = alpha * wix
    vy = alpha * wiy
    vz = wiz
    inv = torch.rsqrt((vx * vx + vy * vy + vz * vz).clamp_min(1e-20))
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    lensq = vx * vx + vy * vy
    inv_len = torch.rsqrt(lensq.clamp_min(1e-20))
    big = lensq > 1e-12
    t1x = torch.where(big, -vy * inv_len, 1.0)
    t1y = torch.where(big, vx * inv_len, 0.0)
    t1z = torch.zeros_like(vx)
    t2x = vy * t1z - vz * t1y
    t2y = vz * t1x - vx * t1z
    t2z = vx * t1y - vy * t1x
    r = torch.sqrt(u0.clamp_min(0.0))
    phi = 2.0 * PI * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vz)
    p2 = (1.0 - s) * torch.sqrt((1.0 - p1 * p1).clamp_min(0.0)) + s * p2
    p3 = torch.sqrt((1.0 - p1 * p1 - p2 * p2).clamp_min(0.0))
    nx = p1 * t1x + p2 * t2x + p3 * vx
    ny = p1 * t1y + p2 * t2y + p3 * vy
    nz = p1 * t1z + p2 * t2z + p3 * vz
    mx = alpha * nx
    my = alpha * ny
    mz = nz.clamp_min(0.0)
    inv_m = torch.rsqrt((mx * mx + my * my + mz * mz).clamp_min(1e-20))
    return mx * inv_m, my * inv_m, mz * inv_m


def _vndf_pdf(wix, wiy, wiz, mx, my, mz, alpha):
    g1 = _smith_g1(wix, wiy, wiz, mx, my, mz, alpha)
    d = _ggx_d(mz, alpha)
    return g1 * _dot3(wix, wiy, wiz, mx, my, mz).abs() * d \
        / wiz.abs().clamp_min(1e-12)
