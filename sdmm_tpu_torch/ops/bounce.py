"""The fused unguided bounce with NEE and its host side (port of
sdmm_tpu/ops/bounce_pallas.py): the constants, the scene tables, the plain
per-lane helpers, the camera packing, and the two kernels of
``csrc/bounce.cu`` with their plain twins.

``build_tables`` packs the scene into the attribute-major tables the kernels
read: ``tri_rows [43, T]`` (the Woop affine transform in rows 0-11, then the
surface attributes), ``em_rows [18, E]`` (the emissive-triangle
distribution) and ``env_row [1, 128]`` (the constant environment in its
first three entries). The helpers are the plain PyTorch twins of the
``__device__`` functions in ``csrc/bounce_math.cuh``, elementwise over
tensors of any shape.

Lane data are the reference's attribute-major arrays flattened to
[rows, N]: state [16, N] f32 (0-2 origin, 3-5 direction, 6-8 throughput,
9-11 radiance, 12 eta², 13 the previous bounce's BSDF pdf, 14-15 zero),
meta [N] int32, film and splat [8, N] (rgb, rgb², sample weight, surface
vertices), pxpy [3, N] (pixel x, pixel y, sample budget).

  step:   one fused pool step for every lane of a live tile: regenerate a
          dead lane on its pixel, its camera ray, 10 uniforms (host rows or
          Philox4x32-10 in the kernel), ``bounce_core``, film += splat.
          State, meta and film are updated in place.
  bounce: ``bounce_core`` on 8 host uniform rows; new state, meta and splat.

``step`` and ``bounce`` launch the kernels for tensors on the card and run
``step_plain`` / ``bounce_plain`` (both on ``bounce_core_plain``) for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..bsdf import fresnel
from ..core import frame, warp
from ..render.volpath import mi_weight
from ..scene import emitters as em_mod
from . import _build

INF = 3.4e38  # miss sentinel of the closest-hit sweep
EPS = 1e-6  # smallest hit distance (every intersector's)
RAY_EPS = 1e-4  # spawn offset along the geometric normal
INV_PI = 1.0 / math.pi
PI = math.pi

# BSDF type codes handled in-kernel (scene.BSDF_*).
T_DIFFUSE = 0
T_CONDUCTOR = 1
T_DIELECTRIC = 2
T_ROUGHCONDUCTOR = 3
SUPPORTED_TYPES = (T_DIFFUSE, T_CONDUCTOR, T_DIELECTRIC, T_ROUGHCONDUCTOR)

# Lane meta word (int32): pixel (or sample count) | depth << 20 | ALIVE |
# EXH | PDELTA (the previous bounce sampled a delta lobe).
_DEPTH_SHIFT = 20
_ALIVE = 1 << 24
_EXH = 1 << 25
_PDELTA = 1 << 26
_PIX_MASK = (1 << 20) - 1
_DEPTH_MASK = 0xF

MAX_UNROLL_TRIS = 96  # above it the table is padded to a CHUNK multiple
CHUNK = 128
MAX_TRIS = 4096
MAX_EMITTERS = 64  # emissive triangles the kernels stage in shared memory

# Lane tiles of RT x 128 lanes (RT_CHUNKED past MAX_UNROLL_TRIS): the unit
# of the tile-alive skip, as in the reference.
RT = 64
RT_CHUNKED = 16
# Uniform rows of a bounce: nee_u1, nee_u2a, nee_u2b, lobe_u1, b2a, b2b, rr,
# spare; ``step`` draws two more for the pixel jitter.
RAND_ROWS = 8
STEP_RAND_ROWS = RAND_ROWS + 2

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


def build_cam_params(scene, width: int, height: int, fov_axis: str = "x"):
    """The perspective camera packed for ``step``: rotation row-major (9),
    origin (3), tan_half_x, tan_half_y; [14] float32 on the scene's device
    (the rays of ``scene.sensor.generate_rays``)."""
    aspect = width / height
    tan_half = scene.cam_tan_half_fov
    if fov_axis == "x":
        tx, ty = tan_half, tan_half / aspect
    else:
        tx, ty = tan_half * aspect, tan_half
    return torch.cat([scene.cam_to_world[:3, :3].reshape(9),
                      scene.cam_to_world[:3, 3], tx.reshape(1),
                      ty.reshape(1)]).float()


def lane_tile(n_cols: int) -> int:
    """Lanes per tile of the tile-alive skip for a triangle table of
    ``n_cols`` columns (RT_CHUNKED rows of 128 past MAX_UNROLL_TRIS)."""
    return (RT_CHUNKED if n_cols > MAX_UNROLL_TRIS else RT) * 128


def _type_flags(types) -> tuple[bool, bool, bool, bool]:
    """(multi, has_cond, has_diel, has_rc) of a scene's BSDF type set."""
    types = tuple(types)
    bad = [t for t in types if t not in SUPPORTED_TYPES]
    if bad:
        raise ValueError(f"BSDF types {bad} are not handled in the kernels")
    return (any(t != T_DIFFUSE for t in types), T_CONDUCTOR in types,
            T_DIELECTRIC in types, T_ROUGHCONDUCTOR in types)


def _type_mask(types) -> int:
    multi, has_cond, has_diel, has_rc = _type_flags(types)
    return int(multi) | int(has_cond) << 1 | int(has_diel) << 2 \
        | int(has_rc) << 3


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


# ---- Philox4x32-10 (twin of csrc/philox.cuh) ----

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the words ``b`` (int64 tensor in [0, 2^32)); b is split into 16-bit
    halves so that no partial product leaves int64."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)  # < 2^48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32(ctr, key):
    """Philox4x32-10 (Salmon et al., Random123) on four int64 word tensors
    ``ctr`` with the key ``key`` (two ints). Returns four word tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = (int(k) & _MASK32 for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed2, n: int, rows: int = STEP_RAND_ROWS,
                    device="cpu") -> torch.Tensor:
    """The uniforms the step kernel draws in-kernel: row r of lane i is word
    r % 4 of Philox4x32-10 at counter (i, r // 4, 0, 0) under the key
    ``seed2`` (two ints), as (word >> 8) * 2^-24. Returns [rows, n] f32."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(lane)
    words = []
    for blk in range((rows + 3) // 4):
        words += philox4x32((lane, torch.full_like(lane, blk), zero, zero),
                            seed2)
    return (torch.stack(words[:rows]) >> 8).float() * (1.0 / 16777216.0)


# ---- the bounce (twin of csrc/bounce.cu bounce_core) ----


def _closest_hit(rox, roy, roz, rdx, rdy, rdz, tri_rows):
    """Closest hit of the lanes over ``tri_rows``: (best_t, u, v, index;
    INF and -1 for a miss). The kernel sweeps the triangles in index order
    with a strict t < best_t, which keeps the lowest index among equal t;
    here each chunk is one [C, N] block: argmin takes the first minimum in
    it, and a strict < against the earlier chunks' best keeps theirs."""
    best_t = torch.full_like(rox, INF)
    bu = torch.zeros_like(rox)
    bv = torch.zeros_like(rox)
    bj = torch.full(rox.shape, -1, dtype=torch.long, device=rox.device)
    for j0 in range(0, tri_rows.shape[1], CHUNK):
        cols = tri_rows[:, j0:j0 + CHUNK, None]  # [43, C, 1]
        t, u, v, okg = _woop_tri(rox, roy, roz, rdx, rdy, rdz, cols,
                                 slice(None))
        t = torch.where(okg & (t > EPS), t, INF)
        jmin = t.argmin(0, keepdim=True)
        tmin = t.gather(0, jmin)[0]
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        bu = torch.where(better, u.gather(0, jmin)[0], bu)
        bv = torch.where(better, v.gather(0, jmin)[0], bv)
        bj = torch.where(better, j0 + jmin[0], bj)
    return best_t, bu, bv, bj


def _any_hit(ox, oy, oz, dx, dy, dz, t_lim, tri_rows):
    """Whether any triangle of ``tri_rows`` is hit within (EPS, t_lim)."""
    occ = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    for j0 in range(0, tri_rows.shape[1], CHUNK):
        t, _, _, okg = _woop_tri(ox, oy, oz, dx, dy, dz,
                                 tri_rows[:, j0:j0 + CHUNK, None],
                                 slice(None))
        occ = occ | (okg & (t > EPS) & (t < t_lim)).any(0)
    return occ


def bounce_core_plain(sv, m, rnd, tri_rows, em_rows, env_row, n_em: int,
                      max_depth: int, rr_depth: int, types, stats=None):
    """One bounce with NEE for every lane (plain twin of the kernels'
    ``bounce_core``; the reference's ``_make_core``): sv [14, N] lane state,
    m [N] meta, rnd [7, N] uniforms. Returns (new state [16, N], new meta
    [N] int32, splat [8, N]). ``stats``, a dict, receives the number of
    NEE candidates (the lanes whose occlusion sweep the kernel runs), the
    candidate mask [N] and each lane's BSDF type (-1 off a surface)."""
    multi, has_cond, has_diel, has_rc = _type_flags(types)
    (rox, roy, roz, rdx, rdy, rdz, thr_r, thr_g, thr_b, li_r, li_g, li_b,
     eta2, ppdf) = sv[0:14]
    alive = (m & _ALIVE) != 0
    prev_delta = (m & _PDELTA) != 0
    depth0 = (m >> _DEPTH_SHIFT) & _DEPTH_MASK
    pix = m & _PIX_MASK
    exh = m & _EXH
    ones = torch.ones_like(rox)
    false = torch.zeros_like(alive)

    # ---- closest hit; the winner's attributes by its index ----
    best_t, bu, bv, bj = _closest_hit(rox, roy, roz, rdx, rdy, rdz, tri_rows)
    hit_valid = best_t < INF
    col = tri_rows[:, bj.clamp_min(0)]  # [43, N]

    def attr(row, default, wanted=True):
        if not wanted:
            return torch.full_like(rox, default)
        return torch.where(hit_valid, col[row], default)

    w0 = 1.0 - bu - bv
    b_ngx, b_ngy, b_ngz = (attr(_TNG + i, 1.0 if i == 2 else 0.0)
                           for i in range(3))
    b_nsx, b_nsy, b_nsz = (
        torch.where(hit_valid, col[_TNS + i] * w0 + col[_TNS + 3 + i] * bu
                    + col[_TNS + 6 + i] * bv, 1.0 if i == 2 else 0.0)
        for i in range(3))
    b_em = [attr(_TEM + i, 0.0) for i in range(3)]
    b_pa = attr(_TPA, 0.0)
    b_alr, b_alg, b_alb = (attr(_TAL + i, 0.0) for i in range(3))
    b_ty = attr(_TTY, 0.0, multi)
    b_alp = attr(_TALP, 0.0, has_rc)
    b_eta = attr(_TETA, 1.0, has_cond or has_diel or has_rc)
    b_k = torch.stack([attr(_TK + i, 0.0, has_cond or has_rc)
                       for i in range(3)], -1)  # [N, 3]
    b_sr, b_sg, b_sb = (attr(_TSP + i, 1.0, has_cond or has_diel or has_rc)
                        for i in range(3))

    t_safe = torch.where(hit_valid, best_t, 0.0)
    px_ = rox + t_safe * rdx
    py_ = roy + t_safe * rdy
    pz_ = roz + t_safe * rdz
    inv_ns = torch.rsqrt(
        (b_nsx * b_nsx + b_nsy * b_nsy + b_nsz * b_nsz).clamp_min(1e-20))
    b_nsx, b_nsy, b_nsz = b_nsx * inv_ns, b_nsy * inv_ns, b_nsz * inv_ns

    is_diff = b_ty == T_DIFFUSE
    is_cond = (b_ty == T_CONDUCTOR) if has_cond else false
    is_diel = (b_ty == T_DIELECTRIC) if has_diel else false
    is_rc = (b_ty == T_ROUGHCONDUCTOR) if has_rc else false

    # ---- emitter hit, MIS against the previous bounce's BSDF pdf ----
    cos_l_hit = -_dot3(b_ngx, b_ngy, b_ngz, rdx, rdy, rdz)
    front = cos_l_hit > 0.0
    pdf_nee_hit = torch.where(
        hit_valid & (cos_l_hit > 1e-6),
        b_pa * best_t * best_t / cos_l_hit.clamp_min(1e-12), 0.0)
    w_hit = torch.where(prev_delta, 1.0, mi_weight(ppdf, pdf_nee_hit))
    gain = torch.where(alive & hit_valid & front, w_hit, 0.0)
    li_r = li_r + thr_r * b_em[0] * gain
    li_g = li_g + thr_g * b_em[1] * gain
    li_b = li_b + thr_b * b_em[2] * gain
    # Escaped rays: the constant environment, MIS weight 1.
    escf = torch.where(alive & ~hit_valid, 1.0, 0.0)
    li_r = li_r + thr_r * env_row[0, 0] * escf
    li_g = li_g + thr_g * env_row[0, 1] * escf
    li_b = li_b + thr_b * env_row[0, 2] * escf
    on_surface = alive & hit_valid

    # ---- shading frame, flipped toward the ray except on dielectrics ----
    cos_i_ns = -_dot3(b_nsx, b_nsy, b_nsz, rdx, rdy, rdz)
    flip = torch.where((cos_i_ns < 0.0) & ~is_diel, -1.0, 1.0)
    nx, ny, nz = b_nsx * flip, b_nsy * flip, b_nsz * flip
    s_, t_ = frame.coordinate_system(torch.stack([nx, ny, nz], -1))
    sx, sy, sz = s_.unbind(-1)
    tx_, ty_, tz_ = t_.unbind(-1)
    wi_z = -_dot3(nx, ny, nz, rdx, rdy, rdz)
    wi_x = -_dot3(sx, sy, sz, rdx, rdy, rdz)
    wi_y = -_dot3(tx_, ty_, tz_, rdx, rdy, rdz)
    wi_dot_geo = -_dot3(b_ngx, b_ngy, b_ngz, rdx, rdy, rdz)
    on_surface = on_surface & ~(wi_dot_geo * wi_z < 0.0)
    smooth = is_diff | is_rc  # NEE targets the non-delta lobes

    # ---- NEE: one emissive triangle by its CDF, a point on it ----
    su0 = torch.sqrt(rnd[1])
    bb0 = 1.0 - su0
    bb1 = rnd[2] * su0
    if n_em > 0:
        cdf = em_rows[_ECDF, :n_em].contiguous()
        e = torch.searchsorted(cdf, rnd[0].contiguous()).clamp_max(n_em - 1)
        er = em_rows[:, e]  # [18, N]
        e_y = [er[_EV + i] + bb0 * er[_EV + 3 + i] + bb1 * er[_EV + 6 + i]
               for i in range(3)]
        e_n = [er[_ENG + i] for i in range(3)]
        e_rad = [er[_ERAD + i] for i in range(3)]
        e_pa = er[_EPA]
    else:
        zero = torch.zeros_like(rox)
        e_y, e_n, e_rad, e_pa = [zero] * 3, [zero, zero, ones], [zero] * 3, \
            zero
    tox, toy, toz = e_y[0] - px_, e_y[1] - py_, e_y[2] - pz_
    dist2 = tox * tox + toy * toy + toz * toz
    dist = torch.sqrt(dist2.clamp_min(1e-20))
    inv_dist = 1.0 / dist
    ldx, ldy, ldz = tox * inv_dist, toy * inv_dist, toz * inv_dist
    cos_l = -_dot3(*e_n, ldx, ldy, ldz)
    pdf_sa = e_pa * dist2 / cos_l.clamp_min(1e-12)
    nee_valid = (cos_l > 1e-6) & (dist2 > 1e-12)
    pdf_sa = torch.where(nee_valid, pdf_sa, 0.0)

    # f(wi, wo_nee) and its BSDF pdf for the smooth lobes.
    wo_l_z = _dot3(nx, ny, nz, ldx, ldy, ldz)
    cos_o = wo_l_z.clamp_min(0.0)
    f_nee = [torch.where(is_diff, a * (INV_PI * cos_o), 0.0)
             for a in (b_alr, b_alg, b_alb)]
    pdf_b_nee = torch.where(is_diff, cos_o * INV_PI, 0.0)
    if has_rc:
        wo_l_x = _dot3(sx, sy, sz, ldx, ldy, ldz)
        wo_l_y = _dot3(tx_, ty_, tz_, ldx, ldy, ldz)
        hx, hy, hz = wi_x + wo_l_x, wi_y + wo_l_y, wi_z + wo_l_z
        inv_h = torch.rsqrt((hx * hx + hy * hy + hz * hz).clamp_min(1e-20))
        hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
        widoth = _dot3(wi_x, wi_y, wi_z, hx, hy, hz)
        d_h = _ggx_d(hz, b_alp)
        g_h = (_smith_g1(wi_x, wi_y, wi_z, hx, hy, hz, b_alp)
               * _smith_g1(wo_l_x, wo_l_y, wo_l_z, hx, hy, hz, b_alp))
        both = (wi_z > 1e-6) & (wo_l_z > 1e-6)
        spec = torch.where(both, d_h * g_h / (4.0 * wi_z).clamp_min(1e-12),
                           0.0)
        f_h = fresnel.fresnel_conductor(widoth, b_eta[:, None], b_k)
        pdf_rc = torch.where(
            both, _vndf_pdf(wi_x, wi_y, wi_z, hx, hy, hz, b_alp)
            / (4.0 * _dot3(wo_l_x, wo_l_y, wo_l_z, hx, hy, hz).abs())
            .clamp_min(1e-12), 0.0)
        f_nee = [torch.where(is_rc, s * f_h[:, c] * spec, f)
                 for c, (s, f) in enumerate(zip((b_sr, b_sg, b_sb), f_nee))]
        pdf_b_nee = torch.where(is_rc, pdf_rc, pdf_b_nee)

    # The NEE light vertex sits at depth0 + 2: gate it by max_depth.
    cand = (on_surface & smooth & nee_valid & (pdf_sa > 0.0)
            & (depth0 + 2 <= max_depth))
    off = torch.where(_dot3(b_ngx, b_ngy, b_ngz, ldx, ldy, ldz) > 0,
                      RAY_EPS, -RAY_EPS)
    occ = _any_hit(px_ + b_ngx * off, py_ + b_ngy * off, pz_ + b_ngz * off,
                   ldx, ldy, ldz, dist * (1.0 - 1e-3), tri_rows)
    if stats is not None:
        stats["nee_candidates"] = int(cand.sum())
        stats["nee_mask"] = cand
        stats["lane_type"] = torch.where(on_surface, b_ty.long(), -1)
    w_nee = mi_weight(pdf_sa, pdf_b_nee)
    scale = torch.where(cand & ~occ, w_nee / pdf_sa.clamp_min(1e-20), 0.0)
    li_r = li_r + thr_r * f_nee[0] * e_rad[0] * scale
    li_g = li_g + thr_g * f_nee[1] * e_rad[1] * scale
    li_b = li_b + thr_b * f_nee[2] * e_rad[2] * scale

    # ---- BSDF sample of the lane's type ----
    dxc, dyc = warp.square_to_uniform_disk_concentric(rnd[4:6].T).unbind(-1)
    dzc = torch.sqrt((1.0 - dxc * dxc - dyc * dyc).clamp_min(0.0))
    wo_x, wo_y, wo_z = dxc, dyc, dzc
    pdf_s = dzc * INV_PI
    w_r, w_g, w_b = b_alr, b_alg, b_alb
    good = (b_alr > 0.0) | (b_alg > 0.0) | (b_alb > 0.0)
    sampled_delta = false
    eta_factor = ones
    if has_cond:
        f_c = fresnel.fresnel_conductor(wi_z, b_eta[:, None], b_k).unbind(-1)
        wo_x = torch.where(is_cond, -wi_x, wo_x)
        wo_y = torch.where(is_cond, -wi_y, wo_y)
        wo_z = torch.where(is_cond, wi_z, wo_z)
        w_r = torch.where(is_cond, b_sr * f_c[0], w_r)
        w_g = torch.where(is_cond, b_sg * f_c[1], w_g)
        w_b = torch.where(is_cond, b_sb * f_c[2], w_b)
        pdf_s = torch.where(is_cond, 1.0, pdf_s)
        good = torch.where(is_cond, (f_c[0] > 0) | (f_c[1] > 0) | (f_c[2] > 0),
                           good)
        sampled_delta = sampled_delta | is_cond
    if has_diel:
        fr, cos_t, eta_it, eta_ti = fresnel.fresnel_dielectric(wi_z, b_eta)
        refl = rnd[3] < fr
        w_dr = torch.where(refl, b_sr, b_alr * eta_ti * eta_ti)
        w_dg = torch.where(refl, b_sg, b_alg * eta_ti * eta_ti)
        w_db = torch.where(refl, b_sb, b_alb * eta_ti * eta_ti)
        wo_x = torch.where(is_diel, torch.where(refl, -wi_x, -wi_x * eta_ti),
                           wo_x)
        wo_y = torch.where(is_diel, torch.where(refl, -wi_y, -wi_y * eta_ti),
                           wo_y)
        wo_z = torch.where(is_diel, torch.where(refl, wi_z, cos_t), wo_z)
        w_r = torch.where(is_diel, w_dr, w_r)
        w_g = torch.where(is_diel, w_dg, w_g)
        w_b = torch.where(is_diel, w_db, w_b)
        pdf_s = torch.where(is_diel, torch.where(refl, fr, 1.0 - fr), pdf_s)
        good = torch.where(is_diel, (w_dr > 0) | (w_dg > 0) | (w_db > 0),
                           good)
        sampled_delta = sampled_delta | is_diel
        eta_factor = torch.where(is_diel & ~refl, eta_it, eta_factor)
    if has_rc:
        mx, my, mz = _sample_vndf(wi_x, wi_y, wi_z, b_alp, rnd[4], rnd[5])
        widm = _dot3(wi_x, wi_y, wi_z, mx, my, mz)
        wo_rx = 2.0 * widm * mx - wi_x
        wo_ry = 2.0 * widm * my - wi_y
        wo_rz = 2.0 * widm * mz - wi_z
        g1o = _smith_g1(wo_rx, wo_ry, wo_rz, mx, my, mz, b_alp)
        f_m = fresnel.fresnel_conductor(widm, b_eta[:, None], b_k)
        w_rc = [s * f_m[:, c] * g1o for c, s in enumerate((b_sr, b_sg, b_sb))]
        pdf_r = _vndf_pdf(wi_x, wi_y, wi_z, mx, my, mz, b_alp) / (
            4.0 * _dot3(wo_rx, wo_ry, wo_rz, mx, my, mz).abs()).clamp_min(1e-12)
        ok_r = wo_rz > 1e-6
        wo_x = torch.where(is_rc, wo_rx, wo_x)
        wo_y = torch.where(is_rc, wo_ry, wo_y)
        wo_z = torch.where(is_rc, wo_rz, wo_z)
        w_r = torch.where(is_rc, torch.where(ok_r, w_rc[0], 0.0), w_r)
        w_g = torch.where(is_rc, torch.where(ok_r, w_rc[1], 0.0), w_g)
        w_b = torch.where(is_rc, torch.where(ok_r, w_rc[2], 0.0), w_b)
        pdf_s = torch.where(is_rc, torch.where(ok_r, pdf_r, 0.0), pdf_s)
        good = torch.where(
            is_rc, ok_r & ((w_rc[0] > 0) | (w_rc[1] > 0) | (w_rc[2] > 0)),
            good)

    wox = sx * wo_x + tx_ * wo_y + nx * wo_z
    woy = sy * wo_x + ty_ * wo_y + ny * wo_z
    woz = sz * wo_x + tz_ * wo_y + nz * wo_z
    wo_dot_geo = _dot3(b_ngx, b_ngy, b_ngz, wox, woy, woz)
    good = good & ~(wo_dot_geo * wo_z <= 0.0)

    # ---- throughput, Russian roulette ----
    depth = depth0 + 1
    survive = on_surface & good & (depth < max_depth)
    thr_nr = thr_r * torch.where(survive, w_r, 1.0)
    thr_ng = thr_g * torch.where(survive, w_g, 1.0)
    thr_nb = thr_b * torch.where(survive, w_b, 1.0)
    eta2_n = eta2 * torch.where(survive, eta_factor * eta_factor, 1.0)
    q = (torch.maximum(torch.maximum(thr_nr, thr_ng), thr_nb)
         * eta2_n).clamp_max(0.95)
    do_rr = (depth + 1) >= rr_depth
    survive = survive & ~(do_rr & (rnd[6] >= q))
    rr_boost = torch.where(do_rr & survive, 1.0 / q.clamp_min(1e-6), 1.0)
    thr_nr, thr_ng, thr_nb = (thr_nr * rr_boost, thr_ng * rr_boost,
                              thr_nb * rr_boost)

    # ---- splat of the paths that end here; NaN radiance splats 0 ----
    done = alive & ~survive
    df = torch.where(done, 1.0, 0.0)
    ls = [torch.where(torch.isfinite(x), x, 0.0) * df
          for x in (li_r, li_g, li_b)]
    splat = torch.stack(ls + [x * x for x in ls]
                        + [df, torch.where(on_surface, 1.0, 0.0)])

    off2 = torch.where(wo_dot_geo > 0, RAY_EPS, -RAY_EPS)
    zero = torch.zeros_like(rox)
    nstate = torch.stack([
        px_ + b_ngx * off2, py_ + b_ngy * off2, pz_ + b_ngz * off2,
        wox, woy, woz, thr_nr, thr_ng, thr_nb, li_r, li_g, li_b, eta2_n,
        pdf_s, zero, zero])
    depth_packed = torch.where(survive, depth, 0) & _DEPTH_MASK
    nmeta = (pix | (depth_packed << _DEPTH_SHIFT)
             | torch.where(survive, _ALIVE, 0)
             | torch.where(sampled_delta, _PDELTA, 0) | exh).to(torch.int32)
    return nstate, nmeta, splat


def _tile_mask(tile_alive, tile: int):
    """Per-lane bool: the lane's tile is live."""
    return tile_alive.repeat_interleave(tile) != 0


def step_plain(state, meta, film, tile_alive, cam, seed2, pxpy, tri_rows,
               em_rows, env_row, n_em: int, max_depth: int, rr_depth: int,
               types, width: int, height: int, rand=None, stats=None):
    """Plain twin of the step kernel. Returns (new state, new meta, new
    film); the lanes of tiles whose ``tile_alive`` flag is 0 keep theirs.
    With ``rand`` None it draws ``philox_uniforms(seed2, N)``."""
    n = meta.shape[0]
    if rand is None:
        rand = philox_uniforms(seed2, n, STEP_RAND_ROWS, meta.device)
    inv_w = 1.0 / width
    inv_h = 1.0 / height

    # ---- regenerate dead lanes on their pixel ----
    alive = (meta & _ALIVE) != 0
    exh = (meta & _EXH) != 0
    count = (meta & _PIX_MASK).float()
    need = ~alive & ~exh
    start = need & (count < pxpy[2])
    exh = exh | (need & ~start)
    count = torch.where(start, count + 1.0, count)
    px = pxpy[0] + rand[RAND_ROWS]
    py = pxpy[1] + rand[RAND_ROWS + 1]
    # The perspective camera of scene.sensor.generate_rays.
    sx = 1.0 - 2.0 * px * inv_w
    sy = 1.0 - 2.0 * py * inv_h
    dcx = sx * cam[12]
    dcy = sy * cam[13]
    dx = cam[0] * dcx + cam[1] * dcy + cam[2]
    dy = cam[3] * dcx + cam[4] * dcy + cam[5]
    dz = cam[6] * dcx + cam[7] * dcy + cam[8]
    inv_n = torch.rsqrt((dx * dx + dy * dy + dz * dz).clamp_min(1e-20))
    ones = torch.ones_like(px)
    zeros = torch.zeros_like(px)
    fresh = torch.stack([cam[9] * ones, cam[10] * ones, cam[11] * ones,
                         dx * inv_n, dy * inv_n, dz * inv_n, ones, ones, ones,
                         zeros, zeros, zeros, ones, ones])
    sv = torch.where(start, fresh, state[0:14])
    depth_bits = _DEPTH_MASK << _DEPTH_SHIFT
    m2 = (count.to(torch.int32)
          | torch.where(alive | start, _ALIVE, 0)
          | torch.where(exh, _EXH, 0)
          | torch.where(start, _PDELTA, meta & _PDELTA)
          | torch.where(start, 0, meta & depth_bits)).to(torch.int32)

    nstate, nmeta, splat = bounce_core_plain(
        sv, m2, rand[0:7], tri_rows, em_rows, env_row, n_em, max_depth,
        rr_depth, types, stats)
    live = _tile_mask(tile_alive, lane_tile(tri_rows.shape[1]))
    return (torch.where(live, nstate, state), torch.where(live, nmeta, meta),
            torch.where(live, film + splat, film))


def bounce_plain(state, meta, rand, tri_rows, em_rows, env_row, n_em: int,
                 max_depth: int, rr_depth: int, types, tile_alive=None,
                 stats=None):
    """Plain twin of the bounce kernel. Returns (new state, new meta,
    splat); with ``tile_alive``, a tile whose flag is 0 keeps its state and
    meta and splats 0."""
    nstate, nmeta, splat = bounce_core_plain(
        state[0:14], meta, rand[0:7], tri_rows, em_rows, env_row, n_em,
        max_depth, rr_depth, types, stats)
    if tile_alive is not None:
        live = _tile_mask(tile_alive, lane_tile(tri_rows.shape[1]))
        nstate = torch.where(live, nstate, state)
        nmeta = torch.where(live, nmeta, meta)
        splat = torch.where(live, splat, 0.0)
    return nstate, nmeta, splat


# ---- the kernels of csrc/bounce.cu ----

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ARGTYPES = {
    # state meta film tile_alive cam pxpy rand tri em env | n tile n_cols n_em
    # e_cols max_depth rr_depth type_mask | seed0 seed1 | inv_w inv_h | stream
    "step_launch": [_P] * 10 + [_I] * 8 + [_U] * 2 + [_F] * 2 + [_P],
    # state meta rand tri em env tile_alive nstate nmeta splat | n tile
    # n_cols n_em e_cols max_depth rr_depth type_mask | stream
    "bounce_launch": [_P] * 10 + [_I] * 8 + [_P],
}


def _fn(symbol: str):
    fn = getattr(_build.load("bounce"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _check_tables(kernel, specs, tri_rows, em_rows, env_row, n_em):
    n_cols = tri_rows.shape[1]
    if not 0 <= n_em <= min(MAX_EMITTERS, em_rows.shape[1]):
        raise ValueError(f"{kernel}: n_em {n_em} outside [0, "
                         f"{min(MAX_EMITTERS, em_rows.shape[1])}]")
    if n_cols > MAX_TRIS:
        raise ValueError(f"{kernel}: {n_cols} triangle columns > {MAX_TRIS}")
    _build.check_inputs(kernel, specs + (
        ("tri_rows", tri_rows, (TRI_ROWS, n_cols), torch.float32),
        ("em_rows", em_rows, (EM_ROWS, em_rows.shape[1]), torch.float32),
        ("env_row", env_row, (1, 128), torch.float32)))


def step(state, meta, film, tile_alive, cam, seed2, pxpy, tri_rows, em_rows,
         env_row, n_em: int, max_depth: int, rr_depth: int, types,
         width: int, height: int, rand=None):
    """One fused pool step for a lane wave, in place: state [16, N] f32,
    meta [N] int32 (the pixel field holds the lane's sample count), film
    [8, N] f32, tile_alive [N // tile] int32 (``lane_tile``; a 0 tile is
    left as it is), cam [14] from ``build_cam_params``, seed2 two ints (the
    Philox key), pxpy [3, N] f32, the tables of ``build_tables``, rand
    [STEP_RAND_ROWS, N] f32 or None (draw Philox uniforms in the kernel).
    N is a multiple of the tile. Returns (state, meta, film)."""
    n = meta.shape[0]
    tile = lane_tile(tri_rows.shape[1])
    if n % tile:
        raise ValueError(f"step: {n} lanes is no multiple of the {tile}-lane "
                         "tile")
    if state.device.type == "cpu":
        out = step_plain(state, meta, film, tile_alive, cam, seed2, pxpy,
                         tri_rows, em_rows, env_row, n_em, max_depth,
                         rr_depth, types, width, height, rand)
        for dst, src in zip((state, meta, film), out):
            dst.copy_(src)
        return state, meta, film
    specs = (("state", state, (16, n), torch.float32),
             ("meta", meta, (n,), torch.int32),
             ("film", film, (8, n), torch.float32),
             ("tile_alive", tile_alive, (n // tile,), torch.int32),
             ("cam", cam, (14,), torch.float32),
             ("pxpy", pxpy, (3, n), torch.float32))
    if rand is not None:
        specs += (("rand", rand, (STEP_RAND_ROWS, n), torch.float32),)
    _check_tables("step", specs, tri_rows, em_rows, env_row, n_em)
    if n > 0:
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = _fn("step_launch")(
            state.data_ptr(), meta.data_ptr(), film.data_ptr(),
            tile_alive.data_ptr(), cam.data_ptr(), pxpy.data_ptr(),
            None if rand is None else rand.data_ptr(), tri_rows.data_ptr(),
            em_rows.data_ptr(), env_row.data_ptr(), n, tile,
            tri_rows.shape[1], n_em, em_rows.shape[1], max_depth, rr_depth,
            _type_mask(types), int(seed2[0]) & _MASK32, int(seed2[1]) & _MASK32, 1.0 / width,
            1.0 / height, stream)
        _build.check(rc, "step")
        step.launches += 1
    return state, meta, film


def bounce(state, meta, rand, tri_rows, em_rows, env_row, n_em: int,
           max_depth: int, rr_depth: int, types=(T_DIFFUSE,),
           tile_alive=None):
    """One bounce for a lane wave: state [16, N] f32, meta [N] int32, rand
    [RAND_ROWS, N] f32, the tables of ``build_tables``; tile_alive
    [N // tile] int32 or None (a 0 tile keeps its state and meta and
    splats 0; N is then a multiple of the tile). Returns (new state
    [16, N], new meta [N], splat [8, N])."""
    if state.device.type == "cpu":
        return bounce_plain(state, meta, rand, tri_rows, em_rows, env_row,
                            n_em, max_depth, rr_depth, types, tile_alive)
    n = meta.shape[0]
    tile = lane_tile(tri_rows.shape[1])
    specs = (("state", state, (16, n), torch.float32),
             ("meta", meta, (n,), torch.int32),
             ("rand", rand, (RAND_ROWS, n), torch.float32))
    if tile_alive is not None:
        if n % tile:
            raise ValueError(f"bounce: {n} lanes is no multiple of the "
                             f"{tile}-lane tile")
        specs += (("tile_alive", tile_alive, (n // tile,), torch.int32),)
    _check_tables("bounce", specs, tri_rows, em_rows, env_row, n_em)
    nstate = torch.empty_like(state)
    nmeta = torch.empty_like(meta)
    splat = torch.empty((8, n), dtype=torch.float32, device=state.device)
    if n > 0:
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = _fn("bounce_launch")(
            state.data_ptr(), meta.data_ptr(), rand.data_ptr(),
            tri_rows.data_ptr(), em_rows.data_ptr(), env_row.data_ptr(),
            None if tile_alive is None else tile_alive.data_ptr(),
            nstate.data_ptr(), nmeta.data_ptr(), splat.data_ptr(), n, tile,
            tri_rows.shape[1], n_em, em_rows.shape[1], max_depth, rr_depth,
            _type_mask(types), stream)
        _build.check(rc, "bounce")
        bounce.launches += 1
    return nstate, nmeta, splat


def kernel_info(n_cols: int) -> dict[str, dict[str, int]]:
    """Registers, spilled (local) bytes, static shared bytes and resident
    blocks an SM of the step and bounce kernels, as built, at the dynamic
    shared memory of an ``n_cols``-column triangle table."""
    return _build.kernel_info("bounce", "bounce_info", ("step", "bounce"),
                              n_cols)


step.launches = 0
bounce.launches = 0
