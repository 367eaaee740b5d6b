"""The fused guided bounce: a trace kernel and a shade kernel around the
leaf lookup (port of sdmm_tpu/ops/guided_step_pallas.py).

  trace:  closest hit by a Woop sweep over the triangle table, emitter hits
          with MIS weight 1 (the guided tracer compiles NEE out) and the
          constant-environment escape; writes the winner's surface
          attributes to a 22-row hit buffer.
  glue:   canonical position → leaf (``stree.find_leaf``), in PyTorch.
  shade:  shading frame, the BSDF sample of the lane's type, the mixture
          conditioning + sample + pdf of ``guided_tile`` on the leaf's bf16
          row, the one-sample MIS combine, Russian roulette, the film-splat
          rows and the next lane state.

``shade`` reads the leaf rows from the packed table of
``pack_shade_table``: the bf16 values of ``pack_guided_rows(...).T``
[L, 353] in ``guided_sample.pack_sample_table``'s layout, each component's
22 on a 24-value stride (two pads), the init flag in component 0's first
pad, so that every component is three 16-byte words the kernel loads
whole. It is built once per render.

Layouts are the reference's attribute-major ones, flattened to [rows, N]:
state [16, N] f32 (0-2 origin, 3-5 direction, 6-8 throughput, 9-11
radiance, 12 eta², 13-15 zero), meta [N] int32 (``bounce`` bit layout), hit
[HIT_ROWS, N], cpos [3, N], rand [RAND_ROWS, N], splat [SPLAT_ROWS, N].
``trace`` and ``shade`` launch the CUDA kernels of ``csrc/guided_step.cu``
for tensors on the card and run ``trace_plain`` / ``shade_plain`` for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..bsdf import fresnel
from ..core import frame, warp
from . import _build
from . import bounce as bo
from .bounce import (
    INF, INV_PI, RAY_EPS, T_CONDUCTOR, T_DIELECTRIC, T_DIFFUSE,
    T_ROUGHCONDUCTOR, _ALIVE, _DEPTH_MASK, _DEPTH_SHIFT, _EXH, _PIX_MASK,
    _TAL, _TALP, _TEM, _TETA, _TK, _TNG, _TNS, _TSP, _TTY, _dot3, _type_flags,
    _type_mask,
)
from .guided_sample import (
    N_ROWS, PACK_COLS, guided_sample_plain, pack_sample_table,
    unpack_sample_table,
)

HIT_ROWS = 22
# Hit rows: 0-2 p, 3-5 ng, 6-8 ns, 9-11 albedo, 12 type, 13 alpha, 14 eta,
# 15-17 k, 18-20 specular, 21 on_surface flag.
SPLAT_ROWS = 10  # rgb, rgb², done weight, n_vert, cond_try, cond_ok
RAND_ROWS = 8  # u_sel, lobe_u, b2a, b2b, rr, g_sel, g_r, g_th

def pack_shade_table(table):
    """The [L, N_ROWS] conditioning table (``pack_guided_rows(...).T``, any
    float dtype) → the [L, PACK_COLS] bf16 table ``shade`` reads
    (csrc/guided_tile.cuh RowPacked, 48 bytes a component):
    ``pack_sample_table`` of the same bf16 values."""
    return pack_sample_table(table, torch.bfloat16)


def trace_plain(state, meta, tri_rows, env_row, types):
    """Plain twin of the trace kernel. Returns (new_state, hit)."""
    multi, has_cond, has_diel, has_rc = _type_flags(types)
    rox, roy, roz, rdx, rdy, rdz = state[0:6]
    thr_r, thr_g, thr_b = state[6:9]
    alive = (meta & _ALIVE) != 0
    best_t, bu, bv, bj = bo._closest_hit(rox, roy, roz, rdx, rdy, rdz,
                                         tri_rows)
    hit_valid = best_t < INF
    # The winner's attribute columns; a miss keeps the defaults below.
    col = tri_rows[:, bj.clamp_min(0)]  # [43, N]

    def attr(row, default, wanted=True):
        if not wanted:
            return torch.full_like(rox, default)
        return torch.where(hit_valid, col[row], default)

    w0 = 1.0 - bu - bv
    ng = [attr(_TNG + i, 1.0 if i == 2 else 0.0) for i in range(3)]
    ns = [torch.where(hit_valid, col[_TNS + i] * w0 + col[_TNS + 3 + i] * bu
                      + col[_TNS + 6 + i] * bv, 1.0 if i == 2 else 0.0)
          for i in range(3)]
    em = [attr(_TEM + i, 0.0) for i in range(3)]
    al = [attr(_TAL + i, 0.0) for i in range(3)]
    ty = attr(_TTY, 0.0, multi)
    alp = attr(_TALP, 0.0, has_rc)
    eta = attr(_TETA, 1.0, has_cond or has_diel or has_rc)
    k = [attr(_TK + i, 0.0, has_cond or has_rc) for i in range(3)]
    sp = [attr(_TSP + i, 1.0, has_cond or has_diel or has_rc)
          for i in range(3)]

    t_safe = torch.where(hit_valid, best_t, 0.0)
    p = [state[i] + t_safe * state[3 + i] for i in range(3)]
    inv_ns = torch.rsqrt(
        (ns[0] * ns[0] + ns[1] * ns[1] + ns[2] * ns[2]).clamp_min(1e-20))
    ns = [x * inv_ns for x in ns]

    # Emitter hit with MIS weight 1, front side only; constant-env escape.
    cos_l_hit = -_dot3(*ng, rdx, rdy, rdz)
    gain = torch.where(alive & hit_valid & (cos_l_hit > 0.0), 1.0, 0.0)
    escf = torch.where(alive & ~hit_valid, 1.0, 0.0)
    thr = (thr_r, thr_g, thr_b)
    nstate = state.clone()
    for i in range(3):
        nstate[9 + i] = state[9 + i] + thr[i] * em[i] * gain
        nstate[9 + i] = nstate[9 + i] + thr[i] * env_row[0, i] * escf
    on_surface = torch.where(alive & hit_valid, 1.0, 0.0)
    hit = torch.stack(p + ng + ns + al + [ty, alp, eta] + k + sp
                      + [on_surface])
    return nstate, hit


def shade_plain(state, meta, hit, cpos, rows_t, rand, types, max_depth: int,
                rr_depth: int, bsdf_fraction: float):
    """Plain twin of the shade kernel on the gathered leaf rows
    ``rows_t`` [N_ROWS, N] (float32). Returns (new_state, new_meta,
    splat)."""
    multi, has_cond, has_diel, has_rc = _type_flags(types)
    rdx, rdy, rdz = state[3:6]
    thr_r, thr_g, thr_b = state[6:9]
    li_r, li_g, li_b = state[9:12]
    eta2 = state[12]
    alive = (meta & _ALIVE) != 0
    depth0 = (meta >> _DEPTH_SHIFT) & _DEPTH_MASK
    pix = meta & _PIX_MASK
    exh = meta & _EXH
    px_, py_, pz_ = hit[0:3]
    b_ngx, b_ngy, b_ngz = hit[3:6]
    b_nsx, b_nsy, b_nsz = hit[6:9]
    b_alr, b_alg, b_alb = hit[9:12]
    b_ty, b_alp, b_eta = hit[12], hit[13], hit[14]
    b_k = hit[15:18].T  # [N, 3]
    b_sr, b_sg, b_sb = hit[18:21]
    on_surface = alive & (hit[21] > 0.5)
    ones = torch.ones_like(px_)
    false = torch.zeros_like(alive)

    is_diff = (b_ty == T_DIFFUSE) if multi else ~false
    is_cond = (b_ty == T_CONDUCTOR) if has_cond else false
    is_diel = (b_ty == T_DIELECTRIC) if has_diel else false
    is_rc = (b_ty == T_ROUGHCONDUCTOR) if has_rc else false

    # Shading frame, flipped toward the incoming ray except on dielectrics.
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
    delta_only = is_cond | is_diel

    # BSDF sample of the lane's type.
    dxc, dyc = warp.square_to_uniform_disk_concentric(rand[2:4].T).unbind(-1)
    wo_x, wo_y = dxc, dyc
    wo_z = torch.sqrt((1.0 - dxc * dxc - dyc * dyc).clamp_min(0.0))
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
        good = torch.where(is_cond, (f_c[0] > 0) | (f_c[1] > 0) | (f_c[2] > 0),
                           good)
        sampled_delta = sampled_delta | is_cond
    if has_diel:
        fr, cos_t, eta_it, eta_ti = fresnel.fresnel_dielectric(wi_z, b_eta)
        refl = rand[1] < fr
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
        good = torch.where(is_diel, (w_dr > 0) | (w_dg > 0) | (w_db > 0),
                           good)
        sampled_delta = sampled_delta | is_diel
        eta_factor = torch.where(is_diel & ~refl, eta_it, eta_factor)
    if has_rc:
        mxv, myv, mzv = bo._sample_vndf(wi_x, wi_y, wi_z, b_alp, rand[2],
                                        rand[3])
        widm = _dot3(wi_x, wi_y, wi_z, mxv, myv, mzv)
        wo_rz = 2.0 * widm * mzv - wi_z
        wo_x = torch.where(is_rc, 2.0 * widm * mxv - wi_x, wo_x)
        wo_y = torch.where(is_rc, 2.0 * widm * myv - wi_y, wo_y)
        wo_z = torch.where(is_rc, wo_rz, wo_z)
        good = torch.where(is_rc, wo_rz > 1e-6, good)

    wbx = sx * wo_x + tx_ * wo_y + nx * wo_z
    wby = sy * wo_x + ty_ * wo_y + ny * wo_z
    wbz = sz * wo_x + tz_ * wo_y + nz * wo_z

    # Guided mixture: conditional sample and pdf at both directions.
    g, g_ok, pdf_g, pdf_b, guide_valid = guided_sample_plain(
        rows_t, cpos, torch.stack([wbx, wby, wbz]), rand[5:8])
    gx, gy, gz = g
    ginit = rows_t[N_ROWS - 1] > 0.5
    guide_ok = guide_valid & ~delta_only
    h = torch.where(guide_ok, bsdf_fraction, 1.0)
    take_bsdf = (rand[0] < h) | ~guide_ok
    cond_try = on_surface & ginit & ~delta_only
    cond_ok_ct = cond_try & guide_valid

    wox = torch.where(take_bsdf, wbx, gx)
    woy = torch.where(take_bsdf, wby, gy)
    woz = torch.where(take_bsdf, wbz, gz)
    wl_x = torch.where(take_bsdf, wo_x, _dot3(sx, sy, sz, gx, gy, gz))
    wl_y = torch.where(take_bsdf, wo_y, _dot3(tx_, ty_, tz_, gx, gy, gz))
    wl_z = torch.where(take_bsdf, wo_z, _dot3(nx, ny, nz, gx, gy, gz))
    sampled_delta = take_bsdf & sampled_delta

    # f(wi, wo) and the BSDF pdf at the chosen direction (smooth lobes).
    cos_o = wl_z.clamp_min(0.0)
    f_ev = [torch.where(is_diff, a * (INV_PI * cos_o), 0.0)
            for a in (b_alr, b_alg, b_alb)]
    pdf_ev = torch.where(is_diff, cos_o * INV_PI, 0.0)
    if has_rc:
        hx, hy, hz = wi_x + wl_x, wi_y + wl_y, wi_z + wl_z
        inv_hl = torch.rsqrt((hx * hx + hy * hy + hz * hz).clamp_min(1e-20))
        hx, hy, hz = hx * inv_hl, hy * inv_hl, hz * inv_hl
        widoth = _dot3(wi_x, wi_y, wi_z, hx, hy, hz)
        d_h = bo._ggx_d(hz, b_alp)
        g_h = (bo._smith_g1(wi_x, wi_y, wi_z, hx, hy, hz, b_alp)
               * bo._smith_g1(wl_x, wl_y, wl_z, hx, hy, hz, b_alp))
        both = (wi_z > 1e-6) & (wl_z > 1e-6)
        spec = torch.where(both, d_h * g_h / (4.0 * wi_z).clamp_min(1e-12),
                           0.0)
        pdf_rc = torch.where(
            both,
            bo._vndf_pdf(wi_x, wi_y, wi_z, hx, hy, hz, b_alp)
            / (4.0 * _dot3(wl_x, wl_y, wl_z, hx, hy, hz).abs())
            .clamp_min(1e-12), 0.0)
        f_rc = fresnel.fresnel_conductor(widoth, b_eta[:, None], b_k)
        f_ev = [torch.where(is_rc, s * f_rc[:, c] * spec, f)
                for c, (s, f) in enumerate(zip((b_sr, b_sg, b_sb), f_ev))]
        pdf_ev = torch.where(is_rc, pdf_rc, pdf_ev)

    gmm_pdf = torch.where(guide_ok, torch.where(take_bsdf, pdf_b, pdf_g), 0.0)
    mis_pdf = h * pdf_ev + (1.0 - h) * gmm_pdf
    inv_mis = 1.0 / mis_pdf.clamp_min(1e-20)
    inv_h = 1.0 / h.clamp_min(1e-6)
    bw = [torch.where(sampled_delta, w * inv_h, f * inv_mis)
          for w, f in zip((w_r, w_g, w_b), f_ev)]
    ok_sample = torch.where(
        sampled_delta, good,
        (mis_pdf > 0.0) & ((f_ev[0] > 0.0) | (f_ev[1] > 0.0) | (f_ev[2] > 0.0))
        & (take_bsdf | g_ok))
    wo_dot_geo = _dot3(b_ngx, b_ngy, b_ngz, wox, woy, woz)
    ok_sample = ok_sample & ~(wo_dot_geo * wl_z <= 0.0)

    # Throughput, Russian roulette.
    depth = depth0 + 1
    survive = on_surface & ok_sample & (depth < max_depth)
    thr_n = [t * torch.where(survive, b, 1.0)
             for t, b in zip((thr_r, thr_g, thr_b), bw)]
    eta2_n = eta2 * torch.where(survive, eta_factor * eta_factor, 1.0)
    q = (torch.maximum(torch.maximum(thr_n[0], thr_n[1]), thr_n[2])
         * eta2_n).clamp_max(0.95)
    do_rr = (depth + 1) >= rr_depth
    survive = survive & ~(do_rr & (rand[4] >= q))
    rr_boost = torch.where(do_rr & survive, 1.0 / q.clamp_min(1e-6), 1.0)
    thr_n = [t * rr_boost for t in thr_n]

    # Film splat of the paths that end here; NaN radiance splats 0.
    done = alive & ~survive
    df = torch.where(done, 1.0, 0.0)
    ls = [torch.where(torch.isfinite(x), x, 0.0) * df
          for x in (li_r, li_g, li_b)]
    splat = torch.stack(ls + [x * x for x in ls] + [
        df, torch.where(on_surface, 1.0, 0.0),
        torch.where(cond_try, 1.0, 0.0), torch.where(cond_ok_ct, 1.0, 0.0)])

    off2 = torch.where(wo_dot_geo > 0, RAY_EPS, -RAY_EPS)
    zeros = torch.zeros_like(px_)
    nstate = torch.stack([
        px_ + b_ngx * off2, py_ + b_ngy * off2, pz_ + b_ngz * off2,
        wox, woy, woz, *thr_n, li_r, li_g, li_b, eta2_n, zeros, zeros, zeros])
    depth_packed = torch.where(survive, depth, 0) & _DEPTH_MASK
    nmeta = (pix | (depth_packed << _DEPTH_SHIFT)
             | torch.where(survive, _ALIVE, 0) | exh).to(torch.int32)
    return nstate, nmeta, splat


def _fn(symbol: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    fn = getattr(_build.load("guided_step"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def trace(state, meta, tri_rows, env_row, types):
    """Trace kernel for a lane wave: state [16, N] f32, meta [N] int32,
    tri_rows [43, T] and env_row [1, 128] from ``bounce.build_tables``,
    ``types`` the scene's BSDF type codes (attribute rows of absent types
    keep their defaults, as in the reference). Returns (new_state
    [16, N], hit [HIT_ROWS, N])."""
    if state.device.type == "cpu":
        return trace_plain(state, meta, tri_rows, env_row, types)
    n = meta.shape[0]
    n_tris = tri_rows.shape[1]
    _build.check_inputs("trace", (
        ("state", state, (16, n), torch.float32),
        ("meta", meta, (n,), torch.int32),
        ("tri_rows", tri_rows, (bo.TRI_ROWS, n_tris), torch.float32),
        ("env_row", env_row, (1, 128), torch.float32)))
    nstate = torch.empty_like(state)
    hit = torch.empty((HIT_ROWS, n), dtype=torch.float32, device=state.device)
    if n > 0:
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = _fn("trace_launch", 6, 3)(
            state.data_ptr(), meta.data_ptr(), tri_rows.data_ptr(),
            env_row.data_ptr(), nstate.data_ptr(), hit.data_ptr(), n,
            n_tris, _type_mask(types), stream)
        _build.check(rc, "trace")
        trace.launches += 1
    return nstate, hit


def shade(state, meta, hit, cpos, leaf, shade_table, rand, types,
          max_depth: int, rr_depth: int, bsdf_fraction: float):
    """Shade kernel for a lane wave: state [16, N], meta [N] int32, hit
    [HIT_ROWS, N] from ``trace``, cpos [3, N] canonical hit positions, leaf
    [N] int32 leaf slots, shade_table [L, PACK_COLS] bf16 from
    ``pack_shade_table`` (each lane reads its leaf's row), rand
    [RAND_ROWS, N] uniforms. Returns (new_state [16, N], new_meta [N],
    splat [SPLAT_ROWS, N])."""
    if state.device.type == "cpu":
        rows_t = unpack_sample_table(shade_table)[leaf.long()].T.float()
        return shade_plain(state, meta, hit, cpos, rows_t, rand, types,
                           max_depth, rr_depth, bsdf_fraction)
    n = meta.shape[0]
    _build.check_inputs("shade", (
        ("state", state, (16, n), torch.float32),
        ("meta", meta, (n,), torch.int32),
        ("hit", hit, (HIT_ROWS, n), torch.float32),
        ("cpos", cpos, (3, n), torch.float32),
        ("leaf", leaf, (n,), torch.int32),
        ("shade_table", shade_table, (shade_table.shape[0], PACK_COLS),
         torch.bfloat16),
        ("rand", rand, (RAND_ROWS, n), torch.float32)))
    if shade_table.data_ptr() % 16:
        raise ValueError("shade: shade_table must start on a 16-byte "
                         "boundary")
    nstate = torch.empty_like(state)
    nmeta = torch.empty_like(meta)
    splat = torch.empty((SPLAT_ROWS, n), dtype=torch.float32,
                        device=state.device)
    if n > 0:
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = _fn("shade_launch", 10, 4, 1)(
            state.data_ptr(), meta.data_ptr(), hit.data_ptr(),
            cpos.data_ptr(), leaf.data_ptr(), shade_table.data_ptr(),
            rand.data_ptr(), nstate.data_ptr(), nmeta.data_ptr(),
            splat.data_ptr(), n, shade_table.shape[0], max_depth, rr_depth,
            bsdf_fraction, stream)
        _build.check(rc, "shade")
        shade.launches += 1
    return nstate, nmeta, splat


def kernel_info(n_cols: int) -> dict[str, dict[str, int]]:
    """Registers, spilled (local) bytes, static shared bytes and resident
    blocks an SM of the trace and shade kernels, as built, trace's at the
    dynamic shared memory of an ``n_cols``-column triangle table."""
    return _build.kernel_info("guided_step", "guided_step_info",
                              ("trace", "shade"), n_cols)


trace.launches = 0
shade.launches = 0
