"""SDMM guided sampling: conditioning + mixture sample + pdf in one pass per
lane (port of sdmm_tpu/ops/guided_pallas.py).

``guided_sample`` is the wrapper of the hand-written CUDA kernel
``csrc/guided_sample.cu``: it reads each lane's row of the packed leaf
table of ``pack_sample_table`` directly, so no per-lane row matrix is
gathered. The packed table holds the float32 values of
``pack_guided_rows(...).T`` [L, 353], each component's 22 on a 24-value
stride (two pads), the init flag in component 0's first pad, so that every
component is six 16-byte words the kernel loads whole; it is built once per
render. For a CUDA tensor the wrapper launches the kernel; for a CPU tensor
it runs ``guided_sample_plain``, the plain PyTorch twin of the same math,
which keeps the reference function's attribute-major [C, N] layout at its
boundary.

Semantics follow the reference kernel's ``guided_tile`` exactly: log-space
conditioning weights with max-subtraction, the 3σ trust-region clamp of the
conditional mean, normalise-then-zero-by-exp-range weights, CDF component
selection, a Box–Muller tangent sample, the mixture pdf at the guided and
at the BSDF-sampled direction, and the same cubic arccos.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

K = 16  # components per leaf
ROWS_PER_K = 22
# Per-component row layout (offsets within a component's 22-row block):
#  0      weight * prep.valid
#  1-3    mu_a (spatial mean)
#  4-9    marg_inv_chol lower (m00, m10, m11, m20, m21, m22)
#  10-15  premult [2, 3] row-major
#  16-18  mu_dir (unit mean direction; the frame is rebuilt from it)
#  19-21  cond_chol lower (c00, c10, c11)
N_ROWS = K * ROWS_PER_K + 1  # + initialized flag row = 353
# The packed table (csrc/guided_tile.cuh RowPackedF32, and RowPacked for
# shade's bf16 copy): per leaf K components of PACK_STRIDE values, the init
# flag at value PACK_INIT, which is component 0's first pad.
PACK_STRIDE = 24
PACK_COLS = K * PACK_STRIDE
PACK_INIT = ROWS_PER_K
_NEG = -1.0e30
_SINC_EPS = 1e-4


def pack_guided_rows(prep, weight: torch.Tensor,
                     initialized: torch.Tensor) -> torch.Tensor:
    """[L]-leaf conditioning table → [N_ROWS, L] attribute-major rows
    (the reference layout; the kernel takes its transpose, [L, N_ROWS])."""
    w = weight * prep.valid.to(weight.dtype)
    mic = prep.marg_inv_chol
    pm = prep.premult.reshape(*prep.premult.shape[:-2], 6)
    cc = prep.cond_chol
    per_k = torch.stack([
        w,
        prep.mu_a[..., 0], prep.mu_a[..., 1], prep.mu_a[..., 2],
        mic[..., 0, 0], mic[..., 1, 0], mic[..., 1, 1],
        mic[..., 2, 0], mic[..., 2, 1], mic[..., 2, 2],
        pm[..., 0], pm[..., 1], pm[..., 2], pm[..., 3], pm[..., 4], pm[..., 5],
        prep.rot[..., 0, 2], prep.rot[..., 1, 2], prep.rot[..., 2, 2],
        cc[..., 0, 0], cc[..., 1, 0], cc[..., 1, 1],
    ], dim=0)  # [22, L, K]
    L = weight.shape[0]
    rows = per_k.permute(2, 0, 1).reshape(K * ROWS_PER_K, L)
    return torch.cat([rows, initialized.to(torch.float32)[None, :]],
                     dim=0).to(torch.float32)


def pack_sample_table(table, dtype=torch.float32):
    """The [L, N_ROWS] conditioning table (``pack_guided_rows(...).T``) →
    the [L, PACK_COLS] table the kernels read, in ``dtype``: the same
    values, each component's ROWS_PER_K on a PACK_STRIDE stride, the init
    flag in the pad slot PACK_INIT, the other pads 0."""
    t = table.to(dtype)
    L = t.shape[0]
    out = torch.zeros((L, K, PACK_STRIDE), dtype=dtype, device=t.device)
    out[:, :, :ROWS_PER_K] = t[:, :K * ROWS_PER_K].reshape(L, K, ROWS_PER_K)
    out[:, 0, PACK_INIT] = t[:, N_ROWS - 1]
    return out.reshape(L, PACK_COLS)


def unpack_sample_table(packed):
    """Inverse of ``pack_sample_table``: [L, PACK_COLS] → [L, N_ROWS] in
    the packed table's dtype."""
    comp = packed.reshape(packed.shape[0], K, PACK_STRIDE)
    return torch.cat([comp[:, :, :ROWS_PER_K].reshape(packed.shape[0], -1),
                      comp[:, 0, PACK_INIT:PACK_INIT + 1]], dim=1)


def _sinc(x):
    small = x.abs() < _SINC_EPS
    safe = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def _acos(x):
    """Abramowitz & Stegun 4.4.45 cubic with the sqrt(1-x) prefactor, as in
    the reference kernel (~1e-4 relative angle accuracy)."""
    xa = x.abs()
    poly = 1.5707288 + xa * (-0.2121144 + xa * (0.0742610 - 0.0187293 * xa))
    ang = torch.sqrt((1.0 - xa).clamp_min(0.0)) * poly
    return torch.where(x >= 0.0, ang, math.pi - ang)


def _coord_system(mx, my, mz):
    """Duff et al. branchless frame; returns (s, t) as coordinate tuples."""
    sign = torch.where(mz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + mz)
    b = mx * my * a
    return ((1.0 + sign * mx * mx * a, sign * b, -sign * mx),
            (b, sign + my * my * a, -my))


def _log_map_pdf(s, t, m, d, i00, i10, i11, inv_det):
    """pdf_k(d) under the conditional component with frame (s, t, m) and
    2x2 inverse Cholesky i."""
    dx, dy, dz = d
    rel0 = s[0] * dx + s[1] * dy + s[2] * dz
    rel1 = t[0] * dx + t[1] * dy + t[2] * dz
    rel2 = m[0] * dx + m[1] * dy + m[2] * dz
    cosa = rel2.clamp(-1.0, 1.0)
    ok = (cosa > -1.0 + 1e-7) & ((dx * dx + dy * dy + dz * dz) > 0.0)
    sina = torch.sqrt((1.0 - cosa * cosa).clamp_min(0.0))
    aos = torch.where(sina < 1e-3, 1.0, _acos(cosa) / sina.clamp_min(1e-12))
    t0 = rel0 * aos
    t1 = rel1 * aos
    z0 = i00 * t0
    z1 = i10 * t0 + i11 * t1
    pdf = (1.0 / (2.0 * math.pi)) * torch.exp(-0.5 * (z0 * z0 + z1 * z1)) \
        * inv_det * aos
    return torch.where(ok, pdf, 0.0)


def guided_sample_plain(rows_t: torch.Tensor, pos: torch.Tensor,
                        wo_b: torch.Tensor, u: torch.Tensor):
    """Plain PyTorch twin of the kernel, vectorized over the K components.

    rows_t [N_ROWS, N] gathered rows; pos, wo_b, u [3, N] (canonical
    position, BSDF-sampled world direction, uniforms for component select /
    Box–Muller r / Box–Muller θ). Returns (d_guide [3, N], g_ok [N],
    pdf_guide [N], pdf_bsdf [N], guide_valid [N]).
    """
    n = rows_t.shape[1]
    r = rows_t[: K * ROWS_PER_K].reshape(K, ROWS_PER_K, n)
    px, py, pz = pos[0], pos[1], pos[2]
    d0 = px - r[:, 1]
    d1 = py - r[:, 2]
    d2 = pz - r[:, 3]
    m00, m10, m11, m20, m21, m22 = (r[:, j] for j in range(4, 10))
    z0 = m00 * d0
    z1 = m10 * d0 + m11 * d1
    z2 = m20 * d0 + m21 * d1 + m22 * d2
    q = z0 * z0 + z1 * z1 + z2 * z2
    wd = r[:, 0] * m00 * m11 * m22
    lw = torch.where(wd > 0.0, torch.log(wd.clamp_min(1e-38)) - 0.5 * q, _NEG)
    cl = (3.0 / torch.sqrt(q.clamp_min(1e-30))).clamp_max(1.0)
    tm0 = cl * (r[:, 10] * d0 + r[:, 11] * d1 + r[:, 12] * d2)
    tm1 = cl * (r[:, 13] * d0 + r[:, 14] * d1 + r[:, 15] * d2)

    lmax = lw.max(dim=0).values.clamp_min(_NEG)
    cond_valid = (lmax > 0.5 * _NEG) & (lmax < -_NEG)
    lref = torch.where(cond_valid, lmax, 0.0)
    wt = torch.exp((lw - lref).clamp_min(-80.0)) \
        * torch.where(lw > 0.5 * _NEG, 1.0, 0.0)
    total = wt.sum(dim=0)
    inv_total = torch.where(cond_valid, 1.0 / total.clamp_min(1e-38), 0.0)

    # Conditional mean directions: exp map in each component's frame.
    ln = torch.sqrt((tm0 * tm0 + tm1 * tm1).clamp_min(0.0))
    exp_ok = ln < math.pi
    s_ = _sinc(ln)
    rel0, rel1, rel2 = tm0 * s_, tm1 * s_, torch.cos(ln)
    mdx, mdy, mdz = r[:, 16], r[:, 17], r[:, 18]
    cs, ct = _coord_system(mdx, mdy, mdz)
    mu = (cs[0] * rel0 + ct[0] * rel1 + mdx * rel2,
          cs[1] * rel0 + ct[1] * rel1 + mdy * rel2,
          cs[2] * rel0 + ct[2] * rel1 + mdz * rel2)
    wnorm = torch.where(exp_ok, wt * inv_total, 0.0)

    # Component selection by CDF.
    cdf = torch.cumsum(wnorm, dim=0)
    sel = (u[0][None] > cdf).sum(dim=0).clamp_max(K - 1)
    idx = sel[None].long()

    def pick(a):
        return a.gather(0, idx)[0]

    sel_mu = tuple(pick(a) for a in mu)
    c00, c10, c11 = pick(r[:, 19]), pick(r[:, 20]), pick(r[:, 21])

    # Box–Muller sample in the selected component's tangent frame.
    rad = torch.sqrt((-2.0 * torch.log(1.0 - u[1].clamp_max(1.0 - 1e-7)))
                     .clamp_min(0.0))
    th = 2.0 * math.pi * u[2]
    zz0 = rad * torch.sin(th)
    zz1 = rad * torch.cos(th)
    t0 = c00 * zz0
    t1 = c10 * zz0 + c11 * zz1
    lg = torch.sqrt((t0 * t0 + t1 * t1).clamp_min(0.0))
    g_ok = lg < math.pi
    sg = _sinc(lg)
    gs, gt = _coord_system(*sel_mu)
    rg0, rg1, rg2 = t0 * sg, t1 * sg, torch.cos(lg)
    g = tuple(gs[j] * rg0 + gt[j] * rg1 + sel_mu[j] * rg2 for j in range(3))

    # Mixture pdf at both candidate directions.
    fs, ft = _coord_system(*mu)
    cc00, cc10, cc11 = r[:, 19], r[:, 20], r[:, 21]
    i00 = 1.0 / cc00
    i11 = 1.0 / cc11
    i10 = -cc10 * i00 * i11
    inv_det = i00 * i11
    gk = tuple(a[None] for a in g)
    bk = tuple(wo_b[j][None] for j in range(3))
    pdf_g = (wnorm * _log_map_pdf(fs, ft, mu, gk, i00, i10, i11, inv_det)
             ).sum(dim=0)
    pdf_b = (wnorm * _log_map_pdf(fs, ft, mu, bk, i00, i10, i11, inv_det)
             ).sum(dim=0)
    init = rows_t[N_ROWS - 1] > 0.5
    return torch.stack(g, dim=0), g_ok, pdf_g, pdf_b, cond_valid & init


def _lib():
    lib = _build.load("guided_sample")
    fn = lib.guided_sample_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def guided_sample(table: torch.Tensor, leaf: torch.Tensor, pos: torch.Tensor,
                  wo_b: torch.Tensor, u: torch.Tensor):
    """Guided sampling for a lane wave.

    table [L, PACK_COLS] f32 (``pack_sample_table``, 16-byte aligned);
    leaf [N] int32; pos, wo_b, u [N, 3] f32 (lane-major). Returns (d_guide
    [N, 3], g_ok [N], pdf_guide [N], pdf_bsdf [N], guide_valid [N]). CUDA
    tensors launch the kernel; CPU tensors run the plain twin.
    """
    if table.device.type == "cpu":
        rows_t = unpack_sample_table(table)[leaf.long()].T
        d, g_ok, pdf_g, pdf_b, valid = guided_sample_plain(
            rows_t, pos.T, wo_b.T, u.T)
        return d.T, g_ok, pdf_g, pdf_b, valid
    n = leaf.shape[0]
    _build.check_inputs("guided_sample", (
        ("table", table, (table.shape[0], PACK_COLS), torch.float32),
        ("leaf", leaf, (n,), torch.int32),
        ("pos", pos, (n, 3), torch.float32),
        ("wo_b", wo_b, (n, 3), torch.float32),
        ("u", u, (n, 3), torch.float32)))
    if table.data_ptr() % 16:
        raise ValueError("guided_sample: table must start on a 16-byte "
                         "boundary")
    dg = torch.empty((n, 3), dtype=torch.float32, device=table.device)
    misc = torch.empty((n, 4), dtype=torch.float32, device=table.device)
    if n > 0:
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _lib()(table.data_ptr(), leaf.data_ptr(), pos.data_ptr(),
                    wo_b.data_ptr(), u.data_ptr(), dg.data_ptr(),
                    misc.data_ptr(), n, table.shape[0], stream)
        _build.check(rc, "guided_sample")
        guided_sample.launches += 1
    return dg, misc[:, 0] > 0.5, misc[:, 1], misc[:, 2], misc[:, 3] > 0.5


def kernel_info() -> dict[str, dict[str, int]]:
    """Registers, spilled (local) bytes, static shared bytes and resident
    blocks an SM of the guided-sampling kernel, as built."""
    return _build.kernel_info("guided_sample", "guided_sample_info",
                              ("guided_sample",))


guided_sample.launches = 0
