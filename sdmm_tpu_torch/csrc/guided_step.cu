// The fused guided bounce for NVIDIA Hopper (sm_90a): a trace kernel and a
// shade kernel around the PyTorch leaf lookup.
//
// Replaces the TPU kernels of sdmm_tpu/ops/guided_step_pallas.py: trace
// (pallas_call over _trace_kernel) and shade (pallas_call over
// _shade_kernel). Lane data are the reference's attribute-major arrays
// flattened to [rows, N]: state [16, N], meta [N], hit [22, N], cpos [3, N],
// rand [8, N], splat [10, N]. One thread owns one lane, so every row read
// and write of a warp is one coalesced 128-byte transaction. The lane count
// needs no padding: the tail block is masked.
//
// trace_kernel. The closest-hit sweep visits the triangles in index order
// with a strict t < best_t, so among equal t the lowest index wins, as in
// the reference; its arithmetic is rounded after every operation in the
// plain twin's order (bounce_math.cuh woop_tri), so kernel and twin pick
// the same winner. The reference re-sweeps all triangles to select the
// winner's attributes because a TPU tile cannot gather; here the thread
// reads the winner's attribute column once by its index. Bound: per lane
// the 16 state rows and meta in, 16 state and 22 hit rows out (220
// bytes), against ~60 operations per triangle and ~80 after the sweep. On
// an H100 (3.35 TB/s, 67 TFLOP/s FP32) bytes bound it up to ~72
// triangles: at the Cornell box's 36 and 131,072 lanes, 28.8 MB or 8.6 us
// against 2.9e8 operations or 4.4 us (chip_smoke.py computes both from the
// run). Design: the block stages the scene's Woop rows once as 16-byte
// [T][12] rows and sweeps them UNROLL triangles at a time (woop_stage.cuh,
// shared with the path kernels; past STAGE_MAX triangles, chunks of the
// same layout); a launch bound of TRACE_BLOCKS keeps a wave of 131,072
// lanes in one round. The sweep is
// most of the time: on one H100 at 700 W, with the lane's traffic cut to
// the ray and four hit rows, the earlier design took 0.0192 ms of its
// 0.0228, and loading the lane's other rows before the staging, to have
// them in flight during the sweep, was 2-5% slower than loading them after
// it (PERF.md section 6).
//
// shade_kernel. Shading frame, the BSDF sample of the lane's type (a
// run-time branch where the reference specialised on the scene's type set;
// a lane's results are the same), guided_tile.cuh on the lane's leaf row,
// the one-sample MIS combine, Russian roulette, the 10 splat rows and the
// new meta word. Bound: per lane it reads state rows 3-12 (40 bytes:
// direction, throughput, radiance, eta^2), meta, 22 hit rows, cpos, leaf
// and 8 rand rows, and writes 16 state rows, meta and 10 splat rows: 288
// bytes, plus the table's bf16 values once (1.4 MB at 2048 leaves).
// Against ~4,100 operations per lane (the mixture's 16 components
// dominate) bytes bound it: at 131,072 lanes 39.2 MB or 11.7 us against
// 5.4e8 operations or 8.0 us (chip_smoke.py computes both).
//
// Design. Neighbouring lanes hold different leaves, so every warp-wide
// load of the table touches up to 32 cache lines: what costs is the number
// of load instructions and their latency, not bytes (the table stays in
// L2). The table comes packed once per render (ops/guided_step.
// pack_shade_table: [L, 384] bfloat16, each component 24 values or three
// 16-byte words, every row 16-byte aligned), so a component's pass-1 block
// is two 16-byte loads and its pass-4 block one: 50 loads a lane where the
// [L, 353] row took 359 two-byte loads. The per-component log-weights and
// tangent means (48 floats) live in the thread's column of a 24 KB shared
// array, and the kernel runs in three parts (the BSDF sample;
// guided_tile; the combine on the lane's rows read again), so that little
// stays live across the mixture math: 64 registers and eight blocks an SM
// (SHADE_BLOCKS), where the [L, 353] design took 148 and three. One H100
// at 700 W took ~0.074 ms at 131,072 lanes on 2048 random leaves, ~0.056
// ms with every lane on one leaf (PERF.md section 6): the mixture math,
// not the gather, is most of it now.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_math.cuh"
#include "guided_tile.cuh"
#include "woop_stage.cuh"

namespace {

using namespace bounce;

constexpr int THREADS = 128;
// Resident blocks an SM that trace and shade ask for: 64 registers.
constexpr int TRACE_BLOCKS = 8;
constexpr int SHADE_BLOCKS = 8;

// type_mask bits: multi (a non-diffuse type is present), conductor,
// dielectric, rough conductor. Attribute rows a type set never reads keep
// their defaults, as in the reference's hit buffer.
constexpr int M_MULTI = 1, M_COND = 2, M_DIEL = 4, M_RC = 8;

__global__ void __launch_bounds__(THREADS, TRACE_BLOCKS)
trace_kernel(const float* __restrict__ state, const int* __restrict__ meta,
             const float* __restrict__ tri, const float* __restrict__ env,
             float* __restrict__ nstate, float* __restrict__ hit, int n,
             int n_tris, int type_mask) {
  extern __shared__ float4 wr[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const int li = active ? i : n - 1;
  const size_t N = (size_t)n;
  const float rox = state[0 * N + li], roy = state[1 * N + li],
              roz = state[2 * N + li];
  const float rdx = state[3 * N + li], rdy = state[4 * N + li],
              rdz = state[5 * N + li];

  float best_t = INF, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  if (n_tris <= STAGE_MAX) {
    stage_woop(wr, tri, n_tris, 0, n_tris);
    __syncthreads();
    closest_sweep(wr, round_up(n_tris, UNROLL), 0, rox, roy, roz, rdx, rdy,
                  rdz, best_t, bu, bv, bj);
  } else {
    for (int base = 0; base < n_tris; base += TILE) {
      const int cnt = min(TILE, n_tris - base);
      __syncthreads();
      stage_woop(wr, tri, n_tris, base, cnt);
      __syncthreads();
      closest_sweep(wr, round_up(cnt, UNROLL), base, rox, roy, roz, rdx, rdy,
                    rdz, best_t, bu, bv, bj);
    }
  }
  if (!active) return;

  const bool alive = (meta[i] & ALIVE) != 0;
  const bool hit_valid = best_t < INF;
  const bool multi = type_mask & M_MULTI;
  const bool has_rc = type_mask & M_RC;
  const bool eta_sp = type_mask & (M_COND | M_DIEL | M_RC);
  const bool k_rows = type_mask & (M_COND | M_RC);
  const float* __restrict__ col = tri + (hit_valid ? bj : 0);
  const size_t T = (size_t)n_tris;
  auto attr = [&](int row, float dflt, bool wanted) {
    return (hit_valid && wanted) ? __ldg(col + row * T) : dflt;
  };
  const float ngx = attr(TNG + 0, 0.0f, true), ngy = attr(TNG + 1, 0.0f, true),
              ngz = attr(TNG + 2, 1.0f, true);
  float ns[3];
  const float w0 = 1.0f - bu - bv;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ns[c] = hit_valid ? __ldg(col + (TNS + c) * T) * w0 +
                            __ldg(col + (TNS + 3 + c) * T) * bu +
                            __ldg(col + (TNS + 6 + c) * T) * bv
                      : (c == 2 ? 1.0f : 0.0f);
  }
  const float inv_ns =
      rsqrtf(fmaxf(ns[0] * ns[0] + ns[1] * ns[1] + ns[2] * ns[2], 1e-20f));

  const float t_safe = hit_valid ? best_t : 0.0f;
  // Emitter hit with MIS weight 1 (front side), constant-env escape.
  const float cos_l_hit = -dot3(ngx, ngy, ngz, rdx, rdy, rdz);
  const float gain = (alive && hit_valid && cos_l_hit > 0.0f) ? 1.0f : 0.0f;
  const float escf = (alive && !hit_valid) ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float x = state[r * N + i];
    if (r >= 9 && r < 12) {
      const int c = r - 9;
      const float thr = state[(6 + c) * N + i];
      x = x + thr * attr(TEM + c, 0.0f, true) * gain;
      x = x + thr * env[c] * escf;
    }
    nstate[r * N + i] = x;
  }

  float* __restrict__ h = hit + i;
  h[0 * N] = rox + t_safe * rdx;
  h[1 * N] = roy + t_safe * rdy;
  h[2 * N] = roz + t_safe * rdz;
  h[3 * N] = ngx;
  h[4 * N] = ngy;
  h[5 * N] = ngz;
  h[6 * N] = ns[0] * inv_ns;
  h[7 * N] = ns[1] * inv_ns;
  h[8 * N] = ns[2] * inv_ns;
  h[9 * N] = attr(TAL + 0, 0.0f, true);
  h[10 * N] = attr(TAL + 1, 0.0f, true);
  h[11 * N] = attr(TAL + 2, 0.0f, true);
  h[12 * N] = attr(TTY, 0.0f, multi);
  h[13 * N] = attr(TALP, 0.0f, has_rc);
  h[14 * N] = attr(TETA, 1.0f, eta_sp);
  h[15 * N] = attr(TK + 0, 0.0f, k_rows);
  h[16 * N] = attr(TK + 1, 0.0f, k_rows);
  h[17 * N] = attr(TK + 2, 0.0f, k_rows);
  h[18 * N] = attr(TSP + 0, 1.0f, eta_sp);
  h[19 * N] = attr(TSP + 1, 1.0f, eta_sp);
  h[20 * N] = attr(TSP + 2, 1.0f, eta_sp);
  h[21 * N] = (alive && hit_valid) ? 1.0f : 0.0f;
}

// The lane's shading frame: the shading normal flipped toward the ray
// except on dielectrics, its tangents s and t, and -rd in the frame.
struct Frame {
  float n[3], s[3], t[3], wi[3];
};

__device__ __forceinline__ Frame shading_frame(float rdx, float rdy,
                                               float rdz, float nsx,
                                               float nsy, float nsz,
                                               bool is_diel) {
  Frame f;
  const float cos_i_ns = -dot3(nsx, nsy, nsz, rdx, rdy, rdz);
  const float flip = (cos_i_ns < 0.0f && !is_diel) ? -1.0f : 1.0f;
  f.n[0] = nsx * flip;
  f.n[1] = nsy * flip;
  f.n[2] = nsz * flip;
  coordinate_system(f.n[0], f.n[1], f.n[2], f.s, f.t);
  f.wi[0] = -dot3(f.s[0], f.s[1], f.s[2], rdx, rdy, rdz);
  f.wi[1] = -dot3(f.t[0], f.t[1], f.t[2], rdx, rdy, rdz);
  f.wi[2] = -dot3(f.n[0], f.n[1], f.n[2], rdx, rdy, rdz);
  return f;
}

// Three parts, so that little stays live across the mixture math: the
// BSDF sample, guided_tile, then the combine on values read again.
__global__ void __launch_bounds__(THREADS, SHADE_BLOCKS)
shade_kernel(const float* __restrict__ state, const int* __restrict__ meta,
             const float* __restrict__ hit, const float* __restrict__ cpos,
             const int* __restrict__ leaf, const uint4* __restrict__ table,
             const float* __restrict__ rand, float* __restrict__ nstate,
             int* __restrict__ nmeta, float* __restrict__ splat, int n,
             int n_leaves, int max_depth, int rr_depth, float bsdf_fraction) {
  __shared__ float slots[3 * guided::K][THREADS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const float* __restrict__ rr = rand + i;

  // ---- part 1: the BSDF sample of the lane's type ----
  float wo_x, wo_y, wo_z, w_r, w_g, w_b, eta_factor = 1.0f;
  bool good, sampled_delta = false;
  float wbx, wby, wbz;
  {
    const float* __restrict__ hr = hit + i;
    const float b_ty = hr[12 * N];
    const bool is_cond = b_ty == (float)T_CONDUCTOR;
    const bool is_diel = b_ty == (float)T_DIELECTRIC;
    const bool is_rc = b_ty == (float)T_ROUGHCONDUCTOR;
    const Frame f = shading_frame(state[3 * N + i], state[4 * N + i],
                                  state[5 * N + i], hr[6 * N], hr[7 * N],
                                  hr[8 * N], is_diel);
    const float wi_x = f.wi[0], wi_y = f.wi[1], wi_z = f.wi[2];
    const float alr = hr[9 * N], alg = hr[10 * N], alb = hr[11 * N];
    disk_concentric(rr[2 * N], rr[3 * N], &wo_x, &wo_y);
    wo_z = sqrtf(fmaxf(0.0f, 1.0f - wo_x * wo_x - wo_y * wo_y));
    w_r = alr, w_g = alg, w_b = alb;
    good = alr > 0.0f || alg > 0.0f || alb > 0.0f;
    if (is_cond) {
      const float b_eta = hr[14 * N];
      const float f_r = fresnel_conductor_1(wi_z, b_eta, hr[15 * N]);
      const float f_g = fresnel_conductor_1(wi_z, b_eta, hr[16 * N]);
      const float f_b = fresnel_conductor_1(wi_z, b_eta, hr[17 * N]);
      wo_x = -wi_x;
      wo_y = -wi_y;
      wo_z = wi_z;
      w_r = hr[18 * N] * f_r;
      w_g = hr[19 * N] * f_g;
      w_b = hr[20 * N] * f_b;
      good = f_r > 0.0f || f_g > 0.0f || f_b > 0.0f;
      sampled_delta = true;
    } else if (is_diel) {
      float cos_t, eta_it, eta_ti;
      const float fr =
          fresnel_dielectric(wi_z, hr[14 * N], &cos_t, &eta_it, &eta_ti);
      const bool refl = rr[1 * N] < fr;
      wo_x = refl ? -wi_x : -wi_x * eta_ti;
      wo_y = refl ? -wi_y : -wi_y * eta_ti;
      wo_z = refl ? wi_z : cos_t;
      w_r = refl ? hr[18 * N] : alr * eta_ti * eta_ti;
      w_g = refl ? hr[19 * N] : alg * eta_ti * eta_ti;
      w_b = refl ? hr[20 * N] : alb * eta_ti * eta_ti;
      good = w_r > 0.0f || w_g > 0.0f || w_b > 0.0f;
      sampled_delta = true;
      eta_factor = refl ? 1.0f : eta_it;
    } else if (is_rc) {
      float mx, my, mz;
      sample_vndf(wi_x, wi_y, wi_z, hr[13 * N], rr[2 * N], rr[3 * N], &mx,
                  &my, &mz);
      const float widm = dot3(wi_x, wi_y, wi_z, mx, my, mz);
      wo_x = 2.0f * widm * mx - wi_x;
      wo_y = 2.0f * widm * my - wi_y;
      wo_z = 2.0f * widm * mz - wi_z;
      good = wo_z > 1e-6f;
    }
    wbx = f.s[0] * wo_x + f.t[0] * wo_y + f.n[0] * wo_z;
    wby = f.s[1] * wo_x + f.t[1] * wo_y + f.n[1] * wo_z;
    wbz = f.s[2] * wo_x + f.t[2] * wo_y + f.n[2] * wo_z;
  }

  // ---- part 2: the guided mixture on the leaf's packed bfloat16 row ----
  const int l = min(max(leaf[i], 0), n_leaves - 1);
  const guided::RowPacked row{table + (size_t)l * (guided::PROW / 8)};
  guided::SharedSlots sl{&slots[0][threadIdx.x], THREADS};
  const guided::TileOut g = guided::guided_tile(
      row, sl,
      guided::LaneValues{{cpos[i], cpos[N + i], cpos[2 * N + i]},
                         {wbx, wby, wbz},
                         {rr[5 * N], rr[6 * N], rr[7 * N]}});

  // ---- part 3: the lane's rows read again ----
  const float* __restrict__ st = guided::reread(state) + i;
  const float* __restrict__ hr = guided::reread(hit) + i;
  const float rdx = st[3 * N], rdy = st[4 * N], rdz = st[5 * N];
  const int m = meta[i];
  const bool alive = (m & ALIVE) != 0;
  const int depth0 = (m >> DEPTH_SHIFT) & DEPTH_MASK;
  const int pix = m & PIX_MASK;
  const int exh = m & EXH;
  const float ngx = hr[3 * N], ngy = hr[4 * N], ngz = hr[5 * N];
  const float b_ty = hr[12 * N];
  const bool is_diff = b_ty == (float)T_DIFFUSE;
  const bool is_cond = b_ty == (float)T_CONDUCTOR;
  const bool is_diel = b_ty == (float)T_DIELECTRIC;
  const bool is_rc = b_ty == (float)T_ROUGHCONDUCTOR;
  const Frame f = shading_frame(rdx, rdy, rdz, hr[6 * N], hr[7 * N],
                                hr[8 * N], is_diel);
  const float wi_x = f.wi[0], wi_y = f.wi[1], wi_z = f.wi[2];
  const float wi_dot_geo = -dot3(ngx, ngy, ngz, rdx, rdy, rdz);
  const bool on_surface =
      alive && hr[21 * N] > 0.5f && !(wi_dot_geo * wi_z < 0.0f);
  const bool delta_only = is_cond || is_diel;

  const bool guide_valid = g.cond_valid && g.init;
  const bool guide_ok = guide_valid && !delta_only;
  const float h = guide_ok ? bsdf_fraction : 1.0f;
  const bool take_bsdf = rr[0] < h || !guide_ok;
  const bool cond_try = on_surface && g.init && !delta_only;
  const bool cond_ok = cond_try && g.cond_valid;

  const float gx = g.d[0], gy = g.d[1], gz = g.d[2];
  const float wox = take_bsdf ? wbx : gx;
  const float woy = take_bsdf ? wby : gy;
  const float woz = take_bsdf ? wbz : gz;
  const float wl_x =
      take_bsdf ? wo_x : dot3(f.s[0], f.s[1], f.s[2], gx, gy, gz);
  const float wl_y =
      take_bsdf ? wo_y : dot3(f.t[0], f.t[1], f.t[2], gx, gy, gz);
  const float wl_z =
      take_bsdf ? wo_z : dot3(f.n[0], f.n[1], f.n[2], gx, gy, gz);
  sampled_delta = take_bsdf && sampled_delta;

  // ---- f(wi, wo) and the BSDF pdf at the chosen direction ----
  const float cos_o = fmaxf(wl_z, 0.0f);
  const float alr = hr[9 * N], alg = hr[10 * N], alb = hr[11 * N];
  float f_r = is_diff ? alr * (INV_PI * cos_o) : 0.0f;
  float f_g = is_diff ? alg * (INV_PI * cos_o) : 0.0f;
  float f_b = is_diff ? alb * (INV_PI * cos_o) : 0.0f;
  float pdf_ev = is_diff ? cos_o * INV_PI : 0.0f;
  if (is_rc) {
    const float b_alp = hr[13 * N], b_eta = hr[14 * N];
    float hx = wi_x + wl_x, hy = wi_y + wl_y, hz = wi_z + wl_z;
    const float inv_hl = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
    hx *= inv_hl;
    hy *= inv_hl;
    hz *= inv_hl;
    const float widoth = dot3(wi_x, wi_y, wi_z, hx, hy, hz);
    const float d_h = ggx_d(hz, b_alp);
    const float g_h = smith_g1(wi_x, wi_y, wi_z, hx, hy, hz, b_alp) *
                      smith_g1(wl_x, wl_y, wl_z, hx, hy, hz, b_alp);
    const bool both = wi_z > 1e-6f && wl_z > 1e-6f;
    const float spec = both ? d_h * g_h / fmaxf(4.0f * wi_z, 1e-12f) : 0.0f;
    pdf_ev = both ? vndf_pdf(wi_x, wi_y, wi_z, hx, hy, hz, b_alp) /
                        fmaxf(4.0f * fabsf(dot3(wl_x, wl_y, wl_z, hx, hy, hz)),
                              1e-12f)
                  : 0.0f;
    f_r = hr[18 * N] * fresnel_conductor_1(widoth, b_eta, hr[15 * N]) * spec;
    f_g = hr[19 * N] * fresnel_conductor_1(widoth, b_eta, hr[16 * N]) * spec;
    f_b = hr[20 * N] * fresnel_conductor_1(widoth, b_eta, hr[17 * N]) * spec;
  }

  // ---- one-sample MIS combine ----
  const float gmm_pdf = guide_ok ? (take_bsdf ? g.pdf_b : g.pdf_g) : 0.0f;
  const float mis_pdf = h * pdf_ev + (1.0f - h) * gmm_pdf;
  const float inv_mis = 1.0f / fmaxf(mis_pdf, 1e-20f);
  const float inv_h = 1.0f / fmaxf(h, 1e-6f);
  const float bw_r = sampled_delta ? w_r * inv_h : f_r * inv_mis;
  const float bw_g = sampled_delta ? w_g * inv_h : f_g * inv_mis;
  const float bw_b = sampled_delta ? w_b * inv_h : f_b * inv_mis;
  bool ok_sample = sampled_delta
                       ? good
                       : (mis_pdf > 0.0f &&
                          (f_r > 0.0f || f_g > 0.0f || f_b > 0.0f) &&
                          (take_bsdf || g.g_ok));
  const float wo_dot_geo = dot3(ngx, ngy, ngz, wox, woy, woz);
  ok_sample = ok_sample && !(wo_dot_geo * wl_z <= 0.0f);

  // ---- throughput and Russian roulette ----
  const float thr_r = st[6 * N], thr_g = st[7 * N], thr_b = st[8 * N];
  const float eta2 = st[12 * N];
  const int depth = depth0 + 1;
  bool survive = on_surface && ok_sample && depth < max_depth;
  float tr = thr_r * (survive ? bw_r : 1.0f);
  float tg = thr_g * (survive ? bw_g : 1.0f);
  float tb = thr_b * (survive ? bw_b : 1.0f);
  const float eta2_n = eta2 * (survive ? eta_factor * eta_factor : 1.0f);
  const float q = fminf(fmaxf(fmaxf(tr, tg), tb) * eta2_n, 0.95f);
  const bool do_rr = depth + 1 >= rr_depth;
  survive = survive && !(do_rr && rr[4 * N] >= q);
  const float rr_boost = (do_rr && survive) ? 1.0f / fmaxf(q, 1e-6f) : 1.0f;
  tr *= rr_boost;
  tg *= rr_boost;
  tb *= rr_boost;

  // ---- film splat of the paths that end here (NaN radiance splats 0) ----
  const float li_r = st[9 * N], li_g = st[10 * N], li_b = st[11 * N];
  const bool done = alive && !survive;
  const float df = done ? 1.0f : 0.0f;
  const float ls_r = (isfinite(li_r) ? li_r : 0.0f) * df;
  const float ls_g = (isfinite(li_g) ? li_g : 0.0f) * df;
  const float ls_b = (isfinite(li_b) ? li_b : 0.0f) * df;
  float* __restrict__ sp = splat + i;
  sp[0 * N] = ls_r;
  sp[1 * N] = ls_g;
  sp[2 * N] = ls_b;
  sp[3 * N] = ls_r * ls_r;
  sp[4 * N] = ls_g * ls_g;
  sp[5 * N] = ls_b * ls_b;
  sp[6 * N] = df;
  sp[7 * N] = on_surface ? 1.0f : 0.0f;
  sp[8 * N] = cond_try ? 1.0f : 0.0f;
  sp[9 * N] = cond_ok ? 1.0f : 0.0f;

  // ---- next lane state ----
  const float off2 = wo_dot_geo > 0.0f ? RAY_EPS : -RAY_EPS;
  float* __restrict__ ns = nstate + i;
  ns[0 * N] = hr[0 * N] + ngx * off2;
  ns[1 * N] = hr[1 * N] + ngy * off2;
  ns[2 * N] = hr[2 * N] + ngz * off2;
  ns[3 * N] = wox;
  ns[4 * N] = woy;
  ns[5 * N] = woz;
  ns[6 * N] = tr;
  ns[7 * N] = tg;
  ns[8 * N] = tb;
  ns[9 * N] = li_r;
  ns[10 * N] = li_g;
  ns[11 * N] = li_b;
  ns[12 * N] = eta2_n;
  ns[13 * N] = 0.0f;
  ns[14 * N] = 0.0f;
  ns[15 * N] = 0.0f;
  const int depth_packed = (survive ? depth : 0) & DEPTH_MASK;
  nmeta[i] = pix | (depth_packed << DEPTH_SHIFT) | (survive ? ALIVE : 0) | exh;
}

unsigned trace_smem_done = 0;

}  // namespace

extern "C" int trace_launch(const float* state, const int* meta,
                            const float* tri, const float* env, float* nstate,
                            float* hit, int n, int n_tris, int type_mask,
                            void* stream) {
  const cudaError_t e = allow_woop_smem(trace_kernel, trace_smem_done);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + THREADS - 1) / THREADS;
  trace_kernel<<<blocks, THREADS, woop_bytes(n_tris), (cudaStream_t)stream>>>(
      state, meta, tri, env, nstate, hit, n, n_tris, type_mask);
  return (int)cudaGetLastError();
}

extern "C" int shade_launch(const float* state, const int* meta,
                            const float* hit, const float* cpos,
                            const int* leaf, const void* table,
                            const float* rand, float* nstate, int* nmeta,
                            float* splat, int n, int n_leaves, int max_depth,
                            int rr_depth, float bsdf_fraction, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  shade_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      state, meta, hit, cpos, leaf, static_cast<const uint4*>(table), rand,
      nstate, nmeta, splat, n, n_leaves, max_depth, rr_depth, bsdf_fraction);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, static shared bytes and resident blocks an
// SM of trace_kernel (which 0; at the dynamic shared memory of an
// n_cols-column triangle table) or shade_kernel (which 1), into info[4].
extern "C" int guided_step_info(int which, int n_cols, int* info) {
  const void* f = which == 0 ? (const void*)trace_kernel
                             : (const void*)shade_kernel;
  cudaError_t e = which == 0 ? allow_woop_smem(trace_kernel, trace_smem_done)
                             : cudaSuccess;
  cudaFuncAttributes a{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, f);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, f, THREADS, which == 0 ? woop_bytes(n_cols) : 0);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)a.sharedSizeBytes;
  info[3] = blocks;
  return (int)e;
}
