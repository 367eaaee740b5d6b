// The fused unguided bounce with next-event estimation for NVIDIA Hopper
// (sm_90a): a step kernel and a bounce kernel around one bounce_core.
//
// Replaces the TPU kernels of sdmm_tpu/ops/bounce_pallas.py: step
// (pallas_call over _step_kernel) and bounce / diffuse_bounce (pallas_call
// over _bounce_kernel); bounce_core is their shared _make_core. Lane data
// are the reference's attribute-major arrays flattened to [rows, N]: state
// [16, N], meta [N], film and splat [8, N], pxpy [3, N], rand [10, N] or
// [8, N]. One thread owns one lane, so each row read and write of a warp is
// one coalesced 128-byte transaction.
//
// bounce_core, in the reference's order: the closest-hit sweep; the emitter
// hit with its MIS weight against the previous bounce's BSDF pdf (state row
// 13) unless that bounce was delta; the constant-environment escape; the
// shading frame and the back-face cull; NEE (an emissive triangle by its
// CDF, a uniform point on it, the BSDF value of the lane's smooth lobe, the
// depth gate depth0 + 2 <= max_depth, the occlusion sweep up to
// dist * 0.999 from the offset origin); the BSDF sample of the lane's type;
// Russian roulette and the splat. It branches on each lane's BSDF type at
// run time where the reference specialises on the scene's type set; a
// lane's result is the same. The sweeps round every operation in the plain
// twin's order (bounce_math.cuh woop_tri), so kernel and twin pick the same
// triangle and the same occlusion. The reference re-sweeps every triangle
// to select the winner's attributes because a TPU tile cannot gather; here
// the thread reads the winner's column once by its index. The emitter
// table (at most 64 x 18 floats) sits in shared memory. The file is
// compiled with -fmad=false, so the arithmetic around the sweeps rounds as
// the twin's separate PyTorch operations do (an H100 run with contraction
// allowed was no faster).
//
// Design. A triangle test is about 60 issued instructions (woop_tri, the
// IEEE reciprocal, the update), so the sweeps are bound by instruction
// issue and its latency, not by bytes:
// - The Woop rows (0-11 of the table) are staged as [T][12] float rows in
//   dynamic shared memory (woop_stage.cuh, shared with the guided trace
//   kernel), once per block for both sweeps while the table fits
//   STAGE_MAX triangles (42 KB, which keeps four blocks an SM); past it,
//   in TILE-triangle chunks of the same layout, staged per sweep. Rows
//   past the count, up to a multiple of UNROLL, are zero: never hit, so
//   the loops have no tail.
// - The sweeps test UNROLL triangles at a time, independent tests whose
//   loads and reciprocals may overlap (one H100 run timed 1, 2 and 4
//   alike); the closest hit then updates in index order with a strict
//   t < best_t, which keeps the first minimum, the twin's winner.
// - NEE shadow rays are compacted per block: the candidates (about two
//   thirds of the lanes mid-path, spread over nearly every warp) write
//   their ray into a shared queue at a ballot and block prefix, the first
//   threads of the block sweep it, and the occlusion flag returns through
//   shared memory, so the warps past the queue's end do no occlusion work.

// step_kernel: per lane, regeneration on its pixel (the sample count lives
// in the meta word's pixel field), the camera ray, 10 uniforms from
// Philox4x32-10 (philox.cuh; key = the two seed words, counter = (lane,
// block of four rows, 0, 0)) or from the host rows, bounce_core, then
// film += splat. State, meta and film are updated in place: a lane reads
// only its own column. A block of a drained tile (tile_alive 0) returns at
// once; the tile is the reference's 64 x 128 lanes (16 x 128 past 96
// triangles), so lane counts, padding and skipping match the reference.
//
// bounce_kernel: bounce_core on 8 host uniform rows into new state, meta
// and splat buffers, with the optional tile skip (state and meta copied,
// splat 0). The striped pool's regeneration stays in PyTorch.
//
// Bound, at the path row's shapes (Cornell box, 36 triangles, 640 x 360:
// 29 tiles, 237,568 lanes), per lane and step: 14 state rows, meta, 8 film
// and 3 pxpy rows in, 16 state rows, meta and 8 film rows out, ~204 bytes,
// or ~48 MB per step: ~14.5 us at 3.35 TB/s. About 60 operations per
// triangle in each of the two sweeps and ~500 more per lane, ~4,600 per
// lane or ~1.1e9 per step: ~16 us at 67 TFLOP/s FP32. The two bounds are
// close; chip_smoke.py computes both from its run. One H100 at 700 W took
// ~0.072 ms a step (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_math.cuh"
#include "philox.cuh"
#include "woop_stage.cuh"

namespace {

using namespace bounce;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// Resident blocks an SM the path kernels ask for: 80 registers, where they
// would take ~90 and fit five (one H100 run: 2-3% faster for a few spilled
// bytes).
constexpr int PATH_BLOCKS = 6;
constexpr int MAX_EM = 64;
constexpr int PDELTA = 1 << 26;

// Rows of the [18, E] emitter table (ops/bounce.py).
constexpr int EM_ROWS = 18;
constexpr int ECDF = 0;
constexpr int EV = 1;
constexpr int ENG = 10;
constexpr int ERAD = 13;
constexpr int EPA = 16;

// type_mask bits: multi (a non-diffuse type is present), conductor,
// dielectric, rough conductor. Attribute rows a type set never reads keep
// their defaults, as in the reference.
constexpr int M_MULTI = 1, M_COND = 2, M_DIEL = 4, M_RC = 8;

// Static shared memory: the emitter table and the block's shadow-ray
// queue (origin, direction, t_lim; the occlusion flag back). The Woop rows
// are the dynamic shared array.
struct Shared {
  float em[EM_ROWS][MAX_EM];
  float q[7][THREADS];
  int q_occ[THREADS];
  int warp_cand[WARPS];
};

__device__ __forceinline__ float mi_weight(float pdf_a, float pdf_b) {
  const float a2 = pdf_a * pdf_a;
  return pdf_a > 0.0f ? a2 / fmaxf(a2 + pdf_b * pdf_b, 1e-32f) : 0.0f;
}

// The caller synchronises before the table is read.
__device__ __forceinline__ void stage_em(Shared& sh, const float* em,
                                         int n_em, int e_cols) {
  for (int idx = threadIdx.x; idx < EM_ROWS * MAX_EM; idx += blockDim.x) {
    const int r = idx / MAX_EM, c = idx % MAX_EM;
    if (c < n_em) sh.em[r][c] = __ldg(em + r * e_cols + c);
  }
}

// One bounce of one lane: sv = 14 state values, m = meta, rnd = 7
// uniforms; writes 16 next-state values, the next meta word and 8 splat
// values. Every thread of the block calls it (the shadow queue and the
// chunked sweeps are block-wide); a thread past the last lane passes a copy
// of a real lane. wr holds the whole table's Woop rows when T <= STAGE_MAX
// (staged by the caller), else room for one chunk.
__device__ void bounce_core(Shared& sh, float4* wr, const float sv[14], int m,
                            const float rnd[7], const float* __restrict__ tri,
                            int T, int n_em, const float* __restrict__ env,
                            int max_depth, int rr_depth, int type_mask,
                            float ns[16], int* nm, float sp[8]) {
  const float rox = sv[0], roy = sv[1], roz = sv[2];
  const float rdx = sv[3], rdy = sv[4], rdz = sv[5];
  const float thr_r = sv[6], thr_g = sv[7], thr_b = sv[8];
  float li_r = sv[9], li_g = sv[10], li_b = sv[11];
  const float eta2 = sv[12], ppdf = sv[13];
  const bool alive = (m & ALIVE) != 0;
  const bool prev_delta = (m & PDELTA) != 0;
  const int depth0 = (m >> DEPTH_SHIFT) & DEPTH_MASK;
  const int pix = m & PIX_MASK;
  const int exh = m & EXH;

  // ---- closest hit ----
  float best_t = INF, bu = 0.0f, bv = 0.0f;
  int bj = -1;
  if (T <= STAGE_MAX) {
    closest_sweep(wr, round_up(T, UNROLL), 0, rox, roy, roz, rdx, rdy, rdz,
                  best_t, bu, bv, bj);
  } else {
    for (int base = 0; base < T; base += TILE) {
      const int cnt = min(TILE, T - base);
      __syncthreads();
      stage_woop(wr, tri, T, base, cnt);
      __syncthreads();
      closest_sweep(wr, round_up(cnt, UNROLL), base, rox, roy, roz, rdx, rdy,
                    rdz, best_t, bu, bv, bj);
    }
  }

  // ---- the winner's attributes, read once by its index ----
  const bool hit_valid = best_t < INF;
  const bool multi = type_mask & M_MULTI;
  const bool has_cond = type_mask & M_COND;
  const bool has_diel = type_mask & M_DIEL;
  const bool has_rc = type_mask & M_RC;
  const bool eta_sp = type_mask & (M_COND | M_DIEL | M_RC);
  const bool k_rows = type_mask & (M_COND | M_RC);
  const float* __restrict__ col = tri + (hit_valid ? bj : 0);
  const size_t TS = (size_t)T;
  auto attr = [&](int row, float dflt, bool wanted) {
    return (hit_valid && wanted) ? __ldg(col + row * TS) : dflt;
  };
  const float ngx = attr(TNG + 0, 0.0f, true), ngy = attr(TNG + 1, 0.0f, true),
              ngz = attr(TNG + 2, 1.0f, true);
  float nsv[3];
  const float w0 = 1.0f - bu - bv;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    nsv[c] = hit_valid ? __ldg(col + (TNS + c) * TS) * w0 +
                             __ldg(col + (TNS + 3 + c) * TS) * bu +
                             __ldg(col + (TNS + 6 + c) * TS) * bv
                       : (c == 2 ? 1.0f : 0.0f);
  }
  const float em_r = attr(TEM + 0, 0.0f, true), em_g = attr(TEM + 1, 0.0f, true),
              em_b = attr(TEM + 2, 0.0f, true);
  const float b_pa = attr(TPA, 0.0f, true);
  const float alr = attr(TAL + 0, 0.0f, true), alg = attr(TAL + 1, 0.0f, true),
              alb = attr(TAL + 2, 0.0f, true);
  const float b_ty = attr(TTY, 0.0f, multi);
  const float b_alp = attr(TALP, 0.0f, has_rc);
  const float b_eta = attr(TETA, 1.0f, eta_sp);
  const float kr = attr(TK + 0, 0.0f, k_rows), kg = attr(TK + 1, 0.0f, k_rows),
              kb = attr(TK + 2, 0.0f, k_rows);
  const float sr = attr(TSP + 0, 1.0f, eta_sp), sg = attr(TSP + 1, 1.0f, eta_sp),
              sb = attr(TSP + 2, 1.0f, eta_sp);

  const float t_safe = hit_valid ? best_t : 0.0f;
  const float px_ = rox + t_safe * rdx;
  const float py_ = roy + t_safe * rdy;
  const float pz_ = roz + t_safe * rdz;
  const float inv_ns = rsqrtf(
      fmaxf(nsv[0] * nsv[0] + nsv[1] * nsv[1] + nsv[2] * nsv[2], 1e-20f));
  const float nsx = nsv[0] * inv_ns, nsy = nsv[1] * inv_ns,
              nsz = nsv[2] * inv_ns;

  const bool is_diff = b_ty == (float)T_DIFFUSE;
  const bool is_cond = has_cond && b_ty == (float)T_CONDUCTOR;
  const bool is_diel = has_diel && b_ty == (float)T_DIELECTRIC;
  const bool is_rc = has_rc && b_ty == (float)T_ROUGHCONDUCTOR;

  // ---- emitter hit, MIS against the previous bounce's BSDF pdf ----
  const float cos_l_hit = -dot3(ngx, ngy, ngz, rdx, rdy, rdz);
  const bool front = cos_l_hit > 0.0f;
  const float pdf_nee_hit =
      (hit_valid && cos_l_hit > 1e-6f)
          ? b_pa * best_t * best_t / fmaxf(cos_l_hit, 1e-12f)
          : 0.0f;
  const float w_hit = prev_delta ? 1.0f : mi_weight(ppdf, pdf_nee_hit);
  const float gain = (alive && hit_valid && front) ? w_hit : 0.0f;
  li_r = li_r + thr_r * em_r * gain;
  li_g = li_g + thr_g * em_g * gain;
  li_b = li_b + thr_b * em_b * gain;
  // Escaped rays: the constant environment, MIS weight 1.
  const float escf = (alive && !hit_valid) ? 1.0f : 0.0f;
  li_r = li_r + thr_r * __ldg(env + 0) * escf;
  li_g = li_g + thr_g * __ldg(env + 1) * escf;
  li_b = li_b + thr_b * __ldg(env + 2) * escf;
  bool on_surface = alive && hit_valid;

  // ---- shading frame, flipped toward the ray except on dielectrics ----
  const float cos_i_ns = -dot3(nsx, nsy, nsz, rdx, rdy, rdz);
  const float flip = (cos_i_ns < 0.0f && !is_diel) ? -1.0f : 1.0f;
  const float nx = nsx * flip, ny = nsy * flip, nz = nsz * flip;
  float s[3], t[3];
  coordinate_system(nx, ny, nz, s, t);
  const float wi_z = -dot3(nx, ny, nz, rdx, rdy, rdz);
  const float wi_x = -dot3(s[0], s[1], s[2], rdx, rdy, rdz);
  const float wi_y = -dot3(t[0], t[1], t[2], rdx, rdy, rdz);
  const float wi_dot_geo = -dot3(ngx, ngy, ngz, rdx, rdy, rdz);
  on_surface = on_surface && !(wi_dot_geo * wi_z < 0.0f);
  const bool smooth = is_diff || is_rc;  // NEE targets the non-delta lobes

  // ---- NEE: one emissive triangle by its CDF, a point on it ----
  const float su0 = sqrtf(rnd[1]);
  const float bb0 = 1.0f - su0;
  const float bb1 = rnd[2] * su0;
  float e_y[3] = {0.0f, 0.0f, 0.0f}, e_n[3] = {0.0f, 0.0f, 1.0f};
  float e_rad[3] = {0.0f, 0.0f, 0.0f}, e_pa = 0.0f;
  int pe = -1;
  for (int e = 0; e < n_em; ++e) {
    if (sh.em[ECDF][e] >= rnd[0] || e == n_em - 1) {
      pe = e;
      break;
    }
  }
  if (pe >= 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e_y[c] = sh.em[EV + c][pe] + bb0 * sh.em[EV + 3 + c][pe] +
               bb1 * sh.em[EV + 6 + c][pe];
      e_n[c] = sh.em[ENG + c][pe];
      e_rad[c] = sh.em[ERAD + c][pe];
    }
    e_pa = sh.em[EPA][pe];
  }
  const float tox = e_y[0] - px_, toy = e_y[1] - py_, toz = e_y[2] - pz_;
  const float dist2 = tox * tox + toy * toy + toz * toz;
  const float dist = sqrtf(fmaxf(dist2, 1e-20f));
  const float inv_dist = 1.0f / dist;
  const float ldx = tox * inv_dist, ldy = toy * inv_dist, ldz = toz * inv_dist;
  const float cos_l = -dot3(e_n[0], e_n[1], e_n[2], ldx, ldy, ldz);
  const bool nee_valid = cos_l > 1e-6f && dist2 > 1e-12f;
  const float pdf_sa =
      nee_valid ? e_pa * dist2 / fmaxf(cos_l, 1e-12f) : 0.0f;

  // f(wi, wo_nee) and its BSDF pdf for the smooth lobes.
  const float wo_l_z = dot3(nx, ny, nz, ldx, ldy, ldz);
  const float cos_o = fmaxf(wo_l_z, 0.0f);
  float f_r = is_diff ? alr * (INV_PI * cos_o) : 0.0f;
  float f_g = is_diff ? alg * (INV_PI * cos_o) : 0.0f;
  float f_b = is_diff ? alb * (INV_PI * cos_o) : 0.0f;
  float pdf_b_nee = is_diff ? cos_o * INV_PI : 0.0f;
  if (is_rc) {
    const float wo_l_x = dot3(s[0], s[1], s[2], ldx, ldy, ldz);
    const float wo_l_y = dot3(t[0], t[1], t[2], ldx, ldy, ldz);
    float hx = wi_x + wo_l_x, hy = wi_y + wo_l_y, hz = wi_z + wo_l_z;
    const float inv_h = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
    hx = hx * inv_h;
    hy = hy * inv_h;
    hz = hz * inv_h;
    const float widoth = dot3(wi_x, wi_y, wi_z, hx, hy, hz);
    const float d_h = ggx_d(hz, b_alp);
    const float g_h = smith_g1(wi_x, wi_y, wi_z, hx, hy, hz, b_alp) *
                      smith_g1(wo_l_x, wo_l_y, wo_l_z, hx, hy, hz, b_alp);
    const bool both = wi_z > 1e-6f && wo_l_z > 1e-6f;
    const float spec = both ? d_h * g_h / fmaxf(4.0f * wi_z, 1e-12f) : 0.0f;
    f_r = sr * fresnel_conductor_1(widoth, b_eta, kr) * spec;
    f_g = sg * fresnel_conductor_1(widoth, b_eta, kg) * spec;
    f_b = sb * fresnel_conductor_1(widoth, b_eta, kb) * spec;
    pdf_b_nee =
        both ? vndf_pdf(wi_x, wi_y, wi_z, hx, hy, hz, b_alp) /
                   fmaxf(4.0f * fabsf(dot3(wo_l_x, wo_l_y, wo_l_z, hx, hy, hz)),
                         1e-12f)
             : 0.0f;
  }

  // The NEE light vertex sits at depth0 + 2: gate it by max_depth.
  const bool cand = on_surface && smooth && nee_valid && pdf_sa > 0.0f &&
                    depth0 + 2 <= max_depth;
  // dot > 0 ? +RAY_EPS : -RAY_EPS, which is -RAY_EPS at 0 (no copysignf).
  const float off =
      dot3(ngx, ngy, ngz, ldx, ldy, ldz) > 0.0f ? RAY_EPS : -RAY_EPS;
  const float shx = px_ + ngx * off, shy = py_ + ngy * off,
              shz = pz_ + ngz * off;
  const float t_lim = dist * 0.999f;

  // ---- the block's shadow rays: queue, sweep by the first threads ----
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, cand);
  if (lane == 0) sh.warp_cand[warp] = __popc(ballot);
  __syncthreads();
  int n_q = 0, slot = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    slot += w < warp ? sh.warp_cand[w] : 0;
    n_q += sh.warp_cand[w];
  }
  slot += __popc(ballot & ((1u << lane) - 1u));
  if (cand) {
    sh.q[0][slot] = shx;
    sh.q[1][slot] = shy;
    sh.q[2][slot] = shz;
    sh.q[3][slot] = ldx;
    sh.q[4][slot] = ldy;
    sh.q[5][slot] = ldz;
    sh.q[6][slot] = t_lim;
  }
  __syncthreads();
  const int j = threadIdx.x;
  bool occ_j = false;
  float qr[7];
  if (j < n_q) {
#pragma unroll
    for (int r = 0; r < 7; ++r) qr[r] = sh.q[r][j];
  }
  if (T <= STAGE_MAX) {
    if (j < n_q)
      occ_j = any_sweep(wr, round_up(T, UNROLL), qr[0], qr[1], qr[2], qr[3],
                        qr[4], qr[5], qr[6]);
  } else if (n_q > 0) {
    for (int base = 0; base < T; base += TILE) {
      const int cnt = min(TILE, T - base);
      __syncthreads();
      stage_woop(wr, tri, T, base, cnt);
      __syncthreads();
      if (j < n_q && !occ_j)
        occ_j = any_sweep(wr, round_up(cnt, UNROLL), qr[0], qr[1], qr[2],
                          qr[3], qr[4], qr[5], qr[6]);
    }
  }
  if (j < n_q) sh.q_occ[j] = occ_j;
  __syncthreads();
  const bool occ = cand && sh.q_occ[slot] != 0;
  const float w_nee = mi_weight(pdf_sa, pdf_b_nee);
  const float scale =
      (cand && !occ) ? w_nee / fmaxf(pdf_sa, 1e-20f) : 0.0f;
  li_r = li_r + thr_r * f_r * e_rad[0] * scale;
  li_g = li_g + thr_g * f_g * e_rad[1] * scale;
  li_b = li_b + thr_b * f_b * e_rad[2] * scale;

  // ---- BSDF sample of the lane's type ----
  float wo_x, wo_y;
  disk_concentric(rnd[4], rnd[5], &wo_x, &wo_y);
  float wo_z = sqrtf(fmaxf(0.0f, 1.0f - wo_x * wo_x - wo_y * wo_y));
  float pdf_s = wo_z * INV_PI;
  float w_r = alr, w_g = alg, w_b = alb;
  bool good = alr > 0.0f || alg > 0.0f || alb > 0.0f;
  bool sampled_delta = false;
  float eta_factor = 1.0f;
  if (is_cond) {
    const float fc_r = fresnel_conductor_1(wi_z, b_eta, kr);
    const float fc_g = fresnel_conductor_1(wi_z, b_eta, kg);
    const float fc_b = fresnel_conductor_1(wi_z, b_eta, kb);
    wo_x = -wi_x;
    wo_y = -wi_y;
    wo_z = wi_z;
    w_r = sr * fc_r;
    w_g = sg * fc_g;
    w_b = sb * fc_b;
    pdf_s = 1.0f;
    good = fc_r > 0.0f || fc_g > 0.0f || fc_b > 0.0f;
    sampled_delta = true;
  } else if (is_diel) {
    float cos_t, eta_it, eta_ti;
    const float fr = fresnel_dielectric(wi_z, b_eta, &cos_t, &eta_it, &eta_ti);
    const bool refl = rnd[3] < fr;
    wo_x = refl ? -wi_x : -wi_x * eta_ti;
    wo_y = refl ? -wi_y : -wi_y * eta_ti;
    wo_z = refl ? wi_z : cos_t;
    w_r = refl ? sr : alr * eta_ti * eta_ti;
    w_g = refl ? sg : alg * eta_ti * eta_ti;
    w_b = refl ? sb : alb * eta_ti * eta_ti;
    pdf_s = refl ? fr : 1.0f - fr;
    good = w_r > 0.0f || w_g > 0.0f || w_b > 0.0f;
    sampled_delta = true;
    eta_factor = refl ? 1.0f : eta_it;
  } else if (is_rc) {
    float mx, my, mz;
    sample_vndf(wi_x, wi_y, wi_z, b_alp, rnd[4], rnd[5], &mx, &my, &mz);
    const float widm = dot3(wi_x, wi_y, wi_z, mx, my, mz);
    wo_x = 2.0f * widm * mx - wi_x;
    wo_y = 2.0f * widm * my - wi_y;
    wo_z = 2.0f * widm * mz - wi_z;
    const float g1o = smith_g1(wo_x, wo_y, wo_z, mx, my, mz, b_alp);
    const float wr_r = sr * fresnel_conductor_1(widm, b_eta, kr) * g1o;
    const float wr_g = sg * fresnel_conductor_1(widm, b_eta, kg) * g1o;
    const float wr_b = sb * fresnel_conductor_1(widm, b_eta, kb) * g1o;
    const float pdf_r =
        vndf_pdf(wi_x, wi_y, wi_z, mx, my, mz, b_alp) /
        fmaxf(4.0f * fabsf(dot3(wo_x, wo_y, wo_z, mx, my, mz)), 1e-12f);
    const bool ok_r = wo_z > 1e-6f;
    w_r = ok_r ? wr_r : 0.0f;
    w_g = ok_r ? wr_g : 0.0f;
    w_b = ok_r ? wr_b : 0.0f;
    pdf_s = ok_r ? pdf_r : 0.0f;
    good = ok_r && (wr_r > 0.0f || wr_g > 0.0f || wr_b > 0.0f);
  }
  const float wox = s[0] * wo_x + t[0] * wo_y + nx * wo_z;
  const float woy = s[1] * wo_x + t[1] * wo_y + ny * wo_z;
  const float woz = s[2] * wo_x + t[2] * wo_y + nz * wo_z;
  const float wo_dot_geo = dot3(ngx, ngy, ngz, wox, woy, woz);
  good = good && !(wo_dot_geo * wo_z <= 0.0f);

  // ---- throughput, Russian roulette ----
  const int depth = depth0 + 1;
  bool survive = on_surface && good && depth < max_depth;
  float tr = thr_r * (survive ? w_r : 1.0f);
  float tg = thr_g * (survive ? w_g : 1.0f);
  float tb = thr_b * (survive ? w_b : 1.0f);
  const float eta2_n = eta2 * (survive ? eta_factor * eta_factor : 1.0f);
  const float q = fminf(fmaxf(fmaxf(tr, tg), tb) * eta2_n, 0.95f);
  const bool do_rr = depth + 1 >= rr_depth;
  survive = survive && !(do_rr && rnd[6] >= q);
  const float rr_boost = (do_rr && survive) ? 1.0f / fmaxf(q, 1e-6f) : 1.0f;
  tr = tr * rr_boost;
  tg = tg * rr_boost;
  tb = tb * rr_boost;

  // ---- splat of the paths that end here; NaN radiance splats 0 ----
  const bool done = alive && !survive;
  const float df = done ? 1.0f : 0.0f;
  const float ls_r = (isfinite(li_r) ? li_r : 0.0f) * df;
  const float ls_g = (isfinite(li_g) ? li_g : 0.0f) * df;
  const float ls_b = (isfinite(li_b) ? li_b : 0.0f) * df;
  sp[0] = ls_r;
  sp[1] = ls_g;
  sp[2] = ls_b;
  sp[3] = ls_r * ls_r;
  sp[4] = ls_g * ls_g;
  sp[5] = ls_b * ls_b;
  sp[6] = df;
  sp[7] = on_surface ? 1.0f : 0.0f;

  // ---- next lane state ----
  const float off2 = wo_dot_geo > 0.0f ? RAY_EPS : -RAY_EPS;
  ns[0] = px_ + ngx * off2;
  ns[1] = py_ + ngy * off2;
  ns[2] = pz_ + ngz * off2;
  ns[3] = wox;
  ns[4] = woy;
  ns[5] = woz;
  ns[6] = tr;
  ns[7] = tg;
  ns[8] = tb;
  ns[9] = li_r;
  ns[10] = li_g;
  ns[11] = li_b;
  ns[12] = eta2_n;
  ns[13] = pdf_s;
  ns[14] = 0.0f;
  ns[15] = 0.0f;
  const int depth_packed = (survive ? depth : 0) & DEPTH_MASK;
  *nm = pix | (depth_packed << DEPTH_SHIFT) | (survive ? ALIVE : 0) |
        (sampled_delta ? PDELTA : 0) | exh;
}

// N is a multiple of the tile, and the tile of THREADS: no tail.
__global__ void __launch_bounds__(THREADS, PATH_BLOCKS)
step_kernel(float* __restrict__ state, int* __restrict__ meta,
            float* __restrict__ film, const int* __restrict__ tile_alive,
            const float* __restrict__ cam, const float* __restrict__ pxpy,
            const float* __restrict__ rand, const float* __restrict__ tri,
            const float* __restrict__ em, const float* __restrict__ env,
            int n, int tile, int T, int n_em, int e_cols, int max_depth,
            int rr_depth, int type_mask, uint32_t seed0, uint32_t seed1,
            float inv_w, float inv_h) {
  __shared__ Shared sh;
  extern __shared__ float4 wr[];
  const int b0 = blockIdx.x * THREADS;
  if (tile_alive[b0 / tile] == 0) return;  // the whole block is one tile
  stage_em(sh, em, n_em, e_cols);
  if (T <= STAGE_MAX) stage_woop(wr, tri, T, 0, T);
  __syncthreads();
  const int i = b0 + threadIdx.x;
  const size_t N = (size_t)n;

  float rnd[10];
  if (rand != nullptr) {
#pragma unroll
    for (int r = 0; r < 10; ++r) rnd[r] = rand[r * N + i];
  } else {
#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
      const philox::U4 x = philox::philox4x32_10(
          philox::U4{{(uint32_t)i, (uint32_t)blk, 0u, 0u}}, seed0, seed1);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (4 * blk + w < 10) rnd[4 * blk + w] = philox::uniform24(x.x[w]);
    }
  }

  // ---- regenerate a dead lane on its pixel ----
  const int m = meta[i];
  const bool alive = (m & ALIVE) != 0;
  bool exh = (m & EXH) != 0;
  float count = (float)(m & PIX_MASK);
  const bool need = !alive && !exh;
  const bool start = need && count < pxpy[2 * N + i];
  exh = exh || (need && !start);
  count = start ? count + 1.0f : count;
  float sv[14];
  if (start) {
    // The perspective camera of scene/sensor.py generate_rays.
    const float px = pxpy[i] + rnd[8];
    const float py = pxpy[N + i] + rnd[9];
    const float sx = 1.0f - 2.0f * px * inv_w;
    const float sy = 1.0f - 2.0f * py * inv_h;
    const float dcx = sx * __ldg(cam + 12);
    const float dcy = sy * __ldg(cam + 13);
    const float dx = __ldg(cam + 0) * dcx + __ldg(cam + 1) * dcy + __ldg(cam + 2);
    const float dy = __ldg(cam + 3) * dcx + __ldg(cam + 4) * dcy + __ldg(cam + 5);
    const float dz = __ldg(cam + 6) * dcx + __ldg(cam + 7) * dcy + __ldg(cam + 8);
    const float inv_n = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
    sv[0] = __ldg(cam + 9);
    sv[1] = __ldg(cam + 10);
    sv[2] = __ldg(cam + 11);
    sv[3] = dx * inv_n;
    sv[4] = dy * inv_n;
    sv[5] = dz * inv_n;
    sv[6] = sv[7] = sv[8] = 1.0f;
    sv[9] = sv[10] = sv[11] = 0.0f;
    sv[12] = sv[13] = 1.0f;
  } else {
#pragma unroll
    for (int r = 0; r < 14; ++r) sv[r] = state[r * N + i];
  }
  const int depth_bits = DEPTH_MASK << DEPTH_SHIFT;
  const int m2 = (int)count | ((alive || start) ? ALIVE : 0) |
                 (exh ? EXH : 0) | (start ? PDELTA : (m & PDELTA)) |
                 (start ? 0 : (m & depth_bits));

  float nsv[16], sp[8];
  int nm;
  bounce_core(sh, wr, sv, m2, rnd, tri, T, n_em, env, max_depth, rr_depth,
              type_mask, nsv, &nm, sp);
#pragma unroll
  for (int r = 0; r < 16; ++r) state[r * N + i] = nsv[r];
  meta[i] = nm;
#pragma unroll
  for (int r = 0; r < 8; ++r) film[r * N + i] += sp[r];
}

__global__ void __launch_bounds__(THREADS, PATH_BLOCKS)
bounce_kernel(const float* __restrict__ state, const int* __restrict__ meta,
              const float* __restrict__ rand, const float* __restrict__ tri,
              const float* __restrict__ em, const float* __restrict__ env,
              const int* __restrict__ tile_alive, float* __restrict__ nstate,
              int* __restrict__ nmeta, float* __restrict__ splat, int n,
              int tile, int T, int n_em, int e_cols, int max_depth,
              int rr_depth, int type_mask) {
  __shared__ Shared sh;
  extern __shared__ float4 wr[];
  const int b0 = blockIdx.x * THREADS;
  const int i = b0 + threadIdx.x;
  const bool active = i < n;
  const int li = active ? i : n - 1;
  const size_t N = (size_t)n;
  if (tile_alive != nullptr && tile_alive[b0 / tile] == 0) {
    // A drained tile passes through: state and meta copied, splat 0.
    if (active) {
#pragma unroll
      for (int r = 0; r < 16; ++r) nstate[r * N + i] = state[r * N + i];
      nmeta[i] = meta[i];
#pragma unroll
      for (int r = 0; r < 8; ++r) splat[r * N + i] = 0.0f;
    }
    return;
  }
  stage_em(sh, em, n_em, e_cols);
  if (T <= STAGE_MAX) stage_woop(wr, tri, T, 0, T);
  __syncthreads();
  float sv[14], rnd[7];
#pragma unroll
  for (int r = 0; r < 14; ++r) sv[r] = state[r * N + li];
#pragma unroll
  for (int r = 0; r < 7; ++r) rnd[r] = rand[r * N + li];
  float nsv[16], sp[8];
  int nm;
  bounce_core(sh, wr, sv, meta[li], rnd, tri, T, n_em, env, max_depth,
              rr_depth, type_mask, nsv, &nm, sp);
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 16; ++r) nstate[r * N + i] = nsv[r];
  nmeta[i] = nm;
#pragma unroll
  for (int r = 0; r < 8; ++r) splat[r * N + i] = sp[r];
}

unsigned step_smem_done = 0, bounce_smem_done = 0;

}  // namespace

extern "C" int step_launch(float* state, int* meta, float* film,
                           const int* tile_alive, const float* cam,
                           const float* pxpy, const float* rand,
                           const float* tri, const float* em,
                           const float* env, int n, int tile, int n_cols,
                           int n_em, int e_cols, int max_depth, int rr_depth,
                           int type_mask, unsigned seed0, unsigned seed1,
                           float inv_w, float inv_h, void* stream) {
  const cudaError_t e = allow_woop_smem(step_kernel, step_smem_done);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n / THREADS;
  step_kernel<<<blocks, THREADS, woop_bytes(n_cols), (cudaStream_t)stream>>>(
      state, meta, film, tile_alive, cam, pxpy, rand, tri, em, env, n, tile,
      n_cols, n_em, e_cols, max_depth, rr_depth, type_mask, seed0, seed1,
      inv_w, inv_h);
  return (int)cudaGetLastError();
}

extern "C" int bounce_launch(const float* state, const int* meta,
                             const float* rand, const float* tri,
                             const float* em, const float* env,
                             const int* tile_alive, float* nstate, int* nmeta,
                             float* splat, int n, int tile, int n_cols,
                             int n_em, int e_cols, int max_depth,
                             int rr_depth, int type_mask, void* stream) {
  const cudaError_t e = allow_woop_smem(bounce_kernel, bounce_smem_done);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + THREADS - 1) / THREADS;
  bounce_kernel<<<blocks, THREADS, woop_bytes(n_cols),
                  (cudaStream_t)stream>>>(
      state, meta, rand, tri, em, env, tile_alive, nstate, nmeta, splat, n,
      tile, n_cols, n_em, e_cols, max_depth, rr_depth, type_mask);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, static shared bytes and resident blocks an
// SM (at the dynamic shared memory of an n_cols-column table) of step_kernel
// (which 0) or bounce_kernel (which 1), into info[4].
extern "C" int bounce_info(int which, int n_cols, int* info) {
  const void* f = which == 0 ? (const void*)step_kernel
                             : (const void*)bounce_kernel;
  cudaError_t e = which == 0 ? allow_woop_smem(step_kernel, step_smem_done)
                             : allow_woop_smem(bounce_kernel,
                                               bounce_smem_done);
  cudaFuncAttributes a{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, f);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, THREADS,
                                                      woop_bytes(n_cols));
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)a.sharedSizeBytes;
  info[3] = blocks;
  return (int)e;
}
