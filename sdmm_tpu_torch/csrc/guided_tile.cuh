// The SDMM guided-sampling math of one lane, for NVIDIA Hopper (sm_90a).
//
// Counterpart of guided_tile in sdmm_tpu/ops/guided_pallas.py, shared by
// guided_sample.cu (float32 rows) and guided_step.cu's shade kernel
// (bfloat16 rows). Per lane: condition the leaf's K = 16 component mixture
// on the hit position (log-space weights with max-subtraction, 3-sigma
// trust-region clamp of the conditional mean), pick a component by CDF,
// draw a Box-Muller tangent sample and map it back with the exp map, then
// evaluate the mixture pdf at the guided and at the BSDF-sampled
// direction, with the reference's cubic arccos.
//
// The lane reads its leaf's row through a row reader straight from the
// table, which stays in L2; no per-lane row matrix is gathered. Both
// kernels read a packed table (ops/guided_sample.pack_sample_table: per
// leaf K components of PSTRIDE = 24 values, the 22 of the [L, 353] row and
// two pads, the init flag in component 0's first pad, every row 16-byte
// aligned). A reader hands over a component's values in two blocks: pass
// 1's 16 (weight, spatial mean, marginal Cholesky, premult) and pass 4's 6
// (mean direction, conditional Cholesky). RowPackedF32 reads the float32
// table of guided_sample.cu, six 16-byte words a component: pass 1's block
// as four loads, pass 4's as two. RowPacked reads shade's bfloat16 table,
// three words a component: pass 1's block as two loads, pass 4's as one.
// guided_tile's four passes are four unrolled k-loops that re-read the row
// instead of holding 16 x 22 values per thread; the per-component
// log-weight and the two conditional tangent-mean coordinates (48 floats)
// live in a slot store: registers (RegSlots, guided_sample.cu) or the
// thread's column of a shared-memory array (SharedSlots, shade), which
// frees the registers for more warps in flight. The selected component is
// read back at a computed offset, so no register array is indexed at run
// time. The lane's own inputs come through an accessor that guided_tile
// asks where each is first needed (the position before pass 1, the
// uniforms before pass 3, the BSDF direction before pass 4), so a kernel
// can read them there from memory instead of holding them in registers
// across the mixture math.

#pragma once

#include <stdint.h>

#include "bounce_math.cuh"

namespace guided {

using bounce::coordinate_system;
using bounce::INV_PI;
using bounce::PI_F;

constexpr int K = 16;
constexpr int RPK = 22;
constexpr int NROWS = K * RPK + 1;
constexpr float INV_TWO_PI = 0.15915494309189535f;
constexpr float NEG = -1.0e30f;

// The packed layout: per leaf K components of PSTRIDE values (the 22 of
// the [L, 353] row, then two pads); the init flag sits in component 0's
// first pad (value PINIT).
constexpr int PSTRIDE = 24;
constexpr int PROW = K * PSTRIDE;
constexpr int PINIT = 22;

// A leaf row of the packed float32 table: six 16-byte words a component.
struct RowPackedF32 {
  const float4* __restrict__ p;  // the leaf's PROW values, 16-byte aligned
  __device__ __forceinline__ void pass1(int k, float v[16]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = __ldg(p + 6 * k + j);
      v[4 * j] = a.x;
      v[4 * j + 1] = a.y;
      v[4 * j + 2] = a.z;
      v[4 * j + 3] = a.w;
    }
  }
  __device__ __forceinline__ void pass4(int k, float v[6]) const {
    const float4 a = __ldg(p + 6 * k + 4), b = __ldg(p + 6 * k + 5);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    v[4] = b.x;
    v[5] = b.y;
  }
  __device__ __forceinline__ float init() const {
    static_assert(PINIT == 22, "the init flag is value z of word 5");
    return __ldg(p + 5).z;
  }
};

// bfloat16 is the upper 16 bits of a float32, so the widening is exact.
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

// A leaf row of the packed bfloat16 table: three 16-byte words a
// component.
struct RowPacked {
  const uint4* __restrict__ p;  // the leaf's PROW values, 16-byte aligned
  __device__ __forceinline__ void pass1(int k, float v[16]) const {
    const uint4 a = __ldg(p + 3 * k), b = __ldg(p + 3 * k + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[2 * j] = bf16_lo(w[j]);
      v[2 * j + 1] = bf16_hi(w[j]);
    }
  }
  __device__ __forceinline__ void pass4(int k, float v[6]) const {
    const uint4 c = __ldg(p + 3 * k + 2);
    v[0] = bf16_lo(c.x);
    v[1] = bf16_hi(c.x);
    v[2] = bf16_lo(c.y);
    v[3] = bf16_hi(c.y);
    v[4] = bf16_lo(c.z);
    v[5] = bf16_hi(c.z);
  }
  __device__ __forceinline__ float init() const {
    static_assert(PINIT == 22, "the init flag is the low half of word 3");
    return bf16_lo(__ldg(p + 2).w);
  }
};

// Per-component slots of one lane in registers: every index is a
// compile-time constant once the k-loops unroll.
struct RegSlots {
  float lw_[K], tm0_[K], tm1_[K];
  __device__ __forceinline__ float& lw(int k) { return lw_[k]; }
  __device__ __forceinline__ float& tm0(int k) { return tm0_[k]; }
  __device__ __forceinline__ float& tm1(int k) { return tm1_[k]; }
  __device__ __forceinline__ void sel_tm(int sel, float* a, float* b) {
    float x = 0.0f, y = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x = k == sel ? tm0_[k] : x;
      y = k == sel ? tm1_[k] : y;
    }
    *a = x;
    *b = y;
  }
};

// Per-component slots of one lane in its column of a [3 K][stride]
// shared-memory array: the lanes of a warp hit 32 distinct banks.
struct SharedSlots {
  float* p;  // &array[0][lane]
  int stride;
  __device__ __forceinline__ float& lw(int k) { return p[k * stride]; }
  __device__ __forceinline__ float& tm0(int k) { return p[(K + k) * stride]; }
  __device__ __forceinline__ float& tm1(int k) {
    return p[(2 * K + k) * stride];
  }
  __device__ __forceinline__ void sel_tm(int sel, float* a, float* b) {
    *a = tm0(sel);
    *b = tm1(sel);
  }
};

// The pointer, hidden from the optimiser: loads through it are issued
// again where they stand instead of reusing earlier loads of the same
// address, whose values would stay live in registers in between.
template <class T>
__device__ __forceinline__ const T* reread(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// A lane's inputs to guided_tile held as values: (px, py, pz) the
// canonical position, (bx, by, bz) the BSDF-sampled world direction,
// (u_sel, u_r, u_th) the uniforms of component selection and Box-Muller.
struct LaneValues {
  float p[3], b[3], u[3];
  __device__ __forceinline__ void pos(float x[3]) const {
    x[0] = p[0], x[1] = p[1], x[2] = p[2];
  }
  __device__ __forceinline__ void uniforms(float x[3]) const {
    x[0] = u[0], x[1] = u[1], x[2] = u[2];
  }
  __device__ __forceinline__ void wob(float x[3]) const {
    x[0] = b[0], x[1] = b[1], x[2] = b[2];
  }
};

// sin and cos through sincospif(x / pi): its argument reduction is exact
// in units of pi, so it compiles no Payne-Hanek slow path with its
// local-memory scratch array, as sinf and cosf do.
__device__ __forceinline__ void sincos_f(float x, float* s, float* c) {
  sincospif(x * INV_PI, s, c);
}

// sin(x) / x and cos(x).
__device__ __forceinline__ void sinc_cos(float x, float* sinc, float* c) {
  float s;
  sincos_f(x, &s, c);
  *sinc = fabsf(x) < 1e-4f ? 1.0f - x * x / 6.0f : s / x;
}

__device__ __forceinline__ float acos_cubic(float x) {
  const float xa = fabsf(x);
  const float poly =
      1.5707288f + xa * (-0.2121144f + xa * (0.0742610f - 0.0187293f * xa));
  const float ang = sqrtf(fmaxf(1.0f - xa, 0.0f)) * poly;
  return x >= 0.0f ? ang : PI_F - ang;
}

// Conditional mean direction of one component: exp map of (tm0, tm1) in the
// frame of its unit mean direction md.
__device__ __forceinline__ void cond_mean(float tm0, float tm1, float mdx,
                                          float mdy, float mdz, float mu[3]) {
  const float ln = sqrtf(fmaxf(tm0 * tm0 + tm1 * tm1, 0.0f));
  float s_, rel2;
  sinc_cos(ln, &s_, &rel2);
  const float rel0 = tm0 * s_, rel1 = tm1 * s_;
  float cs[3], ct[3];
  coordinate_system(mdx, mdy, mdz, cs, ct);
  mu[0] = cs[0] * rel0 + ct[0] * rel1 + mdx * rel2;
  mu[1] = cs[1] * rel0 + ct[1] * rel1 + mdy * rel2;
  mu[2] = cs[2] * rel0 + ct[2] * rel1 + mdz * rel2;
}

__device__ __forceinline__ float log_map_pdf(const float s[3], const float t[3],
                                             const float m[3], float dx,
                                             float dy, float dz, float i00,
                                             float i10, float i11,
                                             float inv_det) {
  const float rel0 = s[0] * dx + s[1] * dy + s[2] * dz;
  const float rel1 = t[0] * dx + t[1] * dy + t[2] * dz;
  const float rel2 = m[0] * dx + m[1] * dy + m[2] * dz;
  const float cosa = fminf(fmaxf(rel2, -1.0f), 1.0f);
  const float d2 = dx * dx + dy * dy + dz * dz;
  const bool ok = (cosa > -1.0f + 1e-7f) && (d2 > 0.0f);
  const float sina = sqrtf(fmaxf(1.0f - cosa * cosa, 0.0f));
  const float aos = sina < 1e-3f ? 1.0f : acos_cubic(cosa) / fmaxf(sina, 1e-12f);
  const float t0 = rel0 * aos, t1 = rel1 * aos;
  const float z0 = i00 * t0;
  const float z1 = i10 * t0 + i11 * t1;
  const float pdf = INV_TWO_PI * expf(-0.5f * (z0 * z0 + z1 * z1)) * inv_det * aos;
  return ok ? pdf : 0.0f;
}

struct TileOut {
  float d[3];       // guided direction
  bool g_ok;        // the tangent sample lies inside the exp map's disk
  float pdf_g;      // mixture pdf at the guided direction
  float pdf_b;      // mixture pdf at the BSDF-sampled direction
  bool cond_valid;  // the conditioning found a component with weight
  bool init;        // the leaf holds a trained mixture
};

// guided_tile for one lane: row is the leaf's row reader, sl the lane's
// slot store, lane its input accessor (LaneValues' interface).
template <class Row, class Slots, class Lane>
__device__ __forceinline__ TileOut guided_tile(const Row& row, Slots& sl,
                                               const Lane& lane) {
  float p[3];
  lane.pos(p);
  const float px = p[0], py = p[1], pz = p[2];
  // ---- pass 1: log spatial-marginal weights + conditional tangent means ----
  float lmax = NEG;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float r[16];
    row.pass1(k, r);
    const float d0 = px - r[1];
    const float d1 = py - r[2];
    const float d2 = pz - r[3];
    const float m00 = r[4], m10 = r[5], m11 = r[6];
    const float m20 = r[7], m21 = r[8], m22 = r[9];
    const float z0 = m00 * d0;
    const float z1 = m10 * d0 + m11 * d1;
    const float z2 = m20 * d0 + m21 * d1 + m22 * d2;
    const float q = z0 * z0 + z1 * z1 + z2 * z2;
    const float wd = r[0] * m00 * m11 * m22;
    const float lwk = wd > 0.0f ? logf(fmaxf(wd, 1e-38f)) - 0.5f * q : NEG;
    const float cl = fminf(1.0f, 3.0f / sqrtf(fmaxf(q, 1e-30f)));
    sl.lw(k) = lwk;
    sl.tm0(k) = cl * (r[10] * d0 + r[11] * d1 + r[12] * d2);
    sl.tm1(k) = cl * (r[13] * d0 + r[14] * d1 + r[15] * d2);
    lmax = fmaxf(lmax, lwk);
  }
  // fmaxf drops NaN operands where jnp.maximum propagates them; a NaN
  // log-weight can only come from a NaN table row, which pack_guided_rows
  // never writes for a live component.
  const bool cond_valid = (lmax > 0.5f * NEG) && (lmax < -NEG);
  const float lref = cond_valid ? lmax : 0.0f;

  // ---- pass 2: normalised weights (kept in lw) ----
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float lwk = sl.lw(k);
    const float w = lwk > 0.5f * NEG ? expf(fmaxf(lwk - lref, -80.0f)) : 0.0f;
    sl.lw(k) = w;
    total += w;
  }
  const float inv_total = cond_valid ? 1.0f / fmaxf(total, 1e-38f) : 0.0f;

  // ---- pass 3: zero out-of-range conditional means, CDF selection ----
  float uv[3];
  lane.uniforms(uv);
  const float u_sel = uv[0], u_r = uv[1], u_th = uv[2];
  float cdf = 0.0f;
  int sel = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = sl.tm0(k), b = sl.tm1(k);
    const float ln = sqrtf(fmaxf(a * a + b * b, 0.0f));
    const float w = ln < PI_F ? sl.lw(k) * inv_total : 0.0f;
    sl.lw(k) = w;
    cdf += w;
    sel += u_sel > cdf ? 1 : 0;
  }
  sel = min(sel, K - 1);
  float sel_tm0, sel_tm1;
  sl.sel_tm(sel, &sel_tm0, &sel_tm1);
  float sc[6];
  row.pass4(sel, sc);
  float smu[3];
  cond_mean(sel_tm0, sel_tm1, sc[0], sc[1], sc[2], smu);
  const float sc00 = sc[3], sc10 = sc[4], sc11 = sc[5];

  // ---- Box-Muller sample in the selected component's tangent frame ----
  const float r = sqrtf(fmaxf(0.0f, -2.0f * logf(1.0f - fminf(u_r, 1.0f - 1e-7f))));
  float sth, cth;  // sin and cos of 2 pi u_th
  sincospif(2.0f * u_th, &sth, &cth);
  const float zz0 = r * sth;
  const float zz1 = r * cth;
  const float t0 = sc00 * zz0;
  const float t1 = sc10 * zz0 + sc11 * zz1;
  const float lg = sqrtf(fmaxf(t0 * t0 + t1 * t1, 0.0f));
  TileOut out;
  out.g_ok = lg < PI_F;
  float sg, rg2;
  sinc_cos(lg, &sg, &rg2);
  const float rg0 = t0 * sg, rg1 = t1 * sg;
  float gs[3], gt[3];
  coordinate_system(smu[0], smu[1], smu[2], gs, gt);
  const float gx = gs[0] * rg0 + gt[0] * rg1 + smu[0] * rg2;
  const float gy = gs[1] * rg0 + gt[1] * rg1 + smu[1] * rg2;
  const float gz = gs[2] * rg0 + gt[2] * rg1 + smu[2] * rg2;

  // ---- pass 4: mixture pdf at both candidate directions ----
  float b[3];
  lane.wob(b);
  const float bx = b[0], by = b[1], bz = b[2];
  float pdf_g = 0.0f, pdf_b = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float c[6];
    row.pass4(k, c);
    float mu[3], fs[3], ft[3];
    cond_mean(sl.tm0(k), sl.tm1(k), c[0], c[1], c[2], mu);
    coordinate_system(mu[0], mu[1], mu[2], fs, ft);
    const float c00 = c[3], c10 = c[4], c11 = c[5];
    const float i00 = 1.0f / c00;
    const float i11 = 1.0f / c11;
    const float i10 = -c10 * i00 * i11;
    const float inv_det = i00 * i11;
    const float lwk = sl.lw(k);
    pdf_g += lwk * log_map_pdf(fs, ft, mu, gx, gy, gz, i00, i10, i11, inv_det);
    pdf_b += lwk * log_map_pdf(fs, ft, mu, bx, by, bz, i00, i10, i11, inv_det);
  }

  out.d[0] = gx;
  out.d[1] = gy;
  out.d[2] = gz;
  out.pdf_g = pdf_g;
  out.pdf_b = pdf_b;
  out.cond_valid = cond_valid;
  out.init = row.init() > 0.5f;
  return out;
}

}  // namespace guided
