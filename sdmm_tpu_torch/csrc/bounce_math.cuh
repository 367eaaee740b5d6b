// Per-lane helpers of the fused bounce kernels for NVIDIA Hopper (sm_90a).
//
// Device counterparts of the helpers of sdmm_tpu/ops/bounce_pallas.py
// (_woop_tri, _coordinate_system, _disk_concentric, _fresnel_dielectric,
// _fresnel_conductor_1, _ggx_d, _smith_g1, _sample_vndf, _vndf_pdf); their
// plain PyTorch twins are in ops/bounce.py, core/frame.py, core/warp.py and
// bsdf/fresnel.py. guided_tile.cuh takes its frame and constants from here.
// Each is the reference's math line for line on one lane's scalars. sin and
// cos go through sincospif, whose argument reduction is exact in units of
// pi: sinf and cosf would compile a Payne-Hanek slow path with a
// local-memory scratch array.

#pragma once

namespace bounce {

constexpr float INF = 3.4e38f;
constexpr float EPS = 1e-6f;
constexpr float RAY_EPS = 1e-4f;
constexpr float PI_F = 3.141592653589793f;
constexpr float INV_PI = 0.3183098861837907f;

constexpr int T_DIFFUSE = 0;
constexpr int T_CONDUCTOR = 1;
constexpr int T_DIELECTRIC = 2;
constexpr int T_ROUGHCONDUCTOR = 3;

// Lane meta word: pixel | depth << 20 | ALIVE | EXH.
constexpr int DEPTH_SHIFT = 20;
constexpr int ALIVE = 1 << 24;
constexpr int EXH = 1 << 25;
constexpr int PIX_MASK = (1 << 20) - 1;
constexpr int DEPTH_MASK = 0xF;

// Rows of the [43, T] triangle table (ops/bounce.py).
constexpr int TW = 0;
constexpr int TNG = 12;
constexpr int TNS = 15;
constexpr int TEM = 24;
constexpr int TPA = 27;
constexpr int TAL = 28;
constexpr int TTY = 31;
constexpr int TALP = 32;
constexpr int TETA = 33;
constexpr int TK = 34;
constexpr int TSP = 37;
constexpr int TRI_ROWS = 43;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// a*b + c*d + e*f rounded after every operation, in the twin's order, so
// that no fused multiply-add changes which triangle wins a near tie.
__device__ __forceinline__ float dot3_rn(float a, float b, float c, float d,
                                         float e, float f) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d)),
                   __fmul_rn(e, f));
}

// Woop-transform intersection against one triangle whose Woop rows are
// w[0..11] (B row-major, then c). Returns ok_geo (the t-range test is the
// caller's) and writes t, u, v. Degenerate and padding triangles have
// all-zero rows: d'_z = 0, never a hit.
__device__ __forceinline__ bool woop_tri(float rox, float roy, float roz,
                                         float rdx, float rdy, float rdz,
                                         const float w[12], float* t, float* u,
                                         float* v) {
  const float dpz = dot3_rn(w[6], rdx, w[7], rdy, w[8], rdz);
  const float opz = __fadd_rn(dot3_rn(w[6], rox, w[7], roy, w[8], roz), w[11]);
  const bool good = fabsf(dpz) > 1e-12f;
  const float inv = good ? __frcp_rn(dpz) : 0.0f;
  const float tt = __fmul_rn(-opz, inv);
  const float uu = __fadd_rn(
      __fadd_rn(dot3_rn(w[0], rox, w[1], roy, w[2], roz), w[9]),
      __fmul_rn(tt, dot3_rn(w[0], rdx, w[1], rdy, w[2], rdz)));
  const float vv = __fadd_rn(
      __fadd_rn(dot3_rn(w[3], rox, w[4], roy, w[5], roz), w[10]),
      __fmul_rn(tt, dot3_rn(w[3], rdx, w[4], rdy, w[5], rdz)));
  *t = tt;
  *u = uu;
  *v = vv;
  return good && uu >= 0.0f && vv >= 0.0f && __fadd_rn(uu, vv) <= 1.0f;
}

// Duff et al. branchless orthonormal basis (s, t) around unit n.
__device__ __forceinline__ void coordinate_system(float nx, float ny, float nz,
                                                  float s[3], float t[3]) {
  const float sign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + nz);
  const float b = nx * ny * a;
  s[0] = 1.0f + sign * nx * nx * a;
  s[1] = sign * b;
  s[2] = -sign * nx;
  t[0] = b;
  t[1] = sign + ny * ny * a;
  t[2] = -ny;
}

// Shirley's concentric square -> disk map. theta is kept in units of pi.
__device__ __forceinline__ void disk_concentric(float u0, float u1, float* x,
                                                float* y) {
  const float ox = 2.0f * u0 - 1.0f;
  const float oy = 2.0f * u1 - 1.0f;
  const bool zero = ox == 0.0f && oy == 0.0f;
  const bool cond = fabsf(ox) > fabsf(oy);
  float r = cond ? ox : oy;
  const float safe_div = cond ? (ox != 0.0f ? oy / ox : 0.0f)
                              : (oy != 0.0f ? ox / oy : 0.0f);
  const float theta_pi = cond ? 0.25f * safe_div : 0.5f - 0.25f * safe_div;
  r = zero ? 0.0f : r;
  float s, c;
  sincospif(theta_pi, &s, &c);
  *x = r * c;
  *y = r * s;
}

// Dielectric Fresnel with a scalar eta. cos_t carries -sign(cos_i), which
// is 0 at cos_i == 0 as jnp.sign is (copysignf would not be).
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta,
                                                    float* cos_t_out,
                                                    float* eta_it_out,
                                                    float* eta_ti_out) {
  const bool outside = cos_i >= 0.0f;
  const float rcp = 1.0f / eta;
  const float eta_it = outside ? eta : rcp;
  const float eta_ti = outside ? rcp : eta;
  const float cos_t2 = 1.0f - eta_ti * eta_ti * (1.0f - cos_i * cos_i);
  const float aci = fabsf(cos_i);
  const float cos_t = sqrtf(fmaxf(cos_t2, 0.0f));
  const float rs = (aci - eta_it * cos_t) / fmaxf(aci + eta_it * cos_t, 1e-12f);
  const float rp = (eta_it * aci - cos_t) / fmaxf(eta_it * aci + cos_t, 1e-12f);
  float f = 0.5f * (rs * rs + rp * rp);
  const float sgn = cos_i > 0.0f ? 1.0f : (cos_i < 0.0f ? -1.0f : 0.0f);
  f = cos_t2 <= 0.0f ? 1.0f : f;
  *cos_t_out = cos_t2 <= 0.0f ? 0.0f : -sgn * cos_t;
  *eta_it_out = eta_it;
  *eta_ti_out = eta_ti;
  return f;
}

// One channel of the conductor Fresnel term.
__device__ __forceinline__ float fresnel_conductor_1(float cos_i, float eta,
                                                     float k) {
  const float c2 = cos_i * cos_i;
  const float s2 = 1.0f - c2;
  const float e2 = eta * eta;
  const float k2 = k * k;
  const float t0 = e2 - k2 - s2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * e2 * k2, 0.0f));
  const float t1 = a2b2 + c2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * a * fabsf(cos_i);
  const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-12f);
  const float t3 = c2 * a2b2 + s2 * s2;
  const float t4 = t2 * s2;
  const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-12f);
  return 0.5f * (rp + rs);
}

__device__ __forceinline__ float ggx_d(float mz, float alpha) {
  const float cos_t = fmaxf(mz, 0.0f);
  const float a2 = alpha * alpha;
  const float den = cos_t * cos_t * (a2 - 1.0f) + 1.0f;
  return cos_t > 0.0f ? a2 / fmaxf(PI_F * den * den, 1e-20f) : 0.0f;
}

__device__ __forceinline__ float smith_g1(float vx, float vy, float vz,
                                          float mx, float my, float mz,
                                          float alpha) {
  const bool chi = dot3(vx, vy, vz, mx, my, mz) * vz > 0.0f;
  const float cos2 = vz * vz;
  const float tan2 = fmaxf(1.0f - cos2, 0.0f) / fmaxf(cos2, 1e-12f);
  const float lam = 0.5f * (sqrtf(1.0f + alpha * alpha * tan2) - 1.0f);
  return chi ? 1.0f / (1.0f + lam) : 0.0f;
}

// Heitz's visible-normal sampling of GGX; writes the unit microfacet normal.
__device__ __forceinline__ void sample_vndf(float wix, float wiy, float wiz,
                                            float alpha, float u0, float u1,
                                            float* mx_out, float* my_out,
                                            float* mz_out) {
  float vx = alpha * wix, vy = alpha * wiy, vz = wiz;
  const float inv = rsqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-20f));
  vx *= inv;
  vy *= inv;
  vz *= inv;
  const float lensq = vx * vx + vy * vy;
  const float inv_len = rsqrtf(fmaxf(lensq, 1e-20f));
  const bool big = lensq > 1e-12f;
  const float t1x = big ? -vy * inv_len : 1.0f;
  const float t1y = big ? vx * inv_len : 0.0f;
  const float t1z = 0.0f;
  const float t2x = vy * t1z - vz * t1y;
  const float t2y = vz * t1x - vx * t1z;
  const float t2z = vx * t1y - vy * t1x;
  const float r = sqrtf(fmaxf(u0, 0.0f));
  float sphi, cphi;
  sincospif(2.0f * u1, &sphi, &cphi);
  const float p1 = r * cphi;
  float p2 = r * sphi;
  const float s = 0.5f * (1.0f + vz);
  p2 = (1.0f - s) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float p3 = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const float nx = p1 * t1x + p2 * t2x + p3 * vx;
  const float ny = p1 * t1y + p2 * t2y + p3 * vy;
  const float nz = p1 * t1z + p2 * t2z + p3 * vz;
  const float mx = alpha * nx, my = alpha * ny, mz = fmaxf(nz, 0.0f);
  const float inv_m = rsqrtf(fmaxf(mx * mx + my * my + mz * mz, 1e-20f));
  *mx_out = mx * inv_m;
  *my_out = my * inv_m;
  *mz_out = mz * inv_m;
}

__device__ __forceinline__ float vndf_pdf(float wix, float wiy, float wiz,
                                          float mx, float my, float mz,
                                          float alpha) {
  const float g1 = smith_g1(wix, wiy, wiz, mx, my, mz, alpha);
  const float d = ggx_d(mz, alpha);
  return g1 * fabsf(dot3(wix, wiy, wiz, mx, my, mz)) * d /
         fmaxf(fabsf(wiz), 1e-12f);
}

}  // namespace bounce
