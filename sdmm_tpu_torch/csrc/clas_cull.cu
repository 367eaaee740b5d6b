// The cluster-cull intersector for scenes of any size, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel of sdmm_tpu/ops/clas_pallas.py: intersect_tiles
// (pallas_call over _kernel), which intersect and occluded call. It
// computes the same closest hit: every cluster's Woop rows [12, t_c]
// (ops/clas_cull.build_woop_rows) in cluster order and slot order, a hit
// where the Woop test passes (csrc/bounce_math.cuh woop_tri) with t > EPS,
// t < best_t (strict) and t < t_max. Output per ray: t (INF on a miss), the
// triangle id tri = ids[cluster * t_c + slot] (-1 on a miss), and u, v as
// the sweep leaves them (0 on a miss). The reference carried the winner's
// code as f32; here it stays an integer.
//
// The TPU's 2048-ray tile becomes a block of 128 rays, one thread each.
// For each cluster every thread runs the reference's slab test of the
// cluster's box against min(best_t, t_max), with its safe inverse of the
// direction; __syncthreads_or decides whether the block fetches the
// cluster at all. If it does, the cluster's Woop rows are staged in shared
// memory in pieces of at most 256 columns (12 KB, whatever t_c is: t_c
// doubles past 2048 clusters) and every thread of the block sweeps them,
// as every lane of the reference's tile does. Culling only skips work: the
// winner is the first minimum in (cluster, slot) order, as the plain
// twin's dense sweep finds it, except on a ray whose hit lies within
// rounding of its cluster box's face. Padding clusters are never read (the
// loop runs over the C real ones), and padding slots have all-zero rows:
// d'_z = 0, never a hit. A thread past the last ray sweeps a real ray's
// copy, votes no, and writes nothing. The file is compiled with
// -fmad=false, and woop_tri rounds every operation in the twin's order.
//
// Bound: the least work any culling design could do is each ray's slab
// test against every cluster (~30 operations), plus the Woop test (~56
// operations) of the real triangles of each cluster whose box the ray
// enters before its final hit distance; bytes are the Woop rows and ids
// read once, plus 28 bytes in and 16 out per ray. chip_smoke.py counts the
// admitted triangles from the twin's result and computes both bounds.

#include <cuda_runtime.h>

#include "bounce_math.cuh"

namespace {

using bounce::EPS;
using bounce::INF;

constexpr int THREADS = 128;
constexpr int STAGE = 256;  // Woop columns staged in shared memory at once

__device__ __forceinline__ float safe_inv(float d) {
  const float dd = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / dd;
}

__global__ void __launch_bounds__(THREADS)
clas_cull_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t_max,
                 const float* __restrict__ aabb,
                 const float* __restrict__ woop, const int* __restrict__ ids,
                 float* __restrict__ out_t, int* __restrict__ out_tri,
                 float* __restrict__ out_u, float* __restrict__ out_v, int n,
                 int C, int tc, int cp) {
  __shared__ float sh[12][STAGE];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool active = i < n;
  const int li = active ? i : n - 1;
  const float rox = ro[3 * li], roy = ro[3 * li + 1], roz = ro[3 * li + 2];
  const float rdx = rd[3 * li], rdy = rd[3 * li + 1], rdz = rd[3 * li + 2];
  const float tmax = t_max[li];
  const float ix = safe_inv(rdx), iy = safe_inv(rdy), iz = safe_inv(rdz);

  float best_t = INF, best_u = 0.0f, best_v = 0.0f;
  int code = -1;
  for (int c = 0; c < C; ++c) {
    // Phase 1: the slab test of cluster c against each ray's current best.
    const float ax0 = (__ldg(aabb + c) - rox) * ix;
    const float ay0 = (__ldg(aabb + cp + c) - roy) * iy;
    const float az0 = (__ldg(aabb + 2 * cp + c) - roz) * iz;
    const float ax1 = (__ldg(aabb + 3 * cp + c) - rox) * ix;
    const float ay1 = (__ldg(aabb + 4 * cp + c) - roy) * iy;
    const float az1 = (__ldg(aabb + 5 * cp + c) - roz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)),
                             fminf(az0, az1));
    const float tmx = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)),
                            fmaxf(az0, az1));
    const bool box_hit =
        tmx >= fmaxf(tmin, 0.0f) && tmin < fminf(best_t, tmax);
    if (!__syncthreads_or(active && box_hit)) continue;

    // Phase 2: sweep the cluster's slots in pieces of STAGE columns.
    const float* rows = woop + (size_t)c * 12 * tc;
    for (int p0 = 0; p0 < tc; p0 += STAGE) {
      const int cnt = min(STAGE, tc - p0);
      for (int k = threadIdx.x; k < 12 * cnt; k += THREADS) {
        const int r = k / cnt, col = k - r * cnt;
        sh[r][col] = __ldg(rows + (size_t)r * tc + p0 + col);
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        float w[12];
#pragma unroll
        for (int r = 0; r < 12; ++r) w[r] = sh[r][j];
        float t, u, v;
        if (bounce::woop_tri(rox, roy, roz, rdx, rdy, rdz, w, &t, &u, &v) &&
            t > EPS && t < best_t && t < tmax) {
          best_t = t;
          best_u = u;
          best_v = v;
          code = c * tc + p0 + j;
        }
      }
      __syncthreads();  // the piece has been swept before the next staging
    }
  }
  if (!active) return;
  const int tri = code >= 0 ? __ldg(ids + code) : -1;
  out_t[i] = tri >= 0 ? best_t : INF;
  out_tri[i] = tri;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

}  // namespace

extern "C" int clas_cull_launch(const float* ro, const float* rd,
                                const float* t_max, const float* aabb,
                                const float* woop, const int* ids, float* t,
                                int* tri, float* u, float* v, int n, int C,
                                int tc, int cp, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  clas_cull_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ro, rd, t_max, aabb, woop, ids, t, tri, u, v, n, C, tc, cp);
  return (int)cudaGetLastError();
}
