// Woop rows staged in shared memory, and the sweeps over them, for NVIDIA
// Hopper (sm_90a): shared by the path kernels (bounce.cu step_kernel and
// bounce_kernel) and the guided trace kernel (guided_step.cu trace_kernel).
//
// A block stages rows 0-11 of the [43, T] triangle table (ops/bounce.py)
// as [T][12] float rows, three 16-byte words a triangle, in dynamic shared
// memory: the whole table once a block while it fits STAGE_MAX triangles
// (42 KB), past it TILE-triangle chunks of the same layout, one after the
// other. Rows past the count, up to a multiple of UNROLL, are zero: never
// hit, so the sweeps have no tail. Every thread of the block reaches the
// staging and its barriers; a thread past the last lane sweeps a copy of a
// real lane.
//
// The sweeps test UNROLL triangles at a time, independent tests whose
// loads and reciprocals may overlap; the closest hit then updates in index
// order with a strict t < best_t, so the first minimum wins, the plain
// twin's winner. Every operation of a test is rounded as woop_tri rounds
// it, so the compiler's contraction flags do not change a result. (A
// closest-hit sweep that computed a triangle's u and v only where some
// lane of the warp had its t in range, by a warp vote, timed within 1-4%
// of this one on one H100, faster in one call and slower in another: the
// vote rarely skips.)

#pragma once

#include <cuda_runtime.h>

#include "bounce_math.cuh"

namespace bounce {

constexpr int TILE = 128;       // triangles a chunk past STAGE_MAX
constexpr int STAGE_MAX = 896;  // triangles staged once a block (42 KB)
constexpr int UNROLL = 4;       // triangle tests in flight

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Dynamic shared bytes of a table of T triangle columns.
__host__ __device__ constexpr int woop_bytes(int T) {
  return round_up(T <= STAGE_MAX ? T : TILE, UNROLL) * 12 * 4;
}

// Woop rows 0-11 of triangles [base, base + cnt) into [c][12] float rows
// of wr, zero rows up to the next multiple of UNROLL. Reads are coalesced
// along the table's rows. The caller synchronises around it.
__device__ __forceinline__ void stage_woop(float4* wr, const float* tri,
                                           int T, int base, int cnt) {
  float* w = reinterpret_cast<float*>(wr);
  const int cnt4 = round_up(cnt, UNROLL);
  for (int idx = threadIdx.x; idx < 12 * cnt4; idx += blockDim.x) {
    const int r = idx / cnt4, c = idx % cnt4;
    w[c * 12 + r] = c < cnt ? __ldg(tri + (size_t)r * T + base + c) : 0.0f;
  }
}

__device__ __forceinline__ void woop_row(const float4* __restrict__ wr, int c,
                                         float w[12]) {
  const float4 a = wr[3 * c], b = wr[3 * c + 1], d = wr[3 * c + 2];
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  w[8] = d.x, w[9] = d.y, w[10] = d.z, w[11] = d.w;
}

// Closest hit over cnt4 staged rows (triangles base + c), UNROLL at a time;
// the updates run in index order with a strict <, so the first minimum
// wins.
__device__ __forceinline__ void closest_sweep(
    const float4* __restrict__ wr, int cnt4, int base, float ox, float oy,
    float oz, float dx, float dy, float dz, float& best_t, float& bu,
    float& bv, int& bj) {
  for (int c = 0; c < cnt4; c += UNROLL) {
    float t[UNROLL], u[UNROLL], v[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      float w[12];
      woop_row(wr, c + k, w);
      ok[k] = woop_tri(ox, oy, oz, dx, dy, dz, w, &t[k], &u[k], &v[k]);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (ok[k] && t[k] > EPS && t[k] < best_t) {
        best_t = t[k];
        bu = u[k];
        bv = v[k];
        bj = base + c + k;
      }
    }
  }
}

// Whether any of cnt4 staged rows is hit within (EPS, t_lim).
__device__ __forceinline__ bool any_sweep(const float4* __restrict__ wr,
                                          int cnt4, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float t_lim) {
  for (int c = 0; c < cnt4; c += UNROLL) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      float w[12], t, u, v;
      woop_row(wr, c + k, w);
      hit |= woop_tri(ox, oy, oz, dx, dy, dz, w, &t, &u, &v) && t > EPS &&
             t < t_lim;
    }
    if (hit) return true;
  }
  return false;
}

// Let the kernel take the dynamic shared memory of the largest staged
// table on the current device (above 48 KB only after this opt-in); done
// keeps one bit a device.
template <class Kernel>
cudaError_t allow_woop_smem(Kernel kernel, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (done >> dev) & 1u) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           woop_bytes(STAGE_MAX));
  if (e == cudaSuccess) done |= 1u << dev;
  return e;
}

}  // namespace bounce
