// The dense Moller-Trumbore closest-hit sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of sdmm_tpu/ops/intersect_pallas.py: mt_sweep /
// mt_sweep_native (pallas_call over _mt_kernel). It computes the same
// thing without the TPU's layout: rays ro, rd [N, 3] and t_max [N], the
// scene's triangles v0, e1, e2 [T, 3] read as they lie (the reference's
// transposed [3, Tp] copy lined chunks up with the TPU's lanes), and the
// hit record t, tri, u, v [N]: t = INF, tri = -1 and u = v = 0 on a miss.
//
// A hit is |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > EPS and
// t < min(best_t, t_max); triangles are swept in index order with a strict
// <, so the lowest index wins among equal t, as the reference's chunk
// argmin and strict < across chunks give. A degenerate triangle has
// det = 0 and is skipped before its t is used, so it never yields a NaN.
//
// One thread owns one ray; a block of 128 stages 128 triangles at a time
// (v0, e1, e2: 4.5 KB) in shared memory, component-major, from coalesced
// reads of the [T, 3] arrays. A thread past the last ray sweeps a real
// ray's copy so that it joins every barrier, and writes nothing. The file
// is compiled with -fmad=false: every multiply and add rounds on its own,
// in the order of the plain twin's PyTorch operations (ops/intersect_sweep
// _mt_chunk), so kernel and twin give the same winner, t, u and v.
//
// Bound: 61 FP32 operations per ray and triangle (the cross products, the
// determinant and its reciprocal, u, v, t, the six tests and the update),
// against 28 bytes in and 16 out per ray and 36 per triangle: operations
// bound it from ~14 triangles on. On the 36-triangle Cornell box, 262,144
// rays move 11.5 MB (~3.4 us at 3.35 TB/s) and need 5.8e8 operations
// (~8.6 us at 67 TFLOP/s); chip_smoke.py computes both from its run.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 128;  // triangles staged in shared memory per chunk
constexpr float INF = 3.4e38f;
constexpr float EPS = 1e-6f;

__global__ void __launch_bounds__(THREADS)
mt_sweep_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ t_max,
                const float* __restrict__ v0, const float* __restrict__ e1,
                const float* __restrict__ e2, float* __restrict__ out_t,
                int* __restrict__ out_tri, float* __restrict__ out_u,
                float* __restrict__ out_v, int n, int T) {
  __shared__ float sh[9][TILE];  // v0xyz, e1xyz, e2xyz of the chunk
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool active = i < n;
  const int li = active ? i : n - 1;
  const float rox = ro[3 * li], roy = ro[3 * li + 1], roz = ro[3 * li + 2];
  const float rdx = rd[3 * li], rdy = rd[3 * li + 1], rdz = rd[3 * li + 2];
  const float tmax = t_max[li];

  float best_t = INF, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  for (int base = 0; base < T; base += TILE) {
    const int cnt = min(TILE, T - base);
    __syncthreads();  // the previous chunk has been swept
    for (int k = threadIdx.x; k < 3 * cnt; k += THREADS) {
      const int c = k / 3, comp = k - 3 * c;
      const size_t g = (size_t)base * 3 + k;
      sh[comp][c] = __ldg(v0 + g);
      sh[3 + comp][c] = __ldg(e1 + g);
      sh[6 + comp][c] = __ldg(e2 + g);
    }
    __syncthreads();
    for (int c = 0; c < cnt; ++c) {
      const float v0x = sh[0][c], v0y = sh[1][c], v0z = sh[2][c];
      const float e1x = sh[3][c], e1y = sh[4][c], e1z = sh[5][c];
      const float e2x = sh[6][c], e2y = sh[7][c], e2z = sh[8][c];
      const float px = rdy * e2z - rdz * e2y;
      const float py = rdz * e2x - rdx * e2z;
      const float pz = rdx * e2y - rdy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      if (!(fabsf(det) > 1e-12f)) continue;
      const float inv_det = 1.0f / det;
      const float tx = rox - v0x, ty = roy - v0y, tz = roz - v0z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (rdx * qx + rdy * qy + rdz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > EPS && t < tmax &&
          t < best_t) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_i = base + c;
      }
    }
  }
  if (!active) return;
  out_t[i] = best_t;
  out_tri[i] = best_i;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

}  // namespace

extern "C" int mt_sweep_launch(const float* ro, const float* rd,
                               const float* t_max, const float* v0,
                               const float* e1, const float* e2, float* t,
                               int* tri, float* u, float* v, int n, int T,
                               void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  mt_sweep_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ro, rd, t_max, v0, e1, e2, t, tri, u, v, n, T);
  return (int)cudaGetLastError();
}
