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
// det = 0 and fails the det test, so its NaN t is never taken.
//
// The file is compiled with -fmad=false: every multiply and add rounds on
// its own, in the order of the plain twin's PyTorch operations
// (ops/intersect_sweep _mt_chunk), so kernel and twin give the same winner,
// t, u and v, bit for bit.
//
// What bounds it: instructions issued. Before this design the inner loop
// took ~88 SASS instructions a ray-triangle pair for ~46 multiplies and
// adds (nine 4-byte shared loads, the IEEE division's slow-path
// scaffolding, the tests and the branch of the det test), at 3.2-3.8x the
// operation bound. Now:
//  - the whole scene (<= 1024 triangles) is staged once a block as 48-byte
//    rows (v0, e1, e2) behind one barrier, in dynamic shared memory sized to
//    the scene, and read as three 16-byte words a triangle;
//  - the det test is a select, not a branch, and t_max and the best t are
//    one limit;
//  - above DEFER_FROM triangles each thread sweeps R = 4 rays and defers
//    the reciprocal and the scaling of u, v and t behind a pre-test on their
//    unscaled numerators and a warp vote (mt_pair<true>): with many small
//    triangles few warps have a lane near any one triangle, and the four
//    rays share each staged row. On a few large triangles some lane of a
//    warp passes the pre-test on most triangles (u >= 0 and v >= 0 on 99.3%
//    of warp-triangle pairs on the Cornell box), so there each thread sweeps
//    one ray with no vote. The threshold was set on the eager render_pool's
//    own queries over the Cornell box with one sphere, 36 to 996 triangles
//    (scripts/em_sweep_variants.py --what pool): the voted kernel loses at
//    36 and 68 triangles and wins from 108 on, by more as triangles shrink.
//
// Bound: 61 FP32 operations per ray and triangle (the cross products, the
// determinant and its reciprocal, u, v, t, the six tests and the update),
// against 28 bytes in and 16 out per ray and 36 per triangle: operations
// bound it from ~14 triangles on. With every multiply and add a separate
// instruction, the same arithmetic cannot run faster than twice that bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_TRIS = 1024;     // triangles staged at a time
constexpr int ROW = 12;            // floats a staged triangle (48 bytes)
constexpr int DEFER_FROM = 100;    // triangles from which the vote pays
constexpr float INF = 3.4e38f;
constexpr float EPS = 1e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, lim, t, u, v;
  int tri;
};

// One ray against one triangle, in the twin's order of operations. With
// DEFER, the reciprocal and the scaling of u, v and t wait behind a
// pre-test on their unscaled numerators U, V, T and a warp vote; the
// result is the same on every pair, as the pre-test passes every pair that
// the final test accepts. With s = sign(det), A = |det| > 1e-12 and
// r = fl(1/det) (finite, nonzero, sign s, within 2^-24 of 1/det relative,
// or 2^-150 absolute where 1/A is subnormal):
//  - u = fl(U r) >= 0 needs s U >= 0, or s U < 0 with U r rounding to -0,
//    so |U r| <= 2^-150 and |U| <= 2^-149 A (or <= 1/2 where r is
//    subnormal): below fl(A 2^-100), as A > 2^-40 makes A 2^-100 >= 2^-140.
//    The same for v.
//  - fl(u + v) <= 1 needs u + v <= 1 + 2^-24, so s U + s V <=
//    A (1 + 2^-21), below fl(A * 1.0001f) (or it overflows to inf).
//  - t > EPS > 0 needs T r > 0, that is s T > 0, exactly.
//  - t = fl(T r) < lim, t normal, needs s T < lim A (1 + 2^-22), below
//    fl(fl(lim A) * 1.0001f) (or it overflows to inf); a NaN lim rejects
//    in both.
// A NaN or infinite U, V or T fails the final test, so the pre-test's
// answer there does not matter. Every lane of the warp reaches the vote:
// the triangle loop is uniform over the block.
template <bool DEFER>
__device__ __forceinline__ void mt_pair(Ray& r, float v0x, float v0y,
                                        float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y,
                                        float e2z, int idx) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = fabsf(det) > 1e-12f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float U = tx * px + ty * py + tz * pz;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float V = r.dx * qx + r.dy * qy + r.dz * qz;
  const float T = e2x * qx + e2y * qy + e2z * qz;
  if (DEFER) {
    const float A = fabsf(det);
    const bool neg = det < 0.0f;
    const float us = neg ? -U : U, vs = neg ? -V : V, ts = neg ? -T : T;
    const bool pre = det_ok && us >= -(A * 0x1p-100f) &&
                     vs >= -(A * 0x1p-100f) && ts > 0.0f &&
                     us + vs <= A * 1.0001f && ts <= r.lim * A * 1.0001f;
    if (!__any_sync(0xffffffffu, pre)) return;
  }
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float u = U * inv_det, v = V * inv_det, t = T * inv_det;
  if (det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > EPS &&
      t < r.lim) {
    r.lim = t;
    r.t = t;
    r.u = u;
    r.v = v;
    r.tri = idx;
  }
}

template <int R, bool DEFER>
__global__ void __launch_bounds__(THREADS)
mt_sweep_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ t_max,
                const float* __restrict__ v0, const float* __restrict__ e1,
                const float* __restrict__ e2, float* __restrict__ out_t,
                int* __restrict__ out_tri, float* __restrict__ out_u,
                float* __restrict__ out_v, int n, int T) {
  extern __shared__ float4 rows[];  // [min(T, MAX_TRIS)][3]
  float* rowf = reinterpret_cast<float*>(rows);
  const int first = blockIdx.x * THREADS * R + threadIdx.x;
  Ray ray[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    // A ray past the last one sweeps a copy of ray n - 1, so that its
    // thread joins every barrier, and writes nothing.
    const int i = min(first + k * THREADS, n - 1);
    Ray& r = ray[k];
    r.ox = ro[3 * i], r.oy = ro[3 * i + 1], r.oz = ro[3 * i + 2];
    r.dx = rd[3 * i], r.dy = rd[3 * i + 1], r.dz = rd[3 * i + 2];
    // t < lim stands for t < t_max && t < best_t (best_t starts at INF); a
    // NaN t_max stays NaN, so no t passes, as in the twin.
    const float tm = t_max[i];
    r.lim = tm >= INF ? INF : tm;
    r.t = INF, r.u = 0.0f, r.v = 0.0f, r.tri = -1;
  }

  for (int base = 0; base < T; base += MAX_TRIS) {
    const int cnt = min(MAX_TRIS, T - base);
    if (base > 0) __syncthreads();  // the previous chunk has been swept
    for (int k = threadIdx.x; k < 3 * cnt; k += THREADS) {
      const int c = k / 3, comp = k - 3 * c;
      const size_t g = (size_t)base * 3 + k;
      rowf[c * ROW + comp] = __ldg(v0 + g);
      rowf[c * ROW + 3 + comp] = __ldg(e1 + g);
      rowf[c * ROW + 6 + comp] = __ldg(e2 + g);
    }
    __syncthreads();
    for (int c = 0; c < cnt; ++c) {
      const float4 a = rows[3 * c], b = rows[3 * c + 1], e = rows[3 * c + 2];
#pragma unroll
      for (int k = 0; k < R; ++k)
        mt_pair<DEFER>(ray[k], a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x,
                       base + c);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = first + k * THREADS;
    if (i < n) {
      out_t[i] = ray[k].t;
      out_tri[i] = ray[k].tri;
      out_u[i] = ray[k].u;
      out_v[i] = ray[k].v;
    }
  }
}

size_t shared_bytes(int T) {
  return (size_t)min(T, MAX_TRIS) * ROW * sizeof(float);
}

// The kernel a scene of T triangles takes, and its rays a thread.
const void* kernel_for(int T, int* rays) {
  *rays = T >= DEFER_FROM ? 4 : 1;
  return T >= DEFER_FROM ? (const void*)mt_sweep_kernel<4, true>
                         : (const void*)mt_sweep_kernel<1, false>;
}

}  // namespace

extern "C" int mt_sweep_launch(const float* ro, const float* rd,
                               const float* t_max, const float* v0,
                               const float* e1, const float* e2, float* t,
                               int* tri, float* u, float* v, int n, int T,
                               void* stream) {
  int rays;
  kernel_for(T, &rays);
  const int blocks = (n + THREADS * rays - 1) / (THREADS * rays);
  cudaStream_t st = (cudaStream_t)stream;
  if (rays == 4)
    mt_sweep_kernel<4, true><<<blocks, THREADS, shared_bytes(T), st>>>(
        ro, rd, t_max, v0, e1, e2, t, tri, u, v, n, T);
  else
    mt_sweep_kernel<1, false><<<blocks, THREADS, shared_bytes(T), st>>>(
        ro, rd, t_max, v0, e1, e2, t, tri, u, v, n, T);
  return (int)cudaGetLastError();
}

// The rays a thread of the kernel a scene of T triangles takes: 4 for the
// warp-voted kernel, 1 for the other.
extern "C" int mt_sweep_rays(int T) {
  int rays;
  kernel_for(T, &rays);
  return rays;
}

// Registers, local (spilled) bytes, static shared bytes and resident blocks
// an SM of the kernel a scene of T triangles takes (which 0), with its
// dynamic shared memory, into info[4].
extern "C" int mt_sweep_info(int, int T, int* info) {
  int rays;
  const void* f = kernel_for(T, &rays);
  cudaFuncAttributes a{};
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, THREADS,
                                                      shared_bytes(T));
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)a.sharedSizeBytes;
  info[3] = blocks;
  return (int)e;
}
