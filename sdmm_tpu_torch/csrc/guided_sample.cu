// SDMM guided sampling for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel sdmm_tpu/ops/guided_pallas.py::guided_sample
// (pallas_call over guided_tile). Per lane: condition the leaf's K = 16
// component mixture on the hit position (log-space weights with
// max-subtraction, 3-sigma trust-region clamp of the conditional mean),
// pick a component by CDF, draw a Box-Muller tangent sample and map it back
// with the exp map, then evaluate the mixture pdf at the guided and at the
// BSDF-sampled direction. The math is guided_tile's, line for line, with the
// same cubic arccos.
//
// Bound. Per lane the kernel does on the order of 4,000 FP32 operations
// (16 components x two log-map pdfs, an exp map and two frames each) against
// 68 bytes of lane data, so it is bound by operations, not bytes. The table
// (3.1 MB at L = 2048) stays in the 50 MB L2.
//
// Design. The TPU version gathers a [353, N] row matrix per lane in XLA.
// Here one thread owns one lane and reads its leaf's row straight from the
// table. Neighbouring lanes hold different leaves, so each warp-wide load
// touches up to 32 cache lines, and each lane pulls its whole 1.5 KB row
// through L2 (~200 MB at 131,072 lanes on random leaves): what costs is
// the number of load instructions and the L2 traffic. So the kernel reads
// the packed float32 table of ops/guided_sample.pack_sample_table ([L, 384]:
// each component's 22 values on a 24-value stride, every row 16-byte
// aligned) in whole 16-byte words, 96 loads a lane where the [L, 353] row
// took ~360 scalar ones (guided_tile.cuh RowPackedF32), and reads the
// lane's own inputs where guided_tile first needs them. The 48
// per-component slots stay in registers (~100 registers, four blocks an
// SM): on one H100 at 700 W, shade's layout (the slots in a 24 KB shared
// array under a launch bound of eight blocks, 48 registers) took 0.089 ms
// on 2,048 random leaves against 0.075 ms for register slots, and 0.049 ms
// against 0.046 with every lane on one leaf (PERF.md section 6); with the
// tangent means alone in shared memory (16 KB) it took register slots'
// 0.075 again, so the larger array likely costs the row reads their L1.
// The lane count needs no padding: the tail block is masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "guided_tile.cuh"

namespace {

constexpr int THREADS = 128;

// The lane's inputs from the [N, 3] pos, wob and u arrays, each read where
// guided_tile asks for it, through pointers the optimiser cannot see
// through, so that no value stays live across the passes before it.
struct LaneRows {
  const float* pos_;
  const float* wob_;
  const float* u_;
  int i;
  __device__ __forceinline__ static void read(const float* a, int i,
                                              float x[3]) {
    const float* p = guided::reread(a) + 3 * i;
    x[0] = p[0], x[1] = p[1], x[2] = p[2];
  }
  __device__ __forceinline__ void pos(float x[3]) const { read(pos_, i, x); }
  __device__ __forceinline__ void uniforms(float x[3]) const {
    read(u_, i, x);
  }
  __device__ __forceinline__ void wob(float x[3]) const { read(wob_, i, x); }
};

__global__ void __launch_bounds__(THREADS)
guided_sample_kernel(const float4* __restrict__ table,
                     const int* __restrict__ leaf,
                     const float* __restrict__ pos,
                     const float* __restrict__ wob,
                     const float* __restrict__ u,
                     float* __restrict__ dg,
                     float4* __restrict__ misc, int n, int n_leaves) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Out-of-range leaf ids are clamped, like an XLA gather.
  const int l = min(max(leaf[i], 0), n_leaves - 1);
  const guided::RowPackedF32 row{table + (size_t)l * (guided::PROW / 4)};
  guided::RegSlots sl;
  const guided::TileOut g =
      guided::guided_tile(row, sl, LaneRows{pos, wob, u, i});
  dg[3 * i] = g.d[0];
  dg[3 * i + 1] = g.d[1];
  dg[3 * i + 2] = g.d[2];
  misc[i] = make_float4(g.g_ok ? 1.0f : 0.0f, g.pdf_g, g.pdf_b,
                        (g.cond_valid && g.init) ? 1.0f : 0.0f);
}

}  // namespace

extern "C" int guided_sample_launch(const void* table, const int* leaf,
                                    const float* pos, const float* wob,
                                    const float* u, float* dg, float* misc,
                                    int n, int n_leaves, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  guided_sample_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(table), leaf, pos, wob, u, dg,
      reinterpret_cast<float4*>(misc), n, n_leaves);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, static shared bytes and resident blocks an
// SM of guided_sample_kernel (which 0; the second argument is unused), into
// info[4].
extern "C" int guided_sample_info(int, int, int* info) {
  const void* f = (const void*)guided_sample_kernel;
  cudaFuncAttributes a{};
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, THREADS, 0);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)a.sharedSizeBytes;
  info[3] = blocks;
  return (int)e;
}
