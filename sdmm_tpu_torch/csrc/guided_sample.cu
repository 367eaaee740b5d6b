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
// Design. The TPU version gathers a [353, N] row matrix per lane in XLA
// (185 MB written and read back per step at 131,072 lanes). Here one thread
// owns one lane and reads its leaf's 353-float row straight from the
// [L, 353] table (2.9 MB at L = 2048, resident in the 50 MB L2). The lane
// count needs no padding: the tail block is masked. The math is
// guided_tile.cuh's, read through its float32 row reader; the shade kernel
// of guided_step.cu runs the same function on bfloat16 rows.
//
// Bound. Per lane the kernel does on the order of 4,000 FP32 operations
// (16 components x two log-map pdfs, an exp map and two frames each) against
// 68 bytes of lane data, so it is bound by operations, not bytes. The row
// reads come from L2. Registers: chip_smoke.py prints nvcc's -Xptxas -v
// report of every build (PERF.md keeps the counts).

#include <cuda_runtime.h>
#include <stdint.h>

#include "guided_tile.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
guided_sample_kernel(const float* __restrict__ table,
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
  const guided::RowF32 row{table + (size_t)l * guided::NROWS};
  const guided::TileOut g = guided::guided_tile(
      row, pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], wob[3 * i],
      wob[3 * i + 1], wob[3 * i + 2], u[3 * i], u[3 * i + 1], u[3 * i + 2]);
  dg[3 * i] = g.d[0];
  dg[3 * i + 1] = g.d[1];
  dg[3 * i + 2] = g.d[2];
  misc[i] = make_float4(g.g_ok ? 1.0f : 0.0f, g.pdf_g, g.pdf_b,
                        (g.cond_valid && g.init) ? 1.0f : 0.0f);
}

}  // namespace

extern "C" int guided_sample_launch(const float* table, const int* leaf,
                                    const float* pos, const float* wob,
                                    const float* u, float* dg, float* misc,
                                    int n, int n_leaves, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  guided_sample_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, leaf, pos, wob, u, dg, reinterpret_cast<float4*>(misc), n,
      n_leaves);
  return (int)cudaGetLastError();
}
