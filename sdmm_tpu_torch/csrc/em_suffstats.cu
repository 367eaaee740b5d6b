// EM E-step sufficient statistics for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel sdmm_tpu/ops/em_pallas.py::_suffstats_call
// (pallas_call over _suffstats_kernel, reached from e_step_pallas) and its
// glue sort_and_tile. Per sample: posteriors over the K = 16 components of
// the sample's leaf (the 5-D tangent-space Gaussian pdf, arccos by the same
// 7th-order minimax polynomial and the same posterior floor g < 1e-10 -> 0;
// a posterior that is not finite, or whose total's reciprocal is not, is
// dropped as in the plain twin and the reference's XLA E-step, where the
// reference's Pallas kernel lets a NaN through). Per (leaf, component): 21 statistics, sum(g w),
// sum(g w t) (5) and the lower triangle of sum(g w t t^T) (15); per leaf the
// valid samples' weight sum and count.
//
// Design. The reference pads every leaf's run to whole 1024-sample tiles
// and copies the samples into that layout (an [8, tiles * 1024] gather),
// then revisits one output block per leaf on a sequential grid. Here no
// sample is padded and no posterior is computed for padding or an invalid
// sample:
//  1. A stable counting sort of the valid samples by leaf, written by hand
//     (em_sort_launch), in chunks of 8,192 samples. em_keys_kernel writes
//     each sample's key (its leaf, or n_leaves for an invalid sample: a
//     non-finite or negative weight or a leaf out of range), each valid
//     sample's packed 32-byte row (px py pz dx | dy dz w -) and each
//     chunk's leaf histogram (shared-memory counters); em_chunk_scan_kernel
//     turns each leaf's column of chunk counts into offsets and its total;
//     em_scatter_kernel stages a chunk's keys and walks them in order with
//     one warp, the lanes of one key (__match_any_sync) taking consecutive
//     places after that key's counter. An invalid sample takes its key and
//     nothing else: no row, no place, no posterior. Past MAX_SHARED_HIST
//     leaves the counters live in global memory. The sort measured faster
//     than a stable torch.sort of int16 keys in the same pipeline
//     (scripts/em_sweep_variants.py --what sort).
//  2. em_plan_kernel, one block: exclusive scans of the leaf counts (each
//     leaf's first place in the order) and of its tile counts
//     ceil(count / tile) (each leaf's first tile).
//  3. em_tile_kernel, one block of 128 threads a tile. The work list is
//     implicit: the grid is sized from shapes (S / tile + n_leaves blocks,
//     no host sync); block b finds its leaf by a binary search of the tile
//     offsets and covers the run [start, end) of that leaf's sorted
//     samples, at most `tile` of them; blocks past the last tile exit at
//     once. A sample is one 32-byte row read through the order: one sector
//     where the reference's layout would take three (pos, dir, weight). For
//     each chunk of 128 samples, thread = sample computes its 16 weighted
//     posteriors and tangent coordinates into shared memory (pass 1; a
//     component of zero weight is skipped: its posterior is 0 exactly, as
//     in the reference); then thread = (component, lane of 8) accumulates
//     that component's 21 sums over 16 of the chunk's samples in registers
//     (pass 2). Pass 2's sample order is rotated by 8 per component, so the
//     four components of a warp read four different bank groups of
//     unpadded 128-float rows (28,160 bytes of shared memory). After the
//     run, the 8 lanes of a component are reduced by warp shuffles into the
//     tile's partial [16, 21], and the block's weight sum in a fixed order.
//  4. em_reduce_kernel, one block a leaf, adds its tiles' partials in tile
//     order and writes the outputs in their final layout (the covariance
//     sums mirrored into both triangles).
// Every sum runs in a fixed order and no float atomic is used, so two
// calls on the same input give the same bits.
//
// Bound. ~147 FP32 operations per sample and live component (102 for the
// log map with the polynomial arccos, the triangular solve, the pdf and the
// posterior; 4 to normalise; 41 to accumulate) against 32 bytes read per
// sample: bound by operations. chip_smoke.py counts both from its run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 16;
constexpr int NSTAT = 21;
constexpr int PCOLS = 32;
constexpr int CH = 128;          // samples per chunk = threads per block
constexpr int LANES = 8;         // threads per component in pass 2
constexpr int SORT_CHUNK = 8192;  // samples a chunk of the counting sort
constexpr int SORT_THREADS = 256;
constexpr int PLAN_THREADS = 1024;
constexpr int REDUCE_THREADS = K * NSTAT + 1;  // + the weight sum
constexpr int MAX_SHARED_HIST = 12288;  // leaves a 48 KB histogram holds
constexpr float PI_F = 3.141592653589793f;
constexpr float INV_SQRT_TWO_PI_5 = 0.010105326013811646f;  // (2 pi)^-5/2

__constant__ int TRI_I[15] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4};
__constant__ int TRI_J[15] = {0, 0, 1, 0, 1, 2, 0, 1, 2, 3, 0, 1, 2, 3, 4};

__device__ __forceinline__ float acos_poly(float x) {
  const float ax = fabsf(x);
  float p = -0.0012624911f;
  p = p * ax + 0.0066700901f;
  p = p * ax - 0.0170881256f;
  p = p * ax + 0.0308918810f;
  p = p * ax - 0.0501743046f;
  p = p * ax + 0.0889789874f;
  p = p * ax - 0.2145988016f;
  p = p * ax + 1.5707963050f;
  const float r = sqrtf(fmaxf(1.0f - ax, 0.0f)) * p;
  return x < 0.0f ? PI_F - r : r;
}

// Keys, the chunk's leaf histogram and the packed rows of chunk b
// (SORT_CHUNK samples): key = the leaf, or n_leaves for an invalid sample;
// hist [n_chunks, n_leaves] gets the chunk's counts.
template <typename LeafT>
__global__ void __launch_bounds__(SORT_THREADS)
em_keys_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
               const float* __restrict__ weight,
               const LeafT* __restrict__ leaf, int S, int n_leaves,
               int* __restrict__ key, int* __restrict__ hist,
               float4* __restrict__ rows, int shared) {
  extern __shared__ int sh_hist[];
  const int tid = threadIdx.x;
  int* h = hist + (size_t)blockIdx.x * n_leaves;
  if (shared) {
    for (int e = tid; e < n_leaves; e += SORT_THREADS) sh_hist[e] = 0;
    __syncthreads();
  }
  const int i0 = blockIdx.x * SORT_CHUNK, i1 = min(i0 + SORT_CHUNK, S);
  for (int i = i0 + tid; i < i1; i += SORT_THREADS) {
    const float w = weight[i];
    const LeafT l = leaf[i];
    const bool ok = isfinite(w) && w >= 0.0f && l >= 0 && l < n_leaves;
    key[i] = ok ? (int)l : n_leaves;
    if (!ok) continue;
    atomicAdd(shared ? &sh_hist[(int)l] : &h[(int)l], 1);
    const size_t i3 = 3 * (size_t)i;
    rows[2 * (size_t)i] =
        make_float4(pos[i3], pos[i3 + 1], pos[i3 + 2], dir[i3]);
    rows[2 * (size_t)i + 1] = make_float4(dir[i3 + 1], dir[i3 + 2], w, 0.0f);
  }
  if (shared) {
    __syncthreads();
    for (int e = tid; e < n_leaves; e += SORT_THREADS) h[e] = sh_hist[e];
  }
}

// Per leaf (one warp), the exclusive scan of its chunk counts in place,
// hist [b, l] -> the leaf's samples in chunks before b, and its total.
__global__ void __launch_bounds__(128)
em_chunk_scan_kernel(int* __restrict__ hist, int n_chunks, int n_leaves,
                     int* __restrict__ counts) {
  const int l = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (l >= n_leaves) return;  // the whole warp
  int carry = 0;
  for (int base = 0; base < n_chunks; base += 32) {
    const int b = base + lane;
    int* p = hist + (size_t)b * n_leaves + l;
    const int v = b < n_chunks ? *p : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (b < n_chunks) *p = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) counts[l] = carry;
}

// The scatter of the stable counting sort, chunk b: the chunk's keys are
// staged in shared memory, then one warp walks them in order, 32 at a
// time; the lanes of one key (__match_any_sync) take consecutive places
// after that key's running counter, which starts at leaf_start[key] plus
// the key's samples in earlier chunks. Invalid samples get no place.
__global__ void __launch_bounds__(SORT_THREADS)
em_scatter_kernel(const int* __restrict__ key, int S, int n_leaves,
                  int* __restrict__ hist, const int* __restrict__ leaf_start,
                  int* __restrict__ order, int shared) {
  extern __shared__ int sh[];
  int* keys = sh;  // [SORT_CHUNK]
  int* off = hist + (size_t)blockIdx.x * n_leaves;
  int* ctr = shared ? sh + SORT_CHUNK : off;  // off is this block's own
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * SORT_CHUNK, n = min(SORT_CHUNK, S - i0);
  for (int e = tid; e < n; e += SORT_THREADS) keys[e] = key[i0 + e];
  for (int e = tid; e < n_leaves; e += SORT_THREADS)
    ctr[e] = leaf_start[e] + off[e];
  __syncthreads();
  if (tid >= 32) return;
  const unsigned below = (1u << tid) - 1u;
  for (int r = 0; r < n; r += 32) {
    const int j = r + tid;
    const int k = j < n ? keys[j] : n_leaves;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const bool valid = k < n_leaves;
    const int first = valid ? ctr[k] : 0;
    __syncwarp();
    if (valid && (peers & below) == 0) ctr[k] = first + __popc(peers);
    __syncwarp();
    if (valid) order[first + __popc(peers & below)] = i0 + j;
  }
}

// Inclusive scan of a and b over the block (1024 threads); returns the
// block totals through tot_a, tot_b.
__device__ __forceinline__ void block_scan2(int& a, int& b, int* wa, int* wb,
                                            int& tot_a, int& tot_b) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, a, o);
    const int yb = __shfl_up_sync(0xffffffffu, b, o);
    if (lane >= o) a += ya, b += yb;
  }
  if (lane == 31) wa[wid] = a, wb[wid] = b;
  __syncthreads();
  if (wid == 0) {
    int x = wa[lane], y = wb[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xa = __shfl_up_sync(0xffffffffu, x, o);
      const int xb = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) x += xa, y += xb;
    }
    wa[lane] = x, wb[lane] = y;
  }
  __syncthreads();
  if (wid > 0) a += wa[wid - 1], b += wb[wid - 1];
  tot_a = wa[31], tot_b = wb[31];
  __syncthreads();  // wa, wb are reused by the next call
}

__global__ void __launch_bounds__(PLAN_THREADS)
em_plan_kernel(const int* __restrict__ counts, int n_leaves, int tile,
               int* __restrict__ leaf_start, int* __restrict__ tile_off) {
  __shared__ int wa[32], wb[32];
  int carry_a = 0, carry_b = 0;
  for (int base = 0; base < n_leaves; base += PLAN_THREADS) {
    const int l = base + threadIdx.x;
    const int c = l < n_leaves ? counts[l] : 0;
    const int nt = (c + tile - 1) / tile;
    int a = c, b = nt, tot_a, tot_b;
    block_scan2(a, b, wa, wb, tot_a, tot_b);
    if (l < n_leaves) {
      leaf_start[l] = carry_a + a - c;
      tile_off[l] = carry_b + b - nt;
    }
    carry_a += tot_a;
    carry_b += tot_b;
  }
  if (threadIdx.x == 0) {
    leaf_start[n_leaves] = carry_a;
    tile_off[n_leaves] = carry_b;
  }
}

struct Sample {
  float px, py, pz, dx, dy, dz, w;
};

__global__ void __launch_bounds__(CH)
em_tile_kernel(const float4* __restrict__ rows,
               const int* __restrict__ order,
               const int* __restrict__ leaf_start,
               const int* __restrict__ tile_off, int n_leaves, int tile,
               const float* __restrict__ params, float* __restrict__ partial,
               float* __restrict__ partial_w) {
  const int t = blockIdx.x;
  if (t >= __ldg(tile_off + n_leaves)) return;
  // The leaf whose tiles hold t: tile_off[lo] <= t < tile_off[lo + 1].
  int lo = 0, hi = n_leaves;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(tile_off + mid) <= t) lo = mid; else hi = mid;
  }
  const int start = __ldg(leaf_start + lo) + (t - __ldg(tile_off + lo)) * tile;
  const int end = min(start + tile, __ldg(leaf_start + lo + 1));

  __shared__ float par[K * PCOLS];
  __shared__ float s_gw[K * CH];
  __shared__ float s_t3[K * CH];
  __shared__ float s_t4[K * CH];
  __shared__ float s_p[3 * CH];

  const int tid = threadIdx.x;
  for (int e = tid; e < K * PCOLS; e += CH)
    par[e] = __ldg(params + (size_t)lo * K * PCOLS + e);

  const int kc = tid / LANES;    // component of this thread in pass 2
  const int lane = tid % LANES;
  float acc[NSTAT];
#pragma unroll
  for (int e = 0; e < NSTAT; ++e) acc[e] = 0.0f;
  float wsum = 0.0f;
  __syncthreads();
  const bool kc_live = par[kc * PCOLS] != 0.0f;

  for (int base = start; base < end; base += CH) {
    // ---- pass 1: thread = sample ----
    if (base + tid < end) {
      // The sample's packed row (px py pz dx | dy dz w -), through the order.
      const size_t i = __ldg(order + base + tid);
      const float4 ra = __ldg(rows + 2 * i), rb = __ldg(rows + 2 * i + 1);
      const Sample sm{ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z};
      wsum += sm.w;
      const bool dd_ok =
          (sm.dx * sm.dx + sm.dy * sm.dy + sm.dz * sm.dz) > 0.0f;
      float total = 0.0f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float* p = par + k * PCOLS;
        float post = 0.0f, t3v = 0.0f, t4v = 0.0f;
        if (p[0] != 0.0f) {
          // rot columns (s, t, mu); rel = R^T d.
          const float relx = p[7] * sm.dx + p[10] * sm.dy + p[13] * sm.dz;
          const float rely = p[8] * sm.dx + p[11] * sm.dy + p[14] * sm.dz;
          const float relz = p[9] * sm.dx + p[12] * sm.dy + p[15] * sm.dz;
          const float cos_a = fminf(fmaxf(relz, -1.0f), 1.0f);
          const bool valid = (cos_a > -1.0f + 1e-7f) && dd_ok;
          const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
          const float aos =
              sin_a < 1e-3f ? 1.0f : acos_poly(cos_a) / fmaxf(sin_a, 1e-12f);
          const float t3 = relx * aos;
          const float t4 = rely * aos;
          const float c0 = sm.px - p[1], c1 = sm.py - p[2], c2 = sm.pz - p[3];
          const float* ic = p + 16;
          const float z0 = ic[0] * c0;
          const float z1 = ic[1] * c0 + ic[2] * c1;
          const float z2 = ic[3] * c0 + ic[4] * c1 + ic[5] * c2;
          const float z3 = ic[6] * c0 + ic[7] * c1 + ic[8] * c2 + ic[9] * t3;
          const float z4 = ic[10] * c0 + ic[11] * c1 + ic[12] * c2 +
                           ic[13] * t3 + ic[14] * t4;
          const float q = z0 * z0 + z1 * z1 + z2 * z2 + z3 * z3 + z4 * z4;
          const float pdf =
              valid ? INV_SQRT_TWO_PI_5 * expf(-0.5f * q) * p[31] * aos : 0.0f;
          post = p[0] * pdf;
          // A non-finite tangent coordinate adds nothing, as in the twin.
          t3v = (valid && isfinite(t3)) ? t3 : 0.0f;
          t4v = (valid && isfinite(t4)) ? t4 : 0.0f;
        }
        total += post;
        s_gw[k * CH + tid] = post;
        s_t3[k * CH + tid] = t3v;
        s_t4[k * CH + tid] = t4v;
      }
      // As the twin: 1 / total where that is finite, else 0 (a total
      // below 1 / FLT_MAX would give inf, and 0 * inf a NaN posterior).
      float inv_total = total > 0.0f ? 1.0f / total : 0.0f;
      inv_total = isfinite(inv_total) ? inv_total : 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // A posterior below 1e-10 or not finite (an overflowed pdf gives
        // inf * 0) is dropped, as the twin and the reference's XLA E-step
        // drop it; the reference's Pallas kernel lets a NaN through.
        float g = s_gw[k * CH + tid] * inv_total;
        g = (g >= 1e-10f && isfinite(g)) ? g : 0.0f;
        s_gw[k * CH + tid] = sm.w * g;
      }
      s_p[tid] = isfinite(sm.px) ? sm.px : 0.0f;
      s_p[CH + tid] = isfinite(sm.py) ? sm.py : 0.0f;
      s_p[2 * CH + tid] = isfinite(sm.pz) ? sm.pz : 0.0f;
    } else {
      // Past the run: slots that add nothing in pass 2.
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s_gw[k * CH + tid] = 0.0f;
        s_t3[k * CH + tid] = 0.0f;
        s_t4[k * CH + tid] = 0.0f;
      }
      s_p[tid] = s_p[CH + tid] = s_p[2 * CH + tid] = 0.0f;
    }
    __syncthreads();

    // ---- pass 2: thread = (component, lane) ----
    if (kc_live) {
#pragma unroll 2
      for (int j = 0; j < CH / LANES; ++j) {
        const int s = (lane + LANES * (j + kc)) & (CH - 1);
        const float gw = s_gw[kc * CH + s];
        const float tv[5] = {s_p[s], s_p[CH + s], s_p[2 * CH + s],
                             s_t3[kc * CH + s], s_t4[kc * CH + s]};
        acc[0] += gw;
        float gt[5];
#pragma unroll
        for (int a = 0; a < 5; ++a) {
          gt[a] = gw * tv[a];
          acc[1 + a] += gt[a];
        }
        int e = 6;
#pragma unroll
        for (int a = 0; a < 5; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b) acc[e++] += gt[a] * tv[b];
        }
      }
    }
    __syncthreads();
  }

  // Reduce the 8 lanes of each component (consecutive threads of a warp).
#pragma unroll
  for (int e = 0; e < NSTAT; ++e) {
    float v = acc[e];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    acc[e] = v;
  }
  if (lane == 0) {
    float* out = partial + ((size_t)t * K + kc) * NSTAT;
#pragma unroll
    for (int e = 0; e < NSTAT; ++e) out[e] = acc[e];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
  if ((tid & 31) == 0) s_p[tid >> 5] = wsum;  // free after the last chunk
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < CH / 32; ++w) s += s_p[w];
    partial_w[t] = s;
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
em_reduce_kernel(const float* __restrict__ partial,
                 const float* __restrict__ partial_w,
                 const int* __restrict__ tile_off, float* __restrict__ sw,
                 float* __restrict__ sm, float* __restrict__ sc,
                 float* __restrict__ ws) {
  const int l = blockIdx.x;
  const int e = threadIdx.x;
  const int t0 = tile_off[l], t1 = tile_off[l + 1];
  float s = 0.0f;
  if (e == K * NSTAT) {
    for (int t = t0; t < t1; ++t) s += partial_w[t];
    ws[l] = s;
    return;
  }
  for (int t = t0; t < t1; ++t) s += partial[(size_t)t * K * NSTAT + e];
  const int k = e / NSTAT, st = e % NSTAT;
  const size_t lk = (size_t)l * K + k;
  if (st == 0) {
    sw[lk] = s;
  } else if (st < 6) {
    sm[lk * 5 + st - 1] = s;
  } else {
    const int i = TRI_I[st - 6], j = TRI_J[st - 6];
    sc[lk * 25 + i * 5 + j] = s;
    sc[lk * 25 + j * 5 + i] = s;
  }
}

}  // namespace

// The packed rows, the stable counting sort of the valid samples by leaf
// and the work list: keys, chunk histograms and rows; the per-leaf scans
// over the chunks (counts); the scans over the leaves (leaf_start,
// tile_off); the scatter (order). leaf_bytes is 4 or 8 (int32 or int64 leaf
// ids); key [S] and hist [ceil(S / SORT_CHUNK), n_leaves] are scratch;
// rows [S, 8] gets (px py pz dx dy dz w -) of every valid sample, order [S]
// the valid samples' indices sorted stably by leaf (the rest of both is
// left unwritten).
extern "C" int em_sort_launch(const float* pos, const float* dir,
                              const float* weight, const void* leaf,
                              int leaf_bytes, int S, int n_leaves, int tile,
                              int* key, int* hist, float* rows, int* counts,
                              int* leaf_start, int* tile_off, int* order,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (S + SORT_CHUNK - 1) / SORT_CHUNK;
  const int shared = n_leaves <= MAX_SHARED_HIST;
  cudaError_t err = cudaSuccess;
  if (n_chunks > 0) {
    if (!shared)
      err = cudaMemsetAsync(hist, 0,
                            (size_t)n_chunks * n_leaves * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = shared ? (size_t)n_leaves * sizeof(int) : 0;
    if (leaf_bytes == 8)
      em_keys_kernel<int64_t><<<n_chunks, SORT_THREADS, smem, st>>>(
          pos, dir, weight, (const int64_t*)leaf, S, n_leaves, key, hist,
          (float4*)rows, shared);
    else
      em_keys_kernel<int><<<n_chunks, SORT_THREADS, smem, st>>>(
          pos, dir, weight, (const int*)leaf, S, n_leaves, key, hist,
          (float4*)rows, shared);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  em_chunk_scan_kernel<<<(n_leaves + 3) / 4, 128, 0, st>>>(hist, n_chunks,
                                                           n_leaves, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  em_plan_kernel<<<1, PLAN_THREADS, 0, st>>>(counts, n_leaves, tile,
                                             leaf_start, tile_off);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_chunks > 0) {
    const int smem =
        (SORT_CHUNK + (shared ? n_leaves : 0)) * (int)sizeof(int);
    err = cudaFuncSetAttribute(em_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    em_scatter_kernel<<<n_chunks, SORT_THREADS, smem, st>>>(
        key, S, n_leaves, hist, leaf_start, order, shared);
    err = cudaGetLastError();
  }
  return (int)err;
}

// The statistics of the sorted samples: cap_tiles tile blocks, then the
// per-leaf reduction into sw [L, K], sm [L, K, 5], sc [L, K, 5, 5] and
// ws [L]. partial holds cap_tiles * (K * NSTAT + 1) floats.
extern "C" int em_stats_launch(const float* rows, const int* order,
                               const int* leaf_start, const int* tile_off,
                               int n_leaves, int tile, int cap_tiles,
                               const float* params, float* partial, float* sw,
                               float* sm, float* sc, float* ws,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* partial_w = partial + (size_t)cap_tiles * K * NSTAT;
  em_tile_kernel<<<cap_tiles, CH, 0, st>>>(
      (const float4*)rows, order, leaf_start, tile_off, n_leaves, tile,
      params, partial, partial_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  em_reduce_kernel<<<n_leaves, REDUCE_THREADS, 0, st>>>(
      partial, partial_w, tile_off, sw, sm, sc, ws);
  return (int)cudaGetLastError();
}

// Registers, local (spilled) bytes, static shared bytes and resident blocks
// an SM of kernel `which` (0 em_tile_kernel, 1 em_reduce_kernel), into
// info[4].
extern "C" int em_suffstats_info(int which, int, int* info) {
  const void* f = which == 0 ? (const void*)em_tile_kernel
                             : (const void*)em_reduce_kernel;
  const int threads = which == 0 ? CH : REDUCE_THREADS;
  cudaFuncAttributes a{};
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads, 0);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)a.sharedSizeBytes;
  info[3] = blocks;
  return (int)e;
}
