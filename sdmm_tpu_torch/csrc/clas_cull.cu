// The cluster-cull intersector for scenes of any size, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel of sdmm_tpu/ops/clas_pallas.py: intersect_tiles
// (pallas_call over _kernel), which intersect and occluded call. It
// computes the same closest hit: over every triangle slot of every cluster
// (ops/clas_cull.build_woop_rows), a hit where the Woop test passes
// (csrc/bounce_math.cuh woop_tri) with EPS < t < t_max, the least t and,
// among equal t, the least code = cluster * t_c + slot, which is the first
// minimum in (cluster, slot) order that the plain twin's dense sweep finds.
// Output per ray: t (INF on a miss), the triangle id tri = ids[code] (-1 on
// a miss), and u, v of the winner (0 on a miss). The any-hit form (the
// eager pools' occluded) writes only whether some slot has EPS < t < t_max.
//
// What bounds it: the Woop tests a ray runs, and the warp's lockstep. The
// TPU kernel swept every cluster that any ray of a 2048-ray tile entered;
// a block vote over 128 incoherent rays on Hopper ran ~21 times the tests
// the bound admits. Here each thread walks a binary tree over the clusters
// (ops/clas_cull.build_tree: the clusters are in Morton order, so a
// complete tree over consecutive clusters is a linear BVH), nearer child
// first, with the reference's slab test and safe inverse of the direction.
// A node is pruned when its entry lies past the ray's best t or at or past
// t_max; a node entered exactly at the best t is not, so that an equal t of
// a lower code is still found, and a hit replaces the best when
// t < best_t || (t == best_t && code < best_code). A parent's box holds its
// children's and the slab test's rounding is monotone, so no cluster the
// flat test would enter at the same best t is skipped; front-to-back order
// shrinks the best t early. The any-hit form prunes by t_max alone and
// stops a ray at its first hit.
//
// The wrapper sorts the queries by direction octant, then by the Morton
// code of the origin (ops/clas_cull.query_order), and a thread reads its
// query and writes its result through that order: neighbouring lanes then
// walk alike, enter the same clusters and share their Woop rows in L1.
//
// The walk has the while-while shape of Aila & Laine (2009): the lanes of a
// warp open inner nodes until each holds a leaf or has none left, then the
// warp sweeps all its lanes' clusters together, and the lanes go on from
// their stacks, which prune again against the new best t. A warp pays for
// as many rounds as its busiest lane visits clusters, not for the union of
// its lanes' clusters. In a round only some lanes hold a cluster, so the
// sweep is shared out: with k holders, groups of m = 2^floor(log2(32 / k))
// lanes each take one holder's ray (by shuffles) and cluster, lane r of a
// group the slots r, r + m, ..., and a shuffle reduction hands the group's
// first minimum in code order back to its holder, which applies the tie
// rule. A round then costs t_c / m slot steps, not t_c. The stacks (node
// and entry distance, one entry a tree level) live in shared memory,
// [level][thread]. The Woop rows are read slot by slot ([C, t_c, 12]:
// three 16-byte loads a test, neighbouring lanes of a group on
// neighbouring slots; the 6.1 MB of the large scene's rows fit the 50 MB
// L2). Padding slots have all-zero rows (d'_z = 0, never a hit); empty
// nodes (lo > hi) are never entered. The file is compiled with -fmad=false,
// and woop_tri rounds every operation in the twin's order, so t, u and v
// are the twin's bit for bit wherever the winner is the same. Kernel and
// twin may disagree only on a ray whose hit lies within rounding of its
// cluster box's face.
//
// An optional 64-bit counter gets, from each warp, 32 times the number of
// slot steps in which any of its lanes ran a Woop test: per query, the
// warp's lockstep cost. Null on every path of the program.
//
// Bound: the least work of a walk over this tree is the Woop test (~56
// operations) of the real triangles of each cluster whose box the ray
// enters before its final hit distance, plus the slab tests (~30
// operations) of the two children of each inner node whose box it enters
// before that distance; bytes are the Woop rows and ids read once, plus 28
// bytes in and 16 out per ray. chip_smoke.py counts both from the twin's
// result (tests/torch_parity.py admitted_tests, least_slab_tests) and
// computes both bounds.

#include <cuda_runtime.h>

#include "bounce_math.cuh"

namespace {

using bounce::EPS;
using bounce::INF;

constexpr int THREADS = 128;
constexpr int STACK = 12;  // tree levels: up to 4096 leaves
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float safe_inv(float d) {
  const float dd = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / dd;
}

// The slab test of node k's box: whether the ray enters it before limit
// (entry <= best and entry < tmax), and its entry distance.
__device__ __forceinline__ bool enters(const float4* __restrict__ nodes,
                                       int k, float rox, float roy, float roz,
                                       float ix, float iy, float iz,
                                       float best, float tmax, float* entry) {
  const float4 lo = __ldg(nodes + 2 * k);
  const float4 hi = __ldg(nodes + 2 * k + 1);
  const float ax0 = (lo.x - rox) * ix;
  const float ay0 = (lo.y - roy) * iy;
  const float az0 = (lo.z - roz) * iz;
  const float ax1 = (hi.x - rox) * ix;
  const float ay1 = (hi.y - roy) * iy;
  const float az1 = (hi.z - roz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)),
                           fminf(az0, az1));
  const float tmx = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)),
                          fmaxf(az0, az1));
  *entry = tmin;
  return lo.x <= hi.x && tmx >= fmaxf(tmin, 0.0f) && tmin <= best &&
         tmin < tmax;
}

// The top of a lane's stack that is still entered at or before best, or 0
// when none is left.
__device__ __forceinline__ int pop(const int (*s_node)[THREADS],
                                   const float (*s_entry)[THREADS], int me,
                                   int& sp, float best) {
  while (sp > 0) {
    --sp;
    if (s_entry[sp][me] <= best) return s_node[sp][me];
  }
  return 0;
}

template <bool ANY>
__global__ void __launch_bounds__(THREADS)
clas_cull_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t_max,
                 const float4* __restrict__ nodes,
                 const float4* __restrict__ woop, const int* __restrict__ ids,
                 const int* __restrict__ order, float* __restrict__ out_t,
                 int* __restrict__ out_tri, float* __restrict__ out_u,
                 float* __restrict__ out_v, bool* __restrict__ out_occ, int n,
                 int tc, int leaves, unsigned long long* __restrict__ tests) {
  __shared__ int s_node[STACK][THREADS];
  __shared__ float s_entry[STACK][THREADS];
  const int me = threadIdx.x;
  const bool active = blockIdx.x * THREADS + me < n;
  // This thread's query: queries sorted by direction octant and origin
  // Morton code walk alike across a warp.
  const int li = __ldg(order + (active ? blockIdx.x * THREADS + me : n - 1));
  const float rox = ro[3 * li], roy = ro[3 * li + 1], roz = ro[3 * li + 2];
  const float rdx = rd[3 * li], rdy = rd[3 * li + 1], rdz = rd[3 * li + 2];
  const float tmax = t_max[li];
  const float ix = safe_inv(rdx), iy = safe_inv(rdy), iz = safe_inv(rdz);

  float best_t = INF, best_u = 0.0f, best_v = 0.0f;
  int code = -1;
  bool occ = false;
  int sp = 0;
  // The next node to open: an inner node, a leaf to sweep, or 0 when done.
  int node = active ? 1 : 0;
  unsigned long long steps = 0;  // slot steps in which a lane tested

  while (true) {
    // Open inner nodes, nearer child first, until this lane holds a leaf or
    // has nothing left.
    while (node > 0 && node < leaves) {
      const int c0 = 2 * node;
      float e0, e1;
      const bool h0 = enters(nodes, c0, rox, roy, roz, ix, iy, iz, best_t,
                             tmax, &e0);
      const bool h1 = enters(nodes, c0 + 1, rox, roy, roz, ix, iy, iz, best_t,
                             tmax, &e1);
      if (h0 && h1) {
        const bool first1 = e1 < e0;  // equal entries: the lower index first
        s_node[sp][me] = first1 ? c0 : c0 + 1;
        s_entry[sp][me] = first1 ? e0 : e1;
        ++sp;
        node = first1 ? c0 + 1 : c0;
      } else if (h0 || h1) {
        node = h0 ? c0 : c0 + 1;
      } else {
        node = pop(s_node, s_entry, me, sp, best_t);
      }
    }
    const bool sweep = node >= leaves;
    if (!__any_sync(FULL, sweep)) break;

    // Share out the holders' clusters: group g of m lanes sweeps the
    // cluster of the g-th holder, with that holder's ray.
    const unsigned holders = __ballot_sync(FULL, sweep);
    const int lane = me & 31;
    const int k = __popc(holders);
    const int m = 1 << (31 - __clz(32 / k));
    const int g = lane / m, r = lane % m;
    const bool helps = g < k;
    const int owner = helps ? __fns(holders, 0, g + 1) : lane;
    const float ox = __shfl_sync(FULL, rox, owner);
    const float oy = __shfl_sync(FULL, roy, owner);
    const float oz = __shfl_sync(FULL, roz, owner);
    const float dx = __shfl_sync(FULL, rdx, owner);
    const float dy = __shfl_sync(FULL, rdy, owner);
    const float dz = __shfl_sync(FULL, rdz, owner);
    const float otmax = __shfl_sync(FULL, tmax, owner);
    const int c = __shfl_sync(FULL, node - leaves, owner);
    float lt = INF, lu = 0.0f, lv = 0.0f;
    int lc = -1;
    int steps_here = 0;
    if (helps) {
      const float4* rows = woop + (size_t)c * tc * 3;
#pragma unroll 4  // loads of the next slots in flight behind this test
      for (int j = r; j < tc; j += m) {
        ++steps_here;
        const float4 a = __ldg(rows + 3 * j);
        const float4 b = __ldg(rows + 3 * j + 1);
        const float4 d = __ldg(rows + 3 * j + 2);
        const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                             b.z, b.w, d.x, d.y, d.z, d.w};
        float t, u, v;
        if (bounce::woop_tri(ox, oy, oz, dx, dy, dz, w, &t, &u, &v) &&
            t > EPS && t < otmax) {
          const int cj = c * tc + j;
          if (ANY) {
            lt = t;
            lc = cj;
            break;
          }
          if (t < lt) {  // slots rise along a lane: the first minimum
            lt = t;
            lu = u;
            lv = v;
            lc = cj;
          }
        }
      }
    }
    // The group's first minimum in code order, then back to its holder.
    for (int off = m >> 1; off > 0; off >>= 1) {
      const float t2 = __shfl_xor_sync(FULL, lt, off);
      const int c2 = __shfl_xor_sync(FULL, lc, off);
      const float u2 = __shfl_xor_sync(FULL, lu, off);
      const float v2 = __shfl_xor_sync(FULL, lv, off);
      if (c2 >= 0 && (lc < 0 || t2 < lt || (t2 == lt && c2 < lc))) {
        lt = t2;
        lc = c2;
        lu = u2;
        lv = v2;
      }
    }
    const int src = sweep ? __popc(holders & ((1u << lane) - 1u)) * m : lane;
    const float gt = __shfl_sync(FULL, lt, src);
    const int gc = __shfl_sync(FULL, lc, src);
    const float gu = __shfl_sync(FULL, lu, src);
    const float gv = __shfl_sync(FULL, lv, src);
    if (sweep) {
      if (gc >= 0) {
        if (ANY) {
          occ = true;
        } else if (gt < best_t || (gt == best_t && gc < code)) {
          best_t = gt;
          best_u = gu;
          best_v = gv;
          code = gc;
        }
      }
      node = (ANY && occ) ? 0 : pop(s_node, s_entry, me, sp, best_t);
    }
    if (tests != nullptr)
      steps += __reduce_max_sync(FULL, (unsigned)steps_here);
  }
  if (tests != nullptr && (me & 31) == 0) atomicAdd(tests, 32ull * steps);
  if (!active) return;
  if (ANY) {
    out_occ[li] = occ;
    return;
  }
  const int tri = code >= 0 ? __ldg(ids + code) : -1;
  out_t[li] = tri >= 0 ? best_t : INF;
  out_tri[li] = tri;
  out_u[li] = best_u;
  out_v[li] = best_v;
}

}  // namespace

extern "C" int clas_cull_launch(const float* ro, const float* rd,
                                const float* t_max, const float* tree,
                                const float* woop, const int* ids,
                                const int* order, float* t, int* tri,
                                float* u, float* v, bool* occ,
                                int n, int tc, int leaves, int any_hit,
                                unsigned long long* tests, void* stream) {
  if (leaves > (1 << STACK)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  const auto* nodes = reinterpret_cast<const float4*>(tree);
  const auto* rows = reinterpret_cast<const float4*>(woop);
  if (any_hit) {
    clas_cull_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        ro, rd, t_max, nodes, rows, ids, order, t, tri, u, v, occ, n, tc,
        leaves, tests);
  } else {
    clas_cull_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        ro, rd, t_max, nodes, rows, ids, order, t, tri, u, v, occ, n, tc,
        leaves, tests);
  }
  return (int)cudaGetLastError();
}
