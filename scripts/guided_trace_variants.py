"""Time variants of the guided_sample and trace kernels, to split where
their time goes and to choose between designs.

    python3 scripts/guided_trace_variants.py --csrc DIR --what before|after
        [--out DIR]

The script copies the kernels' sources from DIR (a csrc/ directory), edits
the copies and builds each with nvcc into --out.

--what before: DIR holds the design before the packed float32 leaf table
(guided_sample.cu reads the [L, 353] table value by value, guided_tile.cuh
RowF32; trace_kernel stages [12][128] column tiles of the Woop rows).
Variants: guided_sample as it was, and reading a packed float32 [L, 384]
table in 16-byte words with its register slots; trace as it was, with its
sweep compiled out (the lane's reads, gathers and writes alone), and with
the sweep kept but the lane's traffic cut to the ray rows in and four hit
rows out.

--what after: DIR holds the packed-table design (guided_sample.cu on
RowPackedF32 with register slots; trace on woop_stage.cuh). Variants of
guided_sample: shade's layout (the slots in a shared array, a launch bound
of 8 blocks an SM), the tangent means alone in shared memory under the
same bound, a launch bound of 5 blocks, and the lane's inputs read up
front. Variants of trace: the sweep one triangle at a time; one at a time
with the u, v half computed only where some lane of the warp has its t in
range (a warp vote); and all 16 of the lane's state rows and meta loaded
before the staging, so that they are in flight during the sweep.

Each is timed by CUDA-graph replays (chip_smoke.time_ms) at 131,072 lanes:
guided_sample on 2,048 random leaves and with every lane on one leaf (its
guide_valid against the twin's), trace on the Cornell box (its hit rows
against the twin's). The last line is a JSON object of the times. Needs a
CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))
import chip_smoke as cs  # noqa: E402
from sdmm_tpu_torch.ops import _build  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from torch_parity import lane_wave  # noqa: E402

# RowF32's packed counterpart, with the layout of pack_sample_table (for
# --what before).
ROW_PACKED_F32 = r'''
struct RowPackedF32 {
  const float4* __restrict__ p;
  __device__ __forceinline__ void pass1(int k, float v[16]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = __ldg(p + 6 * k + j);
      v[4 * j] = a.x, v[4 * j + 1] = a.y, v[4 * j + 2] = a.z,
      v[4 * j + 3] = a.w;
    }
  }
  __device__ __forceinline__ void pass4(int k, float v[6]) const {
    const float4 a = __ldg(p + 6 * k + 4), b = __ldg(p + 6 * k + 5);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y;
  }
  __device__ __forceinline__ float init() const { return __ldg(p + 5).z; }
};
'''


# Slot stores for --what after: the 16 log-weights in registers with the
# 32 tangent means in the thread's column of a shared array.
HYBRID_SLOTS = r"""
struct HybridSlots {
  float lw_[guided::K];
  float* p;
  int stride;
  __device__ __forceinline__ float& lw(int k) { return lw_[k]; }
  __device__ __forceinline__ float& tm0(int k) { return p[k * stride]; }
  __device__ __forceinline__ float& tm1(int k) {
    return p[(guided::K + k) * stride];
  }
  __device__ __forceinline__ void sel_tm(int sel, float* a, float* b) {
    *a = tm0(sel);
    *b = tm1(sel);
  }
};
"""

# Closest-hit sweeps for --what after: one triangle at a time; and one at a
# time with woop_tri split into its t half and its u, v half, the latter
# computed only where some lane of the warp has t in (EPS, best_t).
SWEEPS = r"""
__device__ __forceinline__ void sweep_one(
    const float4* __restrict__ wr, int cnt4, int base, float ox, float oy,
    float oz, float dx, float dy, float dz, float& best_t, float& bu,
    float& bv, int& bj) {
  for (int c = 0; c < cnt4; ++c) {
    float w[12], t, u, v;
    woop_row(wr, c, w);
    if (woop_tri(ox, oy, oz, dx, dy, dz, w, &t, &u, &v) && t > EPS &&
        t < best_t) {
      best_t = t;
      bu = u;
      bv = v;
      bj = base + c;
    }
  }
}
__device__ __forceinline__ void sweep_vote(
    const float4* __restrict__ wr, int cnt4, int base, float ox, float oy,
    float oz, float dx, float dy, float dz, float& best_t, float& bu,
    float& bv, int& bj) {
  for (int c = 0; c < cnt4; ++c) {
    float w[12];
    woop_row(wr, c, w);
    const float dpz = dot3_rn(w[6], dx, w[7], dy, w[8], dz);
    const float opz = __fadd_rn(dot3_rn(w[6], ox, w[7], oy, w[8], oz), w[11]);
    const bool good = fabsf(dpz) > 1e-12f;
    const float inv = good ? __frcp_rn(dpz) : 0.0f;
    const float t = __fmul_rn(-opz, inv);
    const bool in_range = good && t > EPS && t < best_t;
    if (__any_sync(0xFFFFFFFFu, in_range)) {
      const float u = __fadd_rn(
          __fadd_rn(dot3_rn(w[0], ox, w[1], oy, w[2], oz), w[9]),
          __fmul_rn(t, dot3_rn(w[0], dx, w[1], dy, w[2], dz)));
      const float v = __fadd_rn(
          __fadd_rn(dot3_rn(w[3], ox, w[4], oy, w[5], oz), w[10]),
          __fmul_rn(t, dot3_rn(w[3], dx, w[4], dy, w[5], dz)));
      if (in_range && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f) {
        best_t = t;
        bu = u;
        bv = v;
        bj = base + c;
      }
    }
  }
}
"""


def build(out, csrc, name, src):
    """nvcc ``src`` into ``out/name.so`` with the port's flags; prints the
    compiler's register report."""
    path = os.path.join(out, name + ".cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(out, name + ".so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
                        so, path], capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {name}: {line.strip()}", flush=True)
    if r.returncode:
        raise RuntimeError(r.stderr)
    return ctypes.CDLL(so)


def cut(src, start, end, new):
    """``src`` with the text from ``start`` up to ``end`` replaced."""
    a = src.index(start)
    return src[:a] + new + src[src.index(end, a):]


def sub(src, old, new):
    """``src`` with ``old``, which must be there, replaced by ``new``."""
    if old not in src:
        raise ValueError(f"not in the source: {old!r}")
    return src.replace(old, new)


def before_variants(csrc):
    gs = open(os.path.join(csrc, "guided_sample.cu")).read()
    v16 = sub(sub(gs, "namespace {\n", "namespace {\n" + ROW_PACKED_F32),
              "const guided::RowF32 row{table + (size_t)l * guided::NROWS};",
              "const RowPackedF32 row{reinterpret_cast<const float4*>(table) "
              "+ (size_t)l * 96};")
    gt = open(os.path.join(csrc, "guided_step.cu")).read()
    no_sweep = cut(gt, "  for (int base = 0; base < n_tris;",
                   "  if (!active) return;",
                   "  best_t = 1.0f; bu = 0.25f; bv = 0.25f; "
                   "bj = li % n_tris;\n")
    sweep_only = cut(gt, "  const bool alive = (meta[i] & ALIVE) != 0;",
                     "// The pointer, hidden", r"""
  const float t_safe = best_t < INF ? best_t : 0.0f;
  hit[i] = rox + t_safe * rdx;
  hit[N + i] = roy + t_safe * rdy;
  hit[2 * N + i] = roz + t_safe * rdz;
  hit[3 * N + i] = (float)bj + bu + bv;
}

""")
    return ([("as it was", gs, False), ("16-byte loads", v16, True)],
            [("as it was", gt, True), ("sweep compiled out", no_sweep, False),
             ("sweep alone", sweep_only, False)])


def after_variants(csrc):
    gs = open(os.path.join(csrc, "guided_sample.cu")).read()
    gs = sub(gs, "struct LaneRows {", HYBRID_SLOTS + "struct LaneRows {")
    reg = "  guided::RegSlots sl;"
    bound = "__launch_bounds__(THREADS)"
    kernel = "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
    shared = sub(sub(sub(gs, reg, "  guided::SharedSlots sl{&slots[0]"
                         "[threadIdx.x], THREADS};"),
                     bound, "__launch_bounds__(THREADS, 8)"),
                 kernel, "  __shared__ float slots[3 * guided::K][THREADS];\n"
                 + kernel)
    hybrid = sub(sub(sub(gs, reg, "  HybridSlots sl;\n  sl.p = "
                         "&slots[0][threadIdx.x];\n  sl.stride = THREADS;"),
                     bound, "__launch_bounds__(THREADS, 8)"),
                 kernel, "  __shared__ float slots[2 * guided::K][THREADS];\n"
                 + kernel)
    upfront = sub(gs, "LaneRows{pos, wob, u, i}",
                  "guided::LaneValues{{pos[3 * i], pos[3 * i + 1], "
                  "pos[3 * i + 2]}, {wob[3 * i], wob[3 * i + 1], "
                  "wob[3 * i + 2]}, {u[3 * i], u[3 * i + 1], u[3 * i + 2]}}")
    gs_vars = [("as it is", gs, True),
               ("shared slots, 8 blocks", shared, True),
               ("tangent means in shared memory, 8 blocks", hybrid, True),
               ("register slots, 5 blocks",
                sub(gs, bound, "__launch_bounds__(THREADS, 5)"), True),
               ("inputs up front", upfront, True)]
    gt = open(os.path.join(csrc, "guided_step.cu")).read()
    gt = sub(gt, "constexpr int THREADS = 128;",
             SWEEPS + "constexpr int THREADS = 128;")
    early = gt
    for old, new in (
            ("""  const float rox = state[0 * N + li], roy = state[1 * N + li],
              roz = state[2 * N + li];
  const float rdx = state[3 * N + li], rdy = state[4 * N + li],
              rdz = state[5 * N + li];
""", """  float sv[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) sv[r] = state[r * N + li];
  const int m = meta[li];
  const float rox = sv[0], roy = sv[1], roz = sv[2];
  const float rdx = sv[3], rdy = sv[4], rdz = sv[5];
"""),
            ("(meta[i] & ALIVE)", "(m & ALIVE)"),
            ("float x = state[r * N + i];", "float x = sv[r];"),
            ("state[(6 + c) * N + i]", "sv[6 + c]")):
        early = sub(early, old, new)
    gt_vars = [("as it is", gt, True),
               ("one triangle at a time",
                gt.replace("closest_sweep(", "sweep_one("), True),
               ("u, v half behind a warp vote",
                gt.replace("closest_sweep(", "sweep_vote("), True),
               ("the lane's rows loaded before the staging", early, True)]
    return gs_vars, gt_vars


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", required=True)
    ap.add_argument("--what", choices=("before", "after"), required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "variants"))
    args = ap.parse_args()
    csrc, out = os.path.abspath(args.csrc), os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    gs_vars, gt_vars = (before_variants if args.what == "before"
                        else after_variants)(csrc)
    dev = torch.device("cuda", 0)
    print("card:", cs.nvidia_smi_line(), flush=True)
    res = {}

    L, N = 2048, 131_072
    sdmm, prep, init = cs.mixture_state(L, 3, dev)
    table = gso.pack_guided_rows(prep, sdmm.weight, init).T.contiguous()
    packed = gso.pack_sample_table(table)
    rs = np.random.RandomState(11)
    leaf_r = torch.as_tensor(rs.randint(0, L, size=N).astype(np.int32),
                             device=dev)
    leaf_1 = torch.full_like(leaf_r, int(init.nonzero()[0]))
    pos = torch.as_tensor(rs.rand(N, 3).astype(np.float32), device=dev)
    wob = rs.randn(N, 3).astype(np.float32)
    wob = torch.as_tensor(wob / np.linalg.norm(wob, axis=-1, keepdims=True),
                          device=dev)
    u = torch.as_tensor(rs.rand(N, 3).astype(np.float32), device=dev)
    dg = torch.empty((N, 3), device=dev)
    misc = torch.empty((N, 4), device=dev)
    for j, (name, src, is_packed) in enumerate(gs_vars):
        tab = packed if is_packed else table
        fn = build(out, csrc, f"gs_{args.what}_{j}", src).guided_sample_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        for leaves, leaf in (("random", leaf_r), ("one", leaf_1)):
            def call():
                fn(tab.data_ptr(), leaf.data_ptr(), pos.data_ptr(),
                   wob.data_ptr(), u.data_ptr(), dg.data_ptr(),
                   misc.data_ptr(), N, L,
                   torch.cuda.current_stream().cuda_stream)
            call()
            torch.cuda.synchronize()
            ref = gso.guided_sample_plain(table[leaf.long()].T, pos.T, wob.T,
                                          u.T)
            ok = float(((misc[:, 3] > 0.5) == ref[4]).float().mean())
            ms = [cs.time_ms(call, reps=20, graph=True) for _ in range(2)]
            res[f"guided_sample {name}, {leaves} leaves"] = ms
            print(f"guided_sample {name}, {leaves} leaves: {ms} ms "
                  f"(guide_valid equal on {ok:.6f})", flush=True)

    from sdmm_tpu_torch.ops import guided_step as gst

    scene, cfg = cs.cornell_box(640, 360, dev)
    tri, _, env = bo.build_tables(scene)
    state, meta, _ = (torch.as_tensor(x, device=dev)
                      for x in lane_wave(N, 21, 640 * 360, 10))
    _, hit_p = gst.trace_plain(state, meta, tri, env, cfg.bsdf_types)
    nstate = torch.empty_like(state)
    hit = torch.empty((22, N), device=dev)
    for j, (name, src, whole) in enumerate(gt_vars):
        fn = build(out, csrc, f"gt_{args.what}_{j}", src).trace_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]

        def call():
            fn(state.data_ptr(), meta.data_ptr(), tri.data_ptr(),
               env.data_ptr(), nstate.data_ptr(), hit.data_ptr(), N,
               tri.shape[1], bo._type_mask(cfg.bsdf_types),
               torch.cuda.current_stream().cuda_stream)
        call()
        torch.cuda.synchronize()
        exact = [3, 4, 5] + list(range(9, 22))  # the winner's attributes
        same = (hit[exact] == hit_p[exact]).all(0).float().mean()
        agree = (f" (winner attributes equal to the twin's on "
                 f"{float(same):.6f})" if whole else "")
        ms = [cs.time_ms(call, reps=20, graph=True) for _ in range(3)]
        res[f"trace {name}"] = ms
        print(f"trace {name}: {ms} ms{agree}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
