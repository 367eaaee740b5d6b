"""Time variants of the E-step (ops/em_suffstats.py and csrc/em_suffstats.cu)
and of the dense sweep (csrc/mt_sweep.cu), to split where their time goes
and to choose between designs.

    python3 scripts/em_sweep_variants.py --what before|after --root DIR
        [--out DIR]

--root is the root of a checkout: its sdmm_tpu_torch/ and chip_smoke.py are
imported, and its csrc/ sources are copied, edited and built with nvcc
into --out.

--what before: DIR holds the design before the E-step pipeline (a padded
[8, cap_tiles * 1024] copy built by sort_and_tile) and before the sweep's
redesign. It prints: sort_and_tile under torch.profiler at chip_smoke.py
phase 3's shape (the ops by device time, and the launches), and on the E-step
inputs of chip_smoke.py phase 5's training render (rows and valid rows of
each call); torch.sort of the leaf keys as int16 and int32; em_tile_kernel
as it was, with pass 2 compiled out, with pass 1 compiled out, and with the
chunks of padding skipped; mt_sweep's SASS inner loop (cuobjdump), the
share of ray-triangle pairs that pass each of its tests on phase 7's
Cornell queries (per pair, and per warp of 32 rays: some lane passes), and
its time as it was and with the reciprocal stubbed out.

--what after: DIR holds the redesign. It prints the E-step wrapper and its
stages at phase 3's shape and on a phase 5 trainer batch, and the variants
of the tile kernel (tiles of 256 to 2048 samples; a launch bound of 8
blocks an SM; the parameters read in 16-byte words; components of zero
weight not skipped; the packed rows read in their unsorted order, for
timing only; a compact sorted copy of the rows), with the SASS loops of
two of them; and of the sweep on phase 7's four scenes (1, 2 or 4 rays a
thread, with and without the warp-voted reciprocal), each held against the
plain twin, with the share of pairs that pass each test on each scene.

--what sort: the whole e_step wrapper with its hand-written counting sort
against the same pipeline with the counting sort's scatter replaced by a
stable torch.sort of int16 keys (written by the keys kernel), in
alternating turns (ABBA, three times 20 calls a turn, by events), at phase
3's shape and on a phase 5 trainer batch; both held bit-equal.

--what pool: the sweep kernels on the eager render_pool's own queries (its
intersect and occluded calls, captured at 640x360, 2 spp) on the Cornell
box with one sphere of 0 to 960 triangles (36 to 996 in all): 1 or 4 rays a
thread, with and without the warp-voted reciprocal, each a CUDA graph of
all the captured calls, each call held against the plain twin.

--what wrappers: the whole e_step wrapper at phase 3's shape (CUDA events,
three times 20 calls) and the mt_sweep wrapper on the Cornell box and the
996-triangle scene, through the public entry points that DIR's checkout
and its parent share, so that turns of both can alternate in one call.

Times are CUDA-graph replays (chip_smoke.time_ms) unless said otherwise.
The last line is a JSON object of the times. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

ap = argparse.ArgumentParser()
ap.add_argument("--what", choices=("before", "after", "wrappers", "sort",
                                   "pool"),
                required=True)
ap.add_argument("--root", required=True)
ap.add_argument("--out", default=None)
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root)
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))
sys.path.insert(2, os.path.join(HERE, "scripts"))
import chip_smoke as cs  # noqa: E402
from sdmm_tpu_torch.ops import _build  # noqa: E402
from sdmm_tpu_torch.ops import em_suffstats as ems  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep as isweep  # noqa: E402

CSRC = os.path.join(ROOT, "sdmm_tpu_torch", "csrc")
OUT = os.path.abspath(ARGS.out or os.path.join(HERE, "build", "variants"))
RES = {}


def record(key, value):
    RES[key] = value
    print(f"{key}: {value}", flush=True)


def build(name, src, fmad=True):
    """nvcc ``src`` into ``OUT/name.so`` with the port's flags; prints the
    compiler's register report."""
    return build_all([(name, src, fmad)])[0]


def build_all(jobs):
    """``build`` for every (name, src, fmad) of ``jobs``, one nvcc each, all
    started together; returns [(CDLL, path)]."""
    procs = []
    for name, src, fmad in jobs:
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(OUT, name + ".so")
        flags = _build.NVCC_FLAGS + ([] if fmad else ["-fmad=false"])
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *flags, "-I", CSRC, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for name, so, proc in procs:
        log = proc.communicate()[0]
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        if proc.returncode:
            raise RuntimeError(log)
        out.append((ctypes.CDLL(so), so))
    return out


def cut(src, start, end, new):
    """``src`` with the text from ``start`` up to ``end`` replaced."""
    a = src.index(start)
    return src[:a] + new + src[src.index(end, a):]


def sub(src, old, new):
    """``src`` with ``old``, which must be there, replaced by ``new``."""
    if old not in src:
        raise ValueError(f"not in the source: {old!r}")
    return src.replace(old, new)


def graph_ms(fn, n=2):
    return [cs.time_ms(fn, reps=20, graph=True) for _ in range(n)]


def profile_ops(name, fn, top=14):
    """fn under torch.profiler: device ms by op, kernel launches a call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda]
    rows = []
    for a in prof.key_averages():
        if a.device_type == cuda:
            rows.append((a.self_device_time_total / 1e3 / reps,
                         a.count // reps, a.key[:90]))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"{name}: {len(kern) / reps:.0f} kernel launches a call, "
          f"{total:.4f} ms of device time a call", flush=True)
    for ms, calls, key in rows[:top]:
        print(f"  {ms:9.4f} ms {calls:4d}x  {key}", flush=True)
    RES[f"{name} profile"] = {"launches": len(kern) / reps,
                              "device_ms": total,
                              "top": [list(r) for r in rows[:top]]}


def em_inputs(dev):
    """chip_smoke.py phase 3's E-step inputs (2,048 leaves, seed 17)."""
    L, S = 2048, 2_800_000
    sdmm, prep, _ = cs.mixture_state(L, 5, dev)
    rs = np.random.RandomState(17)
    leaf = torch.as_tensor(rs.randint(0, L, size=S).astype(np.int32),
                           device=dev)
    pos = torch.as_tensor(rs.rand(S, 3).astype(np.float32), device=dev)
    d = rs.randn(S, 3).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=dev)
    w = (rs.rand(S) * 2.0).astype(np.float32)
    w[1::211] = -1.0
    return sdmm, prep, pos, d, torch.as_tensor(w, device=dev), leaf, L


def trainer_batches(dev):
    """Every E-step input of chip_smoke.py phase 5's training render."""
    from sdmm_tpu_torch.guiding.trainer import SDMMTrainer, TrainerConfig

    scene, cfg = cs.cornell_box(640, 360, dev)
    tr = SDMMTrainer(scene, cfg, TrainerConfig(tail_chunk_spp=16),
                     device=dev)
    calls, real = [], ems.e_step

    def spy(sdmm, prep, pos, d, weight, leaf, n_leaves, *a, **k):
        calls.append((sdmm, prep, pos.clone(), d.clone(), weight.clone(),
                      leaf.clone(), n_leaves))
        return real(sdmm, prep, pos, d, weight, leaf, n_leaves, *a, **k)

    ems.e_step = spy
    try:
        tr.run(total_spp=64)
    finally:
        ems.e_step = real
    for j, (_, _, _, _, w, leaf, L) in enumerate(calls):
        valid = torch.isfinite(w) & (w >= 0) & (leaf >= 0) & (leaf < L)
        record(f"trainer E-step call {j}", {
            "rows": int(w.numel()), "valid rows": int(valid.sum()),
            "rows with w = -1": int((w == -1).sum()), "leaves": L,
            "leaves with samples": int(torch.unique(leaf[valid]).numel())})
    return calls


def pass_shares(ro, rd, tm, v0, e1, e2):
    """Shares of the pairs that pass det, then u >= 0, then v >= 0, then
    u + v <= 1, then t in range; per pair and per (warp of 32 rays,
    triangle): some lane passes."""
    out = {}
    acc = None
    names = ("det", "u >= 0", "v >= 0", "u + v <= 1", "t in range")
    sums = {k: [0, 0] for k in names}
    for sl in range(0, ro.shape[0], 8192):
        r = slice(sl, sl + 8192)
        t, u, v, _ = isweep._mt_chunk(ro[r], rd[r], v0, e1, e2, tm[r])
        rdv = rd[r]
        px = rdv[:, 1:2] * e2[None, :, 2] - rdv[:, 2:3] * e2[None, :, 1]
        py = rdv[:, 2:3] * e2[None, :, 0] - rdv[:, 0:1] * e2[None, :, 2]
        pz = rdv[:, 0:1] * e2[None, :, 1] - rdv[:, 1:2] * e2[None, :, 0]
        det = e1[None, :, 0] * px + e1[None, :, 1] * py + e1[None, :, 2] * pz
        acc = det.abs() > 1e-12
        stages = [acc]
        for cond in (u >= 0, v >= 0, u + v <= 1.0,
                     (t > 1e-6) & (t < tm[r, None])):
            acc = acc & cond
            stages.append(acc)
        for k, m in zip(names, stages):
            sums[k][0] += float(m.float().sum())
            sums[k][1] += float(m.view(-1, 32, m.shape[1]).any(1).float()
                                .sum() * 32)
    n = ro.shape[0] * v0.shape[0]
    for k in names:
        out[k] = {"pairs": sums[k][0] / n, "warps": sums[k][1] / n}
    return out


def sass_loops(so, kernel):
    """Per function of ``so`` whose name holds ``kernel`` (cuobjdump -sass):
    its instruction count and, for each loop (a span closed by a backward
    branch), the loop's length and opcode histogram (loads and stores with
    their width)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    funcs, body = {}, None
    for line in txt.splitlines():
        if line.strip().startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            body = funcs.setdefault(name, []) if kernel in name else None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if body is not None and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, body in funcs.items():
        loops = []
        for addr, ins in body:
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if b and int(b.group(1), 16) <= addr:
                lo = int(b.group(1), 16)
                ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0]
                       for a, i in body if lo <= a <= addr]
                hist = Counter(o if o.startswith(("LD", "ST"))
                               else o.split(".")[0] for o in ops)
                loops.append({"from": hex(lo), "to": hex(addr),
                              "instructions": len(ops),
                              "opcodes": dict(hist.most_common())})
        out[name[:60]] = {"instructions": len(body), "loops": loops}
    return out


def em_before(dev):
    sdmm, prep, pos, d, w, leaf, L = em_inputs(dev)
    S = pos.shape[0]
    profile_ops("phase 3 sort_and_tile",
                lambda: ems.sort_and_tile(pos, d, w, leaf, L, S))
    record("phase 3 e_step wrapper ms (events)", cs.time_ms(
        lambda: ems.e_step(sdmm, prep, pos, d, w, leaf, L), reps=20))
    valid = torch.isfinite(w) & (w >= 0) & (leaf >= 0) & (leaf < L)
    key = torch.where(valid, leaf, L)
    for dt in (torch.int16, torch.int32):
        k = key.to(dt)
        record(f"phase 3 torch.sort stable {dt} ms", graph_ms(
            lambda: torch.sort(k, stable=True)))

    for j, (sd, pr, p, dd, ww, lf, LL) in enumerate(trainer_batches(dev)):
        if j == 0:
            continue
        profile_ops(f"trainer call {j} sort_and_tile",
                    lambda: ems.sort_and_tile(p, dd, ww, lf, LL, p.shape[0]))
        record(f"trainer call {j} e_step wrapper ms (events)", cs.time_ms(
            lambda: ems.e_step(sd, pr, p, dd, ww, lf, LL), reps=10))
        break

    samples, tile_leaf, tile_off, _, count = ems.sort_and_tile(
        pos, d, w, leaf, L, S)
    params = ems.pack_params(sdmm, prep)
    used = int(tile_off[-1])
    record("phase 3 tiles", {"cap_tiles": tile_leaf.numel(), "used": used,
                             "slots in used tiles": used * ems.TILE,
                             "valid samples": int(count.sum())})
    src = open(os.path.join(CSRC, "em_suffstats.cu")).read()
    variants = [
        ("as it was", src),
        ("pass 2 compiled out", cut(src, "    // ---- pass 2",
                                    "    __syncthreads();\n  }\n\n  // Re",
                                    "")),
        ("pass 1 compiled out", cut(src, "    const bool dd_ok",
                                    "    s_p[tid] = px;", """
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s_gw[k * STRIDE + tid] = ws * (float)(k + 1) * 1e-3f;
      s_t3[k * STRIDE + tid] = dx;
      s_t4[k * STRIDE + tid] = dy;
    }
""")),
        ("chunks of padding skipped",
         sub(src, "    const bool dd_ok = (dx * dx + dy * dy + dz * dz) > "
             "0.0f;\n",
             "    const bool dd_ok = (dx * dx + dy * dy + dz * dz) > 0.0f;\n"
             "    if (!__syncthreads_or(dd_ok)) continue;\n")),
    ]
    partial = torch.empty((tile_leaf.numel(), ems.K, ems.NSTAT), device=dev)
    out = torch.empty((L, ems.K, ems.NSTAT), device=dev)
    ref = ems.suffstats(samples, tile_leaf, tile_off, params, L)
    for j, (name, s) in enumerate(variants):
        fn = build(f"em_before_{j}", s)[0].em_suffstats_launch
        fn.argtypes = ems._lib().argtypes

        def call():
            fn(samples.data_ptr(), samples.shape[1], tile_leaf.data_ptr(),
               tile_leaf.numel(), params.data_ptr(), tile_off.data_ptr(), L,
               partial.data_ptr(), out.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
        call()
        torch.cuda.synchronize()
        same = bool(torch.equal(out, ref))
        record(f"em_tile_kernel {name} ms", graph_ms(call))
        print(f"  equal to the kernel as it was: {same}", flush=True)


def sweep_scenes(dev, every=False):
    """chip_smoke.py phase 7's queries on the Cornell box and the
    996-triangle scene (and, with ``every``, the four-type box and the
    116-triangle box)."""
    from sdmm_tpu_torch.scene import scene as tscene
    from sdmm_tpu_torch.scene import shapes as tshapes
    from torch_parity import make_tiled_box

    sphere = [([0.0, 1.0, 0.3], 0.35, 16, 32)]
    scenes = [("cornell", lambda: cs.cornell_box(640, 360, dev))]
    if every:
        scenes += [("four-type", lambda: cs.cornell_box(640, 360, dev, True)),
                   ("116 triangles", lambda: make_tiled_box(
                       tscene, tshapes, 640, 360).build(device=dev))]
    scenes.append(("996 triangles", lambda: cs.cornell_box(
        640, 360, dev, spheres=sphere)))
    for name, make in scenes:
        scene, _ = make()
        ro, rd, tm, _ = cs.query_rays(scene, 262_144, 31, dev)
        yield name, ro, rd, tm, (scene.tri_v0, scene.tri_e1, scene.tri_e2)


def sweep_before(dev):
    src = open(os.path.join(CSRC, "mt_sweep.cu")).read()
    variants = [("as it was", src),
                ("reciprocal stubbed out",
                 sub(src, "const float inv_det = 1.0f / det;",
                     "const float inv_det = det;"))]
    libs = build_all([(f"mt_before_{j}", s, False)
                      for j, (_, s) in enumerate(variants)])
    record("mt_sweep SASS", sass_loops(libs[0][1], "mt_sweep_kernel"))
    for name, ro, rd, tm, tris in sweep_scenes(dev):
        if name == "cornell":
            record("mt_sweep pass shares, cornell", pass_shares(
                ro, rd, tm, *tris))
        want = isweep.mt_sweep_plain(ro, rd, tm, *tris)
        n, T = ro.shape[0], tris[0].shape[0]
        t = torch.empty(n, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        u, v = torch.empty_like(t), torch.empty_like(t)
        for (vname, _), (lib, _) in zip(variants, libs):
            fn = lib.mt_sweep_launch
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 \
                + [ctypes.c_void_p]

            def call():
                fn(ro.data_ptr(), rd.data_ptr(), tm.data_ptr(),
                   tris[0].data_ptr(), tris[1].data_ptr(),
                   tris[2].data_ptr(), t.data_ptr(), tri.data_ptr(),
                   u.data_ptr(), v.data_ptr(), n, T,
                   torch.cuda.current_stream().cuda_stream)
            call()
            torch.cuda.synchronize()
            eq = all(torch.equal(a, want[k]) for a, k in
                     ((t, "t"), (tri, "tri"), (u, "u"), (v, "v")))
            record(f"mt_sweep {vname}, {name} ms", graph_ms(call))
            print(f"  equal to the twin: {eq}", flush=True)


# --what after: one compact sorted copy of the packed rows (a gather kernel)
# read in order by the tile kernel.
SORTED_COPY = r"""
__global__ void em_sorted_copy_kernel(const float4* __restrict__ rows,
                                      const int* __restrict__ order,
                                      int n, float4* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t i = order[j];
  out[2 * j] = rows[2 * i];
  out[2 * j + 1] = rows[2 * i + 1];
}
}  // namespace
extern "C" int em_sorted_copy_launch(const float* rows, const int* order,
                                     int n, float* out, void* stream) {
  em_sorted_copy_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)rows, order, n, (float4*)out);
  return (int)cudaGetLastError();
}
namespace {
"""
IN_ORDER = "const size_t i = __ldg(order + base + tid);"

def em_after(dev):
    sdmm, prep, pos, d, w, leaf, L = em_inputs(dev)
    S = pos.shape[0]
    params = ems.pack_params(sdmm, prep)
    record("phase 3 e_step wrapper ms (events)", [cs.time_ms(
        lambda: ems.e_step(sdmm, prep, pos, d, w, leaf, L), reps=20)
        for _ in range(2)])
    record("phase 3 sort_and_tile ms (events)", [cs.time_ms(
        lambda: ems.sort_and_tile(pos, d, w, leaf, L), reps=20)
        for _ in range(2)])
    record("phase 3 pack_params ms (events)", [cs.time_ms(
        lambda: ems.pack_params(sdmm, prep), reps=20) for _ in range(2)])
    profile_ops("phase 3 e_step wrapper",
                lambda: ems.e_step(sdmm, prep, pos, d, w, leaf, L))
    print(f"kernel_info: {ems.kernel_info()}", flush=True)
    sd, pr, p, dd, ww, lf, LL = trainer_batches(dev)[1]
    profile_ops("trainer call 1 e_step wrapper",
                lambda: ems.e_step(sd, pr, p, dd, ww, lf, LL))
    record("trainer call 1 e_step wrapper ms (events)", [cs.time_ms(
        lambda: ems.e_step(sd, pr, p, dd, ww, lf, LL), reps=10)
        for _ in range(2)])

    src = open(os.path.join(CSRC, "em_suffstats.cu")).read()
    vector = sub(sub(src, "  __shared__ float par[K * PCOLS];",
                     "  __shared__ __align__(16) float par[K * PCOLS];"),
                 "        const float* p = par + k * PCOLS;\n", """
        float p[PCOLS];
#pragma unroll
        for (int c = 0; c < PCOLS / 4; ++c) {
          const float4 v =
              reinterpret_cast<const float4*>(par + k * PCOLS)[c];
          p[4 * c] = v.x, p[4 * c + 1] = v.y, p[4 * c + 2] = v.z,
          p[4 * c + 3] = v.w;
        }
""")
    in_order = sub(src, IN_ORDER, "const size_t i = base + tid;")
    variants = [
        ("as it is", src, False),
        ("a launch bound of 8 blocks (64 registers)",
         sub(src, "__launch_bounds__(CH)", "__launch_bounds__(CH, 8)"),
         False),
        ("parameters read in 16-byte words", vector, False),
        ("dead components not skipped",
         sub(sub(src, "if (p[0] != 0.0f) {", "{"), "if (kc_live) {", "{"),
         False),
        ("rows read in the unsorted order (wrong sums, timing only)",
         in_order, False),
        ("compact sorted copy of the rows",
         sub(in_order, "struct Sample {", SORTED_COPY + "struct Sample {"),
         True),
    ]
    built = build_all([(f"em_after_{j}", vsrc, True)
                       for j, (_, vsrc, _) in enumerate(variants)])
    libs = [lib for lib, _ in built]
    for j in (0, 2):
        record(f"em SASS, {variants[j][0]}",
               sass_loops(built[j][1], "em_tile_kernel"))
    ref = None
    for tile in (256, 512, 1024, 2048):
        rows, order, ls, toff, _ = ems.sort_and_tile(pos, d, w, leaf, L,
                                                     tile)
        n_tiles = ems.cap_tiles(S, L, tile)
        partial = torch.empty(n_tiles * (ems.K * ems.NSTAT + 1), device=dev)
        outs = [torch.empty(x, device=dev) for x in (
            (L, ems.K), (L, ems.K, 5), (L, ems.K, 5, 5), (L,))]
        copy = torch.empty_like(rows)
        for j, (name, _, is_copy) in enumerate(variants):
            if tile != ems.TILE and j > 0:
                continue
            lib = libs[j]
            fn = lib.em_stats_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p] * 7
            if is_copy:
                gather = lib.em_sorted_copy_launch
                gather.argtypes = [ctypes.c_void_p] * 2 + [
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

            def call():
                st = torch.cuda.current_stream().cuda_stream
                src_ptr = rows.data_ptr()
                if is_copy:
                    gather(rows.data_ptr(), order.data_ptr(), S,
                           copy.data_ptr(), st)
                    src_ptr = copy.data_ptr()
                fn(src_ptr, order.data_ptr(), ls.data_ptr(), toff.data_ptr(),
                   L, tile, n_tiles, params.data_ptr(), partial.data_ptr(),
                   *(o.data_ptr() for o in outs), st)
            call()
            torch.cuda.synchronize()
            got = [o.clone() for o in outs]
            if ref is None:
                ref = got
            err = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                      for a, b in zip(got, ref))
            record(f"em_tile + reduce, {name}, tile {tile} ms",
                   graph_ms(call))
            print(f"  max relative difference to the first: "
                  f"{err:.3g}", flush=True)


def forced(src, rays, defer):
    """The sweep with every scene on mt_sweep_kernel<rays, defer>."""
    return cut(src, "  int rays;\n  kernel_for(T, &rays);",
               "  return (int)cudaGetLastError();\n}\n", f"""
  const int blocks = (n + THREADS * {rays} - 1) / (THREADS * {rays});
  mt_sweep_kernel<{rays}, {defer}><<<blocks, THREADS, shared_bytes(T),
                                    (cudaStream_t)stream>>>(
      ro, rd, t_max, v0, e1, e2, t, tri, u, v, n, T);
""")


def sweep_after(dev):
    src = open(os.path.join(CSRC, "mt_sweep.cu")).read()
    variants = [("as it is", src)]
    for defer in ("false", "true"):
        for r in (1, 2, 4):
            variants.append((f"{r} rays a thread, vote {defer}",
                             forced(src, r, defer)))
    libs = build_all([(f"mt_after_{j}", s, False)
                      for j, (_, s) in enumerate(variants)])
    record("mt_sweep SASS", sass_loops(libs[0][1], "mt_sweep_kernel"))
    for name, ro, rd, tm, tris in sweep_scenes(dev, every=True):
        record(f"mt_sweep pass shares, {name}", pass_shares(
            ro, rd, tm, *tris))
        print(f"kernel_info [{name}]: "
              f"{isweep.kernel_info(tris[0].shape[0])}", flush=True)
        want = isweep.mt_sweep_plain(ro, rd, tm, *tris)
        n, T = ro.shape[0], tris[0].shape[0]
        t = torch.empty(n, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        u, v = torch.empty_like(t), torch.empty_like(t)
        for (vname, _), (lib, _) in zip(variants, libs):
            fn = lib.mt_sweep_launch
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 \
                + [ctypes.c_void_p]

            def call():
                fn(ro.data_ptr(), rd.data_ptr(), tm.data_ptr(),
                   tris[0].data_ptr(), tris[1].data_ptr(),
                   tris[2].data_ptr(), t.data_ptr(), tri.data_ptr(),
                   u.data_ptr(), v.data_ptr(), n, T,
                   torch.cuda.current_stream().cuda_stream)
            call()
            torch.cuda.synchronize()
            eq = all(torch.equal(a, want[k]) for a, k in
                     ((t, "t"), (tri, "tri"), (u, "u"), (v, "v")))
            record(f"mt_sweep {vname}, {name} ms", graph_ms(call))
            print(f"  equal to the twin: {eq}", flush=True)


def bits_equal(a, b):
    """Equal bit for bit, NaN included."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def sort_ab(dev):
    src = open(os.path.join(CSRC, "em_suffstats.cu")).read()
    # The keys kernel writes int16 keys, and em_sort_launch stops before
    # the scatter (the counts, leaf_start and tile_off stay the kernels').
    src = sub(src, "int* __restrict__ key, int* __restrict__ hist,",
              "short* __restrict__ key, int* __restrict__ hist,")
    src = sub(src, "key[i] = ok ? (int)l : n_leaves;",
              "key[i] = (short)(ok ? (int)l : n_leaves);")
    src = sub(src, "S, n_leaves, key, hist,",
              "S, n_leaves, (short*)key, hist,")
    src = cut(src, "  if (n_chunks > 0) {\n    const int smem =",
              "  return (int)err;\n}\n\n// The statistics", "")
    fn = build("em_torch_sort", src)[0].em_sort_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int

    def e_step_torch_sort(sdmm, prep, pos, d, w, leaf, L):
        s, i32 = pos.shape[0], torch.int32
        key = torch.empty(s, dtype=torch.int16, device=dev)
        hist = torch.empty(-(-s // ems.SORT_CHUNK) * L, dtype=i32, device=dev)
        rows = torch.empty((s, 8), device=dev)
        count = torch.empty(L, dtype=i32, device=dev)
        ls = torch.empty(L + 1, dtype=i32, device=dev)
        toff = torch.empty(L + 1, dtype=i32, device=dev)
        _build.check(fn(
            pos.data_ptr(), d.data_ptr(), w.data_ptr(), leaf.data_ptr(),
            leaf.element_size(), s, L, ems.TILE, key.data_ptr(),
            hist.data_ptr(), rows.data_ptr(), count.data_ptr(),
            ls.data_ptr(), toff.data_ptr(), 0,
            torch.cuda.current_stream(dev).cuda_stream), "em_sort")
        order = torch.sort(key, stable=True).indices.to(i32)
        return (*ems.suffstats(rows, order, ls, toff,
                               ems.pack_params(sdmm, prep), L), count)

    sdmm, prep, pos, d, w, leaf, L = em_inputs(dev)
    sd, pr, p, dd, ww, lf, LL = trainer_batches(dev)[1]
    cases = (("phase 3", (sdmm, prep, pos, d, w, leaf, L), 20),
             ("trainer call 1", (sd, pr, p, dd, ww, lf, LL), 20))
    designs = (("counting sort", ems.e_step),
               ("torch.sort int16", e_step_torch_sort))
    for name, args, reps in cases:
        a, b = (f(*args) for _, f in designs)
        again = designs[0][1](*args)
        torch.cuda.synchronize()
        record(f"{name}: the two designs bit-equal (NaN payloads too)",
               all(bits_equal(x, y) for x, y in zip(a, b)))
        record(f"{name}: the counting sort bit-equal across two calls",
               all(bits_equal(x, y) for x, y in zip(a, again)))
        record(f"{name}: NaN in each output of the counting sort",
               [int(torch.isnan(x).sum()) if x.is_floating_point() else 0
                for x in a])
        record(f"{name}: outputs torch.equal, ignoring NaN",
               [bool(torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0)))
                for x, y in zip(a, b)])
        times = {k: [] for k, _ in designs}
        for turn in range(8):
            first = turn % 4 in (0, 3)  # ABBA ABBA
            for k, f in (designs if first else designs[::-1]):
                times[k].append([cs.time_ms(lambda: f(*args), reps=reps)
                                 for _ in range(3)])
        for k, v in times.items():
            flat = [x for turn in v for x in turn]
            record(f"{name}: e_step wrapper ms, {k} (8 turns of 3)", v)
            record(f"{name}: {k} mean / min / max ms",
                   [sum(flat) / len(flat), min(flat), max(flat)])
        diffs = [sum(x) / 3 - sum(y) / 3 for x, y in
                 zip(times["torch.sort int16"], times["counting sort"])]
        record(f"{name}: torch.sort minus counting sort, per turn ms", diffs)


def pool_sweep(dev):
    """The sweep variants on render_pool's captured queries."""
    from sdmm_tpu_torch.render import intersect as tisect
    from sdmm_tpu_torch.render.wavefront import render_pool

    src = open(os.path.join(CSRC, "mt_sweep.cu")).read()
    variants = [(f"{r} rays a thread, vote {defer}", forced(src, r, defer))
                for r, defer in ((1, "false"), (4, "false"), (1, "true"),
                                 (4, "true"))]
    libs = build_all([(f"mt_pool_{j}", s, False)
                      for j, (_, s) in enumerate(variants)])
    for sph in (None, (3, 8), (4, 12), (6, 12), (8, 16), (12, 24), (16, 32)):
        spheres = [] if sph is None else [([0.0, 1.0, 0.3], 0.35, *sph)]
        scene, cfg = cs.cornell_box(640, 360, dev, spheres=spheres)
        tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
        T = tris[0].shape[0]
        calls, real = [], tisect.mt_sweep

        def spy(ro, rd, tm, *a):
            calls.append((ro.clone(), rd.clone(), tm.clone()))
            return real(ro, rd, tm, *a)

        tisect.mt_sweep = spy
        try:
            render_pool(scene, torch.Generator(device=dev).manual_seed(13),
                        n_lanes=1 << 18, spp=2, width=640, height=360,
                        max_depth=10, rr_depth=10, bsdf_types=cfg.bsdf_types,
                        device=dev)
        finally:
            tisect.mt_sweep = real
        queries = sum(c[0].shape[0] for c in calls)
        wants = [isweep.mt_sweep_plain(*c, *tris) for c in calls]
        outs = []
        for c in calls:
            n = c[0].shape[0]
            outs.append((torch.empty(n, device=dev),
                         torch.empty(n, dtype=torch.int32, device=dev),
                         torch.empty(n, device=dev),
                         torch.empty(n, device=dev)))
        res = {"calls": len(calls), "queries": queries}
        for (vname, _), (lib, _) in zip(variants, libs):
            fn = lib.mt_sweep_launch
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 \
                + [ctypes.c_void_p]

            def run():
                st = torch.cuda.current_stream().cuda_stream
                for (ro, rd, tm), (t, tri, u, v) in zip(calls, outs):
                    fn(ro.data_ptr(), rd.data_ptr(), tm.data_ptr(),
                       tris[0].data_ptr(), tris[1].data_ptr(),
                       tris[2].data_ptr(), t.data_ptr(), tri.data_ptr(),
                       u.data_ptr(), v.data_ptr(), ro.shape[0], T, st)
            run()
            torch.cuda.synchronize()
            eq = all(torch.equal(a, w[k]) for o, w in zip(outs, wants)
                     for a, k in zip(o, ("t", "tri", "u", "v")))
            res[vname] = {"ms": [cs.time_ms(run, reps=1, graph=True)
                                 for _ in range(2)], "equal": eq}
        record(f"render_pool queries, {T} triangles", res)


def wrappers(dev):
    sdmm, prep, pos, d, w, leaf, L = em_inputs(dev)
    record("phase 3 e_step wrapper ms (events)", [cs.time_ms(
        lambda: ems.e_step(sdmm, prep, pos, d, w, leaf, L), reps=20)
        for _ in range(3)])
    for name, ro, rd, tm, tris in sweep_scenes(dev):
        record(f"mt_sweep wrapper, {name} ms",
               graph_ms(lambda: isweep.mt_sweep(ro, rd, tm, *tris)))


def main():
    if not torch.cuda.is_available():
        print("em_sweep_variants: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)
    record("card", cs.nvidia_smi_line())
    if ARGS.what == "wrappers":
        wrappers(dev)
    elif ARGS.what == "sort":
        sort_ab(dev)
    elif ARGS.what == "pool":
        pool_sweep(dev)
    elif ARGS.what == "before":
        em_before(dev)
        sweep_before(dev)
    else:
        em_after(dev)
        sweep_after(dev)
    print(json.dumps(RES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
