"""Drive the PyTorch/CUDA port on one GPU and hold every kernel against its
plain PyTorch twin.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit, torch/CUDA versions; build every CUDA
     kernel from csrc/ (one nvcc per source, all started together).
  2. guided_sample: kernel vs plain twin at the main path's shapes (the
     packed float32 table of 2048 leaves, pack_sample_table, checked to
     hold the rows bit for bit; 131,072 lanes), on uniformly random leaves
     and with every lane on one leaf; times of both by CUDA-graph replays;
     the kernel's registers, spills and resident blocks an SM.
  3. EM sufficient statistics: the E-step pipeline (keys, packed rows and
     a stable counting sort by leaf, scans, tile and reduction kernels)
     vs the plain twin at
     2048 leaves and 2.8 M samples, and vs a float64 evaluation; its sort
     and work list equal to the twin's; two calls bit-equal. Times by CUDA
     events of the whole e_step wrapper (row 2's ms) and of sort_and_tile,
     by CUDA-graph replays of the two statistics kernels alone; the
     registers, spills and resident blocks an SM of both.
  4. the fused guided bounce: trace and shade kernels vs their plain twins
     at 131,072 lanes on the Cornell box and on the four-type box (every
     in-kernel BSDF type), shade on the packed bf16 table of 2048 leaves
     (pack_shade_table, checked to hold the twin's bf16 rows bit for bit);
     the twin's hit buffer feeds both shade calls; trace also on the
     Cornell box plus one sphere (1,024 triangle columns, past its
     shared-memory staging budget). Kernel and twin may
     disagree on 1e-4 of all lanes and on 1e-3 of each BSDF type's lanes.
     Times by CUDA events on the Cornell box, shade on uniformly random
     leaves and with every lane on one leaf; the registers, spills and
     resident blocks an SM of both kernels.
  5. the main path: SDMMTrainer(...).run on a programmatic Cornell box at
     640x360, max depth 10, TrainerConfig() defaults with tail_chunk_spp=16,
     64 spp (4 training iterations with EM on the eager pool, then the
     frozen tail in 3 chunks on the fused trace + shade pool), with every
     kernel's launch count read around the run; the image is checked
     against an unguided render (bsdf_fraction=1.0) at equal spp through
     the eager pool, and the fused pool against the eager guided pool at
     equal spp on the same guide state.
  6. the unguided path row with NEE. First the step and bounce kernels
     against their twins at 237,568 lanes (29 tiles of 8192) after four
     warm steps, so that lanes are mid-path, on the Cornell box, the
     four-type box, a box past 96 triangles (2048-lane tiles) and the
     Cornell box plus one sphere (1,024 triangle columns, past the kernels'
     shared-memory staging budget), within phase 4's limits and shade's
     state tolerance, film and splat within rtol 1e-5, meta equal; step in
     its Philox mode (and its host-uniform mode on the twin's Philox bits,
     which must give the same result bit for bit); the NEE candidate share,
     and the registers, spills and resident blocks an SM of both kernels
     on each table; times by CUDA-graph replays on the Cornell box. Then
     the path row itself, with the step and bounce launch counts read
     around it: render_wavefront on the Cornell box at 640x360, depth 10,
     64 spp (sorted2, pilot 8: the step kernel) and 2 spp (striped: the bounce
     kernel); each spends exactly its budget on every pixel, takes the pool
     its spp names, the sorted2 image mean agrees with the eager render_pool
     at 64 spp within 2%, and phase 5's guided image mean with the path
     row's within 5%. Last, path vertices/s at bench.py's configuration
     (640x360, 192 spp, depth 10).
  7. scenes of any size. The dense sweep mt_sweep against its twin on
     262,144 queries (camera rays at 640x360, secondary rays from their
     hits in random directions, occlusion queries toward emitter samples
     with a finite t_max) on the Cornell box, the four-type box, the
     116-triangle box and the Cornell box plus one 16x32 sphere (996
     triangles): hit ids, valid, t, u and v equal on every query; times
     by CUDA-graph replays on the Cornell box and the 996-triangle scene,
     with the registers, spills and resident blocks an SM at each. The
     cluster cull clas_cull against its twin on the Cornell box plus one
     default sphere (4,004 triangles, 131,072 queries) and on the large
     scene (the Cornell box plus 32 default spheres: 127,012 triangles,
     32,768 queries): hit ids and valid equal on >= 0.9999 of the queries,
     the others printed, t, u and v within rtol 1e-6 where they agree; its
     any-hit form (occluded) equal to the twin's on >= 0.9999 of the
     occlusion queries. Times of the whole wrappers by CUDA-graph replays
     (the query order, also timed on its own, and the kernel): cull at
     131,072 and 262,144 queries on the large scene, beside the kernel's
     own count of Woop tests a query and the least work the bound admits
     (Woop tests, and slab tests of the tree nodes entered before the
     hit); any_hit on the occlusion queries of the 131,072. Then the large
     scene's path at 640x360,
     depth 10: render_wavefront at 16 spp (the eager pool, exactly 16
     samples on every pixel, clas_cull launched for intersect and occluded
     on every step) and SDMMTrainer(...).run at 32 spp with
     tail_chunk_spp=8 (2 training iterations, 3 frozen ones on the eager
     guided pool, guided_sample's launches read around it): the guided
     image mean within 5% of the path row's, the valid-conditional share
     of the frozen tail > 0.5.
  8. the port's own entry point. The Cornell box (cornell.xml: every
     toWorld and the camera a 17-digit matrix, hdrfilm 640x360, the
     independent sampler at 64 spp, maxDepth 10, the area emitter on the
     light) and the large scene (large.xml: the box plus an obj shape,
     spheres.obj, the 32 spheres of large_spheres with per-corner 17-digit
     v and vn) are written to a temporary directory, loaded by load_scene
     (the OBJ through the native parser) and built on the card; every
     SceneData field must equal the programmatic scene's (36 and 127,012
     triangles). Then cli.main renders cornell.xml with --integrator sdmm
     and gt at 64 spp and large.xml with gt at 4 spp, every kernel's
     launches read around each call: each EXR must hold the rendered film
     bit for bit, stats.json the trainer's keys (sdmm) or the path schema,
     the sdmm image mean be within 5% of the gt image's, the checkpoint
     load, and guided_sample, the E-step, trace, shade and mt_sweep launch
     in the sdmm run, step in the Cornell gt run, clas_cull in the large
     one. Last, python -m sdmm_tpu_torch render (gt, 4 spp) and compare (the
     two Cornell images) each run once as a subprocess. One line prints the
     load and parse seconds, each call's wall seconds and launches, and
     the card's name and power limit.
  9. materials and lights on the card. write_features_xml writes scene A,
     features.xml (640x360, depth 10: the Cornell rectangles and blocks, a
     small panel and a default sphere, 4,006 triangles, so that every
     eager ray goes through clas_cull; every BSDF type a scene file names,
     4-6, 8-15 and 17, with the blendbsdf, mask, coating and roughcoating
     containers; a PNG bitmap, written with zlib here, and every
     procedural texture; the ceiling light and an EXR env map), and scene
     B, features_lit.xml (A with bump maps from a PNG height map on the
     sphere and the floor, a point, a spot and a directional light, and
     sunsky in place of the env map), to a temporary directory. Both are
     loaded and built on the card and must fail fused_supported and
     guided_fused_supported. cli.main renders A with sdmm and gt at 64 spp
     and B with gt at 16 spp, every kernel's launches read around each
     call: the path row takes the eager pool, the frozen tail never the
     fused guided pool; trace, shade, step and bounce launch 0 times,
     guided_sample, the E-step and clas_cull launch in the sdmm call, and
     clas_cull's closest-hit and any-hit forms in both gt calls. A's sdmm
     image mean must be within 5% of its gt mean, every image finite, and
     B's gt render at 64x36, 16 spp, on the card agree with the same
     render on the CPU (a process of its own, started at the phase's top
     so that it overlaps the card's renders) within 4 standard errors of
     the means, from the films' sqr and weight. One "features:" JSON line
     prints the load and build seconds, each call's wall and launches and
     the card's name and power limit.
 10. participating media, subsurface scattering, samplers and rfilters on
     the card. write_media_xml writes scene M, media.xml (640x360, depth
     10: the Cornell box in a homogeneous fog, a default sphere of
     dielectric holding a 64³ .vol density grid, the short block with a
     skin1 dipole; 4,004 triangles, so clas_cull), and its stripped twin.
     M must fail both fused gates. cli.main renders M with gt at 16 spp
     (renderer.render) and sdmm at 32 spp (the media guided pool), the
     stripped scene with gt, every sampler and rfilter on the Cornell box
     at 8 spp (mt_sweep), and M at 64x36 on the card and in a CPU process
     (started at the phase's top); SDMMTrainer(pooled_training=False)
     trains two iterations on M through trace_wave_guided. The sdmm and
     scan-trained means must lie within 5% of gt's, the stripped mean more
     than 10% away, each sampler's and rfilter's box mean within 3% of the
     independent/box one, the card and CPU means within 4 standard errors;
     guided_sample, the E-step and clas_cull must launch on M, mt_sweep on
     the box, trace, shade, step and bounce never on M. One "media:" JSON
     line prints each call's wall seconds and launches.
 11. the guiding extras on the card, on phase 8's cornell.xml: cli.main gt
     at 64 spp; (a) --integrator ppg at 64 spp (PPGTrainer, mt_sweep on
     every bounce; each iteration's spp, seconds and leaves printed); (b)
     sdmm at 64 spp with -D reservoirCapacity=2000000 -D
     optimizeAsync=true; (c) sdmm to 52 spp with --checkpoint, --resume to
     64, against two uninterrupted 64-spp runs; (d) SDMMTrainer with
     sample_product=True and tail_chunk_spp=16 on the four-type box at 64
     spp against render_wavefront gt (the learned table's fit seconds
     printed); (e) data_init at 32 spp on the box. Checks: (a), (b), (d),
     (e) within 5% of gt; mt_sweep in (a), guided_sample and the E-step in
     (b); (c) every iteration's image and the final one within rtol 1e-5 /
     atol 1e-6 of the first uninterrupted run, or of the two runs' own
     difference; (d) product lanes > 0, guided_sample never launched, the
     E-step launched, the fused guided pool never taken. One
     "guiding_extras:" JSON line.
 12. the rest of scene loading and the classic integrators on the card
     (phase_geometry_classic): scene G (heightfield, hair, Irawan cloth,
     a keyframed cube; clas_cull) through cli.main with gt, sdmm, direct,
     ao, field, multichannel, adaptive and motion, Irawan's card values
     against the CPU twin's, and a COLLADA import. One
     "geometry_classic:" JSON line.
 13. the light-path integrators on the card (phase_light_paths): ptracer,
     vpl, bdpt, photonmapper and sppm through cli.main at 640x360 on the
     Cornell box (mt_sweep) against gt, bdpt on the box with a mirror and
     a glass sphere and ptracer and photonmapper on the large scene
     (clas_cull), and gather_radiance on the card against the CPU. One
     "light_paths:" JSON line.
 14. the Metropolis integrators and the irradiance cache on the card
     (phase_mcmc_irrcache): pssmlt, erpt, mlt and irrcache through cli.main
     at 640x360 on the Cornell box (mt_sweep) against gt, mlt on the box
     with a mirror and a glass sphere (clas_cull), mlt on the box lit by a
     constant environment alone (the fallback to pssmlt), pssmlt on the
     large scene (clas_cull), and eval_path and interpolate on the card
     against the CPU. One "mcmc_irrcache:" JSON line.
 15. the schedulers, the K != 16 route and the intersectors no entry
     point reaches by default (phase_schedulers): (a) SDMMTrainer with
     n_components = 8 on the Cornell box at 640x360, 16 spp, within 5% of
     render_wavefront at 64 spp; guided_sample and the E-step kernels 0
     launches by design, mt_sweep launched, 0 NaN stats_w; (b) the four
     bounce pools (fused, blocked, sorted, shuffled) at 8 spp, each within
     POOL_SE joint standard errors (and POOL_REL) of
     render_pool_fused_sorted2 at 64 spp, with row 6's launches a pool;
     (c) the guided sorted2 and striped pools frozen at a K = 16 model
     trained to 16 spp, each so near render_pool_guided_fused at 16 spp,
     with rows 3-4's launches; (d) on the large scene, 2^18
     queries through bvh.traverse, the round loop (render/clas.intersect)
     and clas_cull (Woop's arithmetic, where the other two run
     Möller–Trumbore's): hit ids and valid equal but on equal-distance
     ties and grazes within float32 rounding of an edge or a triangle's
     plane (counted by _hit_classes; the grazes no more than the measured
     ROUTE_GRAZES), occluded equal but where the closest hits within t_max
     differ so, each route's ms, and the native BVH build's seconds; (e)
     the statistics report, which the process then does not print again
     at exit. One
     "schedulers:" JSON line and the phase's wall.
The SDMM_TPU_* switches are cleared at the start: every phase takes the
default routes.
Phases 5, 7, 10 and 11 run their training under EmCensus, which counts the
E-step's valid samples with a non-finite posterior by cause and the NaN
entries of its stats_w; any NaN fails the run.
Phases 5 and 6 also read mt_sweep's launches: the training iterations and
the eager render_pool intersect through it, and its launch count is the sum
of both. guided_sample's launch count is the sum of phases 5 and 7.
Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last the {"ok": true, "device": ...} line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# tests/torch_parity.py holds the lane-wave generator the CPU and gpu tests
# use too; it imports only the port, numpy and torch.
sys.path.insert(1, os.path.join(ROOT, "tests"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
# operations/s outside the tensor cores (an FMA counts as two operations).
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# FP32 operations per lane of guided_sample (each add, multiply, compare,
# select and special function counted once, from csrc/guided_sample.cu):
# per component 43 (pass 1: marginal, log weight, clamped tangent mean)
# + 5 (pass 2) + 11 (pass 3: exp range, CDF, selection) + 2 (selected
# tangent mean) + 176 (pass 4: conditional mean, its frame and two log-map
# pdfs); plus ~100 per lane for the selected frame and the Box-Muller
# sample.
GUIDED_OPS_PER_LANE = 16 * (43 + 5 + 11 + 2 + 176) + 100
# FP32 operations per valid sample and live component of the E-step
# kernel, the same way: 102 (log map with the polynomial arccos, 5x5
# triangular solve, Gaussian pdf, posterior) + 4 (normalisation, floor,
# weight) + 41 (the 21 accumulations).
EM_OPS_PER_COMPONENT = 102 + 4 + 41
# FP32 operations of trace, the same way (csrc/bounce_math.cuh woop_tri and
# csrc/guided_step.cu trace_kernel): 60 per lane and triangle (the Woop
# transform, the barycentric tests, the closest-hit update), 80 per lane
# after the sweep (shading-normal interpolation and normalisation, hit
# position, emission and escape).
TRACE_OPS_PER_TRI = 60
TRACE_OPS_PER_LANE = 80
# shade: guided_tile's work as guided_sample's, plus 200 per lane (frame,
# disk sample, world directions, the MIS combine, roulette, splat and
# state), plus the BSDF branch of the lane's type: 60 for a conductor
# (three Fresnel channels), 45 for a dielectric, 170 for a rough conductor
# (VNDF sample, GGX eval, three Fresnel channels).
SHADE_OPS_PER_LANE = GUIDED_OPS_PER_LANE + 200
SHADE_OPS_BY_TYPE = {1: 60, 2: 45, 3: 170}
# The unguided bounce core (csrc/bounce.cu bounce_core), the same way: 60
# per lane and triangle in each sweep (the occlusion sweep only for NEE
# candidates), ~500 per lane around the sweeps (NEE sample and BSDF value,
# the BSDF sample, roulette, splat, next state), ~60 for the step kernel's
# regeneration and camera ray; Philox4x32-10's ~320 integer operations per
# lane (3 blocks of 10 rounds) are counted at the FP32 rate.
PATH_OPS_PER_TRI = 60
PATH_OPS_PER_LANE = 500
STEP_OPS_PER_LANE = 60
PHILOX_OPS_PER_LANE = 320
# The intersection kernels, the same way: csrc/mt_sweep.cu 61 per query and
# triangle (cross products, determinant and reciprocal, u, v, t, six tests,
# the update); csrc/clas_cull.cu ~30 per slab test of a tree node's box and
# ~56 per Woop test (bounce_math.cuh woop_tri, three range tests, the
# update).
MT_OPS_PER_TRI = 61
SLAB_OPS = 30
WOOP_OPS = 56
# Bytes per query of both: ro, rd and t_max in, t, tri, u and v out.
QUERY_BYTES = 28 + 16
# trace and shade against their twins: the share of lanes on which they may
# disagree, over all lanes and within each group of lanes (each BSDF type the
# twin's hit buffer names, and the lanes off any surface), so that a fault in
# one branch of a rare type cannot hide among the diffuse lanes.
MAX_OFF_SHARE = 1e-4
MAX_OFF_SHARE_GROUP = 1e-3


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def agreement(name, ok, groups):
    """Print and check the share of lanes where kernel and twin agree
    (``ok`` [N] bool), overall and within each of ``groups``."""
    shares = {g: float(ok[m].float().mean()) for g, m in groups.items()
              if bool(m.any())}
    overall = float(ok.float().mean())
    print(f"  {name}: equal on {overall:.6f} of the lanes; by group "
          + ", ".join(f"{g} {v:.6f} of {int(groups[g].sum())}"
                      for g, v in shares.items()), flush=True)
    check(overall >= 1.0 - MAX_OFF_SHARE, f"{name}: kernel and twin disagree")
    for g, v in shares.items():
        check(v >= 1.0 - MAX_OFF_SHARE_GROUP,
              f"{name}: kernel and twin disagree on {g}")
    return overall


def print_kernel_info(info, where=""):
    """Print the registers, spills and occupancy of ``kernel_info()``."""
    for name, inf in info.items():
        print(f"{name}{where}: {inf['registers']} registers, "
              f"{inf['spill_bytes']} bytes of local memory, "
              f"{inf['shared_bytes']} bytes of static shared memory, "
              f"{inf['blocks_per_sm']} blocks an SM", flush=True)


def time_ms(fn, reps=20, graph=False, warm=3):
    """Median milliseconds of ``fn`` on the current stream after ``warm``
    calls. ``graph`` captures ``reps`` calls in one CUDA graph and times
    whole replays, so host launch overhead stays out of a microsecond
    kernel's time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        times = []
        for _ in range(5):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / reps)
        del g
        return statistics.median(times)
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def mixture_state(L, seed, dev):
    """Anisotropic, unequal-weight mixtures with dead components, from a
    numpy seed (the state recipe of the parity tests), prepared on dev."""
    from sdmm_tpu_torch.guiding import init as init_mod
    from sdmm_tpu_torch.guiding import mixture as mix

    rs = np.random.RandomState(seed)
    lo = torch.zeros((L, 3), device=dev)
    hi = torch.as_tensor((np.ones((L, 3)) * rs.rand(L, 1) + 0.5)
                         .astype(np.float32), device=dev)
    base = init_mod.init_leaf_params(
        torch.Generator(device=dev).manual_seed(seed), lo, hi, 16)
    w = rs.dirichlet(np.ones(16), size=L)
    w = np.where(rs.rand(L, 16) < 0.2, 0.0, w)
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
    jit = rs.randn(L, 16, 5, 5).astype(np.float32) * 0.01
    jit = torch.as_tensor(0.5 * (jit + np.swapaxes(jit, -1, -2)), device=dev)
    sdmm = mix.SDMM(weight=torch.as_tensor(w.astype(np.float32), device=dev),
                    mean=base.mean, cov=base.cov + jit)
    return sdmm, mix.prepare(sdmm), torch.as_tensor(rs.rand(L) < 0.9,
                                                    device=dev)


class EmCensus:
    """While active, wraps ops.em_suffstats.e_step: after every E-step on
    the card it counts the non-finite stats_w entries (components) and the
    leaves that hold one, and sorts the valid samples whose posterior is not
    finite by cause, from the plain math: a non-finite position or
    direction, a component pdf that overflows, or a posterior total so
    small that its reciprocal overflows (the cause on the card: before the
    kernel dropped such posteriors, 0 * inf put a NaN in every live
    component of the sample's leaf). The kernel skips a component of
    weight 0, and so does the count. It also counts the valid samples whose
    tangent coordinates are not finite."""

    KEYS = ("calls", "valid_samples", "nonfinite_posterior",
            "cause_nonfinite_pos_dir", "cause_pdf_overflow",
            "cause_total_underflow", "cause_other", "nonfinite_tangent",
            "nan_stats_w", "leaves_lost")

    def __init__(self):
        self.totals = dict.fromkeys(self.KEYS, 0)

    def __enter__(self):
        from sdmm_tpu_torch.ops import em_suffstats as ems

        self._ems, self._real = ems, ems.e_step

        def counted(sdmm, prep, pos, d, weight, leaf, n_leaves, **kw):
            out = self._real(sdmm, prep, pos, d, weight, leaf, n_leaves,
                             **kw)
            if pos.device.type == "cuda":
                self._count(sdmm, prep, pos, d, weight, leaf, n_leaves,
                            out[0])
            return out

        ems.e_step = counted
        return self

    def __exit__(self, *exc):
        self._ems.e_step = self._real

    def _count(self, sdmm, prep, pos, d, weight, leaf, n_leaves, stats_w):
        from sdmm_tpu_torch.guiding import mixture as mix

        t = self.totals
        t["calls"] += 1
        bad_w = ~torch.isfinite(stats_w)
        t["nan_stats_w"] += int(bad_w.sum())
        t["leaves_lost"] += int(bad_w.any(-1).sum())
        valid = torch.isfinite(weight) & (weight >= 0) & (leaf >= 0) \
            & (leaf < n_leaves)
        idx = torch.nonzero(valid).squeeze(1)
        t["valid_samples"] += int(idx.numel())
        for sl in range(0, idx.numel(), 1 << 18):
            i = idx[sl:sl + (1 << 18)]
            cl = leaf[i].long()
            p, dd = pos[i], d[i]
            pdf, _, t_abs = mix.posterior_and_log(
                sdmm.weight[cl], sdmm.mean[cl], prep.inv_chol[cl],
                prep.inv_det_chol[cl], prep.rot[cl], p, dd)
            w = sdmm.weight[cl]
            live = w != 0
            total = torch.where(live, w * pdf, 0.0).sum(-1)
            under = (total > 0) & torch.isfinite(total) \
                & ~torch.isfinite(1.0 / total)
            bad = ~torch.isfinite(total) | under
            bad_in = ~(torch.isfinite(p).all(-1) & torch.isfinite(dd).all(-1))
            over = (live & torch.isinf(pdf)).any(-1) & ~bad_in
            t["nonfinite_posterior"] += int(bad.sum())
            t["cause_nonfinite_pos_dir"] += int((bad & bad_in).sum())
            t["cause_pdf_overflow"] += int((bad & over).sum())
            t["cause_total_underflow"] += int((under & ~bad_in).sum())
            t["cause_other"] += int((bad & ~bad_in & ~over & ~under).sum())
            t["nonfinite_tangent"] += int(
                (~torch.isfinite(t_abs[..., 3:]) & live[..., None])
                .any(-1).any(-1).sum())


def phase_guided(dev):
    from sdmm_tpu_torch.ops import guided_sample as gso

    L, N = 2048, 131_072
    sdmm, prep, init = mixture_state(L, 3, dev)
    table = gso.pack_guided_rows(prep, sdmm.weight, init).T.contiguous()
    # The kernel reads the packed float32 table, which holds the rows bit
    # for bit.
    packed = gso.pack_sample_table(table)
    check(torch.equal(gso.unpack_sample_table(packed), table),
          "guided_sample: the packed table does not round-trip the rows")
    rs = np.random.RandomState(11)
    leaf_r = torch.as_tensor(rs.randint(0, L, size=N).astype(np.int32),
                             device=dev)
    pos = torch.as_tensor(rs.rand(N, 3).astype(np.float32), device=dev)
    wob = rs.randn(N, 3).astype(np.float32)
    wob = torch.as_tensor(wob / np.linalg.norm(wob, axis=-1, keepdims=True),
                          device=dev)
    u = torch.as_tensor(rs.rand(N, 3).astype(np.float32), device=dev)
    # Every lane on one leaf: the table gather at its most coherent.
    leaf_1 = torch.full_like(leaf_r, int(init.nonzero()[0]))
    errs, times = [], {}
    for leaves, leaf in (("random", leaf_r), ("one", leaf_1)):
        dk, okk, pgk, pbk, vk = gso.guided_sample(packed, leaf, pos, wob, u)
        rows_t = table[leaf.long()].T
        dp, okp, pgp, pbp, vp = gso.guided_sample_plain(rows_t, pos.T, wob.T,
                                                        u.T)
        torch.cuda.synchronize()
        what = f"guided_sample [{leaves} leaves]"
        check(torch.isfinite(dk).all() and torch.isfinite(pgk).all()
              and torch.isfinite(pbk).all(), f"{what}: non-finite output")
        check(bool((vk == vp).all()), f"{what}: guide_valid differs")
        m = vk
        check(int(m.sum()) > N // 2, f"{what}: comparison is vacuous")
        err_d = (dk - dp.T).abs().max(-1).values[m]
        errs.append(float(err_d.max()))
        # A conditional mean with mu_dir.z at an ulp of 0 flips the Duff-
        # frame sign branch, and a u_sel within an ulp of a CDF step picks
        # the neighbour component: measure-zero knife edges, allowed up to
        # 0.2% of the lanes (the reference's own parity bound).
        out_d = float((err_d > 1e-4).float().mean())
        pb_close = torch.isclose(pbk[m], pbp[m], rtol=2e-3, atol=1e-5)
        pg_close = torch.isclose(pgk[m], pgp[m], rtol=2e-3, atol=1e-5)
        print(f"{what}: valid {int(m.sum())}/{N}, max|dir err| "
              f"{errs[-1]:.3g} (share > 1e-4: {out_d:.2e}), pdf_b close "
              f"{float(pb_close.float().mean()):.6f}, pdf_g close "
              f"{float(pg_close.float().mean()):.6f}", flush=True)
        check(out_d <= 0.002, f"{what}: directions disagree")
        check(float(pb_close.float().mean()) > 0.998, f"{what}: pdf_b")
        check(float(pg_close.float().mean()) > 0.998, f"{what}: pdf_g")
        check(bool((okk[m] == okp[m]).float().mean() > 0.998),
              f"{what}: g_ok")
        # A float64 evaluation of the twin judges the two float32 versions:
        # near a component's antipode the log map's 1 - cos^2 cancels, and
        # the kernel's fused multiply-adds round it otherwise than the twin
        # does.
        _, _, pg64, pb64, _ = gso.guided_sample_plain(
            rows_t.double(), pos.T.double(), wob.T.double(), u.T.double())

        def off(a, ref):
            return float((~torch.isclose(a[m].double(), ref[m], rtol=2e-3,
                                         atol=1e-5)).float().mean())

        offs = {"kernel": (off(pgk, pg64), off(pbk, pb64)),
                "twin": (off(pgp, pg64), off(pbp, pb64))}
        print(f"{what}: share of pdfs off float64 beyond rtol 2e-3 "
              "(pdf_g, pdf_b): " + ", ".join(
                  f"{k} {g:.2e} {b:.2e}" for k, (g, b) in offs.items()),
              flush=True)
        for j in range(2):
            check(offs["kernel"][j] <= offs["twin"][j] + 1e-3,
                  f"{what}: kernel pdfs less accurate than the twin's")
        times[leaves] = time_ms(
            lambda: gso.guided_sample(packed, leaf, pos, wob, u), reps=20,
            graph=True)
    ms = times["random"]
    print(f"guided_sample: {ms:.4f} ms on uniformly random leaves of {L}, "
          f"{times['one']:.4f} ms with every lane on one leaf", flush=True)
    print_kernel_info(gso.kernel_info())
    plain_ms = time_ms(lambda: gso.guided_sample_plain(
        table[leaf_r.long()].T, pos.T, wob.T, u.T), reps=20)
    bytes_ = packed.numel() * 4 + N * (4 + 3 * 12) + N * (12 + 16)
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = N * GUIDED_OPS_PER_LANE / PEAK_FP32 * 1e3
    print(f"guided_sample: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
          f"ops {t_ops:.4f})", flush=True)
    return {"name": "guided_sample", "route": "cuda",
            "source": "sdmm_tpu_torch/csrc/guided_sample.cu",
            "replaces": "sdmm_tpu/ops/guided_pallas.py:344",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}


def phase_em(dev):
    from sdmm_tpu_torch.ops import em_suffstats as ems

    L, S = 2048, 2_800_000
    sdmm, prep, _ = mixture_state(L, 5, dev)
    rs = np.random.RandomState(17)
    leaf = torch.as_tensor(rs.randint(0, L, size=S).astype(np.int32),
                           device=dev)
    pos = torch.as_tensor(rs.rand(S, 3).astype(np.float32), device=dev)
    d = rs.randn(S, 3).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=dev)
    w = (rs.rand(S) * 2.0).astype(np.float32)
    w[1::211] = -1.0  # invalid samples, as the trainer's replica rows
    w = torch.as_tensor(w, device=dev)

    out_k = ems.e_step(sdmm, prep, pos, d, w, leaf, L)
    out_p = ems.e_step_plain(sdmm, prep, pos, d, w, leaf, L)
    # A float64 evaluation of the same statistics judges the two float32
    # versions: near a component's antipode the log-map Jacobian amplifies
    # float32 rounding, so at 1,400 samples per leaf they differ by up to
    # ~1e-3 of a statistic (measured on an H100).
    sd = type(sdmm)(*(x.double() for x in sdmm))
    pd = type(prep)(*(x.double() if x.is_floating_point() else x
                      for x in prep))
    out_r = ems.e_step_plain(sd, pd, pos.double(), d.double(), w.double(),
                             leaf, L)
    torch.cuda.synchronize()
    check(bool((out_k[4] == out_p[4]).all()), "em: counts differ")
    check(bool(torch.isclose(out_k[3], out_p[3], rtol=1e-5).all()),
          "em: weight sums differ")
    errs = []
    for name, a, b, r in zip(("w", "mean", "cov"), out_k[:3], out_p[:3],
                             out_r[:3]):
        check(bool(torch.isfinite(a).all()), "em: non-finite statistics")
        scale = float(r.abs().max())
        err = float((a - b).abs().max())
        err_k = float((a.double() - r).abs().max())
        err_p = float((b.double() - r).abs().max())
        errs.append(err)
        print(f"em_suffstats: stat {name}: max|kernel - twin| {err:.4g}, vs "
              f"float64: kernel {err_k:.4g}, twin {err_p:.4g} (scale "
              f"{scale:.4g})", flush=True)
        check(err <= 1e-3 * scale, f"em: {name} statistics differ")
        check(err_k <= 2.0 * err_p + 1e-6 * scale,
              f"em: kernel less accurate than the twin on {name}")
    max_abs_err = max(errs)

    again = ems.e_step(sdmm, prep, pos, d, w, leaf, L)
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          "em: two calls on one input differ")
    rows, order, leaf_start, tile_off, count = ems.sort_and_tile(
        pos, d, w, leaf, L)
    want = ems.sort_and_tile_plain(pos, d, w, leaf, L)
    n_valid = int(count.sum())
    o = want[1][:n_valid].long()
    check(torch.equal(order[:n_valid].long(), o)
          and torch.equal(rows[o], want[0][o])
          and all(torch.equal(a, b) for a, b in
                  zip((leaf_start, tile_off, count), want[2:])),
          "em: the packed rows, the sort or the work list differ from the "
          "twin's")
    params = ems.pack_params(sdmm, prep)
    ms = time_ms(lambda: ems.e_step(sdmm, prep, pos, d, w, leaf, L),
                 reps=20)
    kernel_ms = time_ms(lambda: ems.suffstats(
        rows, order, leaf_start, tile_off, params, L), reps=20, graph=True)
    glue_ms = time_ms(lambda: ems.sort_and_tile(pos, d, w, leaf, L),
                      reps=20)
    plain_ms = time_ms(lambda: ems.e_step_plain(sdmm, prep, pos, d, w, leaf,
                                                L), reps=5)
    # Operations of the live components only: the kernel skips a component
    # of zero weight, whose posterior is 0 exactly.
    live = (sdmm.weight != 0).sum(-1).double()
    ops = float((count.double() * live).sum()) * EM_OPS_PER_COMPONENT
    bytes_ = (pos.numel() + d.numel() + w.numel() + leaf.numel()) * 4 \
        + params.numel() * 4 + L * 16 * (1 + 5 + 25) * 4 + L * 8
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    n_tiles = int(tile_off[-1])
    print(f"em_suffstats: {n_valid} valid samples of {S}, {n_tiles} tiles of"
          f" at most {ems.TILE} ({ems.cap_tiles(S, L)} blocks launched), "
          f"live components {float(live.mean()):.3f} a leaf; max|err| "
          f"{max_abs_err:.3g}; e_step wrapper {ms:.4f} ms, kernels alone "
          f"{kernel_ms:.4f} ms, sort_and_tile (keys, rows, counting sort, "
          f"scans) "
          f"{glue_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, ops "
          f"{t_ops:.4f})", flush=True)
    print_kernel_info(ems.kernel_info())
    return {"name": "em_suffstats", "route": "cuda",
            "source": "sdmm_tpu_torch/csrc/em_suffstats.cu",
            "replaces": "sdmm_tpu/ops/em_pallas.py:169",
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}


def compose(translate, scale, rx=0.0, ry=0.0):
    """translate @ rotate_y(ry) @ rotate_x(rx) @ scale, angles in degrees."""
    m = np.eye(4)
    m[:3, :3] = np.diag(scale)
    a = np.deg2rad(rx)
    rxm = np.eye(4)
    rxm[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    a = np.deg2rad(ry)
    rym = np.eye(4)
    rym[0, 0] = rym[2, 2] = np.cos(a)
    rym[0, 2] = np.sin(a)
    rym[2, 0] = -np.sin(a)
    out = np.eye(4)
    out[:3, 3] = translate
    return out @ rym @ rxm @ m


# The Cornell box: its BSDFs (name, albedo), its rectangles (toWorld, BSDF
# name, emissive), its two blocks and its camera.
CORNELL_BSDFS = (("white", [0.725, 0.71, 0.68]), ("red", [0.63, 0.065, 0.05]),
                 ("green", [0.14, 0.45, 0.091]), ("black", [0.0, 0.0, 0.0]))
CORNELL_RADIANCE = [20.0, 20.0, 20.0]


def cornell_rects():
    return ((compose([0, 0, 0], [1, 1, 1], rx=-90), "white", False),
            (compose([0, 2, 0], [1, 1, 1], rx=90), "white", False),
            (compose([0, 1, -1], [1, 1, 1]), "white", False),
            (compose([-1, 1, 0], [1, 1, 1], ry=90), "red", False),
            (compose([1, 1, 0], [1, 1, 1], ry=-90), "green", False),
            (compose([0, 1.98, 0], [0.3, 0.3, 1], rx=90), "black", True))


def cornell_blocks():
    return (compose([-0.33, 0.6, -0.3], [0.28, 0.6, 0.28], ry=18),
            compose([0.35, 0.3, 0.3], [0.28, 0.3, 0.28], ry=-17))


def cornell_camera():
    cam = np.eye(4)
    cam[:3, 3] = [0.0, 1.0, 4.0]
    cam[0, 0] = -1.0
    cam[2, 2] = -1.0
    return cam


def cornell_box(width, height, dev, extra_bsdfs=False, spheres=()):
    """The closed box of tests/test_render.py with its ceiling light, plus
    the two classic Cornell blocks, all diffuse. ``extra_bsdfs`` adds a
    conductor, a dielectric and a rough-conductor cube (the four-type box
    of tests/torch_parity.py); ``spheres``, (centre, radius, n_theta,
    n_phi) each, adds diffuse spheres of albedo 0.5."""
    from sdmm_tpu_torch.scene import shapes
    from sdmm_tpu_torch.scene.scene import (
        BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_ROUGHCONDUCTOR,
        SceneBuilder,
    )

    b = SceneBuilder()
    ids = {name: b.add_bsdf(BSDF_DIFFUSE, albedo=albedo)
           for name, albedo in CORNELL_BSDFS}
    em = b.add_emitter(CORNELL_RADIANCE)
    for tw, name, emissive in cornell_rects():
        b.add_shape(shapes.make_rectangle(tw), ids[name],
                    em if emissive else -1)
    for tw in cornell_blocks():
        b.add_shape(shapes.make_cube(tw), ids["white"])
    if extra_bsdfs:
        cond = b.add_bsdf(BSDF_CONDUCTOR, specular=[0.9, 0.9, 0.9], eta=0.2,
                          k=[3.9, 2.4, 2.1])
        diel = b.add_bsdf(BSDF_DIELECTRIC, eta=1.5)
        rough = b.add_bsdf(BSDF_ROUGHCONDUCTOR, alpha=0.2, eta=0.2,
                           k=[3.9, 2.4, 2.1])
        for tw, bs in (((-0.7, 0.2, 0.5), cond), ((0.7, 0.2, -0.6), diel),
                       ((0.0, 1.3, -0.5), rough)):
            b.add_shape(shapes.make_cube(compose(list(tw), [0.15] * 3,
                                                 rx=30)), bs)
    if spheres:
        grey = b.add_bsdf(BSDF_DIFFUSE, albedo=[0.5, 0.5, 0.5])
        for c, r, n_theta, n_phi in spheres:
            b.add_shape(shapes.make_sphere(c, r, n_theta=n_theta,
                                           n_phi=n_phi), grey)
    b.set_sensor(cornell_camera(), fov_deg=40.0, width=width, height=height)
    b.max_depth = 10
    b.rr_depth = 10
    return b.build(device=dev)


def phase_guided_step(dev, width=640, height=360):
    """trace and shade against their twins on the Cornell box and the
    four-type box, trace also on the box plus one sphere (past its staging
    budget); returns the two kernels' entries, measured on the Cornell box
    (the main path's scene)."""
    from sdmm_tpu_torch.ops import bounce as bo
    from sdmm_tpu_torch.ops import guided_sample as gso
    from sdmm_tpu_torch.ops import guided_step as gst
    from torch_parity import lane_wave

    N, L = 131_072, 2048
    max_depth, rr_depth, frac = 10, 10, 0.5
    sdmm, prep, init = mixture_state(L, 3, dev)
    table = gso.pack_guided_rows(prep, sdmm.weight, init).T.contiguous()
    table16 = table.to(torch.bfloat16)
    # shade's packed table holds the same bf16 values as the twin's rows.
    shade_table = gst.pack_shade_table(table)
    check(torch.equal(gso.unpack_sample_table(shade_table), table16),
          "shade: the packed table does not round-trip the bf16 rows")
    entries = {}
    # The third scene, the box plus one sphere (1,024 triangle columns),
    # takes trace past its shared-memory staging budget (csrc/
    # woop_stage.cuh STAGE_MAX): the Woop rows are staged in chunks.
    sphere = [([0.0, 1.0, 0.3], 0.35, 16, 32)]
    for extra, (scene_name, kw) in enumerate((
            ("cornell", {}), ("four-type", {"extra_bsdfs": True}),
            ("past the staging budget", {"spheres": sphere}))):
        scene, cfg = cornell_box(width, height, dev, **kw)
        types = cfg.bsdf_types
        tri, _, env = bo.build_tables(scene)
        state, meta, rand = (
            torch.as_tensor(a, device=dev) for a in
            lane_wave(N, 21 + extra, width * height, max_depth))
        st_k, hit_k = gst.trace(state, meta, tri, env, types)
        st_p, hit_p = gst.trace_plain(state, meta, tri, env, types)
        torch.cuda.synchronize()
        exact = [3, 4, 5] + list(range(9, 22))
        ok_exact = (hit_k[exact] == hit_p[exact]).all(0)
        ok_close = torch.isclose(hit_k[[0, 1, 2, 6, 7, 8]],
                                 hit_p[[0, 1, 2, 6, 7, 8]], rtol=1e-5,
                                 atol=1e-6).all(0)
        ok_state = torch.isclose(st_k, st_p, rtol=1e-5, atol=1e-6,
                                 equal_nan=True).all(0)
        ok_t = ok_exact & ok_close & ok_state
        err_t = float((hit_k[0:3] - hit_p[0:3]).abs()[:, ok_exact].max())
        on = hit_p[21] > 0.5
        n_types = {int(t): int(((hit_p[12] == t) & on).sum())
                   for t in range(4)}
        groups = {f"type {t}": on & (hit_p[12] == t) for t in types}
        groups["off surface"] = ~on
        print(f"trace [{scene_name}, {tri.shape[1]} triangles]: lanes on a "
              f"surface {int(on.sum())}/{N} by type {n_types}; winner "
              f"attributes equal {float(ok_exact.float().mean()):.6f}, "
              f"max|hit position err| {err_t:.3g}", flush=True)
        check(all(n_types[t] > 0 for t in types), "trace: a BSDF type was "
              "never hit")
        agreement("trace, all rows within rtol 1e-5", ok_t, groups)
        if scene_name == "past the staging budget":
            print_kernel_info(gst.kernel_info(tri.shape[1]),
                              f" [{tri.shape[1]} triangle columns]")
            continue

        # Shade from the twin's hit buffer, so errors do not compound.
        rs = np.random.RandomState(31 + extra)
        leaf = torch.as_tensor(rs.randint(0, L, N).astype(np.int32),
                               device=dev)
        span = (scene.aabb_hi - scene.aabb_lo).max()
        cpos = ((hit_p[0:3].T - scene.aabb_lo) / span).T.contiguous()
        out_k = gst.shade(st_p, meta, hit_p, cpos, leaf, shade_table, rand,
                          types, max_depth, rr_depth, frac)
        rows_t = table16[leaf.long()].T.float()
        out_p = gst.shade_plain(st_p, meta, hit_p, cpos, rows_t, rand, types,
                                max_depth, rr_depth, frac)
        torch.cuda.synchronize()
        ok_s = torch.isclose(out_k[0], out_p[0], rtol=2e-4, atol=1e-5,
                             equal_nan=True).all(0)
        ok_m = out_k[1] == out_p[1]
        ok_sp = (out_k[2] == out_p[2]).all(0)
        fin = torch.isfinite(out_p[0]) & torch.isfinite(out_k[0])
        err_s = float((out_k[0] - out_p[0]).abs()[fin & ok_m[None]].max())
        sp = out_p[2].sum(1)
        print(f"shade [{scene_name}]: max|state err| on lanes with equal "
              f"meta {err_s:.3g}; done {int(sp[6])}, on surface {int(sp[7])}"
              f", cond tries {int(sp[8])}, cond ok {int(sp[9])}", flush=True)
        for what, ok in (("state (rtol 2e-4, atol 1e-5)", ok_s),
                         ("meta", ok_m), ("splat", ok_sp)):
            agreement(f"shade {what}", ok, groups)
        check(bool(torch.isfinite(out_k[2]).all()), "shade: splat not finite")
        check(0 < int(sp[9]) <= int(sp[8]), "shade: comparison is vacuous")
        if scene_name != "cornell":
            continue

        ms_t = time_ms(lambda: gst.trace(state, meta, tri, env, types),
                       reps=20, graph=True)
        plain_t = time_ms(lambda: gst.trace_plain(state, meta, tri, env,
                                                  types), reps=5)
        ms_s = time_ms(lambda: gst.shade(st_p, meta, hit_p, cpos, leaf,
                                         shade_table, rand, types, max_depth,
                                         rr_depth, frac), reps=20, graph=True)
        # Every lane on one leaf: the table gather at its most coherent.
        leaf1 = torch.full_like(leaf, int(init.nonzero()[0]))
        ms_s1 = time_ms(lambda: gst.shade(st_p, meta, hit_p, cpos, leaf1,
                                          shade_table, rand, types, max_depth,
                                          rr_depth, frac), reps=20, graph=True)
        print(f"shade: {ms_s:.4f} ms on uniformly random leaves of {L}, "
              f"{ms_s1:.4f} ms with every lane on one leaf", flush=True)
        print_kernel_info(gst.kernel_info(tri.shape[1]),
                          f" [{tri.shape[1]} triangle columns]")
        plain_s = time_ms(lambda: gst.shade_plain(
            st_p, meta, hit_p, cpos, table16[leaf.long()].T.float(), rand,
            types, max_depth, rr_depth, frac), reps=5)
        n_tris = tri.shape[1]
        # trace reads every state row (0-15) and meta per lane, triangle
        # rows 0-26 and 28-39 once (the Woop rows and the attributes; not
        # 27, the NEE pdf, nor 40-42), the env row's three entries; it
        # writes 16 state rows and 22 hit rows.
        b_t = (N * (16 * 4 + 4) + 39 * n_tris * 4 + 3 * 4
               + N * (16 + gst.HIT_ROWS) * 4)
        o_t = N * (n_tris * TRACE_OPS_PER_TRI + TRACE_OPS_PER_LANE)
        # shade reads state rows 3-12 (direction, throughput, radiance,
        # eta²; rows 0-2 of the new state come from the hit buffer and rows
        # 13-15 are never read), meta, 22 hit rows, 3 cpos rows, the leaf
        # index, 8 rand rows and the bf16 table once; it writes 16 state
        # rows, meta and 10 splat rows.
        b_s = (N * (10 * 4 + 4 + gst.HIT_ROWS * 4 + 3 * 4 + 4
                    + gst.RAND_ROWS * 4) + table16.numel() * 2
               + N * (16 * 4 + 4 + gst.SPLAT_ROWS * 4))
        o_s = N * SHADE_OPS_PER_LANE + sum(
            c * n_types[t] for t, c in SHADE_OPS_BY_TYPE.items())
        for name, ms, plain, b, o, err, line in (
                ("trace", ms_t, plain_t, b_t, o_t, err_t, ":571"),
                ("shade", ms_s, plain_s, b_s, o_s, err_s, ":615")):
            t_bytes = b / PEAK_BYTES * 1e3
            t_ops = o / PEAK_FP32 * 1e3
            print(f"{name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, ops "
                  f"{t_ops:.4f})", flush=True)
            entries[name] = {
                "name": name, "route": "cuda",
                "source": "sdmm_tpu_torch/csrc/guided_step.cu",
                "replaces": "sdmm_tpu/ops/guided_step_pallas.py" + line,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": None}
    return [entries["trace"], entries["shade"]]


def phase_main_path(dev, width=640, height=360):
    from sdmm_tpu_torch.guiding.trainer import SDMMTrainer, TrainerConfig
    from sdmm_tpu_torch.ops import em_suffstats as ems
    from sdmm_tpu_torch.ops import guided_sample as gso
    from sdmm_tpu_torch.ops import guided_step as gst
    from sdmm_tpu_torch.ops import intersect_sweep as isweep
    from sdmm_tpu_torch.render.guided import (
        render_pool_guided, render_pool_guided_fused,
    )
    from sdmm_tpu_torch.utils import metrics

    scene, cfg = cornell_box(width, height, dev)
    tc = TrainerConfig(tail_chunk_spp=16)
    tr = SDMMTrainer(scene, cfg, tc, device=dev)
    snap = {}

    def on_iteration(t, _):
        st = t.stats[-1]
        print("iteration", json.dumps(st), flush=True)
        c = t.counters["avg_found_conditional"]
        snap[st["iteration"]] = (c.value, c.base)

    gso.guided_sample.launches = 0
    ems.suffstats.launches = 0
    gst.trace.launches = 0
    gst.shade.launches = 0
    isweep.mt_sweep.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with EmCensus() as census:
        img, iters = tr.run(total_spp=64, on_iteration=on_iteration)
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"em census: phase 5: {json.dumps(census.totals)}", flush=True)
    check(census.totals["nan_stats_w"] == 0,
          "main path: the E-step's statistics hold NaN")
    launches = {"guided_sample": gso.guided_sample.launches,
                "em_suffstats": ems.suffstats.launches,
                "trace": gst.trace.launches, "shade": gst.shade.launches,
                "mt_sweep": isweep.mt_sweep.launches}
    print(f"main path: {len(iters)} iterations, {wall:.2f} s, launches "
          f"{launches}", flush=True)

    n_train = sum(1 for s in tr.stats if s["optimized_nodes_count"] > 0)
    check(len(iters) == 7, f"expected 7 iterations, got {len(iters)}")
    check(img.shape == (height, width, 3) and np.isfinite(img).all(),
          "main path: image not finite or misshapen")
    active = int(tr.initialized.sum())
    check(active > 0, "main path: no active leaves")
    v0, b0 = snap[3]
    v1, b1 = snap[max(snap)]
    tail_share = (v1 - v0) / max(b1 - b0, 1.0)
    print(f"main path: {n_train} optimized iterations, active leaves "
          f"{active}, leaves {tr.tree.n_leaves}, valid-conditional share in "
          f"the tail {tail_share:.4f}", flush=True)
    check(tail_share > 0.5, "main path: tail conditionals mostly invalid")
    check(all(v > 0 for v in launches.values()),
          f"main path: a kernel was not launched: {launches}")

    # Unguided render at equal spp through the same pool.
    out = render_pool_guided(
        tr.scene, tr.guide_state(),
        torch.Generator(device=dev).manual_seed(99),
        n_lanes=min(tc.rays_per_wave * 2, width * height * 64), spp=64,
        width=width, height=height, max_depth=10, rr_depth=10,
        bsdf_fraction=1.0,
        bsdf_types=cfg.bsdf_types, device=dev)
    ref = (out["image"] / out["weight"].clamp_min(1.0)[:, None]) \
        .reshape(height, width, 3).cpu().numpy()
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    print(f"main path: image mean {img.mean():.5f} vs unguided "
          f"{ref.mean():.5f} (rel {rel:.4f}); MrSE {metrics.mrse(img, ref):.4f}"
          f", MAPE {metrics.mape(img, ref):.4f}, SMAPE "
          f"{metrics.smape(img, ref):.4f}", flush=True)
    check(rel < 0.05, "main path: image mean disagrees with the unguided "
          "render")

    # The fused frozen-model pool against the eager guided pool, equal spp,
    # the same guide state.
    kw = dict(n_lanes=min(tc.rays_per_wave * 2, width * height * 64),
              spp=64, width=width, height=height, max_depth=10, rr_depth=10,
              bsdf_fraction=tc.bsdf_fraction, device=dev)
    gs = tr.guide_state()
    means = {}
    for name, fn, types in (
            ("fused", render_pool_guided_fused, tuple(cfg.bsdf_types)),
            ("eager", render_pool_guided, cfg.bsdf_types)):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(tr.scene, gs, torch.Generator(device=dev).manual_seed(7),
                 bsdf_types=types, **kw)
        im = out["image"] / out["weight"].clamp_min(1.0)[:, None]
        means[name] = float(im.mean())
        torch.cuda.synchronize()
        print(f"main path: {name} guided pool, 64 spp: {time.time() - t0:.3f}"
              f" s, {out['steps']} steps, image mean {means[name]:.5f}, "
              f"weight {float(out['weight'].sum()):.0f}", flush=True)
        check(float(out["weight"].sum()) == width * height * 64,
              f"main path: the {name} pool did not spend its budget")
    rel_f = abs(means["fused"] - means["eager"]) / means["eager"]
    print(f"main path: fused vs eager guided pool, rel {rel_f:.4f}",
          flush=True)
    check(rel_f < 0.02, "main path: the fused pool disagrees with the eager "
          "guided pool")
    return launches, float(img.mean())


def _warm_wave(bo, scene, cfg, n, dev, warm_steps=4, budget=64):
    """A lane wave after ``warm_steps`` step-kernel launches from fresh
    lanes (lane i on pixel i, ``budget`` samples each), so that lanes are
    mid-path; returns (state, meta, film, pxpy, tables, cam, n_em)."""
    width, height = cfg.width, cfg.height
    tri, em, env = bo.build_tables(scene)
    n_em = int(scene.em_tri_idx.shape[0])
    lane = torch.arange(n, device=dev)
    n_pix = width * height
    pix = torch.where(lane < n_pix, lane, 0)
    pxpy = torch.stack([(pix % width).float(), (pix // width).float(),
                        torch.where(lane < n_pix, budget, 0).float()])
    state = torch.zeros((16, n), device=dev)
    state[5] = 1.0
    state[6:9] = 1.0
    state[12:14] = 1.0
    meta = torch.full((n,), bo._PDELTA, dtype=torch.int32, device=dev)
    film = torch.zeros((8, n), device=dev)
    cam = bo.build_cam_params(scene, width, height)
    ones = torch.ones(n // bo.lane_tile(tri.shape[1]), dtype=torch.int32,
                      device=dev)
    for k in range(warm_steps):
        bo.step(state, meta, film, ones, cam, (101, k), pxpy, tri, em, env,
                n_em, 10, 10, cfg.bsdf_types, width, height)
    return state, meta, film, pxpy.contiguous(), (tri, em, env), cam, n_em


def phase_path_kernels(dev, width=640, height=360, N=29 * 8192):
    """step and bounce against their twins at N lanes (the path row's at
    640x360: 29 tiles of 8192) on the Cornell box, the four-type box and a
    box past 96 triangles; returns the two kernels' entries, measured on
    the Cornell box (the path row's scene)."""
    from sdmm_tpu_torch.ops import bounce as bo
    from sdmm_tpu_torch.scene import scene as tscene
    from sdmm_tpu_torch.scene import shapes as tshapes
    from torch_parity import make_tiled_box

    md = rr = 10
    entries = {}
    sphere = [([0.0, 1.0, 0.3], 0.35, 16, 32)]
    scenes = (
        ("cornell", lambda: cornell_box(width, height, dev)),
        ("four-type", lambda: cornell_box(width, height, dev, True)),
        ("past 96 triangles", lambda: make_tiled_box(
            tscene, tshapes, width, height).build(device=dev)),
        ("past the staging budget", lambda: cornell_box(
            width, height, dev, spheres=sphere)))
    for scene_name, make in scenes:
        scene, cfg = make()
        types = cfg.bsdf_types
        state, meta, film, pxpy, (tri, em, env), cam, n_em = _warm_wave(
            bo, scene, cfg, N, dev)
        tile = bo.lane_tile(tri.shape[1])
        ones = torch.ones(N // tile, dtype=torch.int32, device=dev)
        seed2 = (202, 4)
        args = (cam, seed2, pxpy, tri, em, env, n_em, md, rr, types, width,
                height)

        # step, Philox mode: kernel against twin from equal inputs.
        stats = {}
        ref = bo.step_plain(state, meta, film, ones, *args, stats=stats)
        k = [x.clone() for x in (state, meta, film)]
        bo.step(*k, ones, *args)
        # The host-uniform mode on the twin's Philox bits: the same lanes.
        k2 = [x.clone() for x in (state, meta, film)]
        bo.step(*k2, ones, *args,
                rand=bo.philox_uniforms(seed2, N, device=dev))
        torch.cuda.synchronize()
        same = all(bool(((a == b) | (a.isnan() & b.isnan())).all())
                   for a, b in zip(k, k2))
        check(same, f"step [{scene_name}]: in-kernel Philox uniforms differ "
              "from the twin's bits")
        ltype = stats["lane_type"]
        groups = {f"type {t}": ltype == t for t in types}
        groups["off surface"] = ltype < 0
        n_types = {t: int((ltype == t).sum()) for t in types}
        alive_in = int(((meta & bo._ALIVE) != 0).sum())
        cand = stats["nee_mask"]
        nee_share = stats["nee_candidates"] / N
        print(f"step [{scene_name}, {tri.shape[1]} triangle columns, tile "
              f"{tile}]: {alive_in}/{N} lanes alive after 4 warm steps; "
              f"surface lanes by type {n_types}; NEE candidates "
              f"{stats['nee_candidates']} (share {nee_share:.4f}; warps "
              f"with one {float(cand.view(-1, 32).any(1).float().mean()):.4f}"
              f"); Philox modes equal bit for bit", flush=True)
        print_kernel_info(bo.kernel_info(tri.shape[1]),
                          f" [{tri.shape[1]} triangle columns]")
        check(all(v > 0 for v in n_types.values()),
              f"step [{scene_name}]: a BSDF type was never hit")
        # State within shade's bounds (rtol 2e-4, atol 1e-5): the disk map
        # and the VNDF sample take sincospif in the kernel and cos/sin of a
        # rounded multiple of pi in the twin; z = sqrt(1 - x² - y²) near
        # the disk's rim turns that ulp into ~5e-6 on a direction row.
        ok_s = torch.isclose(k[0], ref[0], rtol=2e-4, atol=1e-5,
                             equal_nan=True).all(0)
        ok_m = k[1] == ref[1]
        ok_f = torch.isclose(k[2], ref[2], rtol=1e-5, atol=1e-6).all(0)
        fin = torch.isfinite(ref[0]) & torch.isfinite(k[0])
        err_step = float((k[0] - ref[0]).abs()[fin & ok_m[None]].max())
        for what, ok in (("state (rtol 2e-4, atol 1e-5)", ok_s),
                         ("meta", ok_m), ("film (rtol 1e-5)", ok_f)):
            agreement(f"step {what}", ok, groups)
        check(bool(torch.isfinite(k[2]).all()), "step: film not finite")
        check(int((ref[2][6] - film[6]).sum()) > 1000,
              "step: comparison is vacuous")

        # bounce on the warm wave with host uniforms.
        rand8 = torch.rand((bo.RAND_ROWS, N), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(7))
        bstats = {}
        ref_b = bo.bounce_plain(state, meta, rand8, tri, em, env, n_em, md,
                                rr, types, stats=bstats)
        out_b = bo.bounce(state, meta, rand8, tri, em, env, n_em, md, rr,
                          types)
        torch.cuda.synchronize()
        ok_bs = torch.isclose(out_b[0], ref_b[0], rtol=2e-4, atol=1e-5,
                              equal_nan=True).all(0)
        ok_bm = out_b[1] == ref_b[1]
        ok_bp = torch.isclose(out_b[2], ref_b[2], rtol=1e-5, atol=1e-6).all(0)
        fin = torch.isfinite(ref_b[0]) & torch.isfinite(out_b[0])
        err_bounce = float((out_b[0] - ref_b[0]).abs()[fin & ok_bm[None]]
                           .max())
        bl = bstats["lane_type"]
        bgroups = {f"type {t}": bl == t for t in types}
        bgroups["off surface"] = bl < 0
        for what, ok in (("state (rtol 2e-4, atol 1e-5)", ok_bs),
                         ("meta", ok_bm), ("splat (rtol 1e-5)", ok_bp)):
            agreement(f"bounce [{scene_name}] {what}", ok, bgroups)
        check(bool(torch.isfinite(out_b[2]).all()), "bounce: splat not "
              "finite")
        print(f"step/bounce [{scene_name}]: max|state err| on lanes with "
              f"equal meta {err_step:.3g} / {err_bounce:.3g}", flush=True)
        if scene_name != "cornell":
            continue

        # Times at the path row's shapes, on the warm Cornell wave: the
        # step in place (lanes keep regenerating: 64 samples each), the
        # bounce out of place on equal inputs.
        ts_ = [x.clone() for x in (state, meta, film)]
        ms_step = time_ms(lambda: bo.step(*ts_, ones, *args), reps=20,
                          graph=True)
        plain_step = time_ms(lambda: bo.step_plain(
            state, meta, film, ones, *args), reps=3)
        ms_bounce = time_ms(lambda: bo.bounce(
            state, meta, rand8, tri, em, env, n_em, md, rr, types), reps=20,
            graph=True)
        plain_bounce = time_ms(lambda: bo.bounce_plain(
            state, meta, rand8, tri, em, env, n_em, md, rr, types), reps=3)
        n_cols = tri.shape[1]
        tables = 39 * n_cols * 4 + 18 * n_em * 4 + 3 * 4
        # step: every lane of a live tile reads state rows 0-13, meta, 8
        # film rows and 3 pxpy rows and writes 16 state rows, meta and 8
        # film rows; the tables once. Philox mode: no uniform rows.
        b_step = N * (14 * 4 + 4 + 8 * 4 + 3 * 4) + tables \
            + N * (16 * 4 + 4 + 8 * 4)
        o_step = (N * (n_cols * PATH_OPS_PER_TRI + PATH_OPS_PER_LANE
                       + STEP_OPS_PER_LANE + PHILOX_OPS_PER_LANE)
                  + stats["nee_candidates"] * n_cols * PATH_OPS_PER_TRI)
        # bounce: state rows 0-13, meta and 7 uniform rows in; 16 state
        # rows, meta and 8 splat rows out.
        b_bounce = N * (14 * 4 + 4 + 7 * 4) + tables \
            + N * (16 * 4 + 4 + 8 * 4)
        o_bounce = (N * (n_cols * PATH_OPS_PER_TRI + PATH_OPS_PER_LANE)
                    + bstats["nee_candidates"] * n_cols * PATH_OPS_PER_TRI)
        for name, ms, plain, b, o, err, line in (
                ("step", ms_step, plain_step, b_step, o_step, err_step,
                 ":947"),
                ("bounce", ms_bounce, plain_bounce, b_bounce, o_bounce,
                 err_bounce, ":1039")):
            t_bytes = b / PEAK_BYTES * 1e3
            t_ops = o / PEAK_FP32 * 1e3
            share = (f"; NEE candidate share {nee_share:.4f}"
                     if name == "step" else "")
            print(f"{name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, ops "
                  f"{t_ops:.4f}){share}", flush=True)
            entries[name] = {
                "name": name, "route": "cuda",
                "source": "sdmm_tpu_torch/csrc/bounce.cu",
                "replaces": "sdmm_tpu/ops/bounce_pallas.py" + line,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "library_ms": None}
    return [entries["step"], entries["bounce"]]


def phase_path_row(dev, guided_mean, smi, width=640, height=360):
    """The unguided path row through render_wavefront, with the step and
    bounce launch counts read around it; returns them."""
    from sdmm_tpu_torch.ops import bounce as bo
    from sdmm_tpu_torch.ops import intersect_sweep as isweep
    from sdmm_tpu_torch.render.wavefront import render_pool, render_wavefront

    scene, cfg = cornell_box(width, height, dev)
    bo.step.launches = 0
    bo.bounce.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    row = render_wavefront(scene, cfg, spp=64, seed=11, device=dev)
    torch.cuda.synchronize()
    t64 = time.time() - t0
    row2 = render_wavefront(scene, cfg, spp=2, seed=12, device=dev)
    torch.cuda.synchronize()
    launches = {"step": bo.step.launches, "bounce": bo.bounce.launches}
    print(f"path row: 64 spp took the {row['pool']} pool ({t64:.3f} s, "
          f"{row['steps']} steps, {row['n_vertices']} vertices), 2 spp the "
          f"{row2['pool']} pool ({row2['steps']} steps); launches "
          f"{launches}", flush=True)
    check(row["pool"] == "sorted2" and row2["pool"] == "striped",
          "path row: render_wavefront took the wrong pool")
    for spp, r in ((64, row), (2, row2)):
        check(r["image"].shape == (height, width, 3)
              and np.isfinite(r["image"]).all(),
              "path row: image not finite or misshapen")
        check(bool((r["weight"] == spp).all()),
              f"path row: the {r['pool']} pool did not spend exactly {spp} "
              "samples on every pixel")
    check(all(v > 0 for v in launches.values()),
          f"path row: a kernel was not launched: {launches}")

    isweep.mt_sweep.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    eager = render_pool(scene, torch.Generator(device=dev).manual_seed(13),
                        n_lanes=1 << 18, spp=64, width=width, height=height,
                        max_depth=10, rr_depth=10, bsdf_types=cfg.bsdf_types,
                        device=dev)
    torch.cuda.synchronize()
    t_eager = time.time() - t0
    print(f"path row: the eager render_pool launched mt_sweep "
          f"{isweep.mt_sweep.launches} times in {eager['steps']} steps",
          flush=True)
    check(isweep.mt_sweep.launches == 2 * eager["steps"],
          "path row: the eager pool's intersect and occluded did not go "
          "through mt_sweep")
    launches["mt_sweep"] = isweep.mt_sweep.launches
    m_eager = float((eager["image"] / eager["weight"].clamp_min(1.0)[:, None])
                    .mean())
    m_row, m_row2 = float(row["image"].mean()), float(row2["image"].mean())
    rel_e = abs(m_row - m_eager) / m_eager
    rel_g = abs(guided_mean - m_row) / m_row
    print(f"path row: image mean 64 spp {m_row:.5f}, 2 spp {m_row2:.5f}; "
          f"eager render_pool 64 spp {m_eager:.5f} ({t_eager:.3f} s, "
          f"{eager['steps']} steps; rel {rel_e:.4f}); phase 5's guided image "
          f"{guided_mean:.5f} (rel {rel_g:.4f})", flush=True)
    check(rel_e < 0.02, "path row: sorted2 disagrees with the eager pool")
    check(rel_g < 0.05, "path row: the guided image disagrees with the path "
          "row")

    # bench.py's configuration: 640x360, 192 spp, depth 10 (at the phase's
    # width and height).
    rates = []
    for seed in range(4):
        torch.cuda.synchronize()
        t0 = time.time()
        r = render_wavefront(scene, cfg, spp=192, seed=100 + seed,
                             device=dev)
        torch.cuda.synchronize()
        if seed:  # the first run is the warm-up
            rates.append(r["n_vertices"] / (time.time() - t0))
    print(f"path row at {width}x{height}, 192 spp, depth 10 ({r['pool']}): "
          f"path vertices/s "
          f"{statistics.median(rates):.4g} (median of {len(rates)}: "
          f"{', '.join(f'{x:.4g}' for x in rates)}) on {smi}", flush=True)
    return launches


def large_spheres():
    """The large scene's 32 spheres: make_sphere's default 32 x 64
    tessellation, centres and radii drawn as scripts/bench_clas.py draws
    them."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(32):
        c = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9])
        out.append((c, rng.uniform(0.03, 0.12), 32, 64))
    return out


def twin_hits(scene, ro, rd, t_max):
    """The hit record of the plain twin on the route render/intersect.py
    takes for ``scene``."""
    from sdmm_tpu_torch.ops import clas_cull as ccull
    from sdmm_tpu_torch.ops import intersect_sweep as isweep
    from sdmm_tpu_torch.render.intersect import BRUTE_FORCE_MAX

    if scene.tri_v0.shape[0] <= BRUTE_FORCE_MAX:
        return isweep.mt_sweep_plain(ro, rd, t_max, scene.tri_v0,
                                     scene.tri_e1, scene.tri_e2)
    t, tri, u, v = ccull.cull_plain(ro, rd, t_max, scene.clas_woop,
                                    scene.clas_ids)
    return {"t": t, "tri": tri, "u": u, "v": v, "valid": tri >= 0}


def query_rays(scene, n, seed, dev, width=640, height=360, hits=None):
    """n queries of three interleaved kinds: camera rays through random
    points of a width x height image; secondary rays from the camera rays'
    hits in uniformly random directions; occlusion queries from those hits
    toward emitter samples, t_max 0.999 of the distance (the eager pool's
    shadow rays). A query whose camera ray missed stays a camera ray. The
    camera rays' hits come from ``hits`` (default ``twin_hits``). Returns
    contiguous (ro, rd, t_max) and each query's kind (0, 1, 2)."""
    from sdmm_tpu_torch.render.intersect import surface_interaction
    from sdmm_tpu_torch.render.volpath import RAY_EPS
    from sdmm_tpu_torch.scene import emitters
    from sdmm_tpu_torch.scene.sensor import generate_rays

    u = torch.rand((n, 7), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    ro, rd = generate_rays(
        scene, u[:, 0:2] * torch.tensor([width, height], device=dev), width,
        height)
    inf = torch.full((n,), 3.4e38, device=dev)
    it = surface_interaction(scene, ro, rd,
                             (hits or twin_hits)(scene, ro, rd, inf))
    kind = torch.where(it["valid"], torch.arange(n, device=dev) % 3, 0)
    z = 2.0 * u[:, 2] - 1.0
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * np.pi * u[:, 3]
    d_sec = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    ls = emitters.sample_direct(scene, it["p"], u[:, 4], u[:, 5:7])

    def spawn(d):
        side = torch.where((it["ng"] * d).sum(-1) > 0, RAY_EPS, -RAY_EPS)
        return it["p"] + it["ng"] * side[:, None]

    k1, k2 = (kind == 1)[:, None], (kind == 2)[:, None]
    ro = torch.where(k1, spawn(d_sec), torch.where(k2, spawn(ls["d"]), ro))
    rd = torch.where(k1, d_sec, torch.where(k2, ls["d"], rd))
    t_max = torch.where(kind == 2, ls["dist"] * (1.0 - 1e-3), inf)
    return ro.contiguous(), rd.contiguous(), t_max.contiguous(), kind


def phase_sweep(dev, N=262_144, width=640, height=360):
    """mt_sweep against its twin on four scenes; returns its entry, timed
    on the Cornell box (the main path's scene)."""
    from sdmm_tpu_torch.ops import intersect_sweep as isweep
    from sdmm_tpu_torch.scene import scene as tscene
    from sdmm_tpu_torch.scene import shapes as tshapes
    from torch_parity import make_tiled_box

    sphere = [([0.0, 1.0, 0.3], 0.35, 16, 32)]
    scenes = (
        ("cornell", lambda: cornell_box(width, height, dev)),
        ("four-type", lambda: cornell_box(width, height, dev, True)),
        ("116 triangles", lambda: make_tiled_box(
            tscene, tshapes, width, height).build(device=dev)),
        ("996 triangles", lambda: cornell_box(width, height, dev,
                                              spheres=sphere)))
    entry, errs = None, []
    for name, make in scenes:
        scene, _ = make()
        n_tris = scene.tri_v0.shape[0]
        ro, rd, tm, kind = query_rays(scene, N, 31, dev)
        tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
        got = isweep.mt_sweep(ro, rd, tm, *tris)
        want = isweep.mt_sweep_plain(ro, rd, tm, *tris)
        torch.cuda.synchronize()
        same = (got["tri"] == want["tri"]) & (got["valid"] == want["valid"])
        exact = same & (got["t"] == want["t"]) & (got["u"] == want["u"]) \
            & (got["v"] == want["v"])
        close = same
        for k in ("t", "u", "v"):
            close = close & torch.isclose(got[k], want[k], rtol=1e-6, atol=0)
        ok = want["valid"]
        errs.append(float((got["t"] - want["t"])[ok & same].abs().max()))
        print(f"mt_sweep [{name}, {n_tris} triangles]: {N} queries (camera "
              f"{int((kind == 0).sum())}, secondary {int((kind == 1).sum())}"
              f", occlusion {int((kind == 2).sum())}), hits "
              f"{int(ok.sum())}; ids and valid equal on "
              f"{float(same.float().mean()):.6f}, t/u/v bit-equal on "
              f"{float(exact.float().mean()):.6f}, within rtol 1e-6 on "
              f"{float(close.float().mean()):.6f}", flush=True)
        check(bool(same.all()), f"mt_sweep [{name}]: hit ids differ")
        check(bool(close.all()), f"mt_sweep [{name}]: t, u or v differ")
        check(0.1 < float(ok.float().mean()) < 1.0,
              f"mt_sweep [{name}]: comparison is vacuous")
        if name not in ("cornell", "996 triangles"):
            continue
        ms = time_ms(lambda: isweep.mt_sweep(ro, rd, tm, *tris), reps=20,
                     graph=True)
        t_bytes = (N * QUERY_BYTES + n_tris * 36) / PEAK_BYTES * 1e3
        t_ops = N * n_tris * MT_OPS_PER_TRI / PEAK_FP32 * 1e3
        print(f"mt_sweep [{name}]: kernel {ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, ops "
              f"{t_ops:.4f}; every operation a separate instruction: "
              f"{2 * t_ops:.4f})", flush=True)
        print_kernel_info(isweep.kernel_info(n_tris), f" [{name}]")
        if name == "cornell":
            plain_ms = time_ms(lambda: isweep.mt_sweep_plain(
                ro, rd, tm, *tris), reps=5)
            print(f"mt_sweep [{name}]: plain {plain_ms:.4f} ms", flush=True)
            entry = {"name": "mt_sweep", "route": "cuda",
                     "source": "sdmm_tpu_torch/csrc/mt_sweep.cu",
                     "replaces": "sdmm_tpu/ops/intersect_pallas.py:147",
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations",
                     "library_ms": None}
    entry["max_abs_err"] = max(errs)
    return entry


def phase_cull(dev, large, width=640, height=360):
    """clas_cull against its twin on the 4,004-triangle scene and on the
    large scene, in both forms (closest hit, and the any-hit form on the
    occlusion queries); returns its entry, the closest hit timed on the
    large scene."""
    from sdmm_tpu_torch.ops import clas_cull as ccull
    from torch_parity import admitted_tests, least_slab_tests

    one, _ = cornell_box(width, height, dev,
                         spheres=[([0.0, 1.0, 0.3], 0.35, 32, 64)])
    errs = []
    for name, scene, n in (("4,004 triangles", one, 131_072),
                           ("large", large, 32_768)):
        ro, rd, tm, kind = query_rays(scene, n, 41, dev)
        clusters = (scene.clas_tree, scene.clas_woop_slot, scene.clas_ids)
        got = ccull.cull(ro, rd, tm, *clusters)
        occ = ccull.any_hit(ro, rd, tm, *clusters)
        want = ccull.cull_plain(ro, rd, tm, scene.clas_woop, scene.clas_ids)
        torch.cuda.synchronize()
        same = got[1] == want[1]
        close = same
        for a, b in zip(got, want):
            if a.is_floating_point():
                close = close & torch.isclose(a, b, rtol=1e-6, atol=0)
        exact = same & (got[0] == want[0]) & (got[2] == want[2]) \
            & (got[3] == want[3])
        hits = want[1] >= 0
        errs.append(float((got[0] - want[0])[same & hits].abs().max()))
        shadow = kind == 2
        occ_want = hits & (want[0] < tm)
        occ_same = float((occ == occ_want)[shadow].float().mean())
        print(f"clas_cull [{name}, {scene.tri_v0.shape[0]} triangles, "
              f"{scene.clas_ids.shape[0]} clusters of "
              f"{scene.clas_ids.shape[1]}, a tree of "
              f"{scene.clas_tree.shape[0] // 2} leaves]: {n} queries (camera "
              f"{int((kind == 0).sum())}, secondary {int((kind == 1).sum())}"
              f", occlusion {int(shadow.sum())}), hits "
              f"{int(hits.sum())}; ids equal on "
              f"{float(same.float().mean()):.6f}, t/u/v bit-equal on "
              f"{float(exact.float().mean()):.6f}, within rtol 1e-6 where "
              f"the ids agree on {float(close[same].float().mean()):.6f}; "
              f"any-hit occluded equal on {occ_same:.6f} of the occlusion "
              f"queries ({int(occ_want[shadow].sum())} occluded)",
              flush=True)
        for i in (~same).nonzero()[:20, 0].tolist():
            print(f"  off query {i} (kind {int(kind[i])}): kernel tri "
                  f"{int(got[1][i])} t {float(got[0][i]):.9g}, twin tri "
                  f"{int(want[1][i])} t {float(want[0][i]):.9g}", flush=True)
        check(float(same.float().mean()) >= 0.9999,
              f"clas_cull [{name}]: hit ids differ")
        check(bool(close[same].all()), f"clas_cull [{name}]: t, u or v "
              "differ")
        check(0.1 < float(hits.float().mean()) < 1.0,
              f"clas_cull [{name}]: comparison is vacuous")
        check(occ_same >= 0.9999, f"clas_cull [{name}]: the any-hit form "
              "disagrees with the twin's occluded")
        check(0.0 < float(occ_want[shadow].float().mean()) < 1.0,
              f"clas_cull [{name}]: the any-hit comparison is vacuous")

    c = large.clas_ids.shape[0]
    clusters = (large.clas_tree, large.clas_woop_slot, large.clas_ids)
    rows_bytes = (large.clas_woop.numel() + large.clas_ids.numel()
                  + 6 * c) * 4
    timed, glue = {}, {}
    for n, seed in ((131_072, 43), (262_144, 44)):
        ro, rd, tm, kind = query_rays(large, n, seed, dev)
        # The whole wrapper (the query order and the kernel), and the
        # order's sort key and argsort alone.
        timed[n] = time_ms(lambda: ccull.cull(ro, rd, tm, *clusters),
                           reps=10, graph=True)
        glue[n] = time_ms(lambda: ccull.query_order(ro, rd, large.clas_tree),
                          reps=10, graph=True)
        if n != 131_072:
            continue
        box = {}
        plain_ms = time_ms(lambda: box.update(w=ccull.cull_plain(
            ro, rd, tm, large.clas_woop, large.clas_ids)), reps=2, warm=1)
        want = box["w"]
        # The least work: the admitted Woop tests, and the slab tests of the
        # tree nodes a query enters before its hit.
        per_query = admitted_tests(ro, rd, tm, want[0], large.clas_aabb,
                                   large.clas_ids)
        slabs = least_slab_tests(ro, rd, tm, want[0], large.clas_tree)
        admitted, n_slab = float(per_query.sum()), float(slabs.sum())
        t_bytes = (n * QUERY_BYTES + rows_bytes) / PEAK_BYTES * 1e3
        t_ops = (n_slab * SLAB_OPS + admitted * WOOP_OPS) / PEAK_FP32 * 1e3
        # The kernel's own count of Woop tests, outside the timed replays.
        tests = torch.zeros(1, dtype=torch.int64, device=dev)
        ccull.cull(ro, rd, tm, *clusters, tests=tests)

        # The any-hit form on the occlusion queries: an occluded query needs
        # one Woop test, an unoccluded one its admitted tests and slab tests.
        sel = kind == 2
        ro_s, rd_s, tm_s = (x[sel].contiguous() for x in (ro, rd, tm))
        n_s = int(sel.sum())
        occ_want = ((want[1] >= 0) & (want[0] < tm))[sel]
        ms_any, ms_closest = (time_ms(lambda: form(
            ro_s, rd_s, tm_s, *clusters), reps=10, graph=True)
            for form in (ccull.any_hit, ccull.cull))
        tests_any = torch.zeros(1, dtype=torch.int64, device=dev)
        occ = ccull.any_hit(ro_s, rd_s, tm_s, *clusters, tests=tests_any)
        check(bool((occ == occ_want).float().mean() >= 0.9999),
              "clas_cull: the any-hit form disagrees on the timed queries")
        need = float(torch.where(occ_want, 1.0, per_query[sel]).sum())
        need_slab = float(torch.where(occ_want, 0.0, slabs[sel]).sum())
        b_any = (n_s * (28 + 1) + rows_bytes) / PEAK_BYTES * 1e3
        o_any = (need_slab * SLAB_OPS + need * WOOP_OPS) / PEAK_FP32 * 1e3
    n_t = large.tri_v0.shape[0]
    print(f"clas_cull [large]: cull {timed[131_072]:.4f} ms at 131,072 "
          f"queries, {timed[262_144]:.4f} ms at 262,144 (of which the query "
          f"order alone {glue[131_072]:.4f} / {glue[262_144]:.4f} ms); plain "
          f"{plain_ms:.4f} ms at 131,072; admitted Woop tests "
          f"{admitted:.4g} ({admitted / 131_072:.1f} a query of {n_t}), "
          f"the kernel's {int(tests)} ({int(tests) / 131_072:.1f} a query, "
          f"the warp's lockstep count); least slab tests "
          f"{n_slab / 131_072:.1f} a query (a flat test of every cluster: "
          f"{c}); bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, ops "
          f"{t_ops:.4f})", flush=True)
    print(f"clas_cull any-hit [large, the {n_s} occlusion queries of the "
          f"131,072, {int(occ_want.sum())} occluded]: any_hit {ms_any:.4f} "
          f"ms (cull on them {ms_closest:.4f} ms); Woop tests needed "
          f"{need / n_s:.1f} a query, the kernel's "
          f"{int(tests_any) / n_s:.1f}; least slab tests "
          f"{need_slab / n_s:.1f} a query; bound {max(b_any, o_any):.4f} ms "
          f"(bytes {b_any:.4f}, ops {o_any:.4f})", flush=True)
    return {"name": "clas_cull", "route": "cuda",
            "source": "sdmm_tpu_torch/csrc/clas_cull.cu",
            "replaces": "sdmm_tpu/ops/clas_pallas.py:191",
            "max_abs_err": max(errs), "ms": timed[131_072],
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}


def phase_large_path(dev, scene, cfg, smi, width=640, height=360):
    """The large scene's path row and training render, with clas_cull's
    launches read around both and guided_sample's around the training
    render (every iteration of it runs the eager guided pool); returns
    the two counts."""
    from sdmm_tpu_torch.guiding.trainer import SDMMTrainer, TrainerConfig
    from sdmm_tpu_torch.ops import clas_cull as ccull
    from sdmm_tpu_torch.ops import guided_sample as gso
    from sdmm_tpu_torch.render.wavefront import render_wavefront

    ccull.cull.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    row = render_wavefront(scene, cfg, spp=16, seed=21, device=dev)
    torch.cuda.synchronize()
    t_row = time.time() - t0
    n_row = ccull.cull.launches
    m_row = float(row["image"].mean())
    print(f"large path row: {row['pool']} pool, 16 spp at {width}x{height}, "
          f"{t_row:.3f} s, {row['steps']} steps, {row['n_vertices']} "
          f"vertices, clas_cull launches {n_row}, image mean {m_row:.5f}",
          flush=True)
    check(row["pool"] == "eager", "large path row: not the eager pool")
    check(row["image"].shape == (height, width, 3)
          and np.isfinite(row["image"]).all(),
          "large path row: image not finite or misshapen")
    check(bool((row["weight"] == 16).all()),
          "large path row: not exactly 16 samples on every pixel")
    check(n_row == 2 * row["steps"], "large path row: intersect and "
          "occluded did not both go through clas_cull on every step")

    tr = SDMMTrainer(scene, cfg, TrainerConfig(tail_chunk_spp=8), device=dev)
    snap = {}

    def on_iteration(t, _):
        st = t.stats[-1]
        print("large iteration", json.dumps(st), flush=True)
        c = t.counters["avg_found_conditional"]
        snap[st["iteration"]] = (c.value, c.base)

    gso.guided_sample.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with EmCensus() as census:
        img, iters = tr.run(total_spp=32, on_iteration=on_iteration)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_gs = gso.guided_sample.launches
    print(f"em census: phase 7: {json.dumps(census.totals)}", flush=True)
    check(census.totals["nan_stats_w"] == 0,
          "large training render: the E-step's statistics hold NaN")
    train = [s for s in tr.stats if s["optimized_nodes_count"] > 0]
    frozen = [s for s in tr.stats if s["optimized_nodes_count"] == 0]
    check(len(iters) == 5 and len(train) == 2,
          f"large training render: {len(iters)} iterations, {len(train)} "
          "training")
    check(img.shape == (height, width, 3) and np.isfinite(img).all(),
          "large training render: image not finite or misshapen")
    v0, b0 = snap[len(train) - 1]
    v1, b1 = snap[max(snap)]
    tail_share = (v1 - v0) / max(b1 - b0, 1.0)
    rel = abs(float(img.mean()) - m_row) / m_row
    per_train = statistics.mean(s["elapsed_seconds"] for s in train)
    per_spp = sum(s["elapsed_seconds"] for s in frozen) \
        / sum(s["spp"] for s in frozen)
    print(f"large training render: {wall:.2f} s, {per_train:.3f} s per "
          f"training iteration, {per_spp:.4f} s per frozen spp, "
          f"valid-conditional share in the tail {tail_share:.4f}, image "
          f"mean {img.mean():.5f} vs the path row's {m_row:.5f} (rel "
          f"{rel:.4f}); clas_cull launches {ccull.cull.launches}, "
          f"guided_sample launches {n_gs} on {smi}", flush=True)
    check(tail_share > 0.5, "large training render: tail conditionals "
          "mostly invalid")
    check(rel < 0.05, "large training render: the guided image disagrees "
          "with the path row")
    check(n_gs > 0, "large training render: guided_sample was not launched")
    return ccull.cull.launches, n_gs


def _digits(values):
    """``values`` at 17 significant digits, enough to read back exactly."""
    return " ".join("%.17g" % x
                    for x in np.asarray(values, np.float64).ravel())


def write_cornell_xml(path, width, height, spp, obj=None, blocks=True):
    """cornell_box(width, height) as a scene file, each toWorld and the
    camera a 17-digit <matrix>, so that the loaded triangles equal the
    programmatic ones; ``obj`` adds a grey diffuse OBJ shape (the spheres of
    cornell_box's ``spheres``); ``blocks=False`` leaves the two blocks
    out."""
    parts = [
        '<scene version="0.6.0">',
        '  <integrator type="volpath"><integer name="maxDepth" value="10"/>'
        '</integrator>',
        '  <sensor type="perspective"><float name="fov" value="40"/>',
        f'    <transform name="toWorld"><matrix value="'
        f'{_digits(cornell_camera())}"/></transform>',
        '    <sampler type="independent"><integer name="sampleCount" '
        f'value="{spp}"/></sampler>',
        f'    <film type="hdrfilm"><integer name="width" value="{width}"/>'
        f'<integer name="height" value="{height}"/><rfilter type="box"/>'
        '</film>',
        '  </sensor>']
    for name, albedo in CORNELL_BSDFS:
        parts.append(f'  <bsdf type="diffuse" id="{name}"><rgb '
                     f'name="reflectance" value="{_digits(albedo)}"/></bsdf>')
    shapes = [("rectangle", tw, name, emissive)
              for tw, name, emissive in cornell_rects()]
    if blocks:
        shapes += [("cube", tw, "white", False) for tw in cornell_blocks()]
    for kind, tw, name, emissive in shapes:
        light = (f'<emitter type="area"><rgb name="radiance" value="'
                 f'{_digits(CORNELL_RADIANCE)}"/></emitter>'
                 if emissive else "")
        parts.append(f'  <shape type="{kind}"><transform name="toWorld">'
                     f'<matrix value="{_digits(tw)}"/></transform>'
                     f'<ref id="{name}"/>{light}</shape>')
    if obj:
        parts.append(f'  <shape type="obj"><string name="filename" '
                     f'value="{obj}"/><bsdf type="diffuse"><rgb '
                     f'name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>'
                     '</shape>')
    parts.append("</scene>\n")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def write_spheres_obj(path, spheres):
    """The triangles of make_sphere for each of ``spheres`` as an OBJ with
    per-corner 17-digit v and vn lines; returns the triangle count."""
    from sdmm_tpu_torch.scene import shapes

    soups = [shapes.make_sphere(c, r, n_theta=nt, n_phi=npp).concat()
             for c, r, nt, npp in spheres]
    v = np.concatenate([s[0] for s in soups]).reshape(-1, 3)
    n = np.concatenate([s[1] for s in soups]).reshape(-1, 3)
    fmt = "%.17g %.17g %.17g"
    lines = ["v " + fmt % tuple(p) for p in v]
    lines += ["vn " + fmt % tuple(p) for p in n]
    lines += ["f %d//%d %d//%d %d//%d" % (a, a, b, b, c, c)
              for a, b, c in np.arange(1, len(v) + 1).reshape(-1, 3)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(v) // 3


def _counts():
    """Every kernel's launch counter, by name."""
    from sdmm_tpu_torch.ops import bounce as bo
    from sdmm_tpu_torch.ops import clas_cull as ccull
    from sdmm_tpu_torch.ops import em_suffstats as ems
    from sdmm_tpu_torch.ops import guided_sample as gso
    from sdmm_tpu_torch.ops import guided_step as gst
    from sdmm_tpu_torch.ops import intersect_sweep as isweep

    return {"guided_sample": gso.guided_sample, "em_suffstats": ems.suffstats,
            "trace": gst.trace, "shade": gst.shade, "step": bo.step,
            "bounce": bo.bounce, "mt_sweep": isweep.mt_sweep,
            "clas_cull": ccull.cull}


def _same_scene(name, got, want):
    """Check every SceneData field and the render config equal."""
    (gs, gc), (ws, wc) = got, want
    for field in gs._fields:
        a, b = getattr(gs, field), getattr(ws, field)
        check(a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a, b), f"{name}: SceneData.{field} differs "
              "from the programmatic scene's")
    check((gc.width, gc.height, gc.max_depth, gc.rr_depth, gc.fov_axis,
           gc.bsdf_types) == (wc.width, wc.height, wc.max_depth, wc.rr_depth,
                              wc.fov_axis, wc.bsdf_types),
          f"{name}: render config differs")


TRAINER_STATS = {"iteration", "spp", "total_spp", "elapsed_seconds",
                 "rendering_seconds", "training_seconds", "mean_path_length",
                 "samples_count", "max_depth", "leaf_nodes_count",
                 "optimized_nodes_count", "active_nodes_count"}


def phase_entry_point(dev, smi, width=640, height=360):
    """The port's own entry point on the card: the Cornell box and the
    large scene as scene files (the spheres as an OBJ), loaded and checked
    against the programmatic scenes, then rendered through cli.main with
    every kernel's launches read around each call, once through
    python -m sdmm_tpu_torch, and the two Cornell images compared through
    python -m sdmm_tpu_torch compare."""
    import tempfile

    from sdmm_tpu_torch import cli, native
    from sdmm_tpu_torch.guiding import io as gio
    from sdmm_tpu_torch.scene.xml_loader import load_scene
    from sdmm_tpu_torch.utils.exr import read_exr

    report = {"card": smi, "seconds": {}, "launches": {}}
    sec = report["seconds"]
    with tempfile.TemporaryDirectory() as tmp:
        cornell = os.path.join(tmp, "cornell.xml")
        large_xml = os.path.join(tmp, "large.xml")
        write_cornell_xml(cornell, width, height, 64)
        write_cornell_xml(large_xml, width, height, 64, obj="spheres.obj")
        t0 = time.time()
        n_obj = write_spheres_obj(os.path.join(tmp, "spheres.obj"),
                                  large_spheres())
        sec["obj_write"] = time.time() - t0

        parsed = []
        real_obj_load = native.obj_load

        def counted(path):
            parsed.append(path)
            return real_obj_load(path)

        native.obj_load = counted
        try:
            t0 = time.time()
            b_cornell = load_scene(cornell)
            sec["xml_parse_cornell"] = time.time() - t0
            t0 = time.time()
            b_large = load_scene(large_xml)
            sec["xml_and_obj_parse_large"] = time.time() - t0
            t0 = time.time()
            real_obj_load(os.path.join(tmp, "spheres.obj"))
            sec["obj_parse"] = time.time() - t0
        finally:
            native.obj_load = real_obj_load
        check(len(parsed) == 1, "large.xml: the native OBJ parser did not "
              "run")
        t0 = time.time()
        loaded = b_cornell.build(device="cuda")
        torch.cuda.synchronize()
        sec["build_cornell"] = time.time() - t0
        t0 = time.time()
        loaded_large = b_large.build(device="cuda")
        torch.cuda.synchronize()
        sec["build_large"] = time.time() - t0
        check(loaded[0].tri_v0.shape[0] == 36, "cornell.xml: triangle count")
        check(loaded_large[0].tri_v0.shape[0] == 127_012 == 36 + n_obj,
              "large.xml: triangle count")
        _same_scene("cornell.xml", loaded, cornell_box(width, height, dev))
        _same_scene("large.xml", loaded_large,
                    cornell_box(width, height, dev, spheres=large_spheres()))
        check((b_cornell.sample_count, b_cornell.seed, b_cornell.sampler,
               b_cornell.rfilter) == (64, 1234, "independent", "box"),
              "cornell.xml: sampler settings")
        print(f"entry point: cornell.xml and large.xml load into the "
              f"programmatic scenes, 36 and {36 + n_obj} triangles, the "
              "OBJ through the native parser", flush=True)

        counters = _counts()
        runs = (("sdmm", cornell, ["--integrator", "sdmm", "--spp", "64"]),
                ("gt", cornell, ["--integrator", "gt", "--spp", "64"]),
                ("large_gt", large_xml, ["--integrator", "gt", "--spp",
                                         "4"]))
        images = {}
        for name, xml, args in runs:
            out = os.path.join(tmp, name, "image.exr")
            npy = os.path.join(tmp, name, "film.npy")
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            check(cli.main(["render", xml, "-o", out, "--npy", npy, *args])
                  is None, f"cli {name}: non-zero return")
            torch.cuda.synchronize()
            sec[f"cli_{name}"] = time.time() - t0
            report["launches"][name] = {k: fn.launches
                                        for k, fn in counters.items()}
            img = read_exr(out)
            film = np.load(npy)
            check(img.shape == (height, width, 3)
                  and np.isfinite(img).all(),
                  f"cli {name}: image not finite or misshapen")
            check(img.tobytes() == film.astype(np.float32).tobytes(),
                  f"cli {name}: the EXR does not hold the rendered image")
            images[name] = (out, film)
            stats = json.load(open(os.path.join(tmp, name, "stats.json")))
            if name == "sdmm":
                check(isinstance(stats, list) and len(stats) == 16
                      and all(TRAINER_STATS <= set(st) for st in stats)
                      and {"mean_pixel_variance", "ttuv"} <= set(stats[-1]),
                      "cli sdmm: stats.json lacks the trainer's keys")
                ckpt = os.path.join(tmp, name, "checkpoints",
                                    "model_00016.asdmm")
                tree, sdmm, init, meta = gio.load_checkpoint(ckpt, device=dev)
                check(meta["iteration"] == 16 and bool(init.any())
                      and bool(torch.isfinite(sdmm.weight).all()),
                      "cli sdmm: checkpoint")
            else:
                check(set(stats) == {"integrator", "spp", "seconds", "mean"}
                      and stats["integrator"] == "gt",
                      f"cli {name}: stats.json")
            print(f"entry point: cli {name}: {sec[f'cli_{name}']:.3f} s, "
                  f"image mean {film.mean():.5f}, launches "
                  f"{report['launches'][name]}", flush=True)

        m_sdmm = float(images["sdmm"][1].mean())
        m_gt = float(images["gt"][1].mean())
        rel = abs(m_sdmm - m_gt) / m_gt
        report["sdmm_vs_gt_rel"] = rel
        check(rel < 0.05, f"cli: the sdmm image mean {m_sdmm:.5f} is not "
              f"within 5% of the gt image mean {m_gt:.5f}")
        la = report["launches"]
        for run, kernel in (("sdmm", "guided_sample"),
                            ("sdmm", "em_suffstats"), ("sdmm", "trace"),
                            ("sdmm", "shade"), ("sdmm", "mt_sweep"),
                            ("gt", "step"), ("large_gt", "clas_cull")):
            check(la[run][kernel] > 0,
                  f"cli {run}: {kernel} was not launched")

        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        sub_out = os.path.join(tmp, "sub", "image.exr")
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "sdmm_tpu_torch", "render", cornell, "-o",
             sub_out, "--integrator", "gt", "--spp", "4"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        sec["python_m_render"] = time.time() - t0
        check(res.returncode == 0 and os.path.exists(sub_out),
              f"python -m sdmm_tpu_torch render failed: {res.stderr[-2000:]}")
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "sdmm_tpu_torch", "compare",
             images["sdmm"][0], images["gt"][0]],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        sec["python_m_compare"] = time.time() - t0
        check(res.returncode == 0, "python -m sdmm_tpu_torch compare "
              f"failed: {res.stderr[-2000:]}")
        metrics = json.loads(res.stdout)
        check(set(metrics) == {"l1", "l2", "mrse", "mrse01", "mape", "smape",
                               "ssim"}, "compare: metric keys")
        report["compare"] = metrics
    print("entry point:", json.dumps(report), flush=True)


def write_png(path, image):
    """An 8-bit grey or RGB PNG of ``image`` ([H, W] or [H, W, 3] uint8),
    written with zlib alone; row y takes filter type y % 5, so that a
    reader meets all five."""
    import struct
    import zlib

    img = np.asarray(image, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int32)
    out = bytearray()
    prev = np.zeros(w * ch, np.int32)
    for y in range(h):
        f = y % 5
        row = raw[y]
        a = np.concatenate([np.zeros(ch, np.int32), row[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = (0, a, prev, (a + prev) >> 1, paeth)[f]
        out += bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             2 if ch == 3 else 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


def write_features_xml(dirname, width, height, spp, lit=False,
                       sphere=True):
    """Phase 9's scenes as files in ``dirname``: the Cornell rectangles and
    blocks, a small panel and one sphere (``sphere=False``: a cube in its
    place), every
    BSDF type a scene file can name among them (4-6, 8-15 and 17; null is
    built only for a medium's shape): roughdiffuse with a PNG bitmap,
    roughplastic with a scaled checkerboard, a blend of plastic with a grid
    texture and ward, a mask over phong with vertex colours, a coating over
    diffuse with a wireframe, a roughcoating over roughconductor, a blend
    of thindielectric and hk, difftrans on the panel, roughdielectric with
    a curvature texture (baked to vertex colours) on the sphere; the
    ceiling light and an env map (an EXR with a bright patch). ``lit``
    writes
    features_lit.xml: bump maps from a PNG height map on the sphere (whose
    uv are zero, as make_sphere's) and on the floor, a point, a spot and a
    directional light, and sunsky in place of the env map; else
    features.xml. Returns the scene file's path."""
    from sdmm_tpu_torch.utils.exr import write_exr

    yy, xx = np.mgrid[0:64, 0:64]
    tex = np.stack([(xx * 4) % 256, (yy * 4) % 256,
                    ((xx // 8 + yy // 8) % 2) * 200 + 30], -1)
    write_png(os.path.join(dirname, "albedo.png"), tex)
    write_png(os.path.join(dirname, "height.png"),
              (127 + 120 * np.sin(xx / 3.0) * np.cos(yy / 5.0)).astype(
                  np.uint8))
    env = np.full((64, 128, 3), 0.2, np.float32)
    env[:, :, 2] += np.linspace(0.0, 0.6, 64)[:, None]
    env[12:20, 40:56] = [40.0, 36.0, 30.0]
    write_exr(os.path.join(dirname, "env.exr"), env)

    def mat(tw):
        return f'<transform name="toWorld"><matrix value="{_digits(tw)}"/>' \
            '</transform>'

    bump = ('<bsdf type="bumpmap"><texture type="bitmap"><string '
            'name="filename" value="height.png"/></texture><float '
            'name="scale" value="0.05"/>{}</bsdf>')
    floor = ('<bsdf type="roughdiffuse"><float name="alpha" value="0.4"/>'
             '<texture type="bitmap" name="reflectance"><string '
             'name="filename" value="albedo.png"/></texture></bsdf>')
    sph = ('<bsdf type="roughdielectric"><float name="alpha" value="0.2"/>'
           '<texture type="curvature" name="specularTransmittance"><float '
           'name="scale" value="0.2"/></texture></bsdf>')
    rects = cornell_rects()
    bsdfs = [
        bump.format(floor) if lit else floor,
        '<bsdf type="roughplastic"><float name="alpha" value="0.25"/>'
        '<texture type="scale" name="diffuseReflectance"><float name="scale" '
        'value="0.8"/><texture type="checkerboard"><float name="uscale" '
        'value="4"/><float name="vscale" value="4"/></texture></texture>'
        '</bsdf>',
        '<bsdf type="blendbsdf"><float name="weight" value="0.4"/><bsdf '
        'type="plastic"><texture type="gridtexture" '
        'name="diffuseReflectance"><float name="lineWidth" value="0.05"/>'
        '</texture></bsdf><bsdf type="ward"><float name="alphaU" '
        'value="0.15"/><float name="alphaV" value="0.4"/></bsdf></bsdf>',
        '<bsdf type="mask"><rgb name="opacity" value="0.85"/><bsdf '
        'type="phong"><float name="exponent" value="40"/><texture '
        'type="vertexcolors" name="diffuseReflectance"/></bsdf></bsdf>',
        '<bsdf type="coating"><float name="thickness" value="0.5"/><rgb '
        'name="sigmaA" value="0.1, 0.05, 0.2"/><bsdf type="diffuse">'
        '<texture type="wireframe" name="reflectance"><rgb '
        'name="interiorColor" value="0.14, 0.45, 0.091"/></texture></bsdf>'
        '</bsdf>',
        '<bsdf type="diffuse"><rgb name="reflectance" value="0"/></bsdf>',
    ]
    parts = [
        '<scene version="0.6.0">',
        '  <integrator type="volpath"><integer name="maxDepth" value="10"/>'
        '</integrator>',
        '  <sensor type="perspective"><float name="fov" value="40"/>',
        f'    {mat(cornell_camera())}',
        '    <sampler type="independent"><integer name="sampleCount" '
        f'value="{spp}"/></sampler>',
        f'    <film type="hdrfilm"><integer name="width" value="{width}"/>'
        f'<integer name="height" value="{height}"/></film>',
        '  </sensor>']
    for (tw, _, emissive), bsdf in zip(rects, bsdfs):
        light = (f'<emitter type="area"><rgb name="radiance" value="'
                 f'{_digits(CORNELL_RADIANCE)}"/></emitter>'
                 if emissive else "")
        parts.append(f'  <shape type="rectangle">{mat(tw)}{bsdf}{light}'
                     '</shape>')
    tall, short = cornell_blocks()
    parts.append(
        f'  <shape type="cube">{mat(tall)}<bsdf type="roughcoating"><float '
        'name="alpha" value="0.15"/><bsdf type="roughconductor"><string '
        'name="material" value="Au"/><float name="alpha" value="0.3"/>'
        '</bsdf></bsdf></shape>')
    parts.append(
        f'  <shape type="cube">{mat(short)}<bsdf type="blendbsdf"><float '
        'name="weight" value="0.5"/><bsdf type="thindielectric"/><bsdf '
        'type="hk"><rgb name="sigmaS" value="1.5, 1.0, 0.7"/><rgb '
        'name="sigmaA" value="0.05, 0.1, 0.2"/><float name="thickness" '
        'value="0.5"/></bsdf></bsdf></shape>')
    # A small panel across the back left corner.
    parts.append(
        '  <shape type="rectangle">'
        f'{mat(compose([-0.55, 0.45, -0.55], [0.3, 0.3, 1.0], ry=45))}'
        '<bsdf type="difftrans"><rgb name="transmittance" value="0.6, 0.5, '
        '0.4"/></bsdf></shape>')
    sph_bsdf = bump.format(sph) if lit else sph
    if sphere:
        parts.append('  <shape type="sphere"><point name="center" x="0.3" '
                     'y="1.2" z="0.2"/><float name="radius" value="0.25"/>'
                     f'{sph_bsdf}</shape>')
    else:
        parts.append(f'  <shape type="cube">'
                     f'{mat(compose([0.3, 1.2, 0.2], [0.2] * 3, ry=30))}'
                     f'{sph_bsdf}</shape>')
    if lit:
        parts += [
            '  <emitter type="point"><point name="position" x="-0.5" '
            'y="1.6" z="0.5"/><rgb name="intensity" value="1.5"/>'
            '</emitter>',
            '  <emitter type="spot"><transform name="toWorld"><lookat '
            'origin="0.6, 1.8, 0.8" target="0, 0, 0"/></transform><rgb '
            'name="intensity" value="4"/><float name="cutoffAngle" '
            'value="30"/></emitter>',
            '  <emitter type="directional"><vector name="direction" x="-0.2" '
            'y="-1" z="-0.3"/><rgb name="irradiance" value="0.8"/>'
            '</emitter>',
            '  <emitter type="sunsky"><integer name="resolution" value="64"/>'
            '<float name="sunScale" value="0.05"/><float name="scale" '
            'value="0.5"/></emitter>']
    else:
        parts.append('  <emitter type="envmap"><string name="filename" '
                     'value="env.exr"/><float name="scale" value="1.5"/>'
                     '</emitter>')
    parts.append("</scene>\n")
    path = os.path.join(dirname, "features_lit.xml" if lit
                        else "features.xml")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


# Phases 9 and 10's CPU render, run as a process of its own: cli.main on
# the CPU with the result of the renderer {fn} of render/{module}.py (the
# film's raw, sqr and weight columns and the pool) saved beside the image;
# six of the host's threads.
CPU_RENDER = """
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
torch.set_num_threads(6)
from sdmm_tpu_torch import cli
from sdmm_tpu_torch.render import {module} as wf
real, film = wf.{fn}, {{}}
def recording(*a, **k):
    film.update(real(*a, **k))
    return film
wf.{fn} = recording
cli.main(["render", {xml!r}, "-o", {npy!r}, *{args!r}, "--device", "cpu"])
np.savez({film!r}, **{{k: film[k] for k in ("raw", "sqr", "weight",
                                           "pool")}})
"""


def _film_mean(res):
    """A render_wavefront result's image mean and its standard error, from
    the film's sqr and weight columns."""
    w = np.maximum(res["weight"], 1.0)[..., None]
    mean = res["raw"] / w
    var = np.maximum(res["sqr"] / w - mean * mean, 0.0) / w
    return float(mean.mean()), float(np.sqrt(var.mean() / mean.size))


def phase_features(dev, smi, width=640, height=360, spp_b=16):
    """Phase 9: materials and lights on the card. Scene A (features.xml:
    every BSDF type a scene file names, bitmap and procedural textures, the
    ceiling light and an EXR env map) and scene B (features_lit.xml: A with
    bump maps, point, spot and directional lights, sunsky) are written to a
    temporary directory, loaded and built on the card; both must fail both
    fused gates. cli.main renders A with sdmm and gt at 64 spp and B with gt
    at ``spp_b``, every kernel's launches read around each call: the path
    row must take the eager pool, the frozen tail no fused guided pool;
    trace, shade, step and bounce must not launch, guided_sample, the
    E-step and clas_cull must in the sdmm call, and clas_cull's closest-hit
    and any-hit forms in both gt calls. A's sdmm image mean must lie within
    5% of its gt mean, every image be finite, and B's gt render at 64x36,
    16 spp, on the card and on the CPU agree in mean within 4 standard
    errors."""
    import tempfile

    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.guiding import trainer as tr
    from sdmm_tpu_torch.ops import clas_cull as ccull
    from sdmm_tpu_torch.render import wavefront as wf
    from sdmm_tpu_torch.render.guided import guided_fused_supported
    from sdmm_tpu_torch.scene.xml_loader import load_scene

    report = {"card": smi, "seconds": {}, "launches": {}, "pool": {}}
    sec = report["seconds"]
    renders = []
    real_rw, real_any, real_fused = (wf.render_wavefront, ccull.any_hit,
                                     tr.render_pool_guided_fused)
    any_hits = [0]

    def recording_rw(*a, **k):
        renders.append(real_rw(*a, **k))
        return renders[-1]

    def counting_any(ro, *a, **k):
        any_hits[0] += int(ro.device.type == "cuda" and ro.shape[0] > 0)
        return real_any(ro, *a, **k)

    def no_fused(*a, **k):
        raise AssertionError("the frozen tail took the fused guided pool")

    wf.render_wavefront, ccull.any_hit = recording_rw, counting_any
    tr.render_pool_guided_fused = no_fused
    cpu_run = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths = {"A": write_features_xml(tmp, width, height, 64),
                     "B": write_features_xml(tmp, width, height, spp_b,
                                             lit=True)}
            # B's small render on the CPU runs in a process of its own
            # while the card renders.
            small = ["--width", "64", "--height", "36", "--spp", "16",
                     "--integrator", "gt"]
            cpu_film = os.path.join(tmp, "small_cpu.npz")
            cpu_run = subprocess.Popen(
                [sys.executable, "-c", CPU_RENDER.format(
                    module="wavefront", fn="render_wavefront", root=ROOT,
                    xml=paths["B"], film=cpu_film,
                    npy=os.path.join(tmp, "small_cpu.npy"), args=small)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            t_cpu = time.time()
            for name, path in paths.items():
                t0 = time.time()
                builder = load_scene(path)
                sec[f"load_{name}"] = time.time() - t0
                t0 = time.time()
                scene, cfg = builder.build(device=dev)
                torch.cuda.synchronize()
                sec[f"build_{name}"] = time.time() - t0
                gs = tr.SDMMTrainer(scene, cfg, tr.TrainerConfig(),
                                    device=dev).guide_state()
                check(scene.tri_v0.shape[0] > 1024, f"scene {name}: "
                      "triangle count at or below the dense sweep's")
                check(not wf.fused_supported(scene, cfg)
                      and not guided_fused_supported(scene, cfg, gs),
                      f"scene {name}: a fused gate takes it")
                print(f"features: scene {name} {scene.tri_v0.shape[0]} "
                      f"triangles, BSDF types {cfg.bsdf_types}, bump "
                      f"{cfg.has_bump}, {scene.pt_pos.shape[0]} delta "
                      f"lights, env map {tuple(scene.env_map.shape)}; both "
                      "fused gates refuse it", flush=True)

            counters = _counts()
            runs = (("sdmm_A", "A", ["--integrator", "sdmm", "--spp", "64"]),
                    ("gt_A", "A", ["--integrator", "gt", "--spp", "64"]),
                    ("gt_B", "B", ["--integrator", "gt", "--spp",
                                   str(spp_b)]))
            means = {}
            for name, scene_name, args in runs:
                out = os.path.join(tmp, name, "image.npy")
                for fn in counters.values():
                    fn.launches = 0
                any_hits[0] = 0
                del renders[:]
                torch.cuda.synchronize()
                t0 = time.time()
                check(cli.main(["render", paths[scene_name], "-o", out,
                                *args]) is None,
                      f"cli {name}: non-zero return")
                torch.cuda.synchronize()
                sec[f"cli_{name}"] = time.time() - t0
                la = {k: fn.launches for k, fn in counters.items()}
                la["clas_cull_any_hit"] = any_hits[0]
                report["launches"][name] = la
                img = np.load(out)
                check(img.shape == (height, width, 3)
                      and np.isfinite(img).all(),
                      f"cli {name}: image not finite or misshapen")
                means[name] = float(img.mean())
                for k in ("trace", "shade", "step", "bounce"):
                    check(la[k] == 0, f"cli {name}: {k} was launched")
                need = (("guided_sample", "em_suffstats", "clas_cull")
                        if name.startswith("sdmm") else ("clas_cull",))
                for k in need:
                    check(la[k] > 0, f"cli {name}: {k} was not launched")
                if name.startswith("gt"):
                    report["pool"][name] = [r["pool"] for r in renders]
                    check(report["pool"][name] == ["eager"],
                          f"cli {name}: the path row took "
                          f"{report['pool'][name]}")
                    check(0 < la["clas_cull_any_hit"] < la["clas_cull"],
                          f"cli {name}: clas_cull's closest-hit and any-hit "
                          "forms did not both launch")
                print(f"features: cli {name}: {sec[f'cli_{name}']:.3f} s, "
                      f"image mean {means[name]:.5f}, launches {la}",
                      flush=True)
            rel = abs(means["sdmm_A"] - means["gt_A"]) / means["gt_A"]
            report["sdmm_vs_gt_rel"] = rel
            check(rel < 0.05, f"scene A: the sdmm image mean "
                  f"{means['sdmm_A']:.5f} is not within 5% of the gt mean "
                  f"{means['gt_A']:.5f}")

            del renders[:]
            t0 = time.time()
            cli.main(["render", paths["B"], "-o",
                      os.path.join(tmp, "small_cuda.npy"), *small])
            sec["cli_gt_B_64x36_cuda"] = time.time() - t0
            out, err = cpu_run.communicate(timeout=600)
            sec["cli_gt_B_64x36_cpu_process"] = time.time() - t_cpu
            check(cpu_run.returncode == 0, "scene B at 64x36 on the CPU: "
                  f"the render failed: {err[-2000:]}")
            films = {"cuda": renders[0], "cpu": dict(np.load(cpu_film))}
            stats = {}
            for where, film in films.items():
                check(str(film["pool"]) == "eager"
                      and (film["weight"] == 16).all()
                      and np.isfinite(film["raw"]).all(),
                      f"scene B at 64x36 on {where}: film")
                stats[where] = _film_mean(film)
            (m_c, se_c), (m_h, se_h) = stats["cuda"], stats["cpu"]
            z = abs(m_c - m_h) / np.hypot(se_c, se_h)
            report["card_vs_cpu"] = {"card": stats["cuda"],
                                     "cpu": stats["cpu"], "z": z}
            check(z < 4.0, f"scene B at 64x36: the card's mean {m_c:.5f} "
                  f"and the CPU's {m_h:.5f} differ by {z:.2f} standard "
                  "errors")
    finally:
        wf.render_wavefront, ccull.any_hit = real_rw, real_any
        tr.render_pool_guided_fused = real_fused
        if cpu_run is not None and cpu_run.poll() is None:
            cpu_run.kill()
            cpu_run.wait()
    print("features:", json.dumps(report), flush=True)


MEDIA_SPHERE = ([0.0, 1.2, 0.3], 0.3)  # centre, radius


def write_media_xml(dirname, width, height, spp, strip=False):
    """Phase 10's scene M as media.xml in ``dirname``: the Cornell box of
    write_cornell_xml filled with a homogeneous scene-level fog (sigma_t
    0.5, a mean free path of the box's size; albedo 0.8, g 0.3), a default
    sphere (make_sphere's tessellation: the scene passes 1,024 triangles)
    of dielectric whose interior is heterogeneous, from a 64³ .vol grid
    (volume.save_vol: smooth density in [0, 1] over the sphere's bounds,
    sigma_t 4, albedo 0.9, g -0.2), and the short block with a dipole
    subsurface model of the skin1 preset at scale 0.05 (a mean free path
    of ~0.25 box units) and 4 irradiance samples a bake point. ``strip``
    writes media_stripped.xml: the same scene without the fog, the
    sphere's medium and the dipole. Returns the file's path."""
    from sdmm_tpu_torch.scene.volume import save_vol

    c, r = MEDIA_SPHERE
    z, y, x = np.mgrid[0:64, 0:64, 0:64] / 63.0
    dens = 0.5 + 0.5 * np.sin(6.0 * x) * np.cos(5.0 * y) * np.sin(4.0 * z
                                                                  + 1.0)
    save_vol(os.path.join(dirname, "density.vol"), dens,
             np.asarray(c) - r, np.asarray(c) + r)
    name = "media_stripped.xml" if strip else "media.xml"
    path = os.path.join(dirname, name)
    write_cornell_xml(path, width, height, spp)
    with open(path) as f:
        text = f.read()
    short = _digits(cornell_blocks()[1])
    medium = ('' if strip else
              '<medium type="heterogeneous" name="interior"><volume '
              'name="density" type="gridvolume"><string name="filename" '
              'value="density.vol"/></volume><float name="scale" value="4"/>'
              '<rgb name="albedo" value="0.9"/><phase type="hg"><float '
              'name="g" value="-0.2"/></phase></medium>')
    extra = [f'  <shape type="sphere"><point name="center" x="{c[0]}" '
             f'y="{c[1]}" z="{c[2]}"/><float name="radius" value="{r}"/>'
             f'<bsdf type="dielectric"><float name="intIOR" value="1.33"/>'
             f'</bsdf>{medium}</shape>']
    if not strip:
        extra.append('  <medium type="homogeneous" id="fog"><rgb '
                     'name="sigmaT" value="0.5"/><rgb name="albedo" '
                     'value="0.8"/><phase type="hg"><float name="g" '
                     'value="0.3"/></phase></medium>')
        block = f'<matrix value="{short}"/></transform><ref id="white"/>'
        check(text.count(block) == 1, "media.xml: the short block")
        text = text.replace(block, block + '<subsurface type="dipole">'
                            '<string name="material" value="skin1"/><float '
                            'name="scale" value="0.05"/><integer '
                            'name="irrSamples" value="4"/></subsurface>')
    text = text.replace("</scene>", "\n".join(extra) + "\n</scene>")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_media(dev, smi, width=640, height=360):
    """Phase 10: participating media, subsurface scattering, samplers and
    rfilters on the card. write_media_xml writes scene M (media.xml: fog,
    a grid-density medium inside a dielectric sphere, a dipole block; >
    1,024 triangles, so every ray goes through clas_cull) and its stripped
    twin to a temporary directory; M must fail both fused gates. cli.main
    renders M with gt at 16 spp (renderer.render: trace_wave) and sdmm at
    32 spp (training on the media guided pool, the frozen tail on the eager
    guided pool), the stripped scene with gt at 16 spp, and M at 64x36, 4
    spp, on the card and on the CPU (a process of its own, started at the
    phase's top); SDMMTrainer(pooled_training=False) trains two iterations
    on M through the scan tracer. On the Cornell box alone (mt_sweep)
    cli.main gt runs at 8 spp under every sampler and rfilter. Every
    E-step of the phase runs under EmCensus. Checks: the sdmm mean within
    5% of gt's, the stripped gt mean more than 10% away from M's, the
    64x36 card and CPU means within 4 standard errors, the scan-trained
    image within 5% of gt, each sampler's and rfilter's box mean within 3%
    of the independent/box one, no NaN in the E-step's stats_w;
    guided_sample, the E-step and clas_cull launch on M, mt_sweep on the
    box, and trace, shade, step and bounce never on M. One "media:" JSON
    line prints each call's wall seconds and launches, the means and the
    card's name and power limit."""
    import tempfile

    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.guiding import trainer as tr
    from sdmm_tpu_torch.render import renderer as rmod
    from sdmm_tpu_torch.render import wavefront as wf
    from sdmm_tpu_torch.render.guided import guided_fused_supported
    from sdmm_tpu_torch.scene.xml_loader import load_scene

    t_phase = time.time()
    report = {"card": smi, "seconds": {}, "launches": {}, "means": {}}
    sec, means = report["seconds"], report["means"]
    films = []
    real_render = rmod.render

    def recording(*a, **k):
        films.append(real_render(*a, **k))
        return films[-1]

    rmod.render = recording
    counters = _counts()
    cpu_run = None
    try:
        with tempfile.TemporaryDirectory() as tmp, EmCensus() as census:
            path = write_media_xml(tmp, width, height, 16)
            stripped = write_media_xml(tmp, width, height, 16, strip=True)
            box = os.path.join(tmp, "box.xml")
            write_cornell_xml(box, width, height, 8)
            small = ["--width", "64", "--height", "36", "--spp", "4",
                     "--integrator", "gt"]
            cpu_film = os.path.join(tmp, "small_cpu.npz")
            cpu_run = subprocess.Popen(
                [sys.executable, "-c", CPU_RENDER.format(
                    module="renderer", fn="render", root=ROOT, xml=path,
                    film=cpu_film,
                    npy=os.path.join(tmp, "small_cpu.npy"), args=small)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            t_cpu = time.time()
            scene, cfg = load_scene(path).build(device=dev)
            gs = tr.SDMMTrainer(scene, cfg, tr.TrainerConfig(),
                                device=dev).guide_state()
            check(scene.tri_v0.shape[0] > 1024 and cfg.has_medium
                  and cfg.has_hetero and cfg.has_sss,
                  "scene M: triangles, media or dipole missing")
            check(not wf.fused_supported(scene, cfg)
                  and not guided_fused_supported(scene, cfg, gs),
                  "scene M: a fused gate takes it")
            print(f"media: scene M {scene.tri_v0.shape[0]} triangles, "
                  f"{scene.med_sigma_t.shape[0]} media rows, volumes "
                  f"{tuple(scene.volumes.shape)}; both fused gates refuse it",
                  flush=True)

            def run(name, xml, args):
                out = os.path.join(tmp, name, "image.npy")
                for fn in counters.values():
                    fn.launches = 0
                del films[:]
                torch.cuda.synchronize()
                t0 = time.time()
                check(cli.main(["render", xml, "-o", out, *args]) is None,
                      f"cli {name}: non-zero return")
                torch.cuda.synchronize()
                sec[name] = time.time() - t0
                la = {k: fn.launches for k, fn in counters.items()}
                report["launches"][name] = la
                img = np.load(out)
                check(np.isfinite(img).all() and img.shape[2] == 3,
                      f"cli {name}: image not finite or misshapen")
                means[name] = float(img.mean())
                print(f"media: cli {name}: {sec[name]:.3f} s, mean "
                      f"{means[name]:.5f}, launches {la}", flush=True)
                return la

            for name, args in (("gt_M", ["--integrator", "gt", "--spp", "16"]),
                               ("sdmm_M", ["--integrator", "sdmm", "--spp",
                                           "32"])):
                la = run(name, path, args)
                for k in ("trace", "shade", "step", "bounce"):
                    check(la[k] == 0, f"cli {name}: {k} was launched")
                need = (("guided_sample", "em_suffstats", "clas_cull")
                        if name.startswith("sdmm") else ("clas_cull",))
                for k in need:
                    check(la[k] > 0, f"cli {name}: {k} was not launched")
            check(len(films) == 0, "sdmm on M reached the wave renderer")
            rel = abs(means["sdmm_M"] - means["gt_M"]) / means["gt_M"]
            report["sdmm_vs_gt_rel"] = rel
            check(rel < 0.05, f"scene M: the sdmm mean {means['sdmm_M']:.5f}"
                  f" is not within 5% of gt's {means['gt_M']:.5f}")
            run("gt_stripped", stripped, ["--integrator", "gt", "--spp",
                                          "16"])
            rel_s = abs(means["gt_stripped"] - means["gt_M"]) / means["gt_M"]
            report["stripped_vs_gt_rel"] = rel_s
            check(rel_s > 0.10, "scene M: stripping the media moved the gt "
                  f"mean by only {rel_s:.4f}")

            # Two training iterations on the scan tracer.
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            st = tr.SDMMTrainer(scene, cfg, tr.TrainerConfig(
                pooled_training=False, train_fraction=1.0), device=dev)
            img, iters = st.run(total_spp=8)
            torch.cuda.synchronize()
            sec["scan_training_M"] = time.time() - t0
            la = {k: fn.launches for k, fn in counters.items()}
            report["launches"]["scan_training_M"] = la
            means["scan_training_M"] = float(img.mean())
            rel_t = abs(means["scan_training_M"] - means["gt_M"]) \
                / means["gt_M"]
            print(f"media: scan training, 2 iterations at 4 spp: "
                  f"{sec['scan_training_M']:.3f} s, mean "
                  f"{means['scan_training_M']:.5f} (rel {rel_t:.4f}), "
                  f"launches {la}", flush=True)
            check(len(iters) == 2 and all(
                s["optimized_nodes_count"] > 0 for s in st.stats),
                "scan training: not two optimized iterations")
            check(np.isfinite(img).all() and rel_t < 0.05,
                  "scan training: the image mean is not within 5% of gt's")
            check(la["guided_sample"] > 0 and la["em_suffstats"] > 0,
                  "scan training: guided_sample or the E-step not launched")

            # Every sampler and rfilter on the box alone.
            run("box_independent_box", box, ["--integrator", "gt",
                                             "--spp", "8"])
            report["box_rel"] = {}
            for opt in (["--sampler", "stratified"], ["--sampler", "halton"],
                        ["--sampler", "sobol"], ["--rfilter", "tent"],
                        ["--rfilter", "gaussian"], ["--rfilter", "mitchell"],
                        ["--rfilter", "catmullrom"],
                        ["--rfilter", "lanczos"]):
                name = f"box_{opt[1]}"
                la = run(name, box, ["--integrator", "gt", "--spp", "8",
                                     *opt])
                check(len(films) == 1 and la["mt_sweep"] > 0,
                      f"cli {name}: not the wave renderer on mt_sweep")
                rel_b = abs(means[name] - means["box_independent_box"]) \
                    / means["box_independent_box"]
                report["box_rel"][name] = rel_b
                check(rel_b < 0.03, f"cli {name}: mean {means[name]:.5f} not "
                      "within 3% of the independent/box mean "
                      f"{means['box_independent_box']:.5f}")

            del films[:]
            t0 = time.time()
            cli.main(["render", path, "-o",
                      os.path.join(tmp, "small_cuda.npy"), *small])
            sec["gt_M_64x36_cuda"] = time.time() - t0
            small_card = dict(films[0])
            out, err = cpu_run.communicate(timeout=900)
            sec["gt_M_64x36_cpu_process"] = time.time() - t_cpu
            check(cpu_run.returncode == 0, "scene M at 64x36 on the CPU: "
                  f"the render failed: {err[-2000:]}")
            stats = {}
            for where, film in (("cuda", small_card),
                                ("cpu", dict(np.load(cpu_film)))):
                check((film["weight"] == 4).all()
                      and np.isfinite(film["raw"]).all(),
                      f"scene M at 64x36 on {where}: film")
                stats[where] = _film_mean(film)
            (m_c, se_c), (m_h, se_h) = stats["cuda"], stats["cpu"]
            z = abs(m_c - m_h) / np.hypot(se_c, se_h)
            report["card_vs_cpu"] = {"card": stats["cuda"],
                                     "cpu": stats["cpu"], "z": z}
            check(z < 4.0, f"scene M at 64x36: the card's mean {m_c:.5f} "
                  f"and the CPU's {m_h:.5f} differ by {z:.2f} standard "
                  "errors")
        report["em_census"] = census.totals
        check(census.totals["calls"] > 0
              and census.totals["nan_stats_w"] == 0,
              f"phase 10: E-step census {census.totals}")
    finally:
        rmod.render = real_render
        if cpu_run is not None and cpu_run.poll() is None:
            cpu_run.kill()
            cpu_run.wait()
    sec["phase"] = time.time() - t_phase
    print("media:", json.dumps(report), flush=True)


RESUME_AT = 52  # spp of the interrupted run in phase 11 (c); see there


def _resume_diff(a, b):
    """The largest |a - b| / (1e-6 + 1e-5·|b|): at most 1 where a lies
    within rtol 1e-5 / atol 1e-6 of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1e-6 + 1e-5 * np.abs(b))).max())


def phase_guiding_extras(dev, smi, width=640, height=360):
    """Phase 11: the guiding extras on the card, on phase 8's cornell.xml
    (written to a temporary directory) at 640x360, depth 10, every E-step
    under EmCensus. cli.main renders gt at 64 spp, the reference mean of
    every check. (a) --integrator ppg at 64 spp: PPGTrainer's
    budget-doubling iterations (1, 2, ..., 32, 1 spp; mt_sweep on every
    bounce); each iteration's spp, seconds and leaf count printed. (b) sdmm
    at 64 spp with -D reservoirCapacity=2000000 -D optimizeAsync=true: the
    EM fits the reservoir (guided_sample, the E-step). (c) resume: sdmm to
    RESUME_AT spp with --checkpoint, then --resume to 64 spp, against two
    uninterrupted 64-spp runs. RESUME_AT is 52, not 32: train_fraction
    applies to each call's own budget, so a 32-spp call trains until 8 spp
    where the 64-spp run trains until 16; from 52 spp on (training while
    total < 13: iterations 0, 4, 8, 12) both calls make the same training
    decisions. (d) SDMMTrainer(TrainerConfig(sample_product=True,
    tail_chunk_spp=16)) on the four-type box (cornell_box(...,
    extra_bsdfs=True)) at 64 spp against render_wavefront gt at 64 spp;
    the learned table's fit seconds printed. (e) TrainerConfig(data_init=
    True) on the Cornell box at 32 spp; the reseeded leaves printed.
    Checks: (a), (b), (d), (e) within 5% of their gt mean; mt_sweep in (a),
    guided_sample and the E-step in (b), no NaN in stats_w; (c) each
    iteration's image and the final image within rtol 1e-5 / atol 1e-6 of
    the first uninterrupted run or, if the two uninterrupted runs differ
    by more, within their difference; (d) the product share of guided
    lanes > 0, guided_sample never launched, the E-step launched, the
    fused guided pool never taken. One "guiding_extras:" JSON line prints
    each call's wall seconds and launches and the card's name and power
    limit."""
    import tempfile

    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.guiding import trainer as tr
    from sdmm_tpu_torch.render import wavefront as wf

    t_phase = time.time()
    report = {"card": smi, "seconds": {}, "launches": {}, "means": {}}
    sec, means, launches = (report["seconds"], report["means"],
                            report["launches"])
    counters = _counts()

    def timed(name, fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        sec[name] = time.time() - t0
        launches[name] = {k: c.launches for k, c in counters.items()}
        return out

    def within(name, ref):
        rel = abs(means[name] - means[ref]) / means[ref]
        report.setdefault("rel", {})[name] = rel
        check(rel < 0.05, f"guiding extras: {name}'s mean {means[name]:.5f}"
              f" is not within 5% of {ref}'s {means[ref]:.5f}")
        return rel

    with tempfile.TemporaryDirectory() as tmp, EmCensus() as census:
        box = os.path.join(tmp, "cornell.xml")
        write_cornell_xml(box, width, height, 64)

        def run(name, *args):
            out = os.path.join(tmp, name, "image.npy")
            timed(name, lambda: check(
                cli.main(["render", box, "-o", out, *args]) is None,
                f"cli {name}: non-zero return"))
            img = np.load(out)
            check(np.isfinite(img).all() and img.shape == (height, width, 3),
                  f"cli {name}: image not finite or misshapen")
            means[name] = float(img.mean())
            print(f"guiding extras: cli {name}: {sec[name]:.3f} s, mean "
                  f"{means[name]:.5f}, launches {launches[name]}",
                  flush=True)
            return img, os.path.dirname(out)

        run("gt", "--integrator", "gt", "--spp", "64")

        # (a) PPG.
        _, d = run("ppg", "--integrator", "ppg", "--spp", "64")
        with open(os.path.join(d, "stats.json")) as f:
            ppg_stats = json.load(f)
        for st in ppg_stats:
            print(f"guiding extras: ppg iteration {st['iteration']}: "
                  f"{st['spp']} spp, {st['seconds']:.3f} s, "
                  f"{st['leaf_nodes_count']} leaves", flush=True)
        report["ppg_iterations"] = ppg_stats
        check([st["spp"] for st in ppg_stats] == [1, 2, 4, 8, 16, 32, 1],
              "ppg: not the budget-doubling iterations")
        within("ppg", "gt")
        check(launches["ppg"]["mt_sweep"] > 0, "ppg: mt_sweep not launched")

        # (b) The reservoir and the asynchronous EM.
        n_census = census.totals["calls"]
        run("sdmm_reservoir_async", "--integrator", "sdmm", "--spp", "64",
            "-D", "reservoirCapacity=2000000", "-D", "optimizeAsync=true")
        within("sdmm_reservoir_async", "gt")
        la = launches["sdmm_reservoir_async"]
        check(la["guided_sample"] > 0 and la["em_suffstats"] > 0,
              "reservoir + async: guided_sample or the E-step not launched")
        check(census.totals["calls"] > n_census
              and census.totals["nan_stats_w"] == 0,
              f"reservoir + async: E-step census {census.totals}")

        # (c) Resume.
        ck = {k: os.path.join(tmp, f"{k}.npz")
              for k in ("full1", "full2", "part", "resumed")}
        finals = {}
        for name in ("full1", "full2"):
            finals[name], _ = run(f"sdmm_{name}", "--integrator", "sdmm",
                                  "--spp", "64", "--checkpoint", ck[name])
        run("sdmm_part", "--integrator", "sdmm", "--spp", str(RESUME_AT),
            "--checkpoint", ck["part"])
        finals["resumed"], _ = run(
            "sdmm_resumed", "--integrator", "sdmm", "--spp", "64",
            "--resume", ck["part"], "--checkpoint", ck["resumed"])
        films = {k: np.load(ck[k])["it_image"]
                 for k in ("full1", "full2", "resumed")}
        check(films["resumed"].shape == films["full1"].shape,
              "resume: not the uninterrupted run's iterations")
        d_two = max(_resume_diff(films["full2"], films["full1"]),
                    _resume_diff(finals["full2"], finals["full1"]))
        d_res = max(_resume_diff(films["resumed"], films["full1"]),
                    _resume_diff(finals["resumed"], finals["full1"]))
        report["resume"] = {"resumed_vs_full1": d_res,
                            "full2_vs_full1": d_two,
                            "iterations": int(films["full1"].shape[0])}
        print(f"guiding extras: resume: the resumed run against the first "
              f"uninterrupted one {d_res:.4g}, the two uninterrupted runs "
              f"{d_two:.4g} (in units of 1e-6 + 1e-5 |x|)", flush=True)
        check(d_res <= max(1.0, d_two), "resume: the resumed run differs "
              f"from the uninterrupted one by {d_res:.4g} (the two "
              f"uninterrupted runs by {d_two:.4g})")

        # (d) Product sampling on the four-type box.
        scene4, cfg4 = cornell_box(width, height, dev, extra_bsdfs=True)
        ref4 = timed("gt_four_type", lambda: wf.render_wavefront(
            scene4, cfg4, spp=64, seed=5, device=dev))
        means["gt_four_type"] = float(np.asarray(ref4["image"]).mean())
        pools, fused = [], []
        real_pool, real_fused = tr.render_pool_guided, \
            tr.render_pool_guided_fused

        def pool(*a, **k):
            pools.append(real_pool(*a, **k))
            return pools[-1]

        tr.render_pool_guided = pool
        tr.render_pool_guided_fused = lambda *a, **k: fused.append(1) \
            or real_fused(*a, **k)
        try:
            ptr = tr.SDMMTrainer(scene4, cfg4, tr.TrainerConfig(
                sample_product=True, tail_chunk_spp=16), device=dev)
            img, _ = timed("product", lambda: ptr.run(total_spp=64))
        finally:
            tr.render_pool_guided = real_pool
            tr.render_pool_guided_fused = real_fused
        means["product"] = float(img.mean())
        n_prod = sum(int(o["n_product"]) for o in pools)
        n_ok = sum(int(o["n_cond_ok"]) for o in pools)
        report["product"] = {"fit_seconds": ptr.learned_seconds,
                             "product_lanes": n_prod,
                             "valid_conditionals": n_ok,
                             "share": n_prod / max(1, n_ok)}
        print(f"guiding extras: product: the learned table fitted in "
              f"{ptr.learned_seconds:.3f} s; {sec['product']:.3f} s, mean "
              f"{means['product']:.5f} (gt {means['gt_four_type']:.5f}), "
              f"product lanes {n_prod} of {n_ok} valid conditionals, "
              f"launches {launches['product']}", flush=True)
        within("product", "gt_four_type")
        check(n_prod > 0, "product: no lane sampled the product")
        check(not fused and launches["product"]["trace"] == 0,
              "product: the fused guided pool ran")
        check(launches["product"]["guided_sample"] == 0
              and launches["product"]["em_suffstats"] > 0,
              "product: guided_sample launched or the E-step did not")

        # (e) Data init.
        scene, cfg = cornell_box(width, height, dev)
        dtr = tr.SDMMTrainer(scene, cfg, tr.TrainerConfig(data_init=True),
                             device=dev)
        img, _ = timed("data_init", lambda: dtr.run(total_spp=32))
        means["data_init"] = float(img.mean())
        report["reseeded_leaves"] = dtr.reseeded_leaves
        print(f"guiding extras: data init: {sec['data_init']:.3f} s, mean "
              f"{means['data_init']:.5f}, {dtr.reseeded_leaves} leaves "
              f"reseeded, launches {launches['data_init']}", flush=True)
        within("data_init", "gt")
        check(dtr.reseeded_leaves > 0, "data init: no leaf was reseeded")
    report["em_census"] = census.totals
    check(census.totals["nan_stats_w"] == 0,
          f"phase 11: E-step census {census.totals}")
    sec["phase"] = time.time() - t_phase
    print("guiding_extras:", json.dumps(report), flush=True)

# Phase 12's scene G: where the cloth, the hair tuft and the animated cube
# sit, and the cube's keyframed translation (time 0 to 1).
CLOTH_TO_WORLD = compose([0.35, 1.25, -0.98], [0.3, 0.3, 1.0])
HAIR_BOX = ((-0.75, -0.15), (1.15, 1.55), (-0.2, 0.4))  # x, top y, z
# make_cube winds its +y and -y faces inward, as the reference's does: the
# camera (at height 1) sees neither face of a cube centred at its height.
CUBE_AT = [0.55, 1.0, 0.45]
CUBE_SCALE = 0.1
CUBE_MOVE = [0.12, 0.05, 0.0]


def write_hair(path, n_fibers, n_segments, seed=3):
    """``n_fibers`` fibers of ``n_segments`` segments in the hair text
    format (one vertex a line, a blank line between fibers), hanging
    0.5 down from the top of HAIR_BOX in a helix that turns 20 degrees a
    segment, so that no vertex is dropped by the angle threshold."""
    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1), (z0, z1) = HAIR_BOX
    lines = []
    k = np.arange(n_segments + 1)
    for _ in range(n_fibers):
        root = np.array([rng.uniform(x0, x1), rng.uniform(y0, y1),
                         rng.uniform(z0, z1)])
        phase = rng.uniform(0.0, 2.0 * np.pi)
        ang = phase + np.deg2rad(20.0) * k
        pts = np.stack([root[0] + 0.02 * np.cos(ang),
                        root[1] - 0.5 * k / n_segments,
                        root[2] + 0.02 * np.sin(ang)], -1)
        lines += ["%.9g %.9g %.9g" % tuple(p) for p in pts]
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_geometry_xml(dirname, width, height, spp, n_fibers=1024,
                       n_segments=16, hf_res=257):
    """Phase 12's scene G as geometry.xml in ``dirname``: the Cornell box
    of write_cornell_xml without its blocks (a visible cube top faces
    inward, see CUBE_AT) with a heightfield floor (an hf_res² EXR height
    map written by utils/exr.py, 2·(hf_res − 1)² triangles, bumps of up
    to 0.04), a hair tuft (hair.txt from write_hair, radius 0.004:
    8·n_segments triangles a fiber), an Irawan cloth rectangle with the
    built-in plain weave on the back wall, and a small cube with a
    two-keyframe <animation> translation by CUBE_MOVE. Returns the
    file's path."""
    from sdmm_tpu_torch.utils.exr import write_exr

    y, x = np.mgrid[0:hf_res, 0:hf_res] / (hf_res - 1.0)
    height_map = 0.5 + 0.5 * np.sin(9.0 * x) * np.cos(7.0 * y)
    write_exr(os.path.join(dirname, "height.exr"),
              np.repeat(height_map[..., None], 3, -1).astype(np.float32))
    write_hair(os.path.join(dirname, "hair.txt"), n_fibers, n_segments)
    path = os.path.join(dirname, "geometry.xml")
    write_cornell_xml(path, width, height, spp, blocks=False)
    with open(path) as f:
        text = f.read()
    floor = compose([0.0, 0.002, 0.0], [0.99, 0.99, 0.04], rx=-90)
    cube0 = compose(CUBE_AT, [CUBE_SCALE] * 3)
    cube1 = compose(np.add(CUBE_AT, CUBE_MOVE), [CUBE_SCALE] * 3)
    extra = [
        '  <shape type="heightfield"><string name="filename" '
        'value="height.exr"/><transform name="toWorld"><matrix value="'
        f'{_digits(floor)}"/></transform><bsdf type="diffuse"><rgb '
        'name="reflectance" value="0.55, 0.5, 0.45"/></bsdf></shape>',
        '  <shape type="hair"><string name="filename" value="hair.txt"/>'
        '<float name="radius" value="0.004"/><bsdf type="diffuse"><rgb '
        'name="reflectance" value="0.35, 0.2, 0.1"/></bsdf></shape>',
        '  <shape type="rectangle"><transform name="toWorld"><matrix '
        f'value="{_digits(CLOTH_TO_WORLD)}"/></transform><bsdf '
        'type="irawan"><float name="repeatU" value="12"/><float '
        'name="repeatV" value="12"/></bsdf></shape>',
        '  <shape type="cube"><animation name="toWorld"><transform '
        f'time="0"><matrix value="{_digits(cube0)}"/></transform>'
        f'<transform time="1"><matrix value="{_digits(cube1)}"/>'
        '</transform></animation><ref id="white"/></shape>']
    text = text.replace("</scene>", "\n".join(extra) + "\n</scene>")
    with open(path, "w") as f:
        f.write(text)
    return path


def write_cornell_dae(path):
    """The Cornell box's walls and blocks (cornell_box's triangles, light
    aside) as a COLLADA file: one geometry a shape with POSITION and
    NORMAL inputs at 17 digits, a lambert effect a material, each bound
    to its instance. Returns [(material, verts [F, 3, 3], normals)]."""
    from sdmm_tpu_torch.scene import shapes

    parts = [(name, shapes.make_rectangle(tw).concat())
             for tw, name, emissive in cornell_rects() if not emissive]
    parts += [("white", shapes.make_cube(tw).concat())
              for tw in cornell_blocks()]
    geoms, nodes = [], []
    for i, (mat, (v, n, _, _)) in enumerate(parts):
        k = len(v) * 3
        geoms.append(
            f'<geometry id="g{i}" name="shape{i}"><mesh>'
            f'<source id="p{i}"><float_array count="{k * 3}">{_digits(v)}'
            '</float_array><technique_common><accessor stride="3"/>'
            f'</technique_common></source><source id="n{i}"><float_array '
            f'count="{k * 3}">{_digits(n)}</float_array><technique_common>'
            '<accessor stride="3"/></technique_common></source>'
            f'<vertices id="v{i}"><input semantic="POSITION" source="#p{i}"/>'
            f'</vertices><triangles count="{len(v)}" material="m"><input '
            f'semantic="VERTEX" source="#v{i}" offset="0"/><input '
            f'semantic="NORMAL" source="#n{i}" offset="0"/><p>'
            + " ".join(str(j) for j in range(k)) + '</p></triangles>'
            '</mesh></geometry>')
        nodes.append(
            f'<node><instance_geometry url="#g{i}"><bind_material>'
            f'<technique_common><instance_material symbol="m" target='
            f'"#{mat}"/></technique_common></bind_material>'
            '</instance_geometry></node>')
    albedo = dict(CORNELL_BSDFS)
    effects = "".join(
        f'<effect id="{m}-fx"><profile_COMMON><technique sid="t"><lambert>'
        f'<diffuse><color>{_digits(albedo[m])} 1</color></diffuse>'
        '</lambert></technique></profile_COMMON></effect>'
        for m in ("white", "red", "green"))
    mats = "".join(f'<material id="{m}"><instance_effect url="#{m}-fx"/>'
                   '</material>' for m in ("white", "red", "green"))
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?><COLLADA xmlns="http://www.collada.'
                'org/2005/11/COLLADASchema" version="1.4.1"><asset><up_axis>'
                'Y_UP</up_axis></asset><library_effects>' + effects
                + '</library_effects><library_materials>' + mats
                + '</library_materials><library_geometries>'
                + "".join(geoms) + '</library_geometries>'
                '<library_visual_scenes><visual_scene id="s">'
                + "".join(nodes) + '</visual_scene></library_visual_scenes>'
                '</COLLADA>\n')


def _project_np(cam, tan_half, p, width, height):
    """World points -> pixel coordinates through the perspective camera
    (fov about x), in float64: the analytic side of the motion check."""
    v = (np.asarray(p, np.float64) - cam[:3, 3]) @ cam[:3, :3]
    tx, ty = tan_half, tan_half * height / width
    return np.stack([(1.0 - v[:, 0] / (v[:, 2] * tx)) * 0.5 * width,
                     (1.0 - v[:, 1] / (v[:, 2] * ty)) * 0.5 * height], -1)


# Irawan's card and CPU float32 evaluations may differ past their tolerance
# on at most this many of _irawan_check's 2^20 lanes (one H100: 2). Both
# lie within 1e-3 of the pole of their yarn spine's curvature, where an
# ulp of the cell coordinate moves f by a large share, and the two devices
# round the coordinate's products and trigonometry differently; in float64
# the card equals the CPU on every lane.
IRAWAN_OFF_LANES = 2


def _irawan_check(dev, scene, n=1 << 20):
    """Irawan on the card: eval_irawan on n random lanes against the CPU
    twin, in float64 on every lane (rtol 1e-5 / atol 1e-6) and in float32
    (the same, or on an ill-conditioned lane no further than twice the
    CPU's float32 error against float64: irawan.float32_disagreement) on
    all but IRAWAN_OFF_LANES lanes, each printed with its ulp sensitivity
    and its distance to the spine's pole; and the cosine sampling's weight
    against f / pdf (rtol 1e-5). Returns the report entry."""
    from sdmm_tpu_torch.bsdf import bsdf as tbsdf
    from sdmm_tpu_torch.bsdf import irawan

    g = torch.Generator().manual_seed(12)
    uv = torch.rand((n, 2), generator=g) * 24.0
    wi, wo = (torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g) * torch.tensor([1.0, 1.0, 0.5])
        + torch.tensor([0.0, 0.0, 0.6]), dim=-1) for _ in range(2))
    tabs = {k: v.cpu() for k, v in irawan.device_tables(scene).items()}
    out, ms = {}, {}
    for name, d, dt in (("cuda", dev, torch.float32),
                        ("cpu", "cpu", torch.float32),
                        ("cuda64", dev, torch.float64),
                        ("cpu64", "cpu", torch.float64)):
        t = {k: v.to(d) for k, v in tabs.items()}
        t = {k: v.to(dt) if v.is_floating_point() else v for k, v in t.items()}
        args = [x.to(d, dt) for x in (uv, wi, wo)]
        fn = lambda: irawan.eval_irawan(t, *args)  # noqa: E731
        ms[name] = time_ms(fn, reps=5) if name == "cuda" else None
        out[name] = fn().cpu().double().numpy()
    got, want, exact = out["cuda"], out["cpu"], out["cpu64"]
    off64 = (np.abs(out["cuda64"] - exact) > 1e-6 + 1e-5 * np.abs(exact))
    off, sens = irawan.lanes_off(tabs, uv, wi, wo, got, want, exact)
    ill = (np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)).any(-1).sum()
    margin = irawan.spine_pole_margin(
        {k: v.double() if v.is_floating_point() else v
         for k, v in tabs.items()}, uv[off].double()).numpy()
    for i, s_i, m_i in zip(off[:5], sens, margin):
        print(f"geometry/classic: irawan lane {i}: card {got[i]}, CPU "
              f"{want[i]}, float64 {exact[i]}, ulp sensitivity {s_i:.3g}, "
              f"spine pole margin {m_i:.3g}", flush=True)
    check(not off64.any(), f"irawan: {int(off64.any(-1).sum())} lanes on "
          "the card differ from the CPU twin in float64")
    check(len(off) <= IRAWAN_OFF_LANES, f"irawan: {len(off)} of {n} lanes "
          "on the card differ from the CPU twin in float32")
    # Cosine sampling: the weight is f / pdf at the sampled direction.
    types = (16,)
    idx = torch.full((n,), int(scene.bsdf_type.tolist().index(16)),
                     dtype=torch.int32, device=dev)
    p = tbsdf.gather_params(scene, idx, uv.to(dev), types=types)
    u = torch.rand((n, 4), generator=g).to(dev)
    bs = tbsdf.sample_full(p, wi.to(dev), u[:, 0], u[:, 1], u[:, 2:],
                           types=types)
    f, pdf = tbsdf.eval_pdf_full(p, wi.to(dev), bs["wo"], types=types)
    ok = pdf > 0
    w_err = float(((bs["weight"][ok] - f[ok] / pdf[ok, None]).abs()
                   / (f[ok] / pdf[ok, None]).abs().clamp_min(1e-30)).max())
    check(w_err <= 1e-5, f"irawan: sampling weight off f/pdf by {w_err:.3g}")
    rep = {"lanes": n, "max_abs_err": float(np.abs(got - want).max()),
           "max_abs_err_float64": float(np.abs(out["cuda64"] - exact).max()),
           "lanes_past_1e-5": int(ill), "lanes_off": len(off),
           "ms": ms["cuda"],
           "weight_rel_err": w_err}
    print(f"geometry/classic: irawan on the card: {rep}", flush=True)
    return rep


def phase_geometry_classic(dev, smi, width=640, height=360, n_fibers=1024,
                           hf_res=257):
    """Phase 12: the rest of scene loading and the classic integrators on the
    card, through cli.main at 640x360, depth 10. write_geometry_xml writes
    scene G (the Cornell box's walls and light, a 257² EXR heightfield
    floor, a hair tuft of 1,024 fibers of 16 segments, an Irawan cloth with
    the plain weave and a keyframed cube: 262,170 triangles, so clas_cull)
    into a temporary directory under build/. gt at 16 spp is the reference
    of every check; sdmm at 32 spp within 5% of it (the Irawan cloth keeps
    it on the eager pools: guided_sample and the E-step launch). direct at
    16 spp within 3% of gt at max depth 2, on G and on the Cornell box
    without its blocks (mt_sweep; a block's top faces inward, as in the
    reference, and gt's strict normals cull it where direct lights it). ao
    at 16 spp: every value in [0, 1]. field (shNormal, distance) at 4 spp
    through the CLI, and trace_field on 2,048 camera rays on the card equal
    to the CPU twin's on every hit ray within 1e-5. multichannel at 4 spp:
    four finite EXRs beside the output. adaptive with at most 64 spp (-D
    maxError=0.1) within 3% of gt and a mean spp below 64. motion at 1 spp:
    on the cube's pixels (field primIndex) the mean displacement within 1%
    of the analytic one (the pixel's field position moved by CUBE_MOVE,
    both projected in float64), every other pixel below 1e-4. Irawan on
    the card (_irawan_check, 2^20 lanes). COLLADA: python -m
    sdmm_tpu_torch import of write_cornell_dae's file, included by a scene
    with the camera and the light, builds the
    SceneData of the same meshes built in code, field for field, and gt at
    16 spp on both gives the same mean. Each call's wall, mean and launches
    of rows 1, 2, 7 and 8 print on its own line; one "geometry_classic:"
    JSON line sums them up with the card's name and power limit."""
    import tempfile

    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.render import classic
    from sdmm_tpu_torch.render.wavefront import render_wavefront
    from sdmm_tpu_torch.scene import shapes
    from sdmm_tpu_torch.scene.collada import load_dae
    from sdmm_tpu_torch.scene.scene import BSDF_DIFFUSE, SceneBuilder
    from sdmm_tpu_torch.scene.sensor import generate_rays
    from sdmm_tpu_torch.scene.xml_loader import load_scene
    from sdmm_tpu_torch.utils.exr import read_exr

    t_phase = time.time()
    rows = ("guided_sample", "em_suffstats", "mt_sweep", "clas_cull")
    report = {"card": smi, "seconds": {}, "launches": {}, "means": {}}
    sec, means, launches = (report["seconds"], report["means"],
                            report["launches"])
    counters = _counts()

    def timed(name, fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        sec[name] = time.time() - t0
        launches[name] = {k: counters[k].launches for k in rows}
        return out

    def within(name, ref, limit):
        rel = abs(means[name] - means[ref]) / means[ref]
        report.setdefault("rel", {})[name] = rel
        check(rel < limit, f"geometry/classic: {name}'s mean "
              f"{means[name]:.5f} is not within {limit:.0%} of {ref}'s "
              f"{means[ref]:.5f}")

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.time()
        g = write_geometry_xml(tmp, width, height, 16, n_fibers=n_fibers,
                               hf_res=hf_res)
        # The box without its blocks: make_cube winds a cube's top face
        # inward, so gt culls the short block's top where direct lights it
        # (both packages alike; ROADMAP C).
        box = os.path.join(tmp, "cornell_walls.xml")
        write_cornell_xml(box, width, height, 16, blocks=False)
        sec["write"] = time.time() - t0
        scene, cfg = timed("load_G", lambda: load_scene(g).build(device=dev))
        n_tris = scene.tri_v0.shape[0]
        report["triangles"] = n_tris
        check(n_tris > 1024 and 16 in cfg.bsdf_types
              and int((scene.tri_mot >= 0).sum()) == 12,
              "geometry/classic: scene G lacks a feature")
        print(f"geometry/classic: G {n_tris} triangles, "
              f"{scene.clas_ids.shape[0]} clusters, loaded and built in "
              f"{sec['load_G']:.2f} s", flush=True)

        def run(name, xml, *args, ext=".npy"):
            out = os.path.join(tmp, name, "image" + ext)
            timed(name, lambda: check(
                cli.main(["render", xml, "-o", out, "--device", str(dev),
                          *args]) is None, f"cli {name}: non-zero return"))
            img = np.load(out) if ext == ".npy" else read_exr(out)
            check(np.isfinite(img).all() and img.shape == (height, width, 3),
                  f"cli {name}: image not finite or misshapen")
            means[name] = float(img.mean())
            print(f"geometry/classic: cli {name}: {sec[name]:.3f} s, mean "
                  f"{means[name]:.5f}, launches {launches[name]}",
                  flush=True)
            return img, os.path.dirname(out)

        run("gt", g, "--integrator", "gt", "--spp", "16")
        check(launches["gt"]["clas_cull"] > 0, "gt on G: no clas_cull")
        run("sdmm", g, "--integrator", "sdmm", "--spp", "32")
        within("sdmm", "gt", 0.05)
        check(launches["sdmm"]["guided_sample"] > 0
              and launches["sdmm"]["em_suffstats"] > 0
              and launches["sdmm"]["clas_cull"] > 0,
              "sdmm on G: guided_sample, the E-step or clas_cull idle")
        for name, xml in (("", g), ("box_", box)):
            run(name + "gt_d2", xml, "--integrator", "gt", "--spp", "16",
                "--max-depth", "2")
            run(name + "direct", xml, "--integrator", "direct", "--spp",
                "16")
            within(name + "direct", name + "gt_d2", 0.03)
        check(launches["box_direct"]["mt_sweep"] > 0
              and launches["direct"]["clas_cull"] > 0,
              "direct: mt_sweep or clas_cull idle")
        ao, _ = run("ao", g, "--integrator", "ao", "--spp", "16")
        check(ao.min() >= 0.0 and ao.max() <= 1.0 and ao.max() > 0.5,
              "ao: values outside [0, 1]")
        for fld in ("shNormal", "distance"):
            run("field_" + fld, g, "--integrator", "field", "--spp", "4",
                "-D", f"field={fld}")
        # The field on the card against the CPU twin, on the same rays.
        scene_cpu, _ = load_scene(g).build(device="cpu")
        gen = torch.Generator().manual_seed(5)
        idx = torch.arange(0, width * height, width * height // 2048)
        pix = torch.stack([idx % width, idx // width], -1).float() + \
            torch.rand((idx.numel(), 2), generator=gen)
        ro, rd = generate_rays(scene_cpu, pix, width, height)
        field_err = {}
        for fld in ("shNormal", "distance"):
            a = classic.trace_field(scene, None, ro, rd, field=fld,
                                    device=dev).cpu()
            b = classic.trace_field(scene_cpu, None, ro, rd, field=fld,
                                    device="cpu")
            hit = (b != 0).any(-1)
            off = ((a - b).abs() > 1e-5).any(-1) & hit
            field_err[fld] = {"rays": int(hit.sum()),
                              "off": int(off.sum()),
                              "max_abs_err": float((a - b).abs().max())}
            check(off.sum() == 0 and hit.sum() > 1000,
                  f"field {fld}: card and CPU differ on {int(off.sum())} "
                  "rays")
        report["field"] = field_err
        print(f"geometry/classic: field on the card vs the CPU twin: "
              f"{field_err}", flush=True)
        _, d = run("multichannel", g, "--integrator", "multichannel",
                   "--spp", "4", ext=".exr")
        chans = sorted(f for f in os.listdir(d) if f.startswith("image_"))
        check(chans == ["image_albedo.exr", "image_distance.exr",
                        "image_position.exr", "image_shNormal.exr"]
              and all(np.isfinite(read_exr(os.path.join(d, f))).all()
                      for f in chans), f"multichannel: wrote {chans}")
        _, d = run("adaptive", g, "--integrator", "adaptive", "--spp", "64",
                   "-D", "maxError=0.1")
        with open(os.path.join(d, "stats.json")) as f:
            report["adaptive_mean_spp"] = json.load(f)["mean_spp"]
        within("adaptive", "gt", 0.03)
        check(report["adaptive_mean_spp"] < 64, "adaptive: no pixel stopped")
        mot, _ = run("motion", g, "--integrator", "motion", "--spp", "1")
        pos, _ = run("position", g, "--integrator", "field", "--spp", "1",
                     "-D", "field=position")
        prim, _ = run("prim", g, "--integrator", "field", "--spp", "1",
                      "-D", "field=primIndex")
        tri = prim[..., 0].reshape(-1).astype(np.int64)
        cube = scene_cpu.tri_mot.numpy()[tri] >= 0
        dxy = mot.reshape(-1, 3)[:, :2].astype(np.float64)
        p0 = pos.reshape(-1, 3)[cube]
        cam = cornell_camera()
        tan_half = np.tan(np.deg2rad(40.0) / 2)
        want = (_project_np(cam, tan_half, p0 + np.asarray(CUBE_MOVE), width,
                            height)
                - _project_np(cam, tan_half, p0, width, height))
        got = dxy[cube].mean(0)
        rel = float(np.linalg.norm(got - want.mean(0))
                    / np.linalg.norm(want.mean(0)))
        static = float(np.abs(dxy[~cube]).max())
        report["motion"] = {"pixels": int(cube.sum()), "mean": got.tolist(),
                            "analytic": want.mean(0).tolist(), "rel": rel,
                            "static_max": static}
        print(f"geometry/classic: motion {report['motion']}", flush=True)
        check(cube.sum() > 100 and rel < 0.01 and static < 1e-4,
              "motion: displacement off its analytic projection")
        report["irawan"] = _irawan_check(dev, scene)

        # COLLADA: import, include beside the camera and light, render.
        dae = os.path.join(tmp, "box.dae")
        write_cornell_dae(dae)
        imported = os.path.join(tmp, "imported", "box.xml")
        res = timed("import", lambda: subprocess.run(
            [sys.executable, "-m", "sdmm_tpu_torch", "import", dae,
             imported, "--device", str(dev)], cwd=ROOT, capture_output=True,
            text=True,
            timeout=300))
        check(res.returncode == 0, f"import: {res.stdout}{res.stderr}")
        print(f"geometry/classic: {res.stdout.strip()} in "
              f"{sec['import']:.2f} s", flush=True)
        light = cornell_rects()[-1][0]
        wrap = os.path.join(tmp, "imported", "scene.xml")
        with open(box) as f:
            head = f.read().split("  <bsdf")[0]
        with open(wrap, "w") as f:
            f.write(head + '  <shape type="rectangle"><transform name='
                    f'"toWorld"><matrix value="{_digits(light)}"/>'
                    '</transform><emitter type="area"><rgb name="radiance"'
                    f' value="{_digits(CORNELL_RADIANCE)}"/></emitter>'
                    '</shape>\n  <include filename="box.xml"/>\n</scene>\n')
        b = SceneBuilder()
        b.add_shape(shapes.make_rectangle(light), b.add_bsdf(
            BSDF_DIFFUSE, albedo=[0.5, 0.5, 0.5]),
            b.add_emitter(CORNELL_RADIANCE))
        meshes, mats = load_dae(dae)
        ids = {m: b.add_bsdf(BSDF_DIFFUSE, name=m, albedo=mats[m])
               for m in sorted(mats)}
        for m in meshes:
            soup = shapes.TriSoup()
            soup.add(m["v"], m["n"])
            b.add_shape(soup, ids[m["material"]])
        b.set_sensor(cornell_camera(), fov_deg=40.0, width=width,
                     height=height)
        b.max_depth = b.rr_depth = 10
        built = b.build(device=dev)
        loaded = load_scene(wrap).build(device=dev)
        _same_scene("imported COLLADA", loaded, built)
        for name, (sc, c) in (("collada_gt", loaded), ("code_gt", built)):
            res = timed(name, lambda: render_wavefront(sc, c, spp=16, seed=3,
                                                       device=dev))
            means[name] = float(res["image"].mean())
            print(f"geometry/classic: {name}: {sec[name]:.3f} s, mean "
                  f"{means[name]:.6f}, launches {launches[name]}",
                  flush=True)
        check(abs(means["collada_gt"] - means["code_gt"])
              <= 1e-6 * means["code_gt"],
              "collada: the imported scene renders another mean")
    sec["phase"] = time.time() - t_phase
    print("geometry_classic:", json.dumps(report), flush=True)


DELTA_SPHERES = (([-0.45, 0.4, 0.2], 0.35, "mirror"),
                 ([0.5, 0.35, -0.1], 0.3, "glass"))  # centre, radius


def write_delta_xml(path, width, height, spp):
    """The Cornell box without its blocks plus a mirror (Cu conductor) and
    a glass (dielectric, IOR 1.5) sphere of make_sphere's default 32 x 64
    tessellation (7,948 triangles, so clas_cull): the scene of the
    reference's BDPT test with delta BSDFs."""
    write_cornell_xml(path, width, height, spp, blocks=False)
    bsdfs = {"mirror": '<bsdf type="conductor"/>',
             "glass": '<bsdf type="dielectric"><float name="intIOR" '
                      'value="1.5"/></bsdf>'}
    shapes = "".join(
        f'  <shape type="sphere"><point name="center" x="{c[0]}" '
        f'y="{c[1]}" z="{c[2]}"/><float name="radius" value="{r}"/>'
        f'{bsdfs[kind]}</shape>\n' for c, r, kind in DELTA_SPHERES)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("</scene>", shapes + "</scene>"))


def _gather_card_vs_cpu(dev, xml, n=4096):
    """gather_radiance on the card against the CPU on the same photons,
    grid and gather points: photons traced and gridded on the CPU, the
    first hits of n camera rays, all copied to the card. Returns the
    report; every point must agree within rtol 1e-5 / atol 1e-6."""
    from sdmm_tpu_torch.bsdf import bsdf as bsdf_mod
    from sdmm_tpu_torch.core.frame import to_local
    from sdmm_tpu_torch.render import intersect as isect
    from sdmm_tpu_torch.render import photonmap
    from sdmm_tpu_torch.render.volpath import shading_frame
    from sdmm_tpu_torch.scene.sensor import generate_rays
    from sdmm_tpu_torch.scene.xml_loader import load_scene

    scene, cfg = load_scene(xml).build(device="cpu")
    types = cfg.bsdf_types or None
    gen = torch.Generator().manual_seed(7)
    n_paths = 1 << 15
    photons = photonmap.trace_photons(scene, gen, n_paths, bsdf_types=types,
                                      device="cpu")
    photons["power"] = photons["power"] / n_paths
    radius = 0.02 * photonmap.scene_diagonal(scene)
    grid = photonmap.build_photon_grid(scene, photons, radius)
    pix = torch.rand((n, 2), generator=gen) * torch.tensor(
        [float(cfg.width), float(cfg.height)])
    ro, rd = generate_rays(scene, pix, cfg.width, cfg.height)
    hit = isect.intersect(scene, ro, rd)
    it = isect.surface_interaction(scene, ro, rd, hit)
    params = bsdf_mod.gather_params(scene, it["bsdf"], it["uv"], types=types)
    frame = shading_frame(params, it["ns"], -rd)
    args = (photons, grid, it["p"], to_local(*frame, -rd), frame, params,
            torch.full((n,), radius * radius))

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(to(v) for v in x)
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    want = photonmap.gather_radiance(scene, *args, bsdf_types=types)
    got = photonmap.gather_radiance(None, *to(args), bsdf_types=types).cpu()
    err = (got - want).abs()
    off = (err > 1e-6 + 1e-5 * want.abs()).any(-1)
    rep = {"points": n, "lit": int((want > 0).all(-1).sum()),
           "off": int(off.sum()), "max_abs_err": float(err.max()),
           "max_rel_err": float((err / want.abs().clamp_min(1e-6)).max())}
    check(rep["off"] == 0 and rep["lit"] > n // 4,
          f"gather_radiance: card and CPU differ on {rep['off']} of {n} "
          "points")
    return rep


def phase_light_paths(dev, smi, width=640, height=360):
    """Phase 13: the light-path integrators on the card, through cli.main
    at 640x360. On the Cornell box without its blocks (cornell.xml,
    mt_sweep): gt at 16 spp is the reference; ptracer and bdpt at 4 spp
    within 3% of it; photonmapper (2^17 photon paths, 4 spp) within
    [0.90, 1.06] of it; sppm (4 passes of 2^16 photon paths) within
    [0.88, 1.10]; vpl at 4 spp within 25% and above direct at 4 spp. On
    the box with a mirror and a glass sphere (write_delta_xml, 7,948
    triangles, clas_cull): bdpt at 4 spp within 7% of gt at 16 spp. On the
    large scene of phase 8 without the blocks (127,000 triangles,
    clas_cull): ptracer and photonmapper at 4 spp against gt at 16 spp, in
    the same bands. gather_radiance on 4,096 gather points on the card
    against the CPU (_gather_card_vs_cpu). Each call's wall, mean and
    launches of rows 7 and 8 print on its own line; one "light_paths:"
    JSON line sums them up with the card's name and power limit."""
    import tempfile

    from sdmm_tpu_torch import cli

    t_phase = time.time()
    rows = ("mt_sweep", "clas_cull")
    report = {"card": smi, "seconds": {}, "launches": {}, "means": {},
              "rel": {}}
    sec, means, launches = (report["seconds"], report["means"],
                            report["launches"])
    counters = _counts()

    def ratio(name, ref, lo, hi):
        r = means[name] / means[ref]
        report["rel"][name] = r - 1.0
        check(lo < r < hi, f"light paths: {name}'s mean {means[name]:.5f} "
              f"is {r:.4f} of {ref}'s {means[ref]:.5f}, outside "
              f"({lo}, {hi})")

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.time()
        box = os.path.join(tmp, "cornell.xml")
        delta = os.path.join(tmp, "delta.xml")
        large = os.path.join(tmp, "large.xml")
        # Without the blocks: make_cube winds a cube's top face inward, so
        # gt's strict normals cull the short block's top where the light
        # paths, two-sided, light it (both packages alike; ROADMAP C).
        write_cornell_xml(box, width, height, 16, blocks=False)
        write_delta_xml(delta, width, height, 16)
        write_cornell_xml(large, width, height, 16, obj="spheres.obj",
                          blocks=False)
        write_spheres_obj(os.path.join(tmp, "spheres.obj"), large_spheres())
        sec["write"] = time.time() - t0

        def run(name, xml, integrator, spp, *args):
            out = os.path.join(tmp, name, "image.npy")
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            check(cli.main(["render", xml, "-o", out, "--device", str(dev),
                            "--integrator", integrator, "--spp", str(spp),
                            *args]) is None, f"cli {name}: non-zero return")
            torch.cuda.synchronize()
            sec[name] = time.time() - t0
            launches[name] = {k: counters[k].launches for k in rows}
            img = np.load(out)
            check(np.isfinite(img).all() and img.shape == (height, width, 3),
                  f"cli {name}: image not finite or misshapen")
            means[name] = float(img.mean())
            with open(os.path.join(tmp, name, "stats.json")) as f:
                stats = json.load(f)
            check(stats["integrator"] == integrator
                  and abs(stats["mean"] - means[name]) <= 1e-6 * means[name],
                  f"cli {name}: stats.json")
            print(f"light paths: cli {name}: {sec[name]:.3f} s, mean "
                  f"{means[name]:.5f}, launches {launches[name]}",
                  flush=True)
            return stats

        run("gt", box, "gt", 16)
        stats = run("ptracer", box, "ptracer", 4)
        check(stats["n_paths"] >= 4 * width * height, "ptracer: n_paths")
        ratio("ptracer", "gt", 0.97, 1.03)
        run("bdpt", box, "bdpt", 4)
        ratio("bdpt", "gt", 0.97, 1.03)
        run("photonmapper", box, "photonmapper", 4)
        ratio("photonmapper", "gt", 0.90, 1.06)
        run("sppm", box, "sppm", 4, "-D", "maxPasses=4")
        ratio("sppm", "gt", 0.88, 1.10)
        run("direct", box, "direct", 4)
        run("vpl", box, "vpl", 4)
        ratio("vpl", "gt", 0.75, 1.25)
        check(means["vpl"] > 1.02 * means["direct"],
              "vpl: no more light than direct alone")
        for name in ("ptracer", "bdpt", "photonmapper", "sppm", "vpl"):
            check(launches[name]["mt_sweep"] > 0
                  and launches[name]["clas_cull"] == 0,
                  f"{name} on the box: mt_sweep idle or clas_cull launched")

        run("delta_gt", delta, "gt", 16)
        run("delta_bdpt", delta, "bdpt", 4)
        ratio("delta_bdpt", "delta_gt", 0.93, 1.07)
        run("large_gt", large, "gt", 16)
        run("large_ptracer", large, "ptracer", 4)
        ratio("large_ptracer", "large_gt", 0.97, 1.03)
        run("large_photonmapper", large, "photonmapper", 4)
        ratio("large_photonmapper", "large_gt", 0.90, 1.06)
        for name in ("delta_bdpt", "large_ptracer", "large_photonmapper"):
            check(launches[name]["clas_cull"] > 0
                  and launches[name]["mt_sweep"] == 0,
                  f"{name}: clas_cull idle or mt_sweep launched")

        t0 = time.time()
        report["gather_card_vs_cpu"] = _gather_card_vs_cpu(dev, box)
        sec["gather_card_vs_cpu"] = time.time() - t0
        print(f"light paths: gather_radiance card vs CPU: "
              f"{report['gather_card_vs_cpu']}", flush=True)
    sec["phase"] = time.time() - t_phase
    print("light_paths:", json.dumps(report), flush=True)


# Lanes of phase 14's 65,536 PSS vectors whose eval_path value may leave
# 1e-4 relative between the card and the CPU: 1 on the H100 (at most
# 1.5e-4 relative; rounding that differs between the devices moves a
# path's later vertices).
EVAL_PATH_OFF_LANES = 2
# Points of phase 14's 4,096 whose interpolated irradiance may leave rtol
# 1e-5 between the card and the CPU (none on the H100).
INTERPOLATE_OFF_POINTS = 0


def write_env_xml(path, width, height, spp):
    """The Cornell box without its blocks, its light a black rectangle and
    the scene lit by a constant environment alone (through the open
    front): a scene with no area emitter, where mlt falls back to
    pssmlt."""
    write_cornell_xml(path, width, height, spp, blocks=False)
    with open(path) as f:
        text = f.read()
    start = text.index('<emitter type="area">')
    end = text.index("</emitter>", start) + len("</emitter>")
    text = text[:start] + text[end:]
    with open(path, "w") as f:
        f.write(text.replace("</scene>", '  <emitter type="constant"><rgb '
                             'name="radiance" value="1"/></emitter>\n'
                             "</scene>"))


def _eval_path_card_vs_cpu(dev, xml, n=65536, depth=6):
    """pssmlt.eval_path on the card against the CPU on n equal PSS vectors:
    pix equal on every lane, value within 1e-4 relative (atol 1e-6) on all
    but EVAL_PATH_OFF_LANES lanes."""
    from sdmm_tpu_torch.render import pssmlt
    from sdmm_tpu_torch.scene.xml_loader import load_scene

    scene, cfg = load_scene(xml).build(device="cpu")
    u = torch.rand((n, pssmlt.pss_dims(depth)),
                   generator=torch.Generator().manual_seed(11))
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = {k: v.cpu() for k, v in pssmlt.eval_path(
            scene, u, cfg.width, cfg.height, max_depth=depth,
            bsdf_types=cfg.bsdf_types or None, fov_axis=cfg.fov_axis,
            device=d).items()}
    want, got = out["cpu"], out[str(dev)]
    err = (got["value"] - want["value"]).abs()
    off = (err > 1e-6 + 1e-4 * want["value"].abs()).any(-1)
    rep = {"lanes": n, "lit": int((want["lum"] > 0).sum()),
           "pix_equal": bool(torch.equal(got["pix"], want["pix"])),
           "off": int(off.sum()), "max_abs_err": float(err.max()),
           "max_rel_err": float((err / want["value"].abs().clamp_min(1e-6))
                                .max())}
    check(rep["pix_equal"] and rep["off"] <= EVAL_PATH_OFF_LANES
          and rep["lit"] > n // 4,
          f"eval_path: card and CPU differ on {rep['off']} of {n} lanes "
          f"(allowed {EVAL_PATH_OFF_LANES}), pix equal {rep['pix_equal']}")
    return rep


def _interpolate_card_vs_cpu(dev, xml, n=4096):
    """irrcache.interpolate on the card against the CPU over one cache
    built on the card (the full table, its final gather on the card), at
    the first hits of n camera rays: E within rtol 1e-5 / atol 1e-7 and
    covered equal on all but INTERPOLATE_OFF_POINTS points."""
    from sdmm_tpu_torch.render import intersect as isect
    from sdmm_tpu_torch.render import irrcache
    from sdmm_tpu_torch.scene.scene import scene_to
    from sdmm_tpu_torch.scene.sensor import generate_rays
    from sdmm_tpu_torch.scene.xml_loader import load_scene

    scene, cfg = load_scene(xml).build(device=dev)
    cache = irrcache.build_cache(
        scene, torch.Generator(device=dev).manual_seed(3), cfg.width,
        cfg.height, bsdf_types=cfg.bsdf_types or None,
        max_depth=cfg.max_depth, fov_axis=cfg.fov_axis, device=dev)
    pix = torch.rand((n, 2), generator=torch.Generator().manual_seed(4),
                     ) * torch.tensor([float(cfg.width), float(cfg.height)])
    cpu = scene_to(scene, "cpu")
    ro, rd = generate_rays(cpu, pix, cfg.width, cfg.height)
    it = isect.surface_interaction(cpu, ro, rd, isect.intersect(cpu, ro, rd))
    want = irrcache.interpolate({k: v.cpu() for k, v in cache.items()}, cpu,
                                it["p"], it["ns"], 48)
    got = [t.cpu() for t in irrcache.interpolate(
        cache, scene, it["p"].to(dev), it["ns"].to(dev), 48)]
    err = (got[0] - want[0]).abs()
    off = (err > 1e-7 + 1e-5 * want[0].abs()).any(-1) | (got[1] != want[1])
    rep = {"points": n, "records": int(cache["valid"].sum()),
           "covered": int(want[1].sum()), "off": int(off.sum()),
           "max_abs_err": float(err.max())}
    check(rep["off"] <= INTERPOLATE_OFF_POINTS and rep["covered"] > n // 2,
          f"interpolate: card and CPU differ on {rep['off']} of {n} points")
    return rep


def phase_mcmc_irrcache(dev, smi, width=640, height=360):
    """Phase 14: the Metropolis integrators and the irradiance cache on the
    card, through cli.main at 640x360 and the scene's max depth (10). On
    the Cornell box without its blocks (mt_sweep): gt at 16 spp is the
    reference; pssmlt within 5%, erpt within 8%, mlt within 10% and
    irrcache within 15% of it, each at 4 spp. On the box with a mirror and
    a glass sphere (write_delta_xml, clas_cull): mlt at 4 spp within 15%
    of gt at 16 spp. On the block-less box lit by a constant environment
    alone (write_env_xml): mlt must print the reference CLI's fallback
    line and render through pssmlt, within 5% of gt. On the large scene of
    phase 8 without the blocks (clas_cull): pssmlt within 5% of gt. Each
    call prints its wall, mean against gt, launches of rows 7 and 8, b and
    (pssmlt) the acceptance rate; then eval_path and interpolate on the
    card against the CPU. One "mcmc_irrcache:" JSON line."""
    import contextlib
    import io
    import tempfile

    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.render import pssmlt

    t_phase = time.time()
    rows = ("mt_sweep", "clas_cull")
    report = {"card": smi, "seconds": {}, "launches": {}, "means": {},
              "rel": {}, "b": {}, "acceptance": {}}
    sec, means, launches = (report["seconds"], report["means"],
                            report["launches"])
    counters = _counts()
    real_pssmlt, last = pssmlt.render_pssmlt, {}

    def recording(*a, **k):
        last.update(real_pssmlt(*a, **k))
        return last

    def ratio(name, ref, band):
        r = means[name] / means[ref]
        report["rel"][name] = r - 1.0
        check(abs(r - 1.0) < band, f"mcmc: {name}'s mean {means[name]:.5f} "
              f"is {r:.4f} of {ref}'s {means[ref]:.5f}, outside {band}")

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    pssmlt.render_pssmlt = recording
    try:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            t0 = time.time()
            box = os.path.join(tmp, "cornell.xml")
            delta = os.path.join(tmp, "delta.xml")
            env = os.path.join(tmp, "env.xml")
            large = os.path.join(tmp, "large.xml")
            write_cornell_xml(box, width, height, 16, blocks=False)
            write_delta_xml(delta, width, height, 16)
            write_env_xml(env, width, height, 16)
            write_cornell_xml(large, width, height, 16, obj="spheres.obj",
                              blocks=False)
            write_spheres_obj(os.path.join(tmp, "spheres.obj"),
                              large_spheres())
            sec["write"] = time.time() - t0

            def run(name, xml, integrator, spp):
                out = os.path.join(tmp, name, "image.npy")
                for c in counters.values():
                    c.launches = 0
                last.clear()
                printed = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.time()
                with contextlib.redirect_stdout(printed):
                    code = cli.main(["render", xml, "-o", out, "--device",
                                     str(dev), "--integrator", integrator,
                                     "--spp", str(spp)])
                torch.cuda.synchronize()
                sec[name] = time.time() - t0
                check(code is None, f"cli {name}: non-zero return")
                launches[name] = {k: counters[k].launches for k in rows}
                img = np.load(out)
                check(np.isfinite(img).all()
                      and img.shape == (height, width, 3),
                      f"cli {name}: image not finite or misshapen")
                means[name] = float(img.mean())
                with open(os.path.join(tmp, name, "stats.json")) as f:
                    stats = json.load(f)
                check(stats["integrator"] == integrator
                      and abs(stats["mean"] - means[name])
                      <= 1e-6 * means[name], f"cli {name}: stats.json")
                if "b" in stats:
                    report["b"][name] = stats["b"]
                    check(stats["b"] > 0, f"cli {name}: b = {stats['b']}")
                if "acceptance" in last:
                    report["acceptance"][name] = last["acceptance"]
                print(f"mcmc: cli {name}: {sec[name]:.3f} s, mean "
                      f"{means[name]:.5f}, launches {launches[name]}, b "
                      f"{stats.get('b')}, acceptance "
                      f"{last.get('acceptance')}", flush=True)
                return printed.getvalue()

            run("gt", box, "gt", 16)
            run("pssmlt", box, "pssmlt", 4)
            ratio("pssmlt", "gt", 0.05)
            run("erpt", box, "erpt", 4)
            ratio("erpt", "gt", 0.08)
            run("mlt", box, "mlt", 4)
            ratio("mlt", "gt", 0.10)
            run("irrcache", box, "irrcache", 4)
            ratio("irrcache", "gt", 0.15)
            run("env_gt", env, "gt", 16)
            text = run("env_mlt", env, "mlt", 4)
            check("falling back to pssmlt" in text
                  and "env_mlt" in report["acceptance"],
                  "mlt on the environment-lit box: no pssmlt fallback")
            ratio("env_mlt", "env_gt", 0.05)
            for name in ("pssmlt", "erpt", "mlt", "irrcache", "env_mlt"):
                check(launches[name]["mt_sweep"] > 0
                      and launches[name]["clas_cull"] == 0,
                      f"{name} on the box: mt_sweep idle or clas_cull "
                      "launched")
            run("delta_gt", delta, "gt", 16)
            run("delta_mlt", delta, "mlt", 4)
            ratio("delta_mlt", "delta_gt", 0.15)
            run("large_gt", large, "gt", 16)
            run("large_pssmlt", large, "pssmlt", 4)
            ratio("large_pssmlt", "large_gt", 0.05)
            for name in ("delta_mlt", "large_pssmlt"):
                check(launches[name]["clas_cull"] > 0
                      and launches[name]["mt_sweep"] == 0,
                      f"{name}: clas_cull idle or mt_sweep launched")

            t0 = time.time()
            report["eval_path_card_vs_cpu"] = _eval_path_card_vs_cpu(dev,
                                                                     box)
            sec["eval_path_card_vs_cpu"] = time.time() - t0
            print(f"mcmc: eval_path card vs CPU: "
                  f"{report['eval_path_card_vs_cpu']}", flush=True)
            t0 = time.time()
            report["interpolate_card_vs_cpu"] = _interpolate_card_vs_cpu(
                dev, box)
            sec["interpolate_card_vs_cpu"] = time.time() - t0
            print(f"mcmc: interpolate card vs CPU: "
                  f"{report['interpolate_card_vs_cpu']}", flush=True)
    finally:
        pssmlt.render_pssmlt = real_pssmlt
    sec["phase"] = time.time() - t_phase
    print("mcmc_irrcache:", json.dumps(report), flush=True)


def _pool_mean(out):
    """A pool's image mean and its standard error, from its film. The
    channels are taken as fully correlated, which bounds the error from
    above."""
    w = out["weight"].double().clamp_min(1.0)[:, None]
    mean = out["image"].double() / w
    var = ((out["sqr"].double() / w - mean * mean).clamp_min(0.0) / w)
    sd = var.sqrt().mean(-1)
    return (float(mean.mean()),
            float(torch.sqrt((sd * sd).sum()) / sd.numel()))


# Phase 15's pools agree with their references within POOL_SE joint
# standard errors, and never further apart than POOL_REL.
POOL_SE = 4.0
POOL_REL = 0.02
# Phase 15(d): the most queries on which two routes' closest hits may
# differ by a float32 graze, as measured on one H100 (the large scene,
# 2^18 queries from seed 31); ties are not capped.
ROUTE_GRAZES = {"bvh vs clas_cull": 2, "round_loop vs clas_cull": 3,
                "bvh vs round_loop": 1, "bvh_occ vs clas_cull_occ": 1,
                "round_loop_occ vs clas_cull_occ": 1}


def _pool_agrees(m, se, m_ref, se_ref):
    """Whether a pool's mean lies within POOL_SE joint standard errors of
    its reference's, and within POOL_REL of it."""
    return (abs(m - m_ref) <= POOL_SE * float(np.hypot(se, se_ref))
            and abs(m / m_ref - 1.0) < POOL_REL)


def _hit_classes(scene, ro, rd, got, want, t_lim):
    """Where two closest-hit records disagree (valid or triangle id), the
    class of each query, from a float64 Möller–Trumbore test of both
    triangles: "tie", both hit within 1e-6 relative of each other (a shared
    edge or vertex); "graze", either route's triangle has the ray within
    float32 rounding of one of its edges or of its plane (the barycentric
    margin below 16 ulp of float32 times |tvec||p| / |det| or |d||q| /
    |det|, the size of the rounding of u and v), or its hit within
    rounding of t_lim or of the least distance EPS; "other". Returns the
    counts and the number of queries, and prints the first "other"
    queries."""
    from sdmm_tpu_torch.ops.bounce import EPS

    diff = (got["valid"] != want["valid"]) | (got["tri"] != want["tri"])
    out = {"queries": int(ro.shape[0]), "differ": int(diff.sum()),
           "tie": 0, "graze": 0, "other": 0}
    if not bool(diff.any()):
        return out
    o, d, lim = ro[diff].double(), rd[diff].double(), t_lim[diff].double()
    ulp = 16 * 2.0 ** -24

    def mt64(tri):
        i = tri[diff].clamp_min(0).long()
        v0, e1, e2 = (a[i].double() for a in (scene.tri_v0, scene.tri_e1,
                                              scene.tri_e2))
        p = torch.linalg.cross(d, e2)
        det = (e1 * p).sum(-1)
        inv = 1.0 / torch.where(det.abs() > 1e-300, det, 1.0)
        tv = o - v0
        u = (tv * p).sum(-1) * inv
        q = torch.linalg.cross(tv, e1)
        v = (d * q).sum(-1) * inv
        t = (e2 * q).sum(-1) * inv
        edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs()
        nrm = torch.linalg.vector_norm
        bound = ulp * torch.maximum(nrm(tv, dim=-1) * nrm(p, dim=-1),
                                    nrm(d, dim=-1) * nrm(q, dim=-1)) \
            * inv.abs()
        t_err = ulp * nrm(e2, dim=-1) * nrm(q, dim=-1) * inv.abs()
        ok = tri[diff] >= 0
        near_t = ((t - lim).abs() <= torch.maximum(1e-6 * lim.abs(), t_err)) \
            | ((t - EPS).abs() <= t_err)
        return t, ok, ok & ((edge <= bound) | near_t), edge, det

    ta, oka, ga, ea, da = mt64(got["tri"])
    tb, okb, gb, eb, db = mt64(want["tri"])
    tie = oka & okb & ((ta - tb).abs() <= 1e-6 * tb.abs())
    graze = ~tie & (ga | gb)
    out["tie"] = int(tie.sum())
    out["graze"] = int(graze.sum())
    out["other"] = out["differ"] - out["tie"] - out["graze"]
    rest = (~tie & ~graze).nonzero()[:, 0][:8]
    idx = diff.nonzero()[:, 0][rest]
    for j, i in zip(rest.tolist(), idx.tolist()):
        print(f"  other: query {i}: got valid {bool(got['valid'][i])} tri "
              f"{int(got['tri'][i])} t {float(got['t'][i]):.9g}; want valid "
              f"{bool(want['valid'][i])} tri {int(want['tri'][i])} t "
              f"{float(want['t'][i]):.9g}; float64 t {float(ta[j]):.9g} / "
              f"{float(tb[j]):.9g}, edge {float(ea[j]):.3g} / "
              f"{float(eb[j]):.3g}, det {float(da[j]):.3g} / "
              f"{float(db[j]):.3g}", flush=True)
    return out

def phase_schedulers(dev, smi, large, width=640, height=360,
                     n_queries=1 << 18):
    """Phase 15: the K = 8 training run, the four bounce pools, the guided
    sorted2 and striped pools, the BVH and the round loop on the card (see
    the module docstring). One "schedulers:" JSON line."""
    from sdmm_tpu_torch import native
    from sdmm_tpu_torch.guiding.trainer import SDMMTrainer, TrainerConfig
    from sdmm_tpu_torch.ops import clas_cull as ccull
    from sdmm_tpu_torch.render import bvh, clas
    from sdmm_tpu_torch.render import guided as tg
    from sdmm_tpu_torch.render import wavefront as wf
    from sdmm_tpu_torch.render.intersect import intersect
    from sdmm_tpu_torch.utils import stats

    t_phase = time.time()
    counters = _counts()
    report = {"card": smi, "seconds": {}, "launches": {}, "means": {},
              "rel": {}}
    sec, launches, means = (report["seconds"], report["launches"],
                            report["means"])

    def run(name, fn, *a, **k):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        sec[name] = time.time() - t0
        launches[name] = {n: c.launches for n, c in counters.items()
                          if c.launches}
        return out

    scene, cfg = cornell_box(width, height, dev)
    gt = run("gt_64", wf.render_wavefront, scene, cfg, spp=64, seed=11,
             device=dev)
    means["gt_64"] = float(gt["image"].mean())

    # (a) K = 8: the mixture route and the twin's E-step math on the card.
    tr = SDMMTrainer(scene, cfg, TrainerConfig(n_components=8), device=dev)
    img, _ = run("sdmm_k8", tr.run, 16)
    means["sdmm_k8"] = float(img.mean())
    la = launches["sdmm_k8"]
    nan_w = int(torch.isnan(tr.em.stats_w).sum())
    print(f"schedulers: K = 8, 16 spp: {sec['sdmm_k8']:.2f} s, mean "
          f"{means['sdmm_k8']:.5f} vs gt {means['gt_64']:.5f}, active leaves "
          f"{int(tr.initialized.sum())}; launches guided_sample "
          f"{la.get('guided_sample', 0)} and E-step "
          f"{la.get('em_suffstats', 0)} (0 by design: K != 16), mt_sweep "
          f"{la.get('mt_sweep', 0)}; NaN stats_w {nan_w}", flush=True)
    check(np.isfinite(img).all() and img.shape == (height, width, 3),
          "schedulers: the K = 8 image is not finite")
    check(int(tr.initialized.sum()) > 0, "schedulers: K = 8 trained no leaf")
    check(la.get("guided_sample", 0) == 0 and la.get("em_suffstats", 0) == 0,
          "schedulers: K = 8 launched a K = 16 kernel")
    check(la.get("mt_sweep", 0) > 0, "schedulers: K = 8 took no mt_sweep")
    check(nan_w == 0, "schedulers: K = 8 stats_w hold NaN")
    report["rel"]["sdmm_k8"] = means["sdmm_k8"] / means["gt_64"] - 1.0
    check(abs(report["rel"]["sdmm_k8"]) < 0.05,
          "schedulers: the K = 8 image disagrees with gt")

    # (b) The four bounce pools against sorted2.
    kw = dict(width=width, height=height, max_depth=cfg.max_depth,
              rr_depth=cfg.rr_depth, fov_axis=cfg.fov_axis,
              bsdf_types=tuple(cfg.bsdf_types), device=dev)
    ref = run("sorted2_64", wf.render_pool_fused_sorted2, scene, 5, spp=64,
              **kw)
    means["sorted2_64"], se_ref = _pool_mean(ref)
    for name, fn, extra in (
            ("fused", wf.render_pool_fused, dict(n_lanes=1 << 18)),
            ("blocked", wf.render_pool_fused_blocked, {}),
            ("sorted", wf.render_pool_fused_sorted, dict(spp_pilot=2)),
            ("shuffled", wf.render_pool_fused_shuffled, {})):
        out = run(name, fn, scene, 6, spp=8, **kw, **extra)
        m, se = _pool_mean(out)
        means[name] = m
        report["rel"][name] = m / means["sorted2_64"] - 1.0
        nb = launches[name].get("bounce", 0)
        print(f"schedulers: {name} pool, 8 spp: {sec[name]:.3f} s, "
              f"{out['steps']} steps, mean {m:.5f} (se {se:.2e}) vs sorted2 "
              f"{means['sorted2_64']:.5f} (se {se_ref:.2e}), rel "
              f"{report['rel'][name]:+.4f}; bounce launches {nb}", flush=True)
        check(float(out["weight"].sum()) == width * height * 8
              and float(out["weight"].min()) == 8.0,
              f"schedulers: the {name} pool did not spend 8 spp a pixel")
        check(nb > 0 and set(launches[name]) == {"bounce"},
              f"schedulers: the {name} pool's launches {launches[name]}")
        check(_pool_agrees(m, se, means["sorted2_64"], se_ref),
              f"schedulers: the {name} pool disagrees with sorted2")

    # (c) The guided sorted2 and striped pools on a frozen K = 16 model.
    tr16 = SDMMTrainer(scene, cfg, TrainerConfig(), device=dev)
    run("sdmm_k16", tr16.run, 16)
    gs = tr16.guide_state()
    gkw = dict(spp=16, width=width, height=height, max_depth=cfg.max_depth,
               rr_depth=cfg.rr_depth, bsdf_types=tuple(cfg.bsdf_types),
               fov_axis=cfg.fov_axis, device=dev)
    out = run("guided_fused", tg.render_pool_guided_fused, tr16.scene, gs,
              torch.Generator(device=dev).manual_seed(21),
              n_lanes=1 << 17, **gkw)
    means["guided_fused"], se_ref = _pool_mean(out)
    for name, fn, extra in (
            ("guided_sorted2", tg.render_pool_guided_sorted2,
             dict(spp_pilot=4)),
            ("guided_striped", tg.render_pool_guided_striped, {})):
        out = run(name, fn, tr16.scene, gs,
                  torch.Generator(device=dev).manual_seed(22), **gkw, **extra)
        m, se = _pool_mean(out)
        means[name] = m
        report["rel"][name] = m / means["guided_fused"] - 1.0
        la = launches[name]
        print(f"schedulers: {name} pool, 16 spp: {sec[name]:.3f} s, "
              f"{out['steps']} steps, mean {m:.5f} (se {se:.2e}) vs fused "
              f"{means['guided_fused']:.5f} (se {se_ref:.2e}), rel "
              f"{report['rel'][name]:+.4f}; trace {la.get('trace', 0)}, "
              f"shade {la.get('shade', 0)} launches", flush=True)
        check(float(out["weight"].sum()) == width * height * 16
              and float(out["weight"].min()) == 16.0,
              f"schedulers: the {name} pool did not spend 16 spp a pixel")
        check(la.get("trace", 0) > 0 and la.get("shade", 0) > 0
              and set(la) == {"trace", "shade"},
              f"schedulers: the {name} pool's launches {la}")
        check(_pool_agrees(m, se, means["guided_fused"], se_ref),
              f"schedulers: the {name} pool disagrees with the fused pool")

    # (d) The large scene through the BVH, the round loop and clas_cull.
    n = n_queries
    ro, rd, t_max, kind = query_rays(large, n, 31, dev, hits=intersect)
    inf = torch.full((n,), 3.4e38, device=dev)
    hits = {"bvh": run("bvh", bvh.traverse, large, ro, rd),
            "round_loop": run("round_loop", clas.intersect, large, ro, rd),
            "clas_cull": run("clas_cull", ccull.intersect, large, ro, rd,
                             inf)}
    report["differ"] = {}

    def agree(name, got, want, sub, t_lim):
        """Count the queries where two routes' closest hits differ, by
        class (``_hit_classes``); fail on any but ties and grazes, and on
        more grazes than ROUTE_GRAZES[name]."""
        cls = _hit_classes(large, ro[sub], rd[sub], got, want, t_lim)
        report["differ"][name] = cls
        print(f"schedulers: {name} on {int(sub.sum())} queries: {cls} "
              f"(grazes allowed {ROUTE_GRAZES[name]})", flush=True)
        check(cls["other"] == 0, f"schedulers: {name}: hits differ off "
              "equal-distance ties and edge grazes")
        check(cls["graze"] <= ROUTE_GRAZES[name], f"schedulers: {name}: "
              f"{cls['graze']} grazes, {ROUTE_GRAZES[name]} allowed")

    everyone = torch.ones(n, dtype=torch.bool, device=dev)
    for name in ("bvh", "round_loop"):
        agree(f"{name} vs clas_cull", hits[name], hits["clas_cull"],
              everyone, inf)
        print(f"schedulers: {name} {sec[name] * 1e3:.1f} ms, clas_cull "
              f"{sec['clas_cull'] * 1e3:.1f} ms", flush=True)
    agree("bvh vs round_loop", hits["bvh"], hits["round_loop"], everyone,
          inf)
    occ = kind == 2
    o_ro, o_rd, o_tm = ro[occ].contiguous(), rd[occ].contiguous(), \
        t_max[occ].contiguous()
    occs = {"bvh_occ": run("bvh_occ", bvh.traverse, large, o_ro, o_rd, o_tm,
                           any_hit=True),
            "round_loop_occ": run("round_loop_occ", clas.occluded, large,
                                  o_ro, o_rd, o_tm),
            "clas_cull_occ": run("clas_cull_occ", ccull.occluded, large,
                                 o_ro, o_rd, o_tm)}
    print(f"schedulers: occluded on {int(occ.sum())} queries, "
          f"{int(occs['clas_cull_occ'].sum())} occluded; ms "
          f"{ {k: round(sec[k] * 1e3, 1) for k in occs} }", flush=True)
    # Where two routes' occluded answers differ, their closest hits within
    # t_max must differ by a tie or a graze, or lie at t_max's rounding.
    t_hits = {"bvh_occ": bvh.traverse(large, o_ro, o_rd, o_tm),
              "round_loop_occ": clas.intersect(large, o_ro, o_rd, o_tm),
              "clas_cull_occ": ccull.intersect(large, o_ro, o_rd, o_tm)}
    for name in ("bvh_occ", "round_loop_occ"):
        sub = torch.zeros(n, dtype=torch.bool, device=dev)
        sub[occ] = occs[name] != occs["clas_cull_occ"]
        pick = sub[occ]
        agree(f"{name} vs clas_cull_occ",
              {k: v[pick] for k, v in t_hits[name].items()},
              {k: v[pick] for k, v in t_hits["clas_cull_occ"].items()},
              sub, o_tm[pick])
    verts = torch.stack([large.tri_v0, large.tri_v0 + large.tri_e1,
                         large.tri_v0 + large.tri_e2], 1).cpu().numpy()
    t0 = time.time()
    tree = native.bvh_build_native(verts)
    sec["native_bvh_build"] = time.time() - t0
    print(f"schedulers: native BVH build of {len(verts)} triangles "
          f"{sec['native_bvh_build']:.3f} s, {len(tree['lo'])} nodes",
          flush=True)

    # (e) The statistics report, here and not at exit: the last line stays
    # the result.
    print("statistics report:\n" + stats.take_report().rstrip(), flush=True)
    report["wall"] = time.time() - t_phase
    print("schedulers: " + json.dumps(report), flush=True)
    print(f"schedulers: phase 15 took {report['wall']:.2f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    for k in [k for k in os.environ if k.startswith("SDMM_TPU_")]:
        del os.environ[k]  # the default routes in every phase
    from sdmm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    reports = _build.build_all(["guided_sample", "em_suffstats",
                                "guided_step", "bounce", "mt_sweep",
                                "clas_cull"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.time()
    large, large_cfg = cornell_box(640, 360, dev, spheres=large_spheres())
    print(f"large scene: {large.tri_v0.shape[0]} triangles, "
          f"{large.clas_ids.shape[0]} clusters of {large.clas_ids.shape[1]}, "
          f"{large.clas_woop.numel() * 4} bytes of Woop rows, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    check(large.tri_v0.shape[0] == 127_012, "large scene: triangle count")
    kernels = [phase_guided(dev), phase_em(dev), *phase_guided_step(dev),
               *phase_path_kernels(dev), phase_sweep(dev),
               phase_cull(dev, large)]
    launches, guided_mean = phase_main_path(dev)
    # mt_sweep's count sums its two paths: phase 5's training iterations
    # and phase 6's eager render_pool.
    row = phase_path_row(dev, guided_mean, smi)
    print(f"mt_sweep launches: {launches['mt_sweep']} in phase 5, "
          f"{row['mt_sweep']} in phase 6", flush=True)
    launches["mt_sweep"] += row.pop("mt_sweep")
    launches.update(row)
    # guided_sample's count sums its two paths: phase 5's training
    # iterations and phase 7's training and eager frozen iterations.
    launches["clas_cull"], n_gs = phase_large_path(dev, large, large_cfg,
                                                   smi)
    print(f"guided_sample launches: {launches['guided_sample']} in phase 5,"
          f" {n_gs} in phase 7", flush=True)
    launches["guided_sample"] += n_gs
    phase_entry_point(dev, smi)
    phase_features(dev, smi)
    phase_media(dev, smi)
    phase_guiding_extras(dev, smi)
    phase_geometry_classic(dev, smi)
    phase_light_paths(dev, smi)
    phase_mcmc_irrcache(dev, smi)
    phase_schedulers(dev, smi, large)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
