"""Where the PyTorch/CUDA port's main path spends its time on one GPU.

    python3 scripts/torch_profile_main_path.py [--width 640 --height 360]
        [--json summary.json]

Builds the Cornell box of chip_smoke.py at the protocol size (640x360,
max depth 10, TrainerConfig() defaults), warms the trainer up with four
training iterations (so that each measured one runs one EM step, as
the steady state does), then profiles one training iteration (guided render
with vertex collection + optimize), one frozen-model iteration (guided
render at 4 spp, the fused trace + shade pool the trainer takes on the
card) and the same frozen render on the eager pool (render_pool_guided, for
comparison), then the unguided path row (render_wavefront at 64 spp, the
sorted2 pool on the step kernel, and at 2 spp, the striped pool on the
bounce kernel), then the same three kinds of phase on the large scene of
chip_smoke.py (127,012 triangles: every ray goes through the clas_cull
kernel, and every pool is eager) under torch.profiler. For each phase it
prints the wall
time, the time the device was busy (the union of its kernel intervals),
its share of the unprofiled wall time, the number of kernel launches,
and the kernels that took the most device time; ``--json`` also writes the summary to a file.
Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _busy_us(events):
    """Union of the device intervals of kernel events, in microseconds."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(iv)


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_phase(name, fn, top=20):
    """Median wall of three unprofiled runs of ``fn``, then one profiled
    run: device busy time over that unprofiled wall, and the kernels by
    device time (the profiler stretches the host side, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    wall = statistics.median(_wall(fn) for _ in range(3))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    busy, n_kernels = _busy_us(prof.events())
    rows = []
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": a.key[:100],
                         "device_ms": a.self_device_time_total / 1e3,
                         "calls": a.count})
    rows.sort(key=lambda r: -r["device_ms"])
    out = {"phase": name, "wall_s": wall, "wall_profiled_s": wall_prof,
           "device_busy_s": busy / 1e6, "busy_share": busy / 1e6 / wall,
           "device_kernels": n_kernels, "top": rows[:top]}
    print(f"{name}: wall {wall:.4f} s (profiled {wall_prof:.4f} s), device "
          f"busy {busy / 1e6:.4f} s (share of the unprofiled wall "
          f"{out['busy_share']:.4f}), {n_kernels} kernel launches",
          flush=True)
    for r in rows[:top]:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:7d}  {r['name']}",
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--json", help="write the summary to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_main_path: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sdmm_tpu_torch.guiding.trainer import SDMMTrainer, TrainerConfig
    from sdmm_tpu_torch.ops import _build
    from sdmm_tpu_torch.render.guided import render_pool_guided
    from sdmm_tpu_torch.render.wavefront import render_wavefront

    _build.build_all(["guided_sample", "em_suffstats", "guided_step",
                      "bounce", "mt_sweep", "clas_cull"])
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    scene, cfg = chip_smoke.cornell_box(args.width, args.height, dev)
    tr = SDMMTrainer(scene, cfg, TrainerConfig(), device=dev)

    def train_iteration(t=tr):
        _, _, _, batches = t.render_iteration(collect=True)
        t.optimize(batches)
        t.iteration += 1
        t.total_spp += t.cfg.samples_per_iteration

    def frozen_eager():
        c, rc = tr.cfg, tr.render_cfg
        render_pool_guided(
            tr.scene, tr.guide_state(),
            torch.Generator(device=dev).manual_seed(tr.iteration),
            n_lanes=min(c.rays_per_wave * 2, rc.width * rc.height * 4),
            spp=c.samples_per_iteration, width=rc.width, height=rc.height,
            max_depth=rc.max_depth, rr_depth=rc.rr_depth,
            bsdf_fraction=c.bsdf_fraction, bsdf_types=rc.bsdf_types,
            fov_axis=rc.fov_axis, device=dev)

    for _ in range(4):  # warm-up: first launches, the tree fills up
        train_iteration()
    t_render = statistics.median(_wall(
        lambda: tr.render_iteration(collect=True)) for _ in range(3))
    print(f"training render alone (collect=True, 4 spp): {t_render:.4f} s",
          flush=True)
    phases = [
        profile_phase("training iteration (render + optimize)",
                      train_iteration),
        profile_phase("frozen iteration (fused render, 4 spp)",
                      lambda: tr.render_iteration(collect=False)),
        profile_phase("frozen iteration on the eager pool (render, 4 spp)",
                      frozen_eager),
        profile_phase("path row: render_wavefront, 64 spp (sorted2, step)",
                      lambda: render_wavefront(scene, cfg, spp=64, seed=5,
                                               device=dev)),
        profile_phase("path row: render_wavefront, 2 spp (striped, bounce)",
                      lambda: render_wavefront(scene, cfg, spp=2, seed=6,
                                               device=dev)),
    ]
    large, large_cfg = chip_smoke.cornell_box(
        args.width, args.height, dev, spheres=chip_smoke.large_spheres())
    tl = SDMMTrainer(large, large_cfg, TrainerConfig(), device=dev)
    for _ in range(2):
        train_iteration(tl)
    phases += [
        profile_phase("large scene: training iteration (render + optimize)",
                      lambda: train_iteration(tl)),
        profile_phase("large scene: frozen iteration (eager render, 4 spp)",
                      lambda: tl.render_iteration(collect=False)),
        profile_phase("large scene: path row, render_wavefront, 16 spp "
                      "(eager, clas_cull)",
                      lambda: render_wavefront(large, large_cfg, spp=16,
                                               seed=7, device=dev)),
    ]
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": chip_smoke.nvidia_smi_line(),
                       "size": [args.width, args.height],
                       "training_render_s": t_render, "phases": phases}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
