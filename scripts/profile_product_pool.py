"""Time one pass of the guided lane pool with and without learned-BSDF
product sampling on the card, and profile the product pass by kernel.

    python3 scripts/profile_product_pool.py [--root DIR] [--spp N]

On the four-type box of chip_smoke.py (640x360, depth 10) it trains
SDMMTrainer(TrainerConfig(sample_product=True)) for 16 spp, then renders
one pool pass of --spp (default 4) spp on the same guide state with the
learned table (product lanes, the mixture route) and without it (the
guided_sample kernel), and prints each wall and step count; then
torch.profiler's kernel table of a 1-spp product pass, by CUDA time and by
CPU time. --root is the root of a checkout (default: the one holding this
script) whose sdmm_tpu_torch/ and chip_smoke.py are imported, so that two
versions of the product code can be timed in one call.
"""

import argparse
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from sdmm_tpu_torch.guiding import trainer as tr
    from sdmm_tpu_torch.ops import _build
    from sdmm_tpu_torch.render import guided as rg

    if not torch.cuda.is_available():
        print("profile_product_pool: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    _build.build_all(["guided_sample", "em_suffstats", "guided_step",
                      "bounce", "mt_sweep", "clas_cull"])
    dev = torch.device("cuda", 0)
    scene, cfg = cs.cornell_box(640, 360, dev, extra_bsdfs=True)
    trainer = tr.SDMMTrainer(scene, cfg, tr.TrainerConfig(
        sample_product=True, train_fraction=1.0), device=dev)
    trainer.run(total_spp=16)
    gs = trainer.guide_state()

    def pool(g, spp):
        return rg.render_pool_guided(
            scene, g, torch.Generator(device=dev).manual_seed(1),
            n_lanes=131072, spp=spp, width=640, height=360,
            bsdf_types=cfg.bsdf_types or None, device=dev)

    for name, learned in (("product", gs.learned), ("kernel", None)):
        torch.cuda.synchronize()
        t0 = time.time()
        out = pool(gs._replace(learned=learned), args.spp)
        torch.cuda.synchronize()
        print(f"{name} pool, {args.spp} spp: {time.time() - t0} s, "
              f"{out['steps']} steps", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pool(gs, 1)
        torch.cuda.synchronize()
    for key in ("cuda_time_total", "cpu_time_total"):
        print(prof.key_averages().table(sort_by=key, row_limit=30),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
