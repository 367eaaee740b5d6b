"""Count the PyTorch operations one step of each Metropolis integrator and
the irradiance cache's calls dispatch, on the CPU: each operation that is
not a view is one kernel launch on the card (a few launch more than one),
so the counts predict the launch overhead of phase 14 of chip_smoke.py
before it runs there.

    python3 scripts/count_mcmc_ops.py [--width 32 --height 18]

The scenes are phase 14's: the Cornell box without its blocks
(chip_smoke.write_cornell_xml) and the box with a mirror and a glass sphere
(chip_smoke.write_delta_xml), max depth 10, at a small size; the counts
depend on the depths, not on the lane count. Prints one line a call:
operations outside intersection, intersection calls (one mt_sweep launch,
or clas_cull's query order and kernel, on the card), and the host seconds
on this CPU; then the steps each call of phase 14 takes at 640x360 and 4
spp.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from count_lightpath_ops import Count  # noqa: E402


class OutsideIntersection(Count):
    """Count's operations, those inside an intersection call left out and
    the calls counted instead."""

    def __init__(self):
        super().__init__()
        self.calls = 0
        self.inside = False

    def outside(self, fn, *a, **kw):
        self.calls += 1
        self.inside = True
        try:
            return fn(*a, **kw)
        finally:
            self.inside = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.inside:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--height", type=int, default=18)
    args = ap.parse_args()
    import chip_smoke as cs
    from sdmm_tpu_torch.render import irrcache, mlt, pssmlt
    from sdmm_tpu_torch.scene.sensor import generate_rays
    from sdmm_tpu_torch.scene.xml_loader import load_scene

    torch.set_num_threads(2)
    w, h = args.width, args.height
    n = w * h
    scenes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, write in (("box", lambda p: cs.write_cornell_xml(
                p, w, h, 4, blocks=False)),
                            ("delta box", lambda p: cs.write_delta_xml(
                                p, w, h, 4))):
            path = os.path.join(tmp, name.replace(" ", "_") + ".xml")
            write(path)
            scenes[name] = load_scene(path).build(device="cpu")
    scene, cfg = scenes["box"]
    types = cfg.bsdf_types or None
    gen = torch.Generator().manual_seed(0)
    pix = torch.rand((n, 2), generator=gen) * torch.tensor([float(w),
                                                            float(h)])
    ro, rd = generate_rays(scene, pix, w, h)
    u = torch.rand((n, pssmlt.pss_dims(6)), generator=gen)
    irrcache.TABLE = 64  # the counts do not depend on the table's size
    cache = irrcache.build_cache(scene, gen, w, h, bsdf_types=types,
                                 max_depth=cfg.max_depth, n_candidates=n,
                                 gather_res=2, device="cpu")
    trace = irrcache.make_trace_fn(cache, cfg, 48)
    calls = {
        "pssmlt.eval_path (depth 6; one Kelemen step, one ERPT step)":
            lambda: pssmlt.eval_path(scene, u, w, h, max_depth=6,
                                     bsdf_types=types, device="cpu"),
        "irrcache.build_cache (depth 10)": lambda: irrcache.build_cache(
            scene, gen, w, h, bsdf_types=types, max_depth=cfg.max_depth,
            n_candidates=n, gather_res=2, device="cpu"),
        "irrcache trace_fn (one wave)": lambda: trace(scene, gen, ro, rd),
    }
    for name, (sc, cf) in scenes.items():
        t = tuple(cf.bsdf_types)
        paths = mlt.trace_path_record(sc, gen, pix, w, h, cf.max_depth, t,
                                      device="cpu")
        calls[f"mlt.mlt_chain_step, one step (depth 10, the {name})"] = (
            lambda sc=sc, cf=cf, t=t, paths=paths: mlt.mlt_chain_step(
                sc, paths, gen, w, h, cf.max_depth, t, n_steps=1,
                device="cpu"))
    # Intersection queries are counted as calls: on the card each is one
    # mt_sweep launch, or clas_cull's query order and kernel, where the CPU
    # twins (the cull's above all) dispatch many operations.
    from sdmm_tpu_torch.render import intersect as isect

    real = {k: getattr(isect, k) for k in ("intersect", "occluded")}
    for k, fn in real.items():
        setattr(isect, k, lambda *a, fn=fn, **kw: mode.outside(fn, *a, **kw))
    for name, call in calls.items():
        with OutsideIntersection() as mode:
            t0 = time.time()
            call()
            sec = time.time() - t0
        print(f"{name}: {mode.n} operations and {mode.calls} intersection "
              f"calls, {sec:.2f} s on this CPU", flush=True)
    for k, fn in real.items():
        setattr(isect, k, fn)
    n_pix = 640 * 360
    print(f"steps at 640x360, 4 spp: pssmlt {max(1, 4 * n_pix // (1 << 14))} "
          f"+ 2 bootstrap evaluations; erpt 32 + 1; mlt "
          f"{8 * max(1, 4 * n_pix // (8192 * 8))} (rounds of 8); irrcache "
          f"{-(-4 * n_pix // (1 << 18))} waves", flush=True)


if __name__ == "__main__":
    main()
