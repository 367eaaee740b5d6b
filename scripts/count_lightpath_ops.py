"""Count the PyTorch operations one wave of each light-path integrator
dispatches, on the CPU: each operation that is not a view is one kernel
launch on the card (a few launch more than one), so the counts predict the
launch overhead of phase 13 of chip_smoke.py before it runs there.

    python3 scripts/count_lightpath_ops.py [--width 32 --height 18]

The scene is chip_smoke.cornell_box (36 triangles, max depth 10) at a small
size; the counts depend on the depths and the chunking, not on the lane
count. Prints one line a call: operations, and the host seconds on this
CPU.
"""

import argparse
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VIEWS = {"view", "_unsafe_view", "slice", "select", "expand", "unsqueeze",
         "squeeze", "t", "permute", "as_strided", "alias", "detach",
         "unbind", "split", "split_with_sizes", "reshape", "_reshape_alias",
         "lift_fresh", "transpose"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--height", type=int, default=18)
    args = ap.parse_args()
    import chip_smoke as cs
    from sdmm_tpu_torch.render import bdpt, photonmap, ptracer
    from sdmm_tpu_torch.scene.sensor import generate_rays

    torch.set_num_threads(2)
    w, h = args.width, args.height
    scene, cfg = cs.cornell_box(w, h, "cpu")
    types = cfg.bsdf_types or None
    n = w * h
    pix = torch.rand((n, 2), generator=torch.Generator().manual_seed(0))
    pix = pix * torch.tensor([float(w), float(h)])
    ro, rd = generate_rays(scene, pix, w, h)
    photons = photonmap.trace_photons(scene, torch.Generator(), 4096,
                                      bsdf_types=types, device="cpu")
    photons["power"] = photons["power"] / 4096
    grid = photonmap.build_photon_grid(scene, photons, 0.05)
    vpls = ptracer.generate_vpls(scene, 32, 4, bsdf_types=types,
                                 generator=torch.Generator(), device="cpu")
    depth = min(cfg.max_depth, 8)
    # Chunks of 16 VPLs, as a wave of 2^18 rays takes on the card.
    ptracer.VPL_LANES = 16 * n
    calls = {
        "ptracer.trace_particles (depth 10)": lambda: ptracer.trace_particles(
            scene, torch.Generator(), n, w, h, max_depth=cfg.max_depth,
            rr_depth=cfg.rr_depth, bsdf_types=types, device="cpu"),
        f"bdpt.trace_bdpt (depth {depth})": lambda: bdpt.trace_bdpt(
            scene, torch.Generator(), pix, w, h, max_depth=depth,
            bsdf_types=types, device="cpu"),
        "photonmap.trace_photons (depth 8)": lambda: photonmap.trace_photons(
            scene, torch.Generator(), n, bsdf_types=types, device="cpu"),
        "photonmap.camera_gather (the box: one step)":
            lambda: photonmap.camera_gather(
                scene, torch.Generator(), ro, rd, photons, grid,
                torch.tensor(0.0025), bsdf_types=types, device="cpu"),
        "ptracer.trace_vpl (160 VPLs, 16 a chunk)": lambda: ptracer.trace_vpl(
            scene, None, ro, rd, vpls, bsdf_types=types, device="cpu"),
    }
    for name, call in calls.items():
        with Count() as c:
            t0 = time.time()
            call()
            sec = time.time() - t0
        print(f"{name}: {c.n} operations, {sec:.2f} s on this CPU",
              flush=True)


if __name__ == "__main__":
    main()
