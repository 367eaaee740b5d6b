"""What a gradient of inverse rendering holds and what its finite
differences measure, on chip_smoke.py's four-type box (depth 10), on the
CPU at a small size.

    python3 scripts/diff_memory_fd.py --what saved [--width 64 --height 36]
    python3 scripts/diff_memory_fd.py --what ladder [--width 128 --height 72]

``saved`` counts the bytes of the tensors autograd saves for one pass of
``diff/inverse.make_render_fn_multi`` (each storage once, through
``torch.autograd.graph.saved_tensors_hooks``) and prints them per camera
path, the figure that sizes a full-width gradient's graph. ``ladder``
prints the gradient of the image mean in the rough cube's alpha beside
same-seed central differences at shrinking eps (means in float64): where
an eps window holds a visibility or lobe-mask jump of some path, the
difference measures the jump, not the interior derivative.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sdmm_tpu_torch.diff import inverse  # noqa: E402

NAMES = ("bsdf_albedo", "bsdf_alpha")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=("saved", "ladder"), required=True)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=36)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    scene, cfg = chip_smoke.cornell_box(a.width, a.height, "cpu",
                                        extra_bsdfs=True)
    n = a.width * a.height
    params = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in NAMES}
    if a.what == "saved":
        render = inverse.make_render_fn_multi(scene, cfg, torch.arange(n),
                                              spp=1, device="cpu")
        seen = {}

        def pack(t):
            s = t.untyped_storage()
            seen.setdefault(s.data_ptr(), s.nbytes())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            render(params, a.seed).mean()
        total = sum(seen.values())
        print(f"{a.width}x{a.height}, depth {cfg.max_depth}: {total} bytes "
              f"saved for one pass, {total / n:.1f} a path")
        return
    render = inverse.make_render_fn_multi(scene, cfg, torch.arange(n),
                                          spp=a.spp, device="cpu")
    rough = int(scene.bsdf_alpha.shape[0]) - 1
    render(params, a.seed).double().mean().backward()
    grad = float(params["bsdf_alpha"].grad[rough])
    print(f"{a.width}x{a.height}, {a.spp} spp, seed {a.seed}: gradient "
          f"{grad:.6g}")
    base = scene.bsdf_alpha
    for eps in (5e-3, 1e-3, 2e-4, 4e-5, 8e-6, 2e-6):
        e = torch.zeros_like(base)
        e[rough] = eps
        lo_p, hi_p = base - e, base + e
        with torch.no_grad():
            hi = render({"bsdf_alpha": hi_p}, a.seed).double().mean()
            lo = render({"bsdf_alpha": lo_p}, a.seed).double().mean()
        fd = float(hi - lo) / float(hi_p[rough].double()
                                    - lo_p[rough].double())
        print(f"  eps {eps:g}: FD {fd:.6g}, rel {abs(fd - grad) / abs(grad):.4g}",
              flush=True)


if __name__ == "__main__":
    main()
