"""Count the E-step's non-finite posteriors, by cause, and the NaN entries
of its statistics on the card (chip_smoke.EmCensus) over chip_smoke.py's
phase 5 (the Cornell box) and phase 7 (the 127,012-triangle scene)
training renders.

    python3 scripts/em_census.py [--root DIR]

--root is the root of a checkout (default: the one holding this script)
whose sdmm_tpu_torch/ and chip_smoke.py are imported and whose csrc/ is
built. To count what an earlier E-step kernel does, put that commit's
csrc/em_suffstats.cu into a copy of the checkout and pass the copy: each
phase prints its census line before it checks that no NaN remains, so a
faulty kernel's counts print and the run then stops at that check.
"""

import argparse
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from sdmm_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("em_census: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    print("card:", smi, flush=True)
    _build.build_all(["guided_sample", "em_suffstats", "guided_step",
                      "mt_sweep", "clas_cull", "bounce"])
    t0 = time.time()
    cs.phase_main_path(dev)
    large, cfg = cs.cornell_box(640, 360, dev, spheres=cs.large_spheres())
    cs.phase_large_path(dev, large, cfg, smi)
    print(f"em_census: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
