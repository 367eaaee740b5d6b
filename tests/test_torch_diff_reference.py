"""The inverse-rendering slice as a whole against the reference, in
expectation: on tests/test_diff.py's rough scene (12x12, depth 3, 4 spp)
the image mean and the mean's gradients in bsdf_albedo and bsdf_alpha,
over 16 reference keys and 16 port seeds, agree entry by entry within 4
joint standard errors plus 2% of the reference's value. The reference's
jax.jit(jax.value_and_grad(...)) of one make_render_fn_multi is compiled
once, in a background thread, while the port renders."""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_rough_box, to_np  # noqa: E402

from sdmm_tpu.diff import inverse as jinverse  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.diff import inverse as tinverse  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
NAMES = ("bsdf_albedo", "bsdf_alpha")
RUNS = 16


def _reference(out):
    scene, cfg = make_rough_box(jscene, jshapes).build()
    pix = jnp.arange(cfg.width * cfg.height, dtype=jnp.int32)
    render = jinverse.make_render_fn_multi(scene, cfg, pix, spp=4)
    f = jax.jit(jax.value_and_grad(lambda p, k: jnp.mean(render(p, k))))
    p = {n: getattr(scene, n) for n in NAMES}
    runs = []
    for k in range(RUNS):
        v, g = f(p, jax.random.PRNGKey(k))
        runs.append([np.asarray(v)] + [np.asarray(g[n]) for n in NAMES])
    out["runs"] = runs


def _mean_se(runs):
    return [(np.mean(x, 0), np.std(x, 0, ddof=1) / np.sqrt(len(x)))
            for x in zip(*runs)]


def test_gradients_agree_with_the_reference_in_expectation():
    ref = {}
    th = threading.Thread(target=_reference, args=(ref,))
    th.start()
    scene, cfg = make_rough_box(tscene, tshapes).build(device="cpu")
    render = tinverse.make_render_fn_multi(
        scene, cfg, torch.arange(cfg.width * cfg.height), spp=4,
        device="cpu")
    runs = []
    for seed in range(RUNS):
        p = {n: getattr(scene, n).clone().requires_grad_(True)
             for n in NAMES}
        v = render(p, seed).mean()
        v.backward()
        runs.append([to_np(v)] + [to_np(p[n].grad) for n in NAMES])
    th.join(timeout=600)
    assert not th.is_alive() and "runs" in ref
    for name, (mt, st), (mr, sr) in zip(("mean",) + NAMES, _mean_se(runs),
                                        _mean_se(ref["runs"])):
        lim = 4.0 * np.hypot(st, sr) + 0.02 * np.abs(mr)
        assert (np.abs(mt - mr) <= lim).all(), (name, mt, mr, lim)
    # The alpha gradient lives on the rough conductor alone.
    assert abs(float(runs[0][2][-1])) > 0.0
