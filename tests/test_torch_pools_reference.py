"""The schedulers that no entry point reaches against the reference's pools
of the same name in Pallas interpret mode, on the CPU (the port's kernels'
plain twins): the four bounce pools (``render_pool_fused``, ``_blocked``,
``_sorted``, ``_shuffled``) on tests/test_bounce_pallas.py's box at depth
6, and the guided striped pool on one trained K = 16 model, which the port
writes in the reference's checkpoint schema and the reference's trainer
restores. Random streams differ between the packages, so images agree in
expectation only: each image mean within 4 joint standard errors.

An interpret-mode step costs the same for every lane of a tile (8,192
lanes), so the pools render more pixels at fewer spp: the same samples in
fewer steps. The reference's five pools compile and run in background
threads while the port renders. One test, so that the tier-1 scheduler
(``--dist loadfile``, files with the most tests first) hands the file out
last."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_trainer import _trainers  # noqa: E402
from torch_parity import film_mean_se, make_box, within_se  # noqa: E402

from sdmm_tpu.render import guided as jguided  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import io as tio  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
# The bounce pools: 64x48 pixels, 8 spp, depth 6.
W, H, SPP = 64, 48, 8
# The guided striped pool: one trace tile of pixels, 8 spp.
GW, GH = 128, 64


def _mean_se(out):
    w = np.asarray(out["weight"])
    assert w.min() == w.max() == SPP  # exact spp on every pixel
    return film_mean_se(np.asarray(out["image"]), np.asarray(out["sqr"]), w)


def _bounce_pools(mod):
    """(name, pool, its own arguments) of the four bounce pools of the
    wavefront module ``mod``, either package's."""
    return (("fused", mod.render_pool_fused, dict(n_lanes=8192)),
            ("blocked", mod.render_pool_fused_blocked, {}),
            ("sorted", mod.render_pool_fused_sorted, dict(spp_pilot=2)),
            ("shuffled", mod.render_pool_fused_shuffled, dict(groups=4)))


def test_pools_match_the_reference_pools_in_expectation(tmp_path):
    jt, tt = _trainers(train_fraction=0.5)
    tt.run(total_spp=8)
    assert int(tt.initialized.sum()) > 0
    tio.save_full_checkpoint(str(tmp_path / "model.npz"), tt, [])
    jt.restore(str(tmp_path / "model.npz"))
    rc = tt.render_cfg
    gkw = dict(spp=SPP, width=GW, height=GH, max_depth=rc.max_depth,
               rr_depth=rc.rr_depth, bsdf_fraction=0.5, fov_axis=rc.fov_axis,
               bsdf_types=tuple(rc.bsdf_types))
    js, jcfg = make_box(jscene, jshapes, W, H).build()
    kw = dict(spp=SPP, width=W, height=H, max_depth=6, rr_depth=6,
              fov_axis=jcfg.fov_axis)

    def bounce_ref(fn, extra):
        return _mean_se(fn(js, jax.random.PRNGKey(3), interpret=True, **kw,
                           **extra))

    def guided_ref():
        out = jguided.render_pool_guided_striped(
            jt.scene, jt.guide_state(), jax.random.PRNGKey(5),
            interpret=True, **gkw)
        assert 0 < float(out["n_cond_ok"]) <= float(out["n_cond_try"])
        return _mean_se(out)

    with ThreadPoolExecutor(5) as ex:
        refs = {"guided_striped": ex.submit(guided_ref)}
        refs.update({name: ex.submit(bounce_ref, fn, extra)
                     for name, fn, extra in _bounce_pools(jwf)})
        got = {}
        ts, _ = make_box(tscene, tshapes, W, H).build(device="cpu")
        for name, fn, extra in _bounce_pools(twf):
            got[name] = _mean_se(fn(ts, 11, device="cpu", **kw, **extra))
        out = tguided.render_pool_guided_striped(
            tt.scene, tt.guide_state(), torch.Generator().manual_seed(6),
            device="cpu", **gkw)
        assert 0 < float(out["n_cond_ok"]) <= float(out["n_cond_try"])
        got["guided_striped"] = _mean_se(out)
        for name, mean_se in got.items():
            want = refs[name].result()
            assert within_se(mean_se, want), (name, mean_se, want)
