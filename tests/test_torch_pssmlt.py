"""Port parity of the PSS measurement and mutations of PSSMLT and ERPT
(sdmm_tpu_torch/render/pssmlt.py against sdmm_tpu/render/pssmlt.py), on the
reference's own draws: each uniform a reference function draws is rebuilt
here with jax.random as it splits its key, and fed to the port.

- eval_path on the reference's u at depth 3 on the 32x32 box: pix equal,
  value and lum within rtol 1e-4 / atol 1e-6;
- _small_step, _lens_step and _tail_step on the reference's draws: rtol
  1e-6;
- the chain seeds of render_pssmlt: seed_chains on the reference's
  bootstrap luminances gives the reference's indices.

The reference's jitted eval_path (with the scene's bsdf_types) compiles in a
background thread while the port's parts run.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.render import pssmlt as jps  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import pssmlt as tps  # noqa: E402

torch.set_num_threads(2)
W = H = 32
DEPTH = 3
N = 1 << 13
N_BOOT = N  # one shape: one reference compile of eval_path
N_CHAINS = 1 << 10
SEED = 1234


def _u(key, n, depth):
    return jax.random.uniform(key, (n, jps.pss_dims(depth)))


def _boot_u():
    """render_pssmlt's bootstrap vectors for seed SEED."""
    kb, _, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    return _u(kb, N_BOOT, DEPTH)


def _reference(scene):
    js, cfg = scene
    out = {}
    for name, u in (("path", _u(jax.random.PRNGKey(0), N, DEPTH)),
                    ("boot", _boot_u())):
        res = jps.eval_path(js, u, W, H, max_depth=DEPTH,
                            bsdf_types=tuple(cfg.bsdf_types))
        out[name] = {k: np.asarray(v) for k, v in res.items()}
    return out


@pytest.fixture(scope="module")
def scene():
    return make_box(jscene, jshapes, W, H).build()


@pytest.fixture(scope="module")
def reference(scene):
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference, scene)


def test_eval_path_matches_reference(scene, reference):
    js, cfg = scene
    ts = convert.scene_from_arrays(js, device="cpu")
    u = np.asarray(_u(jax.random.PRNGKey(0), N, DEPTH))
    got = tps.eval_path(ts, torch.as_tensor(u.copy()), W, H, max_depth=DEPTH,
                        bsdf_types=tuple(cfg.bsdf_types), device="cpu")
    want = reference.result()["path"]
    np.testing.assert_array_equal(to_np(got["pix"]), want["pix"])
    for k in ("value", "lum"):
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert (want["lum"] > 0).mean() > 0.5


def test_mutation_steps_match_reference():
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(jax.random.fold_in(key, 1), (4096, jps.pss_dims(4)))
    tu = torch.as_tensor(np.array(u))
    k1, k2 = jax.random.split(key)  # as each step splits its key
    r, r_sign = (torch.as_tensor(np.array(jax.random.uniform(k, u.shape)))
                 for k in (k1, k2))
    np.testing.assert_allclose(to_np(tps._small_step(tu, r, r_sign)),
                               np.asarray(jps._small_step(key, u)),
                               rtol=1e-6, atol=1e-7)
    r, r_phi = (torch.as_tensor(np.array(jax.random.uniform(k, (4096,))))
                for k in (k1, k2))
    np.testing.assert_allclose(to_np(tps._lens_step(tu, r, r_phi, W, H)),
                               np.asarray(jps._lens_step(key, u, W, H)),
                               rtol=1e-6, atol=1e-7)
    r, r_sign = (torch.as_tensor(np.array(jax.random.uniform(k, (4096, 7))))
                 for k in (k1, k2))
    got = to_np(tps._tail_step(tu, r, r_sign))
    np.testing.assert_allclose(got, np.asarray(jps._tail_step(key, u)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[:, :-7], np.asarray(u)[:, :-7])


def test_chain_seeds_match_reference(scene, reference):
    """render_pssmlt's seeding, on the reference's bootstrap luminances and
    on the port's of the same vectors."""
    js, cfg = scene
    lum = reference.result()["boot"]["lum"]
    probs = np.asarray(lum, dtype=np.float64)
    probs = probs / probs.sum()
    want = np.random.default_rng(SEED).choice(N_BOOT, size=N_CHAINS, p=probs)
    np.testing.assert_array_equal(tps.seed_chains(lum, N_CHAINS, SEED), want)
    ts = convert.scene_from_arrays(js, device="cpu")
    port = tps.eval_path(ts, torch.as_tensor(np.array(_boot_u())), W, H,
                         max_depth=DEPTH, bsdf_types=tuple(cfg.bsdf_types),
                         device="cpu")["lum"]
    got = tps.seed_chains(to_np(port), N_CHAINS, SEED)
    assert (got == want).mean() > 0.999
    assert len(np.unique(want)) > N_CHAINS // 4
