"""Port parity of BDPT (sdmm_tpu_torch/render/bdpt.py against
sdmm_tpu/render/bdpt.py), on the reference's own draws (rebuilt with
jax.random as each reference function splits and folds its key):

- _convert, _we_dir (both fov axes) and _mis_weight for every executed
  (s, t) strategy up to depth 5, on synthetic vertex arrays with zero pdfs
  and delta vertices: rtol 1e-5, every weight in (0, 1];
- _sample_light_origin, _walk (3 vertices, 64 lanes) and
  _prepend_light_origin: every field within rtol 1e-5;
- trace_bdpt whole, 256 lanes on the 16x16 box of torch_parity.make_box at
  max_depth 5 and on the box with a mirror and a glass sphere (7,948
  triangles) at max_depth 4: li and the splat within rtol 1e-4 / atol 1e-6
  (the splat sums in another order).

Every reference call passes the scene's bsdf_types (an untyped trace_bdpt
compiles every BSDF model into every strategy, minutes on the CPU); the
reference's jitted calls compile in a background thread.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_ptracer import bsdf_draws, emission_draws  # noqa: E402
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.render import bdpt as jbd  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import bdpt as tbd  # noqa: E402

torch.set_num_threads(2)
W = H = 16
N_LANES = 256


def delta_box():
    """The box with a mirror and a glass sphere (tests/test_bdpt.py's
    scene at 16x16)."""
    b = make_box(jscene, jshapes, W, H)
    mirror = b.add_bsdf(jscene.BSDF_CONDUCTOR, albedo=[0.9, 0.9, 0.9])
    glass = b.add_bsdf(jscene.BSDF_DIELECTRIC, eta=1.5)
    b.add_shape(jshapes.make_sphere(np.array([-0.45, 0.4, 0.2]), 0.35,
                                    np.eye(4)), mirror)
    b.add_shape(jshapes.make_sphere(np.array([0.5, 0.35, -0.1]), 0.3,
                                    np.eye(4)), glass)
    return b


def walk_draws(key, n, n_verts):
    return np.stack([bsdf_draws(jax.random.fold_in(key, i), n)
                     for i in range(n_verts)])


def bdpt_draws(key, n, max_depth):
    """trace_bdpt's uniforms, in the port's rand layout."""
    k_e, k_l, k_s = jax.random.split(key, 3)
    return {"eye": walk_draws(k_e, n, max_depth),
            "light_origin": emission_draws(k_l, n),
            "light": walk_draws(jax.random.fold_in(k_l, 1), n,
                                max_depth - 1),
            "s1": np.stack([emission_draws(jax.random.fold_in(k_s, 100 + t),
                                           n)
                            for t in range(2, max_depth + 1)])}


def _pixels(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, W, (N_LANES, 2))
            + rs.rand(N_LANES, 2)).astype(np.float32)


def _tensors(d):
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


def _as_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


WALK_KEYS = ("p", "ns", "ng", "bsdf", "uv", "wi", "beta", "pdf_fwd",
             "pdf_rev_dir_to_prev", "prev_p", "delta", "prev_delta",
             "vdelta", "valid", "miss_env", "emitter", "tri", "pdf_rev")


def _reference(scenes):
    (js, jcfg), (jd, dcfg) = scenes
    types = jcfg.bsdf_types
    out = {}
    key = jax.random.PRNGKey(11)
    l0 = jbd._sample_light_origin(js, key, 64)
    beta1 = l0["Le"] * (jnp.pi / l0["pdf_pos"])[:, None]
    walk = jax.jit(partial(jbd._walk, n_verts=3, types=types))
    lw = walk(js, jax.random.fold_in(key, 1), l0["p"] + l0["n"] * 1e-4,
              l0["d"], beta1, l0["pdf_dir"])
    out["l0"], out["lw"] = _as_np(l0), _as_np(lw)
    out["lv"] = _as_np(jbd._prepend_light_origin(l0, lw, 3))
    for name, (sc, cfg), depth, seed in (("box", (js, jcfg), 5, 3),
                                          ("delta", (jd, dcfg), 4, 4)):
        li, splat = jbd.trace_bdpt(sc, jax.random.PRNGKey(seed),
                                   jnp.asarray(_pixels(seed)), W, H,
                                   max_depth=depth,
                                   bsdf_types=cfg.bsdf_types)
        out[name] = (np.asarray(li), np.asarray(splat))
    return out


@pytest.fixture(scope="module")
def scenes():
    return make_box(jscene, jshapes, W, H).build(), delta_box().build()


@pytest.fixture(scope="module")
def reference(scenes):
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(_reference, scenes)


def _synthetic_vertices(rs, n, v):
    def pdfs():
        x = rs.uniform(0.05, 4.0, (n, v)).astype(np.float32)
        x[rs.rand(n, v) < 0.1] = 0.0
        return x

    return {"p": rs.randn(n, v, 3).astype(np.float32), "pdf_fwd": pdfs(),
            "pdf_rev": pdfs(), "vdelta": rs.rand(n, v) < 0.15}


def test_convert_we_dir_and_mis_weights_match_reference(scenes):
    (js, _), _ = scenes
    ts = convert.scene_from_arrays(js, device="cpu")
    rs = np.random.RandomState(0)
    n = 512
    a, b, nrm = (rs.randn(n, 3).astype(np.float32) for _ in range(3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pdf = rs.uniform(0.0, 3.0, n).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tbd._convert(*(torch.as_tensor(x) for x in (pdf, a, b, nrm)))),
        np.asarray(jbd._convert(pdf, a, b, nrm)), rtol=1e-5)
    d = rs.randn(n, 3).astype(np.float32) + [0.0, 0.0, -2.5]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    for axis in ("x", "y"):
        want = np.asarray(jbd._we_dir(js, jnp.asarray(d), W, 12, axis))
        assert 0.2 < (want > 0).mean() < 0.9
        np.testing.assert_allclose(
            to_np(tbd._we_dir(ts, torch.as_tensor(d), W, 12, axis)), want,
            rtol=1e-5)

    depth = 5
    ev = _synthetic_vertices(rs, n, depth)
    lv = _synthetic_vertices(rs, n, depth)
    lv["vdelta"][:, 0] = False  # the emitter point is never delta
    lv1 = {"p": lv["p"][:, :1], "pdf_fwd": lv["pdf_fwd"][:, :1],
           "pdf_rev": np.zeros((n, 1), np.float32),
           "vdelta": np.zeros((n, 1), bool)}
    strategies = ([(0, t) for t in range(2, depth + 2)]
                  + [(1, t) for t in range(2, depth + 1)]
                  + [(s, 1) for s in range(2, depth + 1)]
                  + [(s, t) for t in range(2, depth + 1)
                     for s in range(2, depth + 1) if s + t - 1 <= depth])
    assert len(strategies) == 5 + 4 + 4 + 6
    for s, t in strategies:
        revs = [rs.uniform(0.0, 3.0, n).astype(np.float32) for _ in range(4)]
        used = (t >= 2, t >= 3, s >= 1, s >= 2)  # pt, ptm, qs, qsm
        revs = [r if u else None for r, u in zip(revs, used)]
        lvs = lv1 if s == 1 else lv
        want = np.asarray(jbd._mis_weight(
            {k: jnp.asarray(v) for k, v in ev.items()},
            {k: jnp.asarray(v) for k, v in lvs.items()}, s, t,
            *(None if r is None else jnp.asarray(r) for r in revs)))
        got = to_np(tbd._mis_weight(
            _tensors(ev), _tensors(lvs), s, t,
            *(None if r is None else torch.as_tensor(r) for r in revs)))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"(s, t) = ({s}, {t})")
        assert ((got > 0) & (got <= 1)).all(), (s, t)
        assert s + t == 2 or (got < 1).mean() > 0.5, (s, t)


def test_light_subpath_matches_reference(scenes, reference):
    (js, jcfg), _ = scenes
    ts = convert.scene_from_arrays(js, device="cpu")
    key = jax.random.PRNGKey(11)
    l0 = tbd._sample_light_origin(ts, torch.as_tensor(emission_draws(key,
                                                                     64)))
    beta1 = l0["Le"] * (np.pi / l0["pdf_pos"])[:, None]
    lw = tbd._walk(ts, l0["p"] + l0["n"] * 1e-4, l0["d"], beta1,
                   l0["pdf_dir"], 3, jcfg.bsdf_types, torch.as_tensor(
                       walk_draws(jax.random.fold_in(key, 1), 64, 3)))
    lv = tbd._prepend_light_origin(l0, lw, 3)
    want = reference.result()
    assert set(lw) == set(WALK_KEYS)
    for name, got in (("l0", l0), ("lw", lw), ("lv", lv)):
        assert set(got) == set(want[name]), name
        for k, v in want[name].items():
            np.testing.assert_allclose(to_np(got[k]).astype(v.dtype), v,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}: {k}")
    assert want["lw"]["valid"][:, 2].mean() > 0.5


def test_trace_bdpt_matches_reference(scenes, reference):
    """Every strategy of a wave on the reference's draws: the diffuse box
    at depth 5 and the box with delta spheres at depth 4."""
    for name, (sc, cfg), depth, seed in (("box", scenes[0], 5, 3),
                                          ("delta", scenes[1], 4, 4)):
        ts = convert.scene_from_arrays(sc, device="cpu")
        rand = _tensors(bdpt_draws(jax.random.PRNGKey(seed), N_LANES, depth))
        li, splat = tbd.trace_bdpt(ts, None, torch.as_tensor(_pixels(seed)),
                                   W, H, max_depth=depth,
                                   bsdf_types=cfg.bsdf_types, rand=rand,
                                   device="cpu")
        want_li, want_splat = reference.result()[name]
        assert (want_li > 0).all(-1).mean() > 0.6 and (
            want_splat > 0).all(-1).mean() > 0.3, name
        np.testing.assert_allclose(to_np(li), want_li, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name}: li")
        np.testing.assert_allclose(to_np(splat), want_splat, rtol=1e-4,
                                   atol=1e-6, err_msg=f"{name}: splat")
