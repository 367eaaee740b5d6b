"""Port parity of path-space MLT's parts (sdmm_tpu_torch/render/mlt.py
against sdmm_tpu/render/mlt.py), on the reference's own draws and paths.

- trace_path_record fed the reference's per-bounce uniforms (its
  split(key, max_depth) draws) on the 32x32 box and on the box with a
  mirror slab of tests/test_mlt.py: integer and bool fields equal on every
  lane, rgb and wlum within rtol 1e-5 / atol 1e-6 on every lane, the
  vertex fields (pos, ns, ng, uv) within rtol 1e-5 / atol 1e-6 on all but
  GEOMETRY_OFF_LANES of the 4,096 lanes: from the third vertex on, float32
  rounding that differs between the packages compounds along the path
  (measured: 38 lanes on the box, 39 on the mirror box, mostly a few 1e-5
  off in a box 2 units wide; one lane reaches a corner and hits the other
  wall of the same BSDF);
- on the reference's recorded paths, carried across by
  convert.mlt_paths_from_arrays: path_pt_weight, the lens mutation's parts
  (_first_connectable, retrace_chain at a shifted screen position,
  lens_respan of both states, project_to_screen) and the caustic
  mutation's (_second_connectable, retrace_down along a perturbed
  direction, caustic_respan of both states), within rtol 1e-4.

Every reference call passes the scene's bsdf_types; the reference's parts
run in background threads, one a scene, while the port's run.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_box, to_np  # noqa: E402

from sdmm_tpu.render import mlt as jmlt  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import mlt as tmlt  # noqa: E402

torch.set_num_threads(2)
W = H = 32
N = 4096
DEPTH = 5
INT_FIELDS = ("bsdf", "delta", "emitter", "length", "valid")
VERTEX_FIELDS = ("pos", "ns", "ng", "uv")
GEOMETRY_OFF_LANES = 48


def _scene(mirror):
    b = make_box(jscene, jshapes, W, H)
    if mirror:  # tests/test_mlt.py's slab in front of the back wall
        m = b.add_bsdf(jscene.BSDF_CONDUCTOR, specular=[0.9, 0.9, 0.9],
                       eta=0.2, k=[3.0, 3.0, 3.0])
        t = np.eye(4)
        t[:3, 3] = MIRROR_AT
        t[0, 0] = t[1, 1] = 0.45
        b.add_shape(jshapes.make_rectangle(t), m)
    js, cfg = b.build()
    cfg.max_depth = cfg.rr_depth = DEPTH
    return js, cfg


def walk_draws(key, n, depth):
    """trace_path_record's uniforms as it draws them: [depth, n, 4]."""
    out = []
    for k in jax.random.split(key, depth):
        k1, k2, k3 = jax.random.split(k, 3)
        out.append(np.concatenate([
            np.asarray(jax.random.uniform(k1, (n,)))[:, None],
            np.asarray(jax.random.uniform(k2, (n,)))[:, None],
            np.asarray(jax.random.uniform(k3, (n, 2)))], 1))
    return np.stack(out)


MIRROR_AT = [0.4, 0.5, -0.75]


def _spos(seed):
    """Screen positions over the image; on the mirror box (seed 6) half of
    them within 3 pixels of the mirror's centre, so that many eye paths
    start with its delta chain."""
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (N, 2)))
    spos = u * np.float32(W)
    if seed == len("mirror"):
        js, cfg = _scene(True)
        c = np.asarray(jmlt.project_to_screen(
            js, jnp.asarray([MIRROR_AT]), W, H, cfg.fov_axis)[0])[0]
        spos[N // 2:] = c + 6.0 * (u[N // 2:] - 0.5)
    return spos.astype(np.float32)


def _mutation_inputs(path, seed):
    """A lens shift of the screen position (up to ~2 pixels) and a caustic
    direction: the stored direction e_m → e_{m-1} turned by ~0.01 rad."""
    rs = np.random.RandomState(seed)
    spos_new = path["spos"] + rs.uniform(-2.0, 2.0, (N, 2)).astype(np.float32)
    m = np.asarray(jmlt._second_connectable(
        {k: jnp.asarray(v) for k, v in path.items()})[0])
    ar = np.arange(N)
    d = path["pos"][ar, np.maximum(m - 1, 0)] - path["pos"][ar, m]
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    d = d + 0.01 * rs.normal(size=d.shape)
    wo_new = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return spos_new, wo_new


def _np_tree(d):
    return {k: np.asarray(v) for k, v in d.items()} if isinstance(d, dict) \
        else np.asarray(d)


def _reference(name, js, cfg):
    """The reference's recorded path, its parts and respans on one
    scene."""
    types = tuple(cfg.bsdf_types)
    key = jax.random.PRNGKey(1 if name == "box" else 2)
    path = jmlt.trace_path_record(js, key, jnp.asarray(_spos(len(name))),
                                  W, H, DEPTH, types, cfg.fov_axis)
    rec = {"path": _np_tree(path)}
    rec["pt"] = [_np_tree(x) for x in jmlt.path_pt_weight(js, path, types)]
    spos_new, wo_new = _mutation_inputs(rec["path"], len(name))
    j, has_j = jmlt._first_connectable(path)
    prop, ok = jmlt.retrace_chain(js, path, jnp.asarray(spos_new), j, W, H,
                                  types, cfg.fov_axis)
    valid = path["valid"] & has_j & ok
    rec["lens"] = {
        "j": np.asarray(j), "has_j": np.asarray(has_j),
        "prop": _np_tree(prop), "ok": np.asarray(ok),
        "resp_y": [_np_tree(x) for x in jmlt.lens_respan(
            js, prop, j, valid, types)],
        "resp_x": [_np_tree(x) for x in jmlt.lens_respan(
            js, path, j, path["valid"] & has_j, types)],
        "screen": [_np_tree(x) for x in jmlt.project_to_screen(
            js, path["pos"][:, 0], W, H, cfg.fov_axis)]}
    m, ok_s = jmlt._second_connectable(path)
    prop, ok = jmlt.retrace_down(js, path, m, jnp.asarray(wo_new), types)
    suit = path["valid"] & ok_s
    rec["caustic"] = {
        "m": np.asarray(m), "ok_struct": np.asarray(ok_s),
        "prop": _np_tree(prop), "ok": np.asarray(ok),
        "resp_y": [_np_tree(x) for x in jmlt.caustic_respan(
            js, prop, m, suit & ok, W, H, types, cfg.fov_axis)],
        "resp_x": [_np_tree(x) for x in jmlt.caustic_respan(
            js, path, m, suit, W, H, types, cfg.fov_axis)]}
    return rec


@pytest.fixture(scope="module")
def scenes():
    return {"box": _scene(False), "mirror": _scene(True)}


@pytest.fixture(scope="module")
def reference(scenes):
    """One background thread a scene (XLA compiles release the GIL)."""
    with ThreadPoolExecutor(len(scenes)) as ex:
        futures = {name: ex.submit(_reference, name, *sc)
                   for name, sc in scenes.items()}
        yield lambda name: futures[name].result()


def _close(got, want, rtol, what, atol=1e-6):
    if isinstance(want, dict):
        for k, v in want.items():
            _close(got[k], v, rtol, f"{what}: {k}", atol)
        return
    if isinstance(want, list):
        for i, (g, v) in enumerate(zip(got, want, strict=True)):
            _close(g, v, rtol, f"{what}: {i}", atol)
        return
    got = to_np(got)
    if want.dtype in (np.int32, np.bool_) or got.dtype == np.bool_:
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


def test_trace_path_record_matches_reference(scenes, reference):
    for name, (js, cfg) in scenes.items():
        key = jax.random.PRNGKey(1 if name == "box" else 2)
        got = tmlt.trace_path_record(
            convert.scene_from_arrays(js, device="cpu"), None,
            torch.as_tensor(_spos(len(name))), W, H, DEPTH,
            tuple(cfg.bsdf_types), cfg.fov_axis,
            rand=torch.as_tensor(walk_draws(key, N, DEPTH)), device="cpu")
        want = reference(name)["path"]
        assert set(got) == set(want) == set(tmlt.PATH_FIELDS)
        for k in INT_FIELDS:
            assert got[k].dtype == {np.int32: torch.int32,
                                    np.bool_: torch.bool}[want[k].dtype.type]
        _close({k: got[k] for k in want if k not in VERTEX_FIELDS},
               {k: v for k, v in want.items() if k not in VERTEX_FIELDS},
               1e-5, name)
        off = np.zeros(N, bool)
        for k in VERTEX_FIELDS:
            g, w = to_np(got[k]), want[k]
            off |= (np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)).reshape(
                N, -1).any(1)
        assert off.sum() <= GEOMETRY_OFF_LANES, (name, off.sum())
        assert want["valid"].sum() > 60, name
    assert reference("mirror")["path"]["delta"].any()


def test_lens_parts_match_reference(scenes, reference):
    for name, (js, cfg) in scenes.items():
        types = tuple(cfg.bsdf_types)
        ts = convert.scene_from_arrays(js, device="cpu")
        want = reference(name)
        path = convert.mlt_paths_from_arrays(want["path"], device="cpu")
        _close(tmlt.path_pt_weight(ts, path, types), want["pt"], 1e-4,
               f"{name} pt")
        spos_new, _ = _mutation_inputs(want["path"], len(name))
        lens = want["lens"]
        j, has_j = tmlt._first_connectable(path)
        _close(j, lens["j"].astype(np.int64), 0, f"{name} j")
        _close(has_j, lens["has_j"], 0, f"{name} has_j")
        prop, ok = tmlt.retrace_chain(ts, path, torch.as_tensor(spos_new), j,
                                      W, H, types, cfg.fov_axis)
        _close(prop, lens["prop"], 1e-4, f"{name} retrace_chain")
        _close(ok, lens["ok"], 0, f"{name} retrace_chain ok")
        valid = path["valid"] & has_j & ok
        _close(tmlt.lens_respan(ts, prop, j, valid, types), lens["resp_y"],
               1e-4, f"{name} lens_respan y")
        _close(tmlt.lens_respan(ts, path, j, path["valid"] & has_j, types),
               lens["resp_x"], 1e-4, f"{name} lens_respan x")
        _close(tmlt.project_to_screen(ts, path["pos"][:, 0], W, H,
                                      cfg.fov_axis), lens["screen"], 1e-4,
               f"{name} project_to_screen")
        assert (lens["resp_y"][0] > 0).sum() > 30, name
        if name == "mirror":  # re-traces through the mirror's delta chain
            assert (lens["ok"] & (lens["j"] > 0) & want["path"]["valid"]
                    ).sum() > 3


def test_caustic_parts_match_reference(scenes, reference):
    js, cfg = scenes["mirror"]
    types = tuple(cfg.bsdf_types)
    ts = convert.scene_from_arrays(js, device="cpu")
    want = reference("mirror")
    path = convert.mlt_paths_from_arrays(want["path"], device="cpu")
    _, wo_new = _mutation_inputs(want["path"], len("mirror"))
    c = want["caustic"]
    m, ok_s = tmlt._second_connectable(path)
    _close(m, c["m"].astype(np.int64), 0, "m")
    _close(ok_s, c["ok_struct"], 0, "ok_struct")
    prop, ok = tmlt.retrace_down(ts, path, m, torch.as_tensor(wo_new), types)
    _close(prop, c["prop"], 1e-4, "retrace_down")
    _close(ok, c["ok"], 0, "retrace_down ok")
    suit = path["valid"] & ok_s
    _close(tmlt.caustic_respan(ts, prop, m, suit & ok, W, H, types,
                               cfg.fov_axis), c["resp_y"], 1e-4,
           "caustic_respan y")
    _close(tmlt.caustic_respan(ts, path, m, suit, W, H, types, cfg.fov_axis),
           c["resp_x"], 1e-4, "caustic_respan x")
    # The mirror gives caustic structures with a delta chain, and some of
    # them survive the re-trace.
    assert (c["ok_struct"] & want["path"]["valid"]).sum() > 20
    assert (c["resp_y"][0] > 0).sum() > 10
