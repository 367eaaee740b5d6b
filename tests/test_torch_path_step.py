"""Port parity: the fused unguided step with NEE (ops/bounce.py step twin,
its Philox twin and camera packing) and the NEE building blocks
(warp.square_to_uniform_triangle, volpath.mi_weight, emitters.sample_direct
and pdf_direct_hit, intersect.occluded), sdmm_tpu_torch vs sdmm_tpu on the
same numpy inputs.

Tolerances: helpers rtol 1e-5 (the same float32 formulas). The step twin
against three interpret-mode steps of the reference kernel is in
tests/test_torch_path_step_kernel.py (the kernel's ~26 s compile, in a
file of few tests that the tier-1 scheduler runs late); here the step's
Philox mode and tile skip, on the wave that file starts from.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import make_glossy_box, path_wave, to_np  # noqa: E402

from sdmm_tpu.core import warp as jwarp  # noqa: E402
from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.render import volpath as jvolpath  # noqa: E402
from sdmm_tpu.scene import emitters as jem  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.core import warp as twarp  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render import volpath as tvolpath  # noqa: E402
from sdmm_tpu_torch.scene import emitters as tem  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
W = H = 16
R = bo.RT  # one 64 x 128 lane tile
N = R * 128
MAX_DEPTH, RR_DEPTH = 5, 3
TYPES = (0, 1, 2, 3)
STEPS = 3


def _scenes():
    js, _ = make_glossy_box(jscene, jshapes, W, H).build()
    ts, tcfg = make_glossy_box(tscene, tshapes, W, H).build(device="cpu")
    return js, ts, tcfg


def _wave(seed=7):
    """Lanes of every kind: alive at every depth, dead with samples left
    (regenerated on their pixel), dead with none (exhausted now), and
    exhausted; a previous-bounce pdf, delta flags and a film to add to; one
    set of uniforms per step."""
    state, meta, film, pxpy, rand = path_wave(N, seed, W, H, MAX_DEPTH)
    rs = np.random.RandomState(seed + 2)
    rands = [rand] + [rs.rand(bo.STEP_RAND_ROWS, N).astype(np.float32)
                      for _ in range(STEPS - 1)]
    return state, meta, film, pxpy, rands


# Random123's known-answer vectors for Philox4x32-10: (counter, key, out).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_twin_matches_known_answers(ctr, key, want):
    words = bo.philox4x32(
        [torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in words) == want


def test_philox_uniforms_layout():
    u = bo.philox_uniforms((11, 3), 4099)
    assert u.shape == (bo.STEP_RAND_ROWS, 4099) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # Row r of lane i is word r % 4 of the counter (i, r // 4, 0, 0).
    lane = torch.tensor([17, 4098], dtype=torch.int64)
    zero = torch.zeros_like(lane)
    w = bo.philox4x32((lane, torch.full_like(lane, 2), zero, zero), (11, 3))
    np.testing.assert_array_equal(
        to_np(u[9, [17, 4098]]), to_np((w[1] >> 8).float() / 16777216.0))
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert not torch.equal(u, bo.philox_uniforms((11, 4), 4099))


def _helper_inputs(seed=0, n=4096):
    rs = np.random.RandomState(seed)
    f = np.float32
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pdf = rs.uniform(0.0, 5.0, (2, n))
    pdf[:, ::7] = 0.0
    return dict(u=rs.rand(n, 2).astype(f), pdf=pdf.astype(f),
                p=(rs.rand(n, 3) * [1.9, 1.9, 1.9] + [-0.95, 0.05, -0.95])
                .astype(f), u1=rs.rand(n).astype(f), u2=rs.rand(n, 2).astype(f),
                d=d.astype(f), dist=rs.uniform(0.1, 3.0, n).astype(f),
                tmax=rs.uniform(0.05, 4.0, n).astype(f))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=rtol, atol=atol)


def test_square_to_uniform_triangle_matches_reference():
    x = _helper_inputs()
    _close(twarp.square_to_uniform_triangle(torch.as_tensor(x["u"])),
           jwarp.square_to_uniform_triangle(jnp.asarray(x["u"])))


def test_mi_weight_matches_reference():
    x = _helper_inputs()
    a, b = x["pdf"]
    _close(tvolpath.mi_weight(torch.as_tensor(a), torch.as_tensor(b)),
           jvolpath.mi_weight(jnp.asarray(a), jnp.asarray(b)))
    assert tvolpath.RAY_EPS == jvolpath.RAY_EPS


def test_sample_direct_matches_reference():
    js, ts, _ = _scenes()
    x = _helper_inputs(1)
    x["p"][::4, 1] = 1.99  # above the light, which faces down: invalid
    out_t = tem.sample_direct(ts, torch.as_tensor(x["p"]),
                              torch.as_tensor(x["u1"]),
                              torch.as_tensor(x["u2"]))
    out_j = jem.sample_direct(js, jnp.asarray(x["p"]), jnp.asarray(x["u1"]),
                              jnp.asarray(x["u2"]))
    assert sorted(out_t) == sorted(out_j)
    assert 0.5 < float(out_t["valid"].float().mean()) < 0.9
    for k in ("valid", "delta"):
        np.testing.assert_array_equal(to_np(out_t[k]), np.asarray(out_j[k]))
    for k in ("d", "dist", "pdf", "radiance", "n"):
        _close(out_t[k], out_j[k])


def test_pdf_direct_hit_matches_reference():
    js, ts, _ = _scenes()
    x = _helper_inputs(2)
    n_tris = ts.tri_v0.shape[0]
    tri = np.random.RandomState(3).randint(-1, n_tris, len(x["dist"]))
    tri[::5] = to_np(ts.em_tri_idx)[0]  # emissive hits
    dense_t = tem.tri_pdf_over_area(ts)
    dense_j = jem.tri_pdf_over_area(js)
    got = tem.pdf_direct_hit(ts, dense_t, torch.as_tensor(tri, dtype=torch.int32),
                             torch.as_tensor(x["d"]), torch.as_tensor(x["dist"]))
    want = jem.pdf_direct_hit(js, dense_j, jnp.asarray(tri, jnp.int32),
                              jnp.asarray(x["d"]), jnp.asarray(x["dist"]))
    assert float((got > 0).float().mean()) > 0.05
    _close(got, want)


def test_occluded_matches_reference():
    js, ts, _ = _scenes()
    x = _helper_inputs(3)
    got = to_np(tisect.occluded(ts, torch.as_tensor(x["p"]),
                                torch.as_tensor(x["d"]),
                                torch.as_tensor(x["tmax"])))
    want = np.asarray(jisect.occluded(js, jnp.asarray(x["p"]),
                                      jnp.asarray(x["d"]),
                                      jnp.asarray(x["tmax"])))
    assert 0.2 < want.mean() < 0.9
    assert (got == want).mean() >= 0.999


def test_build_cam_params_matches_reference():
    js, ts, _ = _scenes()
    for fov_axis in ("x", "y"):
        _close(bo.build_cam_params(ts, 24, 16, fov_axis),
               bp.build_cam_params(js, 24, 16, fov_axis))


def _port_tables():
    _, ts, tcfg = _scenes()
    tri, em, env = bo.build_tables(ts)
    return ts, tri, em, env, bo.build_cam_params(ts, W, H)


def _port_step(ins, pxpy, rand, tile_alive=None):
    ts, tri, em, env, cam = _port_tables()
    state, meta, film = (torch.tensor(a) for a in ins)
    if tile_alive is None:
        tile_alive = torch.ones(1, dtype=torch.int32)
    out = bo.step(state, meta, film, tile_alive, cam, (0, 0),
                  torch.as_tensor(pxpy), tri, em, env,
                  int(ts.em_tri_idx.shape[0]), MAX_DEPTH, RR_DEPTH, TYPES, W,
                  H, rand=None if rand is None else torch.as_tensor(rand))
    assert out[0] is state and out[1] is meta and out[2] is film  # in place
    return tuple(to_np(a) for a in out)


def test_step_philox_mode_and_tile_skip():
    """On the first step's wave: the Philox mode equals host uniforms of
    the same Philox bits, and a tile marked dead is left as it was."""
    state, meta, film, pxpy, rands = _wave()
    ins = (state, meta, film)
    u = to_np(bo.philox_uniforms((0, 0), N))
    a = _port_step(ins, pxpy, None)
    b = _port_step(ins, pxpy, u)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    skipped = _port_step(ins, pxpy, rands[0],
                         torch.zeros(1, dtype=torch.int32))
    for x, y in zip(skipped, ins):
        np.testing.assert_array_equal(x, y)
