"""Port parity: the fused guided bounce's emitter fields and helpers
(ops/bounce.py, ops/guided_step.py), sdmm_tpu_torch vs sdmm_tpu on the
same numpy inputs; helpers rtol 1e-5.

Files of few tests, which the tier-1 scheduler (``--dist loadfile``,
files with the most tests first) runs after the long reference files,
hold the rest: the tables (tests/test_torch_guided_step_tables.py), the
shade table's packing and shade on the packed table
(tests/test_torch_guided_step_pack.py), and the trace and shade twins
against the reference kernels in interpret mode with the frozen-model pool
render_pool_guided_fused against the reference's XLA pool
(tests/test_torch_guided_step_kernels.py, ~2 minutes of CPU).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import lane_wave, make_box, to_np  # noqa: E402

from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.bsdf import fresnel as tfresnel  # noqa: E402
from sdmm_tpu_torch.core import frame as tframe  # noqa: E402
from sdmm_tpu_torch.core import warp as twarp  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

torch.set_num_threads(2)
R = 16  # lane rows of 128: one shade tile and one trace tile
N = R * 128
MAX_DEPTH, RR_DEPTH, FRACTION = 5, 3, 0.5
TYPES = (0, 1, 2, 3)


def _scenes(extra):
    js, _ = make_box(jscene, jshapes, 16, 16, extra).build()
    ts, tcfg = make_box(tscene, tshapes, 16, 16, extra).build(device="cpu")
    return js, ts, tcfg


@pytest.mark.parametrize("extra", [False, True])
def test_em_tri_fields_match_reference(extra):
    js, ts, _ = _scenes(extra)
    for name in ("em_tri_idx", "em_tri_cdf", "em_tri_pdf", "em_tri_area"):
        np.testing.assert_array_equal(to_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)), name)
    from sdmm_tpu.scene import emitters as jem
    from sdmm_tpu_torch.scene import emitters as tem

    np.testing.assert_array_equal(to_np(tem.tri_pdf_over_area(ts)),
                                  np.asarray(jem.tri_pdf_over_area(js)))


def _helper_inputs(seed=0, n=4096):
    rs = np.random.RandomState(seed)
    v = rs.randn(3, n)
    v /= np.linalg.norm(v, axis=0)
    wi = v * np.array([[1.0], [1.0], [-1.0]]) ** (v[2:3] < 0)  # z >= 0
    m = rs.randn(3, n)
    m[2] = np.abs(m[2])
    m /= np.linalg.norm(m, axis=0)
    cos_i = rs.uniform(-1, 1, n)
    cos_i[::50] = 0.0  # sign(0) = 0 in the refracted cosine
    u = rs.rand(2, n)
    u[:, ::64] = 0.5  # the disk map's centre
    f = np.float32
    return dict(v=v.astype(f), wi=wi.astype(f), m=m.astype(f),
                cos_i=cos_i.astype(f),
                eta=rs.uniform(0.2, 2.5, n).astype(f),
                k=rs.uniform(0.0, 4.0, n).astype(f),
                alpha=rs.uniform(0.05, 0.8, n).astype(f), u=u.astype(f))


def _same(call):
    """A helper whose twin in ops/bounce.py has the reference's name and
    signature."""
    return (lambda x: call(bo, x), lambda x: call(bp, x))


# name: (port twin, reference helper), each called on a dict of inputs. The
# first four twins are the port's frame, warp and Fresnel functions.
HELPERS = {
    "coordinate_system": (
        lambda x: tuple(torch.cat(tframe.coordinate_system(
            torch.stack(tuple(x["v"]), -1)), -1).unbind(-1)),
        lambda x: bp._coordinate_system(*x["v"])),
    "disk_concentric": (
        lambda x: tuple(twarp.square_to_uniform_disk_concentric(
            x["u"].T).unbind(-1)),
        lambda x: bp._disk_concentric(*x["u"])),
    "fresnel_dielectric": (
        lambda x: tfresnel.fresnel_dielectric(x["cos_i"], x["eta"]),
        lambda x: bp._fresnel_dielectric(x["cos_i"], x["eta"])),
    "fresnel_conductor_1": (
        lambda x: tfresnel.fresnel_conductor(
            x["cos_i"], x["eta"][:, None], x["k"][:, None])[:, 0],
        lambda x: bp._fresnel_conductor_1(x["cos_i"], x["eta"], x["k"])),
    "ggx_d": _same(lambda m, x: m._ggx_d(x["m"][2], x["alpha"])),
    "smith_g1": _same(lambda m, x: m._smith_g1(*x["v"], *x["m"],
                                               x["alpha"])),
    "sample_vndf": _same(lambda m, x: m._sample_vndf(*x["wi"], x["alpha"],
                                                     *x["u"])),
    "vndf_pdf": _same(lambda m, x: m._vndf_pdf(*x["v"], *x["m"],
                                               x["alpha"])),
}


TRIG = ("disk_concentric", "sample_vndf")


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_twins_match_reference(name):
    x = _helper_inputs()
    port, ref = HELPERS[name]
    out_t = port({k: torch.as_tensor(v) for k, v in x.items()})
    out_j = ref({k: jnp.asarray(v) for k, v in x.items()})
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        a, b = to_np(a), np.asarray(b)
        if name not in TRIG:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            continue
        # torch's and XLA's cos/sin differ by an ulp, and the VNDF's
        # sqrt(1 - p1² - p2²) amplifies it where the argument nears 0.
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert close.mean() >= 0.999, close.mean()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_woop_tri_twin_matches_reference():
    js, _, _ = _scenes(True)
    tri = np.asarray(bp.build_tables(js)[0])
    state, _, _ = lane_wave(2048, seed=3)
    ro_rd_t = [torch.as_tensor(r) for r in state[0:6]]
    ro_rd_j = [jnp.asarray(r) for r in state[0:6]]
    for j in (0, 5, 13, 40):
        for a, b in zip(bo._woop_tri(*ro_rd_t, torch.as_tensor(tri), j),
                        bp._woop_tri(*ro_rd_j, jnp.asarray(tri), j)):
            if a.dtype == torch.bool:
                assert float((to_np(a) == np.asarray(b)).mean()) > 0.999
            else:
                np.testing.assert_allclose(to_np(a), np.asarray(b),
                                           rtol=1e-5, atol=1e-5)
