"""Port parity of the classic integrators (sdmm_tpu_torch/render/classic.py
against sdmm_tpu/render/classic.py) on a scene written inline: the box of
torch_parity.make_box as a scene file, with a cube keyframed by an
<animation> translation and rotation, loaded by each package's own loader.

- trace_field on every entry of FIELDS, and trace_motion, on the same
  camera rays: rtol 1e-5 (atol 1e-5 on coordinates near 0);
- trace_direct (two emitter samples and one BSDF sample, as -D
  emitterSamples=2) and trace_ao (rayLength < 0) through each package's
  wave renderer: image means within 4 joint standard errors; given
  uniforms (rand) reproduce a generator's draws;
- render_adaptive: the pixels that see nothing are black and stop after
  the first pass in both packages, and the image means lie within 4
  standard errors.

Renders draw their own random numbers (JAX threefry, torch Philox), so they
agree in expectation. The reference's compiles run in a background thread
while the port's parts run; the reference's tests/test_motion.py reads
scene files that the repo does not hold, so this scene is written here.
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
from torch_parity import (  # noqa: E402
    film_mean_se, to_np, within_se,
)

from sdmm_tpu.render import classic as jclassic  # noqa: E402
from sdmm_tpu.render import renderer as jrenderer  # noqa: E402
from sdmm_tpu.scene import sensor as jsensor  # noqa: E402
from sdmm_tpu.scene import xml_loader as jxml  # noqa: E402
from sdmm_tpu_torch.render import classic as tclassic  # noqa: E402
from sdmm_tpu_torch.render import renderer as trenderer  # noqa: E402
from sdmm_tpu_torch.scene import sensor as tsensor  # noqa: E402
from sdmm_tpu_torch.scene import xml_loader as txml  # noqa: E402

torch.set_num_threads(2)
W, H = 24, 16
SPP = 16
# The box seen from further back than make_box's camera, so that the
# image's border sees nothing (an open front: no wall behind the camera).
SCENE = """<scene version="0.6.0">
  <integrator type="direct"><integer name="emitterSamples" value="2"/>
  </integrator>
  <sensor type="perspective"><float name="fov" value="50"/>
    <transform name="toWorld"><lookat origin="0, 1, 5" target="0, 1, 0"
      up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="24"/>
      <integer name="height" value="16"/></film>
  </sensor>
  <bsdf type="diffuse" id="white"><rgb name="reflectance"
    value="0.725, 0.71, 0.68"/></bsdf>
  <bsdf type="diffuse" id="red"><rgb name="reflectance"
    value="0.63, 0.065, 0.05"/></bsdf>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1"
    angle="-90"/></transform><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1"
    angle="90"/><translate y="2"/></transform><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld"><translate y="1"
    z="-1"/></transform><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate y="1"
    angle="90"/><translate x="-1" y="1"/></transform><ref id="red"/>
  </shape>
  <shape type="rectangle"><transform name="toWorld"><scale x="0.3"
    y="0.3"/><rotate x="1" angle="90"/><translate y="1.98"/></transform>
    <emitter type="area"><rgb name="radiance" value="20"/></emitter>
  </shape>
  <shape type="cube"><animation name="toWorld">
    <transform time="0"><scale value="0.35"/><translate x="0.3" y="0.5"/>
    </transform>
    <transform time="1"><scale value="0.35"/><rotate y="1" angle="25"/>
      <translate x="0.45" y="0.6" z="0.1"/></transform>
  </animation><ref id="white"/></shape>
</scene>
"""


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = tmp_path_factory.mktemp("classic") / "scene.xml"
    path.write_text(SCENE)
    jb = jxml.load_scene(str(path))
    tb = txml.load_scene(str(path))
    (js, jcfg), (ts, tcfg) = jb.build(), tb.build(device="cpu")
    for name in ("tri_v0", "tri_mot", "mot_m0", "mot_m1"):
        np.testing.assert_array_equal(to_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)))
    return js, jcfg, ts, tcfg


def _rays(seed=0):
    rs = np.random.RandomState(seed)
    pix = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(
        -1, 2) + rs.rand(W * H, 2)
    return pix.astype(np.float32)


def _reference_fields(js, jcfg):
    ro, rd = jsensor.generate_rays(js, jnp.asarray(_rays()), W, H)
    key = jax.random.PRNGKey(0)
    out = {f: np.asarray(jclassic.trace_field(
        js, key, ro, rd, field=f, bsdf_types=jcfg.bsdf_types))
        for f in jclassic.FIELDS}
    for t in (0.5, 1.0):
        out[f"motion{t}"] = np.asarray(jclassic.trace_motion(
            js, key, ro, rd, W, H, time=t))
    return out


def _reference_renders(js, jcfg):
    out = {}
    for name, trace in (
            ("direct", lambda s, k, ro, rd: jclassic.trace_direct(
                s, k, ro, rd, emitter_samples=2, bsdf_samples=1,
                bsdf_types=jcfg.bsdf_types)),
            ("ao", lambda s, k, ro, rd: jclassic.trace_ao(s, k, ro, rd))):
        r = jrenderer.render(js, jcfg, spp=SPP, seed=3, trace_fn=trace)
        out[name] = film_mean_se(r["raw"], r["sqr"], r["weight"])
    jcfg.max_depth = jcfg.rr_depth = 3
    out["adaptive"] = jclassic.render_adaptive(js, jcfg, max_spp=8, seed=5,
                                               pass_spp=4, max_error=0.2)
    return out


@pytest.fixture(scope="module")
def reference(scenes):
    js, jcfg = scenes[:2]
    with ThreadPoolExecutor(1) as ex:
        yield {"fields": ex.submit(_reference_fields, js, jcfg),
               "renders": ex.submit(_reference_renders, js, jcfg)}


def test_field_and_motion_match_reference(scenes, reference):
    _, _, ts, tcfg = scenes
    ro, rd = tsensor.generate_rays(ts, torch.as_tensor(_rays()), W, H)
    gen = torch.Generator()
    want = reference["fields"].result()
    for f in tclassic.FIELDS:
        got = to_np(tclassic.trace_field(ts, gen, ro, rd, field=f,
                                         bsdf_types=tcfg.bsdf_types,
                                         device="cpu"))
        np.testing.assert_allclose(got, want[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    hit = want["distance"][:, 0] > 0
    assert 0.2 < hit.mean() < 0.95  # the border sees nothing
    for t in (0.5, 1.0):
        got = to_np(tclassic.trace_motion(ts, gen, ro, rd, W, H, time=t,
                                          device="cpu"))
        np.testing.assert_allclose(got, want[f"motion{t}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"time {t}")
    moving = np.abs(got).max(-1) > 0
    cube = to_np(ts.tri_mot)[want["primIndex"][:, 0].astype(int)] >= 0
    np.testing.assert_array_equal(moving, cube & hit)
    assert moving.sum() > 10


def test_direct_and_ao_match_reference_in_expectation(scenes, reference):
    _, _, ts, tcfg = scenes
    want = reference["renders"].result()
    for name, trace in (
            ("direct", lambda s, g, ro, rd: tclassic.trace_direct(
                s, g, ro, rd, emitter_samples=2, bsdf_samples=1,
                bsdf_types=tcfg.bsdf_types, device="cpu")),
            ("ao", lambda s, g, ro, rd: tclassic.trace_ao(
                s, g, ro, rd, device="cpu"))):
        r = trenderer.render(ts, tcfg, spp=SPP, seed=3, trace_fn=trace,
                             device="cpu")
        got = film_mean_se(r["raw"], r["sqr"], r["weight"])
        assert want[name][0] > 0.05 and within_se(got, want[name]), (
            name, got, want[name])
        if name == "ao":
            assert (r["image"] >= 0).all() and (r["image"] <= 1).all()
    # Uniforms given as rand: a generator's own draws give its result.
    ro, rd = tsensor.generate_rays(ts, torch.as_tensor(_rays()), W, H)
    for fn, kw, k in ((tclassic.trace_direct, {"emitter_samples": 2}, 10),
                      (tclassic.trace_ao, {"shading_samples": 2}, 4)):
        a = fn(ts, torch.Generator().manual_seed(4), ro, rd, device="cpu",
               **kw)
        rand = torch.rand((ro.shape[0], k),
                          generator=torch.Generator().manual_seed(4))
        assert torch.equal(a, fn(ts, None, ro, rd, rand=rand, device="cpu",
                                 **kw))


def test_adaptive_matches_reference(scenes, reference):
    _, _, ts, tcfg = scenes
    tcfg.max_depth = tcfg.rr_depth = 3
    got = tclassic.render_adaptive(ts, tcfg, max_spp=8, seed=5, pass_spp=4,
                                   max_error=0.2, device="cpu")
    want = reference["renders"].result()["adaptive"]
    want = {k: np.asarray(v) for k, v in want.items()}
    # Pixels whose four corner rays miss everything are black and stop
    # after the first pass, in both packages.
    corners = np.stack(np.meshgrid(np.arange(W + 1), np.arange(H + 1)),
                       -1).reshape(-1, 2).astype(np.float32)
    ro, rd = tsensor.generate_rays(ts, torch.as_tensor(corners), W, H)
    miss = to_np(tclassic.trace_field(ts, None, ro, rd, field="distance",
                                      device="cpu"))[:, 0] == 0
    miss = miss.reshape(H + 1, W + 1)
    void = miss[:-1, :-1] & miss[1:, :-1] & miss[:-1, 1:] & miss[1:, 1:]
    assert void.sum() > 20
    for res in (got, want):
        assert (res["spp_map"][void] == 4).all()
        assert (res["image"][void] == 0).all()
        assert (res["spp_map"][~void] >= 4).all()
        assert (res["spp_map"] == 8).any()
    # The reference returns no squared sums: its standard error is taken
    # as the port's (the same estimator at nearly the same spp).
    n = np.maximum(got["spp_map"], 1.0)[..., None]
    var = np.maximum(got["sqr"] / n - got["image"] ** 2, 0.0) / n
    sd = np.sqrt(var).mean(-1).ravel()
    se = float(np.sqrt((sd * sd).sum()) / sd.size)
    assert within_se((float(got["image"].mean()), se),
                     (float(want["image"].mean()), se)), (
        got["image"].mean(), want["image"].mean(), se)
