"""The port's command line, ``python -m sdmm_tpu_torch``, on the CPU at 16x12
and a few spp: ``render`` writes the image (EXR, or .npy) and stats.json in
the reference's schema, and the image equals what render_wavefront gives
on the same loaded scene and seed; the classic integrators (direct, ao,
field, motion, adaptive, multichannel) with their -D properties and
stats.json keys; ``compare`` prints all_metrics' keys; ``import`` writes a
scene that builds; every option the port does not hold yet raises
NotImplementedError naming its ROADMAP item. The guided renders (sdmm,
ppg, the trainer's options, a checkpointed and resumed render) and the
module entry point are in tests/test_torch_cli_sdmm.py and
tests/test_torch_cli_guiding.py, files of few tests that the tier-1
scheduler (``--dist loadfile``, files with the most tests first) runs
after the long reference files."""

import json
import pathlib

import numpy as np
import pytest
import torch

from sdmm_tpu_torch import cli
from sdmm_tpu_torch.render.wavefront import render_wavefront
from sdmm_tpu_torch.scene.xml_loader import load_scene
from sdmm_tpu_torch.utils.exr import read_exr
from sdmm_tpu_torch.utils.metrics import all_metrics

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]

BOX = """<scene version="0.6.0">
  <default name="spp" value="4"/>
  <integrator type="volpath"><integer name="maxDepth" value="4"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld">
      <lookat origin="0, 1, 4" target="0, 1, 0" up="0, 1, 0"/></transform>
    <sampler type="$sampler"><integer name="sampleCount" value="$spp"/>
      <integer name="seed" value="77"/></sampler>
    <film type="hdrfilm"><integer name="width" value="16"/>
      <integer name="height" value="12"/></film>
  </sensor>
  <bsdf type="diffuse" id="white">
    <rgb name="reflectance" value="0.725, 0.71, 0.68"/></bsdf>
  <shape type="rectangle"><transform name="toWorld">
    <rotate x="1" angle="-90"/></transform><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld">
    <rotate x="1" angle="90"/><translate y="2"/></transform>
    <ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld">
    <translate y="1" z="-1"/></transform><ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld">
    <rotate y="1" angle="90"/><translate x="-1" y="1"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.63, 0.065, 0.05"/>
    </bsdf></shape>
  <shape type="cube"><transform name="toWorld"><scale value="0.3"/>
    <rotate y="1" angle="20"/><translate x="0.3" y="0.3"/></transform>
    <ref id="white"/></shape>
  <shape type="rectangle"><transform name="toWorld">
    <scale x="0.3" y="0.3"/><rotate x="1" angle="90"/>
    <translate y="1.98"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0"/></bsdf>
    <emitter type="area"><rgb name="radiance" value="20"/></emitter></shape>
</scene>
"""


@pytest.fixture
def box(tmp_path):
    path = tmp_path / "box.xml"
    path.write_text(BOX.replace("$sampler", "independent"))
    return str(path)


def _render(box, out, *extra):
    return cli.main(["render", box, "-o", str(out), "--device", "cpu",
                     *extra])


@pytest.mark.parametrize("integrator,ext", [
    ("gt", ".exr"), ("volpath", ".exr"), ("path", ".npy"), (None, ".exr")])
def test_render_path_integrators(box, tmp_path, integrator, ext):
    out = tmp_path / "out" / f"img{ext}"
    args = ["--integrator", integrator] if integrator else []
    assert _render(box, out, "-D", "spp=3", *args) is None
    builder = load_scene(box, {"spp": "3"})
    assert builder.sample_count == 3
    scene, cfg = builder.build(device="cpu")
    want = render_wavefront(scene, cfg, spp=3, seed=77,
                            nee=integrator != "path", device="cpu")["image"]
    got = read_exr(str(out)) if ext == ".exr" else np.load(out)
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    stats = json.loads((tmp_path / "out" / "stats.json").read_text())
    assert stats.keys() == {"integrator", "spp", "seconds", "mean"}
    assert (stats["integrator"], stats["spp"]) == (integrator or "volpath", 3)
    assert stats["mean"] == pytest.approx(float(want.mean()))


def test_compare_prints_all_metrics(tmp_path, capsys):
    from sdmm_tpu_torch.utils.exr import write_exr

    rs = np.random.RandomState(0)
    a, b = rs.rand(12, 16, 3), rs.rand(12, 16, 3)
    write_exr(str(tmp_path / "a.exr"), a)
    write_exr(str(tmp_path / "b.exr"), b)
    cli.main(["compare", str(tmp_path / "a.exr"), str(tmp_path / "b.exr")])
    printed = json.loads(capsys.readouterr().out)
    want = all_metrics(a.astype(np.float32), b.astype(np.float32))
    assert printed == want


@pytest.mark.parametrize("extra,item", [
    (["--integrator", "pssmlt"], "A12"),
    (["--integrator", "mlt"], "A12"),
    (["--integrator", "irrcache"], "A12"),
])
def test_unported_options_raise(tmp_path, extra, item):
    path = tmp_path / "box.xml"
    path.write_text(BOX)  # the sampler type is a scene variable
    args = extra if "sampler=" in " ".join(extra) else \
        extra + ["-D", "sampler=independent"]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _render(str(path), tmp_path / "x.exr", *args)
    assert not (tmp_path / "x.exr").exists()


@pytest.mark.parametrize("extra", [
    ["--integrator", "gt", "--sampler", "stratified"],
    ["--integrator", "path", "--rfilter", "gaussian"],
    ["-D", "sampler=sobol"]], ids=["stratified", "gaussian", "sobol"])
def test_samplers_and_rfilters_render(tmp_path, extra, monkeypatch):
    """A sampler other than independent or an rfilter other than box
    renders through the wave renderer (renderer.render), with the spp on
    every pixel; the image mean is that of the independent/box render
    within 4 standard errors."""
    from torch_parity import film_mean_se, within_se

    from sdmm_tpu_torch.render import renderer

    path = tmp_path / "box.xml"
    path.write_text(BOX)
    films = []
    real = renderer.render
    monkeypatch.setattr(renderer, "render",
                        lambda *a, **k: films.append(real(*a, **k))
                        or films[-1])
    args = extra if "sampler=" in " ".join(extra) else \
        extra + ["-D", "sampler=independent"]
    _render(str(path), tmp_path / "x.npy", *args, "--spp", "16")
    assert len(films) == 1 and (films[0]["weight"] > 0).all()
    if "--rfilter" not in extra:
        assert (films[0]["weight"] == 16).all()
    ts, cfg = load_scene(str(path), {"sampler": "independent"}).build(
        device="cpu")
    base = render_wavefront(ts, cfg, spp=16, seed=5, device="cpu")
    got, want = (film_mean_se(f["raw"], f["sqr"], f["weight"])
                 for f in (films[0], base))
    assert within_se(got, want), (got, want)
    assert np.isfinite(np.load(tmp_path / "x.npy")).all()


CLASSIC = {
    "direct": (["-D", "emitterSamples=2"], {"mean"}),
    "ao": (["-D", "rayLength=1.5"], {"mean"}),
    "field": (["-D", "field=distance"], {"mean"}),
    "motion": (["-D", "time=0.5"], {"mean"}),
    "adaptive": (["-D", "maxError=0.3"], {"mean", "mean_spp"}),
    "multichannel": (["-D", "fields=position,uv,nope"], {"fields"}),
}


@pytest.mark.parametrize("integrator", sorted(CLASSIC))
def test_classic_integrators_render(box, tmp_path, integrator):
    """The classic integrators through the command line: the image, and
    stats.json with the reference's keys; the properties come from -D."""
    from sdmm_tpu_torch.render import classic

    extra, keys = CLASSIC[integrator]
    out = tmp_path / "out.exr"
    _render(box, out, "--integrator", integrator, "--spp", "4", *extra)
    img = read_exr(str(out))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert {"integrator", "spp", "seconds"} | keys == set(stats)
    assert stats["integrator"] == integrator and stats["spp"] == 4
    if integrator == "field":
        # The same loaded scene and seed through the API.
        from sdmm_tpu_torch.render.renderer import render

        scene, cfg = load_scene(box).build(device="cpu")
        want = render(scene, cfg, spp=4, seed=load_scene(box).seed,
                      trace_fn=lambda s, g, ro, rd: classic.trace_field(
                          s, g, ro, rd, field="distance", device="cpu"),
                      device="cpu")["image"]
        np.testing.assert_array_equal(img, want.astype(np.float32))
    if integrator == "ao":
        assert img.min() >= 0.0 and img.max() <= 1.0
    if integrator == "adaptive":
        assert stats["mean_spp"] == 4.0  # one pass of 4: the most
    if integrator == "multichannel":
        assert stats["fields"] == ["position", "uv"]
        for f in ("position", "uv"):
            assert np.isfinite(read_exr(str(tmp_path / f"out_{f}.exr"))).all()
        np.testing.assert_array_equal(
            img, read_exr(str(tmp_path / "out_position.exr")))


def test_import_writes_a_loadable_scene(tmp_path, capsys):
    """import: a COLLADA file → scene XML + OBJ meshes, the output named
    as a second argument or with -o; the written scene builds."""
    dae = tmp_path / "tri.dae"
    dae.write_text(
        '<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema">'
        '<library_geometries><geometry id="g" name="tri"><mesh><source '
        'id="p"><float_array count="9">0 0 0 1 0 0 0 1 0</float_array>'
        '<technique_common><accessor stride="3"/></technique_common>'
        '</source><vertices id="v"><input semantic="POSITION" source="#p"/>'
        '</vertices><triangles count="1"><input semantic="VERTEX" '
        'source="#v" offset="0"/><p>0 1 2</p></triangles></mesh></geometry>'
        '</library_geometries><library_visual_scenes><visual_scene id="s">'
        '<node><instance_geometry url="#g"/></node></visual_scene>'
        '</library_visual_scenes></COLLADA>')
    for args in ([str(tmp_path / "a.xml")], ["-o", str(tmp_path / "b.xml")]):
        assert cli.main(["import", str(dae), *args, "--device", "cpu"]) == 0
        assert "1 triangles on cpu" in capsys.readouterr().out
    assert (tmp_path / "a.xml").read_text() == (tmp_path / "b.xml").read_text()
    assert (tmp_path / "meshes" / "0000_tri.obj").exists()
