"""The port's command line, ``python -m sdmm_tpu_torch``, on the CPU at 16x12
and a few spp: ``render`` writes the image (EXR, or .npy), stats.json in
the reference's schema and, for sdmm, checkpoints/model_NNNNN.asdmm, and the
image equals what render_wavefront or SDMMTrainer(...).run gives on the same
loaded scene and seed; ``compare`` prints all_metrics' keys; every option
the port does not hold yet raises NotImplementedError naming its ROADMAP
item."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdmm_tpu_torch import cli
from sdmm_tpu_torch.guiding import io as tio
from sdmm_tpu_torch.guiding.trainer import SDMMTrainer, TrainerConfig
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


def test_render_sdmm(box, tmp_path):
    out = tmp_path / "sdmm" / "img.exr"
    npy = tmp_path / "film.npy"
    _render(box, out, "--integrator", "sdmm", "--spp", "8", "--npy", str(npy),
            "--dump-iterations")
    builder = load_scene(box)
    scene, cfg = builder.build(device="cpu")
    tr = SDMMTrainer(scene, cfg, TrainerConfig(seed=77), device="cpu")
    want, iters = tr.run(total_spp=8)
    np.testing.assert_array_equal(read_exr(str(out)),
                                  want.astype(np.float32))
    np.testing.assert_array_equal(np.load(npy), want)
    stats = json.loads((out.parent / "stats.json").read_text())
    assert len(stats) == len(tr.stats) == 2
    timed = ("elapsed_seconds", "rendering_seconds", "training_seconds",
             "ttuv")  # wall clock, or a product with it
    for st, ref in zip(stats, tr.stats):
        assert st.keys() == ref.keys()
        assert {k: v for k, v in st.items() if k not in timed} == \
            {k: v for k, v in ref.items() if k not in timed}
    ckpt = out.parent / "checkpoints" / "model_00002.asdmm"
    tree, sdmm, init, meta = tio.load_checkpoint(str(ckpt), device="cpu")
    assert meta["iteration"] == 2 and tree.n_leaves == tr.tree.n_leaves
    for a, b in zip(sdmm, tr.sdmm):
        assert torch.equal(a, b)
    for i, it in enumerate(iters):
        n = np.maximum(it["weight"], 1.0)[:, None]
        np.testing.assert_array_equal(
            read_exr(str(out.parent / f"iteration{i:05d}.exr")),
            (it["image"] / n).reshape(12, 16, 3).astype(np.float32))
        assert (out.parent / f"iteration_sqr{i:05d}.exr").exists()


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
    (["--integrator", "ppg"], "A10"),
    (["--integrator", "bdpt"], "A12"),
    (["--integrator", "direct"], "A12"),
    (["--integrator", "pssmlt"], "A12"),
    (["--integrator", "sdmm", "--resume", "full.npz"], "A10"),
    (["--integrator", "sdmm", "--checkpoint", "full.npz"], "A10"),
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


def test_unported_trainer_options_raise(box, tmp_path):
    with pytest.raises(NotImplementedError):
        _render(box, tmp_path / "x.exr", "--integrator", "sdmm",
                "-D", "reservoirCapacity=64")


def test_module_entry_point(box, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = tmp_path / "m.exr"
    res = subprocess.run(
        [sys.executable, "-m", "sdmm_tpu_torch", "render", box, "-o",
         str(out), "--integrator", "gt", "--spp", "2", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "Rendered" in res.stdout
    assert read_exr(str(out)).shape == (12, 16, 3)
