"""Guards of the PyTorch port's ground rules: it never imports JAX or the
reference package, its entry points run on the card unless the caller asks
for the CPU (no silent fallback), options outside the ported slice raise,
and chip_smoke.py refuses to run without a GPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from torch_parity import make_box  # noqa: E402

from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.guiding import trainer as ttrainer  # noqa: E402
from sdmm_tpu_torch.ops import bounce as gbounce  # noqa: E402
from sdmm_tpu_torch.ops import clas_cull as ccull  # noqa: E402
from sdmm_tpu_torch.ops import intersect_sweep as isweep  # noqa: E402
from sdmm_tpu_torch.ops import guided_step as gstep  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "sdmm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sdmm_tpu_torch\n"
        "for m in pkgutil.walk_packages(sdmm_tpu_torch.__path__, "
        "'sdmm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sdmm_tpu' or m.startswith('sdmm_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('sdmm_tpu_torch')]),"
        " bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) > 20  # every module was imported


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_import_no_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "sdmm_tpu"), (path, n)


def _scene():
    return make_box(tscene, tshapes, 8, 8).build(device="cpu")


def test_entry_points_default_to_the_card(no_gpu):
    scene, cfg = _scene()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(max_leaves=8))
    tr = ttrainer.SDMMTrainer(scene, cfg,
                              ttrainer.TrainerConfig(max_leaves=8),
                              device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tguided.render_pool_guided(scene, tr.guide_state(),
                                   torch.Generator(), n_lanes=64, spp=1,
                                   width=8, height=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tem.em_step(tr.sdmm, tr.em, torch.zeros((4, 3)), torch.zeros((4, 3)),
                    torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                    torch.zeros(8, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tguided.render_pool_guided_fused(scene, tr.guide_state(),
                                         torch.Generator(), n_lanes=2048,
                                         spp=1, width=8, height=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_box(tscene, tshapes, 8, 8).build()
    # The kernel wrappers run the plain twin only for CPU tensors; any other
    # device goes to the kernel, which takes CUDA tensors alone.
    n = 128
    state = torch.zeros((16, n), device="meta")
    meta = torch.zeros(n, dtype=torch.int32, device="meta")
    tri, _, env = gbounce.build_tables(scene)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gstep.trace(state, meta, tri.to("meta"), env.to("meta"), (0,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gstep.shade(state, meta, torch.zeros((gstep.HIT_ROWS, n),
                                             device="meta"),
                    state[0:3], meta,
                    torch.zeros((4, gstep.PACK_COLS), dtype=torch.bfloat16,
                                device="meta"),
                    state[0:8], (0,), 10, 10, 0.5)


def test_path_entry_points_default_to_the_card(no_gpu):
    scene, cfg = _scene()
    for call in (
            lambda: twf.render_wavefront(scene, cfg, spp=1),
            lambda: twf.render_pool(scene, torch.Generator(), 64, 1, 8, 8),
            lambda: twf.render_pool_fused_sorted2(scene, 0, 4, 8, 8, 1),
            lambda: twf.render_pool_fused_striped(scene, 0, 1, 8, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # The path kernels' wrappers take CUDA tensors alone off the CPU.
    n = 8192
    state = torch.zeros((16, n), device="meta")
    meta = torch.zeros(n, dtype=torch.int32, device="meta")
    tri, em, env = (x.to("meta") for x in gbounce.build_tables(scene))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gbounce.step(state, meta, state[0:8], meta[0:1],
                     torch.zeros(14, device="meta"), (0, 0), state[0:3], tri,
                     em, env, 2, 10, 10, (0,), 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gbounce.bounce(state, meta, state[0:8], tri, em, env, 2, 10, 10)


def test_intersect_kernels_take_cuda_tensors_alone(no_gpu, monkeypatch):
    """Off the CPU the intersection wrappers launch their kernel or raise:
    they never reach a plain twin. With no card, a scene above
    BRUTE_FORCE_MAX triangles still refuses device='cuda'."""
    def no_twin(*a, **k):
        raise AssertionError("a plain twin ran on a non-CPU tensor")

    monkeypatch.setattr(isweep, "mt_sweep_plain", no_twin)
    monkeypatch.setattr(ccull, "cull_plain", no_twin)
    scene, cfg = _scene()
    x = torch.zeros((8, 3), device="meta")
    tm = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        isweep.mt_sweep(x, x, tm, *(a.to("meta") for a in (
            scene.tri_v0, scene.tri_e1, scene.tri_e2)))
    clusters = [a.to("meta") for a in (
        scene.clas_tree, scene.clas_woop_slot, scene.clas_ids)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ccull.cull(x, x, tm, *clusters)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ccull.any_hit(x, x, tm, *clusters)
    big = make_box(tscene, tshapes, 8, 8)
    big.add_shape(tshapes.make_sphere([0.0, 1.0, 0.0], 0.3, n_theta=24,
                                      n_phi=48), 0)
    big_scene, big_cfg = big.build(device="cpu")
    assert big_scene.tri_v0.shape[0] > 1024
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twf.render_wavefront(big_scene, big_cfg, spp=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        big.build()


def test_unported_path_options_raise():
    """Subsurface scattering, bump maps and point lights are ported: has_sss
    and has_bump render on the CPU (the box has no subsurface instance, so
    the dipole term adds nothing), and sample_direct takes a scene with a
    point light."""
    scene, cfg = _scene()
    plain = twf.render_pool(scene, torch.Generator().manual_seed(0), 64, 1,
                            8, 8, device="cpu")
    sss = twf.render_pool(scene, torch.Generator().manual_seed(0), 64, 1, 8,
                          8, device="cpu", has_sss=True)
    assert torch.equal(plain["image"], sss["image"])
    out = twf.render_pool(scene, torch.Generator().manual_seed(0), 64, 1, 8,
                          8, device="cpu", has_bump=True)
    assert (out["weight"] == 1).all() and torch.isfinite(out["image"]).all()
    from sdmm_tpu_torch.scene import emitters as temit

    b = make_box(tscene, tshapes, 8, 8)
    b.add_point_light([0.0, 1.5, 0.0], [5.0, 5.0, 5.0])
    lit, _ = b.build(device="cpu")
    gen = torch.Generator().manual_seed(1)
    rec = temit.sample_direct(lit, torch.rand((256, 3), generator=gen),
                              torch.rand(256, generator=gen),
                              torch.rand((256, 2), generator=gen))
    assert rec["delta"].any() and (~rec["delta"]).any()


@pytest.mark.parametrize("option", [
    {"sample_product": True}, {"data_init": True}, {"reservoir_capacity": 64},
    {"optimize_async": True}, {"n_components": 4},
    {"n_components": 8}])
def test_unported_options_raise(option):
    scene, cfg = _scene()
    with pytest.raises(NotImplementedError):
        ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(**option),
                             device="cpu")


def test_unported_scene_features_raise():
    """Irawan still raises; a textured diffuse builds."""
    b = tscene.SceneBuilder()
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        b.add_bsdf(tscene.BSDF_IRAWAN)
    tex = b.add_texture(torch.rand((4, 4, 3)).numpy())
    b.add_shape(tshapes.make_rectangle(torch.eye(4).numpy()),
                b.add_bsdf(tscene.BSDF_DIFFUSE, tex=tex))
    textured, _ = b.build(device="cpu")
    assert textured.bsdf_tex.tolist() == [tex]
    assert textured.textures.shape == (1, b.texture_res, b.texture_res, 3)
    scene, cfg = _scene()
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(max_leaves=8),
                              device="cpu")
    # Media are ported: the guided pool carries them (the box's vacuum).
    out = tguided.render_pool_guided(
        scene, tr.guide_state(), torch.Generator().manual_seed(0),
        n_lanes=64, spp=1, width=8, height=8, has_medium=True, device="cpu")
    assert float(out["weight"].sum()) == 64
    # A scene past BRUTE_FORCE_MAX triangles is ported: it takes the
    # cluster cull over its clas_* tensors (here the box's own clusters)
    # where the dense sweep over its 2000 empty triangles would find none.
    big = tscene.SceneData(*[getattr(scene, f) for f in scene._fields])
    big = big._replace(tri_v0=torch.zeros((2000, 3)),
                       tri_e1=torch.zeros((2000, 3)),
                       tri_e2=torch.zeros((2000, 3)))
    from sdmm_tpu_torch.render import intersect as tisect
    ro = torch.tensor([[0.0, 1.0, 0.5]]).repeat(4, 1)
    rd = torch.tensor([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]])
    hit = tisect.intersect(big, ro, rd)
    assert hit["valid"].all()
    assert torch.equal(hit["tri"], tisect.intersect(scene, ro, rd)["tri"])


@pytest.mark.parametrize("feature", ["fog", "grid medium", "dipole"])
def test_fused_gates_refuse_media_and_subsurface(feature):
    """Neither fused pool carries a medium or the dipole term: both gates
    refuse such a scene, as the reference's do, while they take the box."""
    from torch_parity import make_media_box

    scene, cfg = _scene()
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(max_leaves=8),
                              device="cpu")
    gs = tr.guide_state()
    assert twf.fused_supported(scene, cfg)
    assert tguided.guided_fused_supported(scene, cfg, gs)
    kw = {"fog": dict(hetero=False), "grid medium": dict(fog=False),
          "dipole": dict(fog=False, dipole=True)}[feature]
    b = make_media_box(tscene, tshapes, 8, 8, **kw)
    if feature == "dipole":
        b.media.clear()
        b.soups = [(s, bsdf, e, 0, -1, sss) for s, bsdf, e, _, _, sss
                   in b.soups]
    scene, cfg = b.build(device="cpu")
    assert cfg.has_medium == (feature != "dipole")
    assert cfg.has_sss == (feature == "dipole")
    assert not twf.fused_supported(scene, cfg)
    assert not tguided.guided_fused_supported(scene, cfg, gs)


def test_chip_smoke_refuses_without_gpu(no_gpu, tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script cannot run."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _xml(tmp_path, body=""):
    path = tmp_path / "scene.xml"
    path.write_text(
        '<scene version="0.6.0"><sensor type="perspective"><film '
        'type="hdrfilm"><integer name="width" value="8"/><integer '
        'name="height" value="6"/></film></sensor><shape type="cube">'
        '<transform name="toWorld"><translate z="-4"/></transform></shape>'
        f'{body}</scene>')
    return str(path)


def test_textured_scene_needs_the_card_or_the_cpu(no_gpu, tmp_path,
                                                  monkeypatch):
    """A scene with plastic, a bitmap, a point light and an env map:
    cli.main (gt and sdmm) on a machine without a card raises unless
    --device cpu is given, and renders with it (torch.cuda.is_available
    patched false, so the check holds on any machine)."""
    import numpy as np

    from chip_smoke import write_png
    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.utils.exr import write_exr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_png(tmp_path / "t.png", np.arange(48, dtype=np.uint8).reshape(
        4, 4, 3) * 5)
    write_exr(str(tmp_path / "e.exr"), np.ones((4, 8, 3), np.float32))
    xml = _xml(tmp_path, '<shape type="rectangle"><bsdf type="plastic">'
                         '<texture type="bitmap" name="diffuseReflectance">'
                         '<string name="filename" value="t.png"/></texture>'
                         '</bsdf></shape><emitter type="point"/><emitter '
                         'type="envmap"><string name="filename" '
                         'value="e.exr"/></emitter>')
    for integ in ("gt", "sdmm"):
        out = str(tmp_path / f"{integ}.npy")
        args = ["render", xml, "-o", out, "--spp", "1", "--integrator",
                integ]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
        assert not os.path.exists(out)
        cli.main(args + ["--device", "cpu"])
        assert np.isfinite(np.load(out)).all()


def test_png_decoder_never_falls_back_to_the_placeholder(tmp_path):
    """Only a missing file or a git-lfs stub gives the mid-grey
    placeholder (with a warning); a PNG that is there is decoded, and a
    file that is there but cannot be decoded raises."""
    import warnings

    import numpy as np

    from chip_smoke import write_png
    from sdmm_tpu_torch.scene import xml_loader as txml

    img = (np.arange(75, dtype=np.uint8).reshape(5, 5, 3) * 3)
    write_png(tmp_path / "ok.png", img)
    (tmp_path / "stub.png").write_text(
        "version https://git-lfs.github.com/spec/v1\noid sha256:00\n")
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)

    def load(name):
        xml = _xml(tmp_path, '<shape type="rectangle"><bsdf type="diffuse">'
                             '<texture type="bitmap" name="reflectance">'
                             f'<string name="filename" value="{name}"/>'
                             '</texture></bsdf></shape>')
        return txml.load_scene(xml).textures[0]

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tex = load("ok.png")
    np.testing.assert_array_equal(tex, (img / np.float32(255.0)) ** 2.2)
    for name in ("stub.png", "missing.png"):
        with pytest.warns(UserWarning, match="mid-grey"):
            np.testing.assert_array_equal(load(name), 0.5)
    with pytest.raises(ValueError):
        load("bad.png")


def test_cli_and_loader_default_to_the_card(no_gpu, tmp_path):
    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.scene import xml_loader as txml

    xml = _xml(tmp_path)
    out = str(tmp_path / "out.exr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", xml, "-o", out, "--spp", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        txml.load_scene(xml).build()
    assert not os.path.exists(out)
    scene, _ = txml.load_scene(xml).build(device="cpu")
    assert scene.tri_v0.device.type == "cpu"
    cli.main(["render", xml, "-o", out, "--spp", "1", "--device", "cpu"])
    assert os.path.exists(out)


@pytest.mark.parametrize("cxx", [["/nonexistent/g++"], ["false"]],
                         ids=["missing", "failing"])
def test_native_obj_parser_raises_when_its_build_fails(cxx, tmp_path,
                                                       monkeypatch):
    """A failed build of native/mesh_loader.cpp raises; the Python parser
    runs only when the caller asks for it."""
    from sdmm_tpu_torch import native
    from sdmm_tpu_torch.scene import xml_loader as txml

    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    xml = _xml(tmp_path, '<shape type="obj"><string name="filename" '
                         'value="m.obj"/></shape>')
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="mesh_loader.cpp"):
        tshapes.load_obj(str(tmp_path / "m.obj"))
    with pytest.raises(RuntimeError, match="mesh_loader.cpp"):
        txml.load_scene(xml)
    assert len(tshapes.load_obj(str(tmp_path / "m.obj"),
                                native=False).concat()[0]) == 1
    assert not any((tmp_path / "build").glob("*.so"))
