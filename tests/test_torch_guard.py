"""Guards of the PyTorch port's ground rules: it never imports JAX or the
reference package, its entry points run on the card unless the caller asks
for the CPU (no silent fallback), options outside the ported slice raise,
and chip_smoke.py refuses to run without a GPU. The guards that start a
process or render are in tests/test_torch_guard_processes.py and
tests/test_torch_guard_renders.py, files of few tests that the tier-1
scheduler (``--dist loadfile``, files with the most tests first) runs
after the long reference files."""

import ast
import os
import pathlib
import sys

import numpy as np
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


@pytest.mark.parametrize("option", [{"n_components": 4},
                                    {"n_components": 8}])
def test_unported_options_raise(option):
    """Mixtures of K != 16 components are ported: such a trainer trains and
    renders on the CPU on the mixture route (no kernel table, both fused
    gates shut, the E-step the twin's math); the mesh option still
    raises."""
    scene, cfg = _scene()
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(
        max_leaves=8, train_fraction=0.8, **option), device="cpu")
    gs = tr.guide_state()
    assert gs.kernel_table is None and tguided.mixture_route(gs)
    assert not tguided.guided_fused_supported(scene, cfg, gs)
    assert not tem.use_em_kernel(tr.sdmm)
    img, iters = tr.run(total_spp=24)
    k = option["n_components"]
    assert tr.sdmm.weight.shape == (8, k) and tr.em.stats_w.shape == (8, k)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0 and len(iters) == 6
    # The fifth iteration (past 12 spp) trains the leaves; the sixth is
    # frozen on the mixture route.
    assert tr.stats[4]["optimized_nodes_count"] > 0
    assert int(tr.initialized.sum()) > 0
    assert not torch.isnan(tr.sdmm.weight).any()
    with pytest.raises(NotImplementedError):
        ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(**option),
                             mesh=object(), device="cpu")


EXTRAS = [{"sample_product": True}, {"data_init": True},
          {"reservoir_capacity": 64}, {"optimize_async": True}]


@pytest.mark.parametrize("option", EXTRAS, ids=lambda o: next(iter(o)))
def test_trainer_options_construct_on_the_cpu(option):
    """Each guiding extra constructs on the CPU with its state there: the
    learned table, the reservoir; data_init and optimize_async hold
    none."""
    scene, cfg = _scene()
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(
        max_leaves=8, **option), device="cpu")
    if "sample_product" in option:
        assert tr.learned["has"].device.type == "cpu"
        assert tr.guide_state().learned is tr.learned
    else:
        assert tr.learned is None and tr.guide_state().learned is None
    if "reservoir_capacity" in option:
        assert tr.reservoir["pos"].shape == (64, 3)
        assert tr.reservoir["valid"].device.type == "cpu"
    else:
        assert tr.reservoir is None


@pytest.mark.parametrize("option", EXTRAS, ids=lambda o: next(iter(o)))
def test_trainer_options_default_to_the_card(no_gpu, option):
    scene, cfg = _scene()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(
            max_leaves=8, **option))


def test_guiding_extras_default_to_the_card(no_gpu, tmp_path):
    """PPGTrainer, the learned table, the reservoir and the checkpoint
    loaders run on the card unless the caller passes device="cpu"."""
    from sdmm_tpu_torch.guiding import io as tio
    from sdmm_tpu_torch.guiding import learned_bsdf, ppg, reservoir

    scene, cfg = _scene()
    tr = ttrainer.SDMMTrainer(scene, cfg,
                              ttrainer.TrainerConfig(max_leaves=8),
                              device="cpu")
    tio.save_full_checkpoint(str(tmp_path / "c.npz"), tr, [])
    tio.save_bsdf_mixture(str(tmp_path / "m.sdmm"), [1.0], [[0, 0, 1.0]],
                          [[[1.0, 0], [0, 1.0]]])
    for call in (lambda: ppg.PPGTrainer(scene, cfg),
                 lambda: learned_bsdf.build_learned_table(scene),
                 lambda: reservoir.make_reservoir(16),
                 lambda: tio.load_full_checkpoint(str(tmp_path / "c.npz")),
                 lambda: tio.load_bsdf_mixture(str(tmp_path / "m.sdmm"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ppg.PPGTrainer(scene, cfg, device="cpu").hist.device.type == "cpu"


def test_unported_scene_features_raise():
    """Every scene feature builds: an Irawan cloth with its weave tables
    and an unknown BSDF code raises; a textured diffuse builds."""
    from sdmm_tpu_torch.bsdf.irawan import PLAIN_WEAVE, parse_weave

    b = tscene.SceneBuilder()
    with pytest.raises(ValueError, match="unknown BSDF type"):
        b.add_bsdf(99)
    b.irawan_pattern = parse_weave(PLAIN_WEAVE)
    cloth = b.add_bsdf(tscene.BSDF_IRAWAN)
    b.add_shape(tshapes.make_rectangle(torch.eye(4).numpy()), cloth)
    woven, cfg = b.build(device="cpu")
    assert cfg.bsdf_types == (tscene.BSDF_IRAWAN,)
    assert woven.iw_pattern.tolist() == [[0, 1], [2, 3]]
    assert float(woven.iw_consts[8]) > 0.0  # the specular normalisation
    b = tscene.SceneBuilder()
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


@pytest.mark.parametrize("feature", ["fog", "grid medium", "dipole",
                                     "irawan"])
def test_fused_gates_refuse_media_and_subsurface(feature):
    """Neither fused pool carries a medium, the dipole term or Irawan's
    cloth (not an in-kernel BSDF type): both gates refuse such a scene, as
    the reference's do, while they take the box."""
    from torch_parity import make_media_box

    scene, cfg = _scene()
    tr = ttrainer.SDMMTrainer(scene, cfg, ttrainer.TrainerConfig(max_leaves=8),
                              device="cpu")
    gs = tr.guide_state()
    assert twf.fused_supported(scene, cfg)
    assert tguided.guided_fused_supported(scene, cfg, gs)
    if feature == "irawan":
        from sdmm_tpu_torch.bsdf.irawan import PLAIN_WEAVE, parse_weave

        b = make_box(tscene, tshapes, 8, 8)
        b.irawan_pattern = parse_weave(PLAIN_WEAVE)
        b.bsdfs[0] = {**b.bsdfs[0], "type": tscene.BSDF_IRAWAN}
        scene, cfg = b.build(device="cpu")
        assert tscene.BSDF_IRAWAN in cfg.bsdf_types
        assert not twf.fused_supported(scene, cfg)
        assert not tguided.guided_fused_supported(scene, cfg, gs)
        return
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


def _xml(tmp_path, body=""):
    path = tmp_path / "scene.xml"
    path.write_text(
        '<scene version="0.6.0"><sensor type="perspective"><film '
        'type="hdrfilm"><integer name="width" value="8"/><integer '
        'name="height" value="6"/></film></sensor><shape type="cube">'
        '<transform name="toWorld"><translate z="-4"/></transform></shape>'
        f'{body}</scene>')
    return str(path)


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


def _rays(n=4):
    ro = torch.tensor([[0.0, 1.0, 3.0]]).repeat(n, 1)
    rd = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    return ro, rd


CLASSIC_CALLS = {
    "trace_direct": lambda c, s, g, ro, rd, **k: c.trace_direct(
        s, g, ro, rd, **k),
    "trace_ao": lambda c, s, g, ro, rd, **k: c.trace_ao(s, g, ro, rd, **k),
    "trace_field": lambda c, s, g, ro, rd, **k: c.trace_field(
        s, g, ro, rd, **k),
    "trace_motion": lambda c, s, g, ro, rd, **k: c.trace_motion(
        s, g, ro, rd, 8, 8, **k),
}


@pytest.mark.parametrize("name", sorted(CLASSIC_CALLS))
def test_classic_traces_default_to_the_card(no_gpu, name):
    """A classic integrator's trace runs on the card unless the caller
    passes device="cpu", which traces a wave here."""
    from sdmm_tpu_torch.render import classic

    scene, _ = _scene()
    ro, rd = _rays()
    call = CLASSIC_CALLS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(classic, scene, torch.Generator(), ro, rd)
    out = call(classic, scene, torch.Generator().manual_seed(0), ro, rd,
               device="cpu")
    assert out.shape == (4, 3) and out.device.type == "cpu"
    assert torch.isfinite(out).all()


def test_classic_renders_and_import_default_to_the_card(no_gpu, tmp_path):
    """render_multichannel, render_adaptive, renderer.render with a
    trace_fn and the import subcommand run on the card unless the caller
    asks for the CPU."""
    from sdmm_tpu_torch import cli
    from sdmm_tpu_torch.render import classic, renderer

    scene, cfg = _scene()
    cfg.width = cfg.height = 4

    def trace(s, g, ro, rd):
        return classic.trace_field(s, g, ro, rd, device="cpu")

    for call in (lambda: classic.render_multichannel(scene, cfg, spp=1),
                 lambda: classic.render_adaptive(scene, cfg, max_spp=4),
                 lambda: renderer.render(scene, cfg, spp=1, trace_fn=trace)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    img = renderer.render(scene, cfg, spp=1, trace_fn=trace,
                          device="cpu")["image"]
    assert img.shape == (4, 4, 3)
    dae = tmp_path / "tri.dae"
    dae.write_text(
        '<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema">'
        '<library_geometries><geometry id="g"><mesh><source id="p">'
        '<float_array count="9">0 0 0 1 0 0 0 1 0</float_array>'
        '<technique_common><accessor stride="3"/></technique_common>'
        '</source><vertices id="v"><input semantic="POSITION" source="#p"/>'
        '</vertices><triangles count="1"><input semantic="VERTEX" '
        'source="#v" offset="0"/><p>0 1 2</p></triangles></mesh></geometry>'
        '</library_geometries><library_visual_scenes><visual_scene id="s">'
        '<node><instance_geometry url="#g"/></node></visual_scene>'
        '</library_visual_scenes></COLLADA>')
    out = str(tmp_path / "tri.xml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["import", str(dae), out])
    assert not os.path.exists(out)
    cli.main(["import", str(dae), out, "--device", "cpu"])
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
