"""The Metropolis integrators and the irradiance cache through the port's
command line, and their device rule, on the CPU:

- pssmlt, erpt, mlt and irrcache through ``cli.main(["render", ...,
  "--device", "cpu"])`` at 8x8 and a few spp, their properties taken from
  -D (pLarge, chainLength, resolution, quality, indirectOnly): the image
  (the EXR and the --npy copy) equals the API call's on the same loaded
  scene and seed, and stats.json holds the reference CLI's keys (b for the
  three Metropolis integrators);
- mlt on a scene lit only by a constant environment prints the reference
  CLI's fallback line and renders through pssmlt;
- the new entry points (the renderers, eval_path, trace_path_record,
  mlt_chain_step, empty_paths, build_cache, sh.project, sh.lambda_l and
  the state converters) raise "no CUDA device" unless given device="cpu".
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cli import BOX  # noqa: E402
from test_torch_guard import no_gpu  # noqa: E402,F401

from sdmm_tpu_torch import cli  # noqa: E402
from sdmm_tpu_torch.core import sh  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import irrcache, mlt, pssmlt  # noqa: E402
from sdmm_tpu_torch.scene.xml_loader import load_scene  # noqa: E402
from sdmm_tpu_torch.utils.exr import read_exr  # noqa: E402

torch.set_num_threads(2)
SPP = 2

# integrator: (-D properties, the API call on (scene, cfg, seed), extra
# stats.json keys)
CASES = {
    "pssmlt": (["pLarge=0.5"], lambda s, c, seed: pssmlt.render_pssmlt(
        s, c, spp=SPP, seed=seed, p_large=0.5, device="cpu"), {"b"}),
    "erpt": (["chainLength=4"], lambda s, c, seed: pssmlt.render_erpt(
        s, c, spp=SPP, seed=seed, chain_length=4, device="cpu"), {"b"}),
    "mlt": ([], lambda s, c, seed: mlt.render_mlt(
        s, c, spp=SPP, seed=seed, device="cpu"), {"b"}),
    "irrcache": (["resolution=2", "quality=2", "indirectOnly=false"],
                 lambda s, c, seed: irrcache.render_irrcache(
                     s, c, spp=SPP, seed=seed, gather_res=2, kappa=2.0,
                     device="cpu"), set()),
}


def _small_box(tmp_path, text=BOX):
    path = tmp_path / "box.xml"
    path.write_text(text.replace("$sampler", "independent").replace(
        'value="16"/>', 'value="8"/>').replace('value="12"/>',
                                                'value="8"/>'))
    return path


def test_mcmc_and_irrcache_through_the_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(irrcache, "TABLE", 512)
    path = _small_box(tmp_path)
    for name, (props, api, extra) in CASES.items():
        out = tmp_path / name / "img.exr"
        defines = [a for p in props for a in ("-D", p)]
        assert cli.main(["render", str(path), "-o", str(out), "--integrator",
                         name, "--spp", str(SPP), "--device", "cpu",
                         "--npy", str(out.with_suffix(".npy")),
                         *defines]) is None
        builder = load_scene(str(path), {"integrator": name})
        scene, cfg = builder.build(device="cpu")
        assert (cfg.width, cfg.height) == (8, 8)
        res = api(scene, cfg, builder.seed)
        want = np.asarray(res["image"])
        for got in (read_exr(str(out)), np.load(out.with_suffix(".npy"))):
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
            assert np.isfinite(got).all() and got.mean() > 0.05, name
        stats = json.loads((tmp_path / name / "stats.json").read_text())
        assert stats.keys() == {"integrator", "spp", "seconds", "mean"
                                } | extra, name
        assert (stats["integrator"], stats["spp"]) == (name, SPP)
        assert stats["mean"] == pytest.approx(float(want.mean()))
        if "b" in extra:
            assert stats["b"] == pytest.approx(res["b"]) and res["b"] > 0
    # indirectOnly reads "true" as true: the image darkens.
    dark = tmp_path / "dark" / "img.npy"
    cli.main(["render", str(path), "-o", str(dark), "--integrator",
              "irrcache", "--spp", str(SPP), "--device", "cpu", "-D",
              "resolution=2", "-D", "indirectOnly=true"])
    assert np.load(dark).mean() < np.load(tmp_path / "irrcache" /
                                          "img.npy").mean()


def test_mlt_falls_back_to_pssmlt_without_area_emitters(tmp_path, capsys):
    start = BOX.index('  <shape type="rectangle"><transform name="toWorld">'
                      '\n    <scale x="0.3"')
    text = BOX[:start] + ('  <emitter type="constant"><rgb name="radiance" '
                          'value="1"/></emitter>\n</scene>\n')
    path = _small_box(tmp_path, text)
    out = tmp_path / "env" / "img.npy"
    cli.main(["render", str(path), "-o", str(out), "--integrator", "mlt",
              "--spp", str(SPP), "--device", "cpu", "-D", "pLarge=0.4"])
    assert ("mlt: no area-emitter bootstrap paths (b == 0); falling back "
            "to pssmlt for env transport") in capsys.readouterr().out
    builder = load_scene(str(path), {"integrator": "mlt"})
    scene, cfg = builder.build(device="cpu")
    assert scene.em_tri_idx.numel() == 0
    want = pssmlt.render_pssmlt(scene, cfg, spp=SPP, seed=builder.seed,
                                p_large=0.4, device="cpu")
    np.testing.assert_array_equal(np.load(out), want["image"].astype(
        np.float32))
    stats = json.loads((tmp_path / "env" / "stats.json").read_text())
    assert stats["b"] == pytest.approx(want["b"]) and want["b"] > 0
    assert stats["integrator"] == "mlt" and np.load(out).mean() > 0


def test_mcmc_entry_points_default_to_the_card(no_gpu, monkeypatch):
    from torch_parity import make_box

    from sdmm_tpu_torch.scene import scene as tscene
    from sdmm_tpu_torch.scene import shapes as tshapes

    monkeypatch.setattr(irrcache, "TABLE", 64)
    scene, cfg = make_box(tscene, tshapes, 4, 4).build(device="cpu")
    cfg.max_depth = cfg.rr_depth = 2
    types = tuple(cfg.bsdf_types)
    spos = torch.rand((8, 2), generator=torch.Generator().manual_seed(0)) * 4
    paths = mlt.trace_path_record(scene, torch.Generator(), spos, 4, 4, 2,
                                  types, device="cpu")
    cache = irrcache.build_cache(scene, torch.Generator(), 4, 4, grid_res=4,
                                 gather_res=1, max_depth=2, n_candidates=64,
                                 device="cpu")
    u = torch.rand((8, pssmlt.pss_dims(2)))
    calls = {
        "render_pssmlt": lambda **k: pssmlt.render_pssmlt(
            scene, cfg, spp=1, n_chains=8, n_bootstrap=64, **k),
        "render_erpt": lambda **k: pssmlt.render_erpt(
            scene, cfg, n_seeds=8, chain_length=1, **k),
        "eval_path": lambda **k: pssmlt.eval_path(scene, u, 4, 4,
                                                  max_depth=2, **k),
        "render_mlt": lambda **k: mlt.render_mlt(scene, cfg, spp=1,
                                                 n_chains=8, **k),
        "trace_path_record": lambda **k: mlt.trace_path_record(
            scene, torch.Generator(), spos, 4, 4, 2, types, **k),
        "mlt_chain_step": lambda **k: mlt.mlt_chain_step(
            scene, paths, torch.Generator(), 4, 4, 2, types, n_steps=1,
            **k),
        "empty_paths": lambda **k: mlt.empty_paths(8, 2, **k),
        "render_irrcache": lambda **k: irrcache.render_irrcache(
            scene, cfg, spp=1, grid_res=4, gather_res=1, **k),
        "build_cache": lambda **k: irrcache.build_cache(
            scene, torch.Generator(), 4, 4, grid_res=4, gather_res=1,
            max_depth=2, n_candidates=64, **k),
        "sh.project": lambda **k: sh.project(lambda d: d[:, 2], 2, res=8,
                                             **k),
        "sh.lambda_l": lambda **k: sh.lambda_l(2, **k),
        "mlt_paths_from_arrays": lambda **k: convert.mlt_paths_from_arrays(
            paths, **k),
        "irrcache_from_arrays": lambda **k: convert.irrcache_from_arrays(
            cache, **k),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        out = call(device="cpu")
        first = out[0] if isinstance(out, tuple) else out
        if isinstance(first, dict):
            first = next(iter(first.values()))
        assert isinstance(first, (torch.Tensor, np.ndarray)), name
        if isinstance(first, torch.Tensor):
            assert first.device.type == "cpu", name
