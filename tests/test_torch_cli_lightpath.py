"""The light-path integrators through the port's command line and their
device rule, on the CPU:

- ptracer, vpl, bdpt, photonmapper, ppm and sppm through
  ``cli.main(["render", ..., "--device", "cpu"])`` at 8x8 and a few spp,
  their properties taken from -D (lightPaths, maxDepth, globalPhotons,
  maxPasses, photonCount, alpha): the image (.npy) equals the API call's on
  the same loaded scene and seed, an EXR is written, and stats.json holds
  the reference CLI's keys;
- the new entry points (render_ptracer, render_vpl, render_bdpt,
  render_photonmap, render_sppm, the wave functions and the state
  converters) raise "no CUDA device" unless given device="cpu".
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
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.render import bdpt, photonmap, ptracer  # noqa: E402
from sdmm_tpu_torch.scene.xml_loader import load_scene  # noqa: E402
from sdmm_tpu_torch.utils.exr import read_exr  # noqa: E402

torch.set_num_threads(2)
SPP = 4

# integrator: (-D properties, the API call on (scene, cfg, seed), extra
# stats.json keys)
CASES = {
    "ptracer": ([], lambda s, c, seed: ptracer.render_ptracer(
        s, c, spp=SPP, seed=seed, device="cpu"), {"n_paths"}),
    "vpl": (["lightPaths=8", "maxDepth=2"],
            lambda s, c, seed: ptracer.render_vpl(
                s, c, spp=SPP, seed=seed, n_light_paths=8, vpl_depth=2,
                device="cpu"), set()),
    "bdpt": ([], lambda s, c, seed: bdpt.render_bdpt(
        s, c, spp=SPP, seed=seed, rays_per_wave=cli.BDPT_WAVE,
        device="cpu"), set()),
    "photonmapper": (["globalPhotons=4096"],
                     lambda s, c, seed: photonmap.render_photonmap(
                         s, c, spp=SPP, seed=seed, n_photon_paths=4096,
                         device="cpu"), set()),
    "ppm": (["photonCount=2048", "alpha=0.5"],
            lambda s, c, seed: photonmap.render_sppm(
                s, c, iterations=max(SPP // 4, 4), seed=seed,
                photon_paths_per_iter=2048, alpha=0.5, device="cpu"), set()),
    "sppm": (["photonCount=2048", "maxPasses=2"],
             lambda s, c, seed: photonmap.render_sppm(
                 s, c, iterations=2, seed=seed, photon_paths_per_iter=2048,
                 device="cpu"), set()),
}


def test_light_path_integrators_through_the_cli(tmp_path):
    path = tmp_path / "box.xml"
    path.write_text(BOX.replace("$sampler", "independent").replace(
        'value="16"/>', 'value="8"/>').replace('value="12"/>',
                                                'value="8"/>'))
    for name, (props, api, extra) in CASES.items():
        out = tmp_path / name / "img.npy"
        defines = [a for p in props for a in ("-D", p)]
        assert cli.main(["render", str(path), "-o", str(out), "--integrator",
                         name, "--spp", str(SPP), "--device", "cpu",
                         *defines]) is None
        builder = load_scene(str(path), {"integrator": name})
        scene, cfg = builder.build(device="cpu")
        assert (cfg.width, cfg.height) == (8, 8)
        want = np.asarray(api(scene, cfg, builder.seed)["image"])
        got = np.load(out)
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)
        assert np.isfinite(got).all() and got.mean() > 0.05, name
        stats = json.loads((tmp_path / name / "stats.json").read_text())
        assert stats.keys() == {"integrator", "spp", "seconds", "mean"
                                } | extra, name
        assert (stats["integrator"], stats["spp"]) == (name, SPP)
        assert stats["mean"] == pytest.approx(float(want.mean()))
        if name == "ptracer":
            assert stats["n_paths"] == 1 << 16
        exr = tmp_path / name / "img.exr"
        cli.main(["render", str(path), "-o", str(exr), "--integrator", name,
                  "--spp", "1", "--device", "cpu", *defines])
        assert read_exr(str(exr)).shape == (8, 8, 3)


def test_light_path_entry_points_default_to_the_card(no_gpu):
    from torch_parity import make_box

    from sdmm_tpu_torch.scene import scene as tscene
    from sdmm_tpu_torch.scene import shapes as tshapes

    scene, cfg = make_box(tscene, tshapes, 4, 4).build(device="cpu")
    cfg.max_depth = cfg.rr_depth = 2
    pix = torch.rand((8, 2), generator=torch.Generator().manual_seed(0)) * 4
    photons = photonmap.trace_photons(scene, None, 64, max_depth=2,
                                      device="cpu")
    grid = photonmap.build_photon_grid(scene, photons, 0.2)
    vpls = ptracer.generate_vpls(scene, 4, 1, device="cpu")
    ro = torch.zeros((8, 3)) + torch.tensor([0.0, 1.0, 3.0])
    rd = torch.tensor([0.0, 0.0, -1.0]).expand(8, 3)
    calls = {
        "render_ptracer": lambda **k: ptracer.render_ptracer(
            scene, cfg, spp=1, paths_per_wave=64, **k),
        "render_vpl": lambda **k: ptracer.render_vpl(
            scene, cfg, spp=1, n_light_paths=2, vpl_depth=1, **k),
        "render_bdpt": lambda **k: bdpt.render_bdpt(scene, cfg, spp=1, **k),
        "render_photonmap": lambda **k: photonmap.render_photonmap(
            scene, cfg, spp=1, n_photon_paths=64, photon_depth=2, **k),
        "render_sppm": lambda **k: photonmap.render_sppm(
            scene, cfg, iterations=1, photon_paths_per_iter=64,
            photon_depth=2, **k),
        "sample_emission": lambda **k: ptracer.sample_emission(
            scene, 8, **k),
        "trace_particles": lambda **k: ptracer.trace_particles(
            scene, None, 8, 4, 4, max_depth=2, **k),
        "generate_vpls": lambda **k: ptracer.generate_vpls(scene, 2, 1, **k),
        "trace_vpl": lambda **k: ptracer.trace_vpl(scene, None, ro, rd,
                                                   vpls, **k),
        "trace_bdpt": lambda **k: bdpt.trace_bdpt(scene, None, pix, 4, 4,
                                                  max_depth=2, **k),
        "trace_photons": lambda **k: photonmap.trace_photons(
            scene, None, 8, max_depth=2, **k),
        "camera_gather": lambda **k: photonmap.camera_gather(
            scene, None, ro, rd, photons, grid, torch.tensor(0.04), **k),
        "photons_from_arrays": lambda **k: convert.photons_from_arrays(
            photons, **k),
        "photon_grid_from_arrays": lambda **k:
            convert.photon_grid_from_arrays(grid, **k),
        "vpls_from_arrays": lambda **k: convert.vpls_from_arrays(vpls, **k),
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
