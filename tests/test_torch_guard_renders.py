"""Guards that render on the CPU: subsurface scattering, bump maps and
point lights take the eager pool's ported paths, and a textured scene
renders through cli.main only on the card or with --device cpu. The file
holds few tests, so that the tier-1 scheduler (``--dist loadfile``, files
with the most tests first) runs it after the long reference files."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from test_torch_guard import _scene, _xml, no_gpu  # noqa: E402,F401
from torch_parity import make_box  # noqa: E402

from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402


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
