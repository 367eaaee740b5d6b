"""The statistics report and the reference's environment switches,
sdmm_tpu_torch vs sdmm_tpu. The report: the same counter values in both
registries give the same report dict, the same at-exit text and the same
log lines (``print_report``), and ``python -m sdmm_tpu_torch render
--integrator sdmm`` prints the report to stderr at exit. The switches, each
under ``monkeypatch.setenv`` against the reference's gate or route in the
same environment: SDMM_TPU_NO_FUSED shuts both fused gates,
SDMM_TPU_NO_EM_KERNEL the E-step kernel (the reference's gate is shut on a
CPU backend either way; the port's opens for K = 16 without the switch),
SDMM_TPU_NO_NATIVE takes the Python OBJ parser (the soups equal the
reference's), SDMM_TPU_TIME_OPTIMIZE prints the same stages of
``optimize`` in the same order, SDMM_TPU_BVH sends intersection above
1,024 triangles through bvh.traverse. Few tests, so that the tier-1
scheduler (``--dist loadfile``, files with the most tests first) runs the
file after the long reference files."""

import io
import logging
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cli import ROOT, box  # noqa: E402,F401
from test_torch_trainer import _synthetic_batch, _trainers  # noqa: E402
from torch_parity import make_sphere_box, t  # noqa: E402

from sdmm_tpu import native as jnative  # noqa: E402
from sdmm_tpu.render import bvh as jbvh  # noqa: E402
from sdmm_tpu.render import guided as jguided  # noqa: E402
from sdmm_tpu.render import intersect as jisect  # noqa: E402
from sdmm_tpu.render import wavefront as jwf  # noqa: E402
from sdmm_tpu.guiding import em as jem  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu.utils import stats as jstats  # noqa: E402
from sdmm_tpu_torch import native as tnative  # noqa: E402
from sdmm_tpu_torch.guiding import em as tem  # noqa: E402
from sdmm_tpu_torch.render import bvh as tbvh  # noqa: E402
from sdmm_tpu_torch.render import guided as tguided  # noqa: E402
from sdmm_tpu_torch.render import intersect as tisect  # noqa: E402
from sdmm_tpu_torch.render import wavefront as twf  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402
from sdmm_tpu_torch.scene import shapes as tshapes  # noqa: E402
from sdmm_tpu_torch.utils import stats as tstats  # noqa: E402

torch.set_num_threads(2)
VALUES = {"integrator.avg_path_length": (7.0, 3.0),
          "integrator.pct_invalid_samples": (0.0, 0.0),
          "guiding.pct_valid_conditionals": (41.0, 50.0)}


def _capture_at_exit(mod, monkeypatch):
    err = io.StringIO()
    monkeypatch.setattr(mod, "_printed", False)
    monkeypatch.setattr(sys, "__stderr__", err)
    mod._at_exit()
    return err.getvalue()


def test_statistics_report_matches_reference(monkeypatch, caplog, box,
                                             tmp_path):
    for mod in (jstats, tstats):
        for name, c in mod.StatsCounter._registry.items():
            monkeypatch.setattr(c, "value", VALUES[name][0])
            monkeypatch.setattr(c, "base", VALUES[name][1])
    assert tstats.StatsCounter.report() == jstats.StatsCounter.report()
    text = _capture_at_exit(tstats, monkeypatch)
    assert text == _capture_at_exit(jstats, monkeypatch) == \
        tstats.report_text()
    assert text.startswith("sdmm_tpu statistics:\n") and "82" in text
    lines = []
    for mod in (jstats, tstats):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="sdmm_tpu"):
            mod.StatsCounter.print_report()
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[0] == lines[1] and len(lines[0]) == 4
    # The CLI's sdmm render feeds the counters and prints the report.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "sdmm_tpu_torch", "render", box, "-o",
         str(tmp_path / "s.exr"), "--integrator", "sdmm", "--spp", "4",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    rep = res.stderr[res.stderr.index("sdmm_tpu statistics:\n"):]
    got = dict(re.findall(r"^  (\S+) +(\S+)$", rep, re.M))
    assert set(got) == set(VALUES)
    assert float(got["integrator.avg_path_length"]) > 1.0


def test_switches_shut_the_fused_and_em_gates(monkeypatch):
    jt, tt = _trainers()
    jcfg, tcfg = jt.render_cfg, tt.render_cfg
    jgs, tgs = jt.guide_state(), tt.guide_state()
    gates = {"fused": (lambda: jwf.fused_supported(jt.scene, jcfg),
                       lambda: twf.fused_supported(tt.scene, tcfg)),
             "guided": (lambda: jguided.guided_fused_supported(
                 jt.scene, jcfg, jgs),
                 lambda: tguided.guided_fused_supported(tt.scene, tcfg, tgs))}
    monkeypatch.delenv("SDMM_TPU_NO_FUSED", raising=False)
    for name, (jg, tg) in gates.items():
        assert jg() and tg(), name
    monkeypatch.setenv("SDMM_TPU_NO_FUSED", "1")
    for name, (jg, tg) in gates.items():
        assert not jg() and not tg(), name
    # The E-step kernel's gate.
    monkeypatch.delenv("SDMM_TPU_NO_EM_KERNEL", raising=False)
    assert tem.use_em_kernel(tt.sdmm)
    assert not jem._use_pallas_e_step(jt.sdmm)  # a CPU backend
    monkeypatch.setenv("SDMM_TPU_NO_EM_KERNEL", "1")
    assert not tem.use_em_kernel(tt.sdmm)
    assert not jem._use_pallas_e_step(jt.sdmm)
    # Stage timing of optimize: the same stages, in the same order.
    monkeypatch.setenv("SDMM_TPU_TIME_OPTIMIZE", "1")
    jt2, tt2 = _trainers(split_threshold=500, jitter_replicas=False)
    jt2.total_spp = tt2.total_spp = 16
    batch = _synthetic_batch(jt2)
    stages = []
    for tr, conv in ((jt2, jnp.asarray), (tt2, torch.as_tensor)):
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdout", out)
        tr.optimize([{k: (conv(v) if isinstance(v, np.ndarray) else v)
                      for k, v in batch.items()}])
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
        stages.append(re.findall(r"opt\[(\w+)\] \d+\.\d{3}s",
                                 out.getvalue()))
    assert stages[0] == stages[1] and len(stages[0]) == 7, stages


def test_switches_route_obj_parsing_and_intersection(monkeypatch, tmp_path):
    (tmp_path / "m.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\nvt 1 0\n"
        "vt 1 1\nvt 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\n")
    monkeypatch.setenv("SDMM_TPU_NO_NATIVE", "1")

    def no_native(*a, **k):
        raise AssertionError("the native parser ran")

    monkeypatch.setattr(tnative, "obj_load", no_native)
    monkeypatch.setattr(jnative, "obj_load_native", no_native)
    assert tnative.disabled()
    got = tshapes.load_obj(str(tmp_path / "m.obj")).concat()
    want = jshapes.load_obj(str(tmp_path / "m.obj")).concat()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    monkeypatch.delenv("SDMM_TPU_NO_NATIVE")
    # SDMM_TPU_BVH: above BRUTE_FORCE_MAX both packages traverse the BVH.
    js, _ = make_sphere_box(jscene, jshapes).build()
    ts, _ = make_sphere_box(tscene, tshapes).build(device="cpu")
    assert ts.tri_v0.shape[0] > tisect.BRUTE_FORCE_MAX
    rs = np.random.RandomState(0)
    ro = np.tile(np.float32([[0.0, 1.0, 3.5]]), (64, 1))
    rd = rs.randn(64, 3).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 1.0
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tm = np.full(64, 4.0, np.float32)
    calls = {"jax": 0, "torch": 0}

    def spy(mod, key):
        real = mod.traverse

        def traverse(*a, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, "traverse", traverse)

    spy(jbvh, "jax")
    spy(tbvh, "torch")
    for env in ("", "1"):
        monkeypatch.setenv("SDMM_TPU_BVH", env)
        jh = jisect.intersect.__wrapped__(js, jnp.asarray(ro),
                                          jnp.asarray(rd))
        jo = jisect.occluded.__wrapped__(js, jnp.asarray(ro),
                                         jnp.asarray(rd), jnp.asarray(tm))
        th = tisect.intersect(ts, t(ro), t(rd))
        to = tisect.occluded(ts, t(ro), t(rd), t(tm))
        assert calls["jax"] == calls["torch"] == 2 * (env == "1"), env
        np.testing.assert_array_equal(th["tri"].numpy(), np.asarray(jh["tri"]))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert 0 < int(to.sum()) < 64
