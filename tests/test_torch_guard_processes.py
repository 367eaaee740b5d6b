"""Guards that start a process: importing every module of the port
leaves JAX and the reference package out, and chip_smoke.py refuses to run
without a GPU or copied out of the repository. The file holds few tests,
so that the tier-1 scheduler (``--dist loadfile``, files with the most
tests first) runs it after the long reference files."""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guard import ROOT, no_gpu  # noqa: E402,F401


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
