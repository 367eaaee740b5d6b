"""Port parity of the cluster-cull intersector's plain twin
(``ops/clas_cull.cull_plain``, the CPU route of render/intersect.py above
1024 triangles) against the reference, on tests/test_torch_clas.py's scene
(the box of tests/test_render.py plus six spheres of resolution 10, 2,172
triangles): against one interpret-mode call of the reference kernel
``clas_pallas.intersect`` at t_c = 128, as tests/test_clas_pallas.py
forces a multi-cluster build (~40 s, nearly all of it tracing the kernel's
128-way unrolled sweep; it runs in a background thread), and against the
reference's default route for such scenes, the XLA round loop
``clas.intersect`` / ``clas.occluded``. 4,096 random rays, t_max INF on
half of them and finite on the rest, so that one call covers both closest
hit and occlusion: hit ids and valid equal on every ray, t within rtol
2e-4 / atol 2e-5 (tests/test_clas_pallas.py:62-69; XLA's CPU backend may
contract the Woop products into FMAs, and the round loop runs
Möller–Trumbore). A file of few tests, so that the tier-1 scheduler
(``--dist loadfile``, files with the most tests first) runs it after the
long reference files.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_clas import (  # noqa: E402
    _assert_same_hits, _js, _rays, _tris, _ts,
)
from torch_parity import to_np  # noqa: E402

from sdmm_tpu.ops import clas_pallas  # noqa: E402
from sdmm_tpu.render import clas as jclas  # noqa: E402
from sdmm_tpu_torch.ops import clas_cull  # noqa: E402
from sdmm_tpu_torch.render import clas as tclas  # noqa: E402

torch.set_num_threads(2)


def _reference_kernel():
    js = _js()
    c = jclas.build_clusters(*_tris(js), t_c=128)
    js = js._replace(**{f"clas_{k}": jnp.asarray(c[k]) for k in (
        "lo", "hi", "rows", "ids", "woop", "aabb")})
    ro, rd, tm = (jnp.asarray(a) for a in _rays())
    out = clas_pallas.intersect(js, ro, rd, tm, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


def _reference_xla():
    js = _js()
    ro, rd, tm = (jnp.asarray(a) for a in _rays())
    out = {k: np.asarray(v) for k, v in jclas.intersect(js, ro, rd, tm)
           .items()}
    out["occluded"] = np.asarray(jclas.occluded(js, ro, rd, tm))
    return out


@pytest.fixture(scope="module", autouse=True)
def _reference_runs():
    """Starts the reference's calls at the top of the module, so that the
    interpret-mode trace overlaps the port's tests."""
    with ThreadPoolExecutor(2) as ex:
        yield {"kernel": ex.submit(_reference_kernel),
               "xla": ex.submit(_reference_xla)}


def test_twin_matches_reference_kernel(_reference_runs):
    ts = _ts()
    c = tclas.build_clusters(*_tris(ts), t_c=128)
    ts = ts._replace(clas_ids=torch.as_tensor(c["ids"]),
                     clas_woop=torch.as_tensor(c["woop"]),
                     clas_aabb=torch.as_tensor(c["aabb"]))
    ro, rd, tm = (torch.as_tensor(a) for a in _rays())
    got = clas_cull.intersect(ts, ro, rd, tm)
    want = _reference_runs["kernel"].result()
    _assert_same_hits(got, want, to_np(tm))
    # The reference's occluded is valid & (t < t_max) of the same call.
    np.testing.assert_array_equal(
        to_np(clas_cull.occluded(ts, ro, rd, tm)),
        want["valid"] & (want["t"] < to_np(tm)))


def test_twin_matches_xla_cluster_sweep(_reference_runs):
    ts = _ts()
    ro, rd, tm = (torch.as_tensor(a) for a in _rays())
    want = _reference_runs["xla"].result()
    _assert_same_hits(clas_cull.intersect(ts, ro, rd, tm), want, to_np(tm))
    np.testing.assert_array_equal(to_np(clas_cull.occluded(ts, ro, rd, tm)),
                                  want["occluded"])
