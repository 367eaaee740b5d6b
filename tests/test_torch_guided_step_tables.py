"""Port parity of the fused bounce's tables (ops/bounce.py build_tables
against sdmm_tpu/ops/bounce_pallas.py's) on the box, with and without its
extra shapes, and their padding past the unroll limit: rtol 1e-6 (the
same float32 3x3 inverse, LU in both). The file holds few tests, so that
the tier-1 scheduler (``--dist loadfile``, files with the most tests
first) runs it after the long reference files."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guided_step import _scenes  # noqa: E402
from torch_parity import jax_scene_arrays, make_box, to_np  # noqa: E402

from sdmm_tpu.ops import bounce_pallas as bp  # noqa: E402
from sdmm_tpu.scene import scene as jscene  # noqa: E402
from sdmm_tpu.scene import shapes as jshapes  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.scene import scene as tscene  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("extra", [False, True])
def test_build_tables_match_reference(extra):
    js, ts, _ = _scenes(extra)
    ts_j = tscene.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    for port in (bo.build_tables(ts), bo.build_tables(ts_j)):
        for a, b in zip(port, bp.build_tables(js)):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == torch.float32
            np.testing.assert_allclose(to_np(a), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
    assert bo.build_tables(ts)[0].shape[0] == bo.TRI_ROWS == bp.TRI_ROWS


def test_build_tables_pads_past_the_unroll_limit():
    js, _ = make_box(jscene, jshapes, 8, 8, True).build(pad_tris_to=100)
    ts = tscene.scene_from_numpy(jax_scene_arrays(js), device="cpu")
    tri = to_np(bo.build_tables(ts)[0])
    assert tri.shape == (bo.TRI_ROWS, 128) == np.asarray(
        bp.build_tables(js)[0]).shape
    assert not tri[:, 100:].any()
