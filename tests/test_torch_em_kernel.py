"""Port parity of the EM sufficient statistics against the reference's
Pallas kernel in interpret mode (sdmm_tpu/ops/em_pallas.py
``e_step_pallas``): the case of tests/test_torch_em.py's
test_plain_twin_matches_reference that takes ~2 minutes of CPU, in a file
of its own so that the tier-1 scheduler (``--dist loadfile``, files with
the most tests first) runs it after the long reference files. Same
problem and tolerances as there."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_em import _plain_twin_matches  # noqa: E402


@pytest.mark.parametrize("reference", ["e_step_pallas"])
def test_plain_twin_matches_reference(reference):
    _plain_twin_matches(reference)
