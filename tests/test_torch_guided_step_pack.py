"""The shade table's packing (ops/guided_step.py pack_shade_table) round
trips the reference's pack_guided_rows bit for bit, and shade on the
packed table equals shade on the rows, NaN radiance included. The file
holds few tests, so that the tier-1 scheduler (``--dist loadfile``, files
with the most tests first) runs it after the long reference files."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guided_step import (  # noqa: E402
    FRACTION, MAX_DEPTH, RR_DEPTH, TYPES, _scenes,
)
from torch_parity import lane_wave, make_mixture_state  # noqa: E402

from sdmm_tpu.guiding import mixture as jmix  # noqa: E402
from sdmm_tpu.ops import guided_pallas as jgp  # noqa: E402
from sdmm_tpu_torch.guiding import convert  # noqa: E402
from sdmm_tpu_torch.ops import bounce as bo  # noqa: E402
from sdmm_tpu_torch.ops import guided_sample as gso  # noqa: E402
from sdmm_tpu_torch.ops import guided_step as gst  # noqa: E402

torch.set_num_threads(2)


def _reference_table(L, seed):
    """The reference's pack_guided_rows of a seeded mixture state, carried
    to the port as numpy (convert's array bridge): [L, N_ROWS] float32."""
    ms = make_mixture_state(seed=seed, L=L)
    js = jmix.SDMM(weight=jnp.asarray(ms["weight"]),
                   mean=jnp.asarray(ms["mean"]), cov=jnp.asarray(ms["cov"]))
    rows = jgp.pack_guided_rows(jmix.prepare(js), js.weight,
                                jnp.asarray(ms["initialized"]))
    return torch.as_tensor(convert._np(rows).T.copy()), ms["initialized"]


def test_pack_shade_table_round_trips_reference_rows():
    L = 64
    table, initialized = _reference_table(L, seed=4)
    t16 = table.to(torch.bfloat16)
    packed = gst.pack_shade_table(table)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (L, gso.PACK_COLS) and packed.is_contiguous()
    # Every row and every component's three words start on 16 bytes.
    assert (gso.PACK_COLS * 2) % 16 == 0 and (gso.PACK_STRIDE * 2) % 16 == 0
    bits = packed.view(torch.int16)
    assert torch.equal(gso.unpack_sample_table(packed).view(torch.int16),
                       t16.view(torch.int16))
    comp = bits.reshape(L, gso.K, gso.PACK_STRIDE)
    ref = t16.view(torch.int16)
    # The kernel's blocks: values 0-15 (two words) and 16-21 (one word).
    assert torch.equal(comp[:, :, :16].reshape(L, -1),
                       ref[:, :gso.K * 22].reshape(L, gso.K, 22)[:, :, :16]
                       .reshape(L, -1))
    assert torch.equal(comp[:, :, 16:22],
                       ref[:, :gso.K * 22].reshape(L, gso.K, 22)[:, :, 16:])
    # The init flag in component 0's first pad; every other pad is 0.
    assert torch.equal(comp[:, 0, gso.PACK_INIT], ref[:, gso.N_ROWS - 1])
    assert torch.equal(packed.float()[:, gso.PACK_INIT] > 0.5,
                       torch.as_tensor(initialized))
    pads = comp[:, :, 22:].clone()
    pads[:, 0, 0] = 0
    assert not pads.any()


def test_shade_on_packed_table_equals_shade_on_rows():
    _, ts, tcfg = _scenes(True)
    tri, _, env = bo.build_tables(ts)
    n, L = 2048, 64
    state, meta, rand = (torch.as_tensor(a) for a in
                         lane_wave(n, seed=12, max_depth=MAX_DEPTH))
    st, hit = gst.trace(state, meta, tri, env, TYPES)
    table, _ = _reference_table(L, seed=5)
    leaf = torch.as_tensor(np.random.RandomState(6).randint(0, L, n)
                           .astype(np.int32))
    cpos = ((hit[0:3].T - ts.aabb_lo) / 2.0).T.contiguous()
    packed = gst.shade(st, meta, hit, cpos, leaf,
                       gst.pack_shade_table(table), rand, TYPES, MAX_DEPTH,
                       RR_DEPTH, FRACTION)
    rows = gst.shade_plain(st, meta, hit, cpos,
                           table.to(torch.bfloat16)[leaf.long()].T.float(),
                           rand, TYPES, MAX_DEPTH, RR_DEPTH, FRACTION)
    for a, b in zip(packed, rows):  # bit for bit, NaN radiance included
        assert bool(((a == b) | (a.isnan() & b.isnan())).all())
    assert 0 < int(rows[2][9].sum())  # guided samples were drawn
