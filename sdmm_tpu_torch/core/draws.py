"""Uniform draws of the wave tracers that do not depend on how a wave is
split over the ranks of a mesh.

The reference shards a wave under GSPMD, so its uniforms are those of the
global array whatever the mesh. ``rand`` gives the port the same property:
a tracer draws through it with a plain ``torch.Generator`` (one process,
``torch.rand`` as it is) or with a ``WaveBlock``, which a mesh rank passes
for its block of a wave: then the whole wave's rows are drawn and the
block's kept, so every rank's lanes see the uniforms that one process
tracing the whole wave gives them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def seeded(device, *parts) -> torch.Generator:
    """A generator on ``device`` seeded from integer parts."""
    seed = 0
    for p in parts:
        seed = (seed * 1_000_003 + int(p)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


class WaveBlock(NamedTuple):
    """Rows ``first`` .. ``first`` + n of a wave of ``total`` rows, drawn
    from ``generator``."""
    generator: torch.Generator
    first: int
    total: int


def rand(shape, generator, device, axis: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` (a ``torch.Generator`` or a
    ``WaveBlock``); ``axis`` is the one that runs over the wave's rows."""
    if not isinstance(generator, WaveBlock):
        return torch.rand(shape, generator=generator, device=device)
    full = list(shape)
    full[axis] = generator.total
    return torch.rand(full, generator=generator.generator,
                      device=device).narrow(axis, generator.first,
                                            shape[axis])
