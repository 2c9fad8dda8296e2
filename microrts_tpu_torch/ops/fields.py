"""Grid field ops: multi-source BFS distance fields on batched planes.

A port of ``distance_field`` and ``descend_direction`` of
``microrts_tpu.ops.fields`` (the plain versions; the ``rush`` kernel
computes them inside itself).  Planes are ``[B, H, W]``.

``distance_field`` is ``iters`` synchronous 4-neighbour min-plus sweeps
(the JAX package runs ``H + W``), not a converged BFS: a cell whose
shortest path is longer than ``iters`` stays ``INF``.  Sources are 0 even
when they cannot be walked, other cells that cannot be walked are
``INF``, off-board neighbours read ``INF - 1``.  ``descend_direction``
steps to the strictly smaller neighbour with the reference A*'s tie order
down, left, up, right (AStarPathFinding.java:73-76).
"""

from __future__ import annotations

import torch

from ..engine.kernel import pull
from ..engine.types import INF

# tie order: down, left, up, right (AStarPathFinding.java:73-76)
TIE_ORDER = (2, 3, 0, 1)


def distance_field_plain(sources: torch.Tensor, passable: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """int32 ``[B, H, W]`` path length to the nearest source (bool planes
    ``sources`` and ``passable``)."""
    d = torch.where(sources, 0, INF).to(torch.int32)
    for _ in range(iters):
        best = d
        for k in range(4):
            best = torch.minimum(best, pull(d, k, fill=INF - 1) + 1)
        d = torch.where(sources, 0, torch.where(passable, best, INF)).to(
            torch.int32)
    return d


def descend_direction_plain(dist: torch.Tensor,
                            movable: torch.Tensor) -> torch.Tensor:
    """int32 ``[B, H, W]``: the direction of the smallest neighbour of
    ``dist`` below the cell's own value, the neighbours tried in
    ``TIE_ORDER`` and each kept only if strictly smaller than the best so
    far; -1 if none.  ``movable`` bool ``[B, H, W, 4]`` gates which
    neighbours can be stepped into."""
    best_d = torch.full(dist.shape, -1, dtype=torch.int32,
                        device=dist.device)
    best_v = dist
    for k in TIE_ORDER:
        v = pull(dist, k, fill=INF)
        ok = movable[..., k] & (v < best_v)
        best_d = torch.where(ok, k, best_d)
        best_v = torch.where(ok, v, best_v)
    return best_d
