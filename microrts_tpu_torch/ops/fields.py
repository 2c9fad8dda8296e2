"""Grid field ops: multi-source BFS distance fields on batched planes.

A port of ``microrts_tpu.ops.fields``.  Planes are ``[B, H, W]``.

``distance_field`` is ``iters`` synchronous 4-neighbour min-plus sweeps
(the JAX package runs ``H + W``), not a converged BFS: a cell whose
shortest path is longer than ``iters`` stays ``INF``.  Sources are 0 even
when they cannot be walked, other cells that cannot be walked are
``INF``, off-board neighbours read ``INF - 1``.  ``descend_direction``
steps to the strictly smaller neighbour with the reference A*'s tie order
down, left, up, right (AStarPathFinding.java:73-76).  ``distance_field2``
keeps, per cell, the nearest two distinct sources (their distances and
flat positions); ``descend_direction_excluding`` steps toward the nearest
source other than the cell's own id.

The public functions launch the ``fields.cu`` kernels on CUDA tensors
(``kernels.DISTANCE_FIELDS``, ``DESCEND``, ``DISTANCE_FIELD2``,
``DESCEND_EXCLUDING``) and run the ``*_plain`` versions on CPU tensors or
with ``plain=True``.  ``distance_fields`` computes F fields over one
passable plane in one launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels as KN
from ..engine.kernel import iota, pull
from ..engine.types import INF

# tie order: down, left, up, right (AStarPathFinding.java:73-76)
TIE_ORDER = (2, 3, 0, 1)

Field2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _kernel(t: torch.Tensor, plain: bool) -> bool:
    return not plain and t.device.type != "cpu"


def distance_field_plain(sources: torch.Tensor, passable: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """int32 ``[B, H, W]`` path length to the nearest source (bool planes
    ``sources`` and ``passable``; any leading axes broadcast)."""
    d = torch.where(sources, 0, INF).to(torch.int32)
    for _ in range(iters):
        best = d
        for k in range(4):
            best = torch.minimum(best, pull(d, k, fill=INF - 1) + 1)
        d = torch.where(sources, 0, torch.where(passable, best, INF)).to(
            torch.int32)
    return d


def distance_fields_plain(sources: torch.Tensor, passable: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """int32 ``[B, F, H, W]``: ``distance_field_plain`` of each of the F
    source planes of bool ``sources [B, F, H, W]`` over ``passable [B, H,
    W]``."""
    return distance_field_plain(sources, passable[:, None], iters)


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


def distance_field2_plain(sources: torch.Tensor, passable: torch.Tensor,
                          iters: int) -> Field2:
    """The nearest two distinct sources per cell (fields.py:42-101):
    ``(d1, i1, d2, i2)``, int32 ``[B, H, W]`` each, ``i*`` flat row-major
    source positions (-1 where none), unreachable ``INF``.  Each sweep
    merges the four neighbours' entries in the order direction 0..3, the
    first entry before the second (``insert``; a candidate replaces the
    second only if strictly nearer); a source cell pins its first entry to
    itself."""
    B, H, W = sources.shape
    dev = sources.device
    xs, ys = iota(H, W, dev)
    flat = (ys * W + xs).expand(B, H, W)
    i32 = torch.int32
    d1 = torch.where(sources, 0, INF).to(i32)
    i1 = torch.where(sources, flat, -1).to(i32)
    d2 = torch.full((B, H, W), INF, dtype=i32, device=dev)
    i2 = torch.full((B, H, W), -1, dtype=i32, device=dev)

    def insert(st, dc, ic):
        d1, i1, d2, i2 = st
        valid = ic >= 0
        same1 = (ic == i1) & valid
        beats1 = (dc < d1) & valid
        case_b = ~same1 & beats1
        case_c = ~same1 & ~beats1 & valid
        d2c = torch.minimum(d2, dc)
        i2c = torch.where(dc < d2, ic, i2)
        nd1 = torch.where(same1, torch.minimum(d1, dc),
                          torch.where(case_b, dc, d1))
        ni1 = torch.where(case_b, ic, i1)
        nd2 = torch.where(case_b, d1, torch.where(case_c, d2c, d2))
        ni2 = torch.where(case_b, i1, torch.where(case_c, i2c, i2))
        return nd1, ni1, nd2, ni2

    ok = sources | passable
    st = (d1, i1, d2, i2)
    for _ in range(iters):
        out = st
        for k in range(4):
            out = insert(out, pull(st[0], k, fill=INF - 1) + 1,
                         pull(st[1], k, fill=-1))
            out = insert(out, pull(st[2], k, fill=INF - 1) + 1,
                         pull(st[3], k, fill=-1))
        d1n, i1n, d2n, i2n = out
        d1n = torch.where(sources, 0, torch.where(ok, d1n, INF))
        i1n = torch.where(sources, flat, torch.where(ok, i1n, -1))
        d2n = torch.where(ok, d2n, INF)
        i2n = torch.where(ok, i2n, -1)
        st = tuple(x.to(i32) for x in (d1n, i1n, d2n, i2n))
    return st


def descend_direction_excluding_plain(st: Field2, movable: torch.Tensor,
                                      self_id: torch.Tensor) -> torch.Tensor:
    """int32 ``[B, H, W]``: the direction toward the nearest source whose
    id differs from ``self_id`` (int32 ``[B, H, W]``, e.g. the cell's own
    flat position), -1 if no neighbour improves; ``st`` is
    ``distance_field2``'s output (fields.py:104-123)."""
    d1, i1, d2, _ = st

    def val(d1v, i1v, d2v):
        return torch.where(i1v != self_id, d1v, d2v)

    best_d = torch.full(d1.shape, -1, dtype=torch.int32, device=d1.device)
    best_v = val(d1, i1, d2)
    for k in TIE_ORDER:
        v = val(pull(d1, k, fill=INF), pull(i1, k, fill=-1),
                pull(d2, k, fill=INF))
        ok = movable[..., k] & (v < best_v)
        best_d = torch.where(ok, k, best_d)
        best_v = torch.where(ok, v, best_v)
    return best_d


# ----------------------------------------------------------------------
# dispatch: kernels on CUDA tensors, plain versions on CPU tensors


def distance_fields(sources: torch.Tensor, passable: torch.Tensor,
                    iters: int, plain: bool = False) -> torch.Tensor:
    """int32 ``[B, F, H, W]``, F fields over one passable plane."""
    if _kernel(sources, plain):
        return KN.DISTANCE_FIELDS(sources, passable, iters)
    return distance_fields_plain(sources, passable, iters)


def distance_field(sources: torch.Tensor, passable: torch.Tensor,
                   iters: int, plain: bool = False) -> torch.Tensor:
    """int32 ``[B, H, W]``: one field (``distance_fields`` with F = 1)."""
    return distance_fields(sources[:, None], passable, iters, plain)[:, 0]


def descend_direction(dist: torch.Tensor, movable: torch.Tensor,
                      plain: bool = False) -> torch.Tensor:
    if _kernel(dist, plain):
        return KN.DESCEND(dist, movable)
    return descend_direction_plain(dist, movable)


def distance_field2(sources: torch.Tensor, passable: torch.Tensor,
                    iters: int, plain: bool = False) -> Field2:
    if _kernel(sources, plain):
        return KN.DISTANCE_FIELD2(sources, passable, iters)
    return distance_field2_plain(sources, passable, iters)


def descend_direction_excluding(st: Field2, movable: torch.Tensor,
                                self_id: torch.Tensor,
                                plain: bool = False) -> torch.Tensor:
    if _kernel(st[0], plain):
        return KN.DESCEND_EXCLUDING(st, movable, self_id)
    return descend_direction_excluding_plain(st, movable, self_id)
