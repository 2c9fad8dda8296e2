"""Fog of war on batched planes (port of ``microrts_tpu.engine.fog``).

Partial observability as in rts/PartiallyObservableGameState.java: a
player sees the cells within the squared-Euclidean sight disc of any of
its units (:61-71); the other players' units outside those discs,
resources included, are removed from its view (:35-54); its observation
has eight planes (:82-154).  ``player`` is an int or an int32 ``[B]`` (one
per env).  Each function dispatches by device: CPU tensors (or
``plain=True``) take the plain version, CUDA tensors launch the ``po_state``
and ``obs_po`` kernels.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .. import kernels as KN
from .kernel import as_player, shift
from .types import EngineConfig, State

I32 = torch.int32

# the unit planes a view masks (terrain and the scalars are shared)
VIEW_FILL = dict(utype=0, owner=-1, hp=0, carried=0, uid=0, atype=0,
                 aparam=0, atx=0, aty=0, aptype=0, aticks=0, aorder=0,
                 atime=-1)


def sight_offsets(max_sight: int) -> List[Tuple[int, int, int]]:
    """(dx, dy, d2) of every offset of the disc of radius ``max_sight``,
    dy outer, dx inner (fog.py:18)."""
    return [(ox, oy, ox * ox + oy * oy)
            for oy in range(-max_sight, max_sight + 1)
            for ox in range(-max_sight, max_sight + 1)
            if ox * ox + oy * oy <= max_sight * max_sight]


def _use_kernel(state: State, plain: bool) -> bool:
    return not plain and state.device.type != "cpu"


def _sight_cover(src: torch.Tensor, utype: torch.Tensor,
                 cfg: EngineConfig) -> torch.Tensor:
    """bool ``[B, H, W]``: the cells within the sight disc of any unit of
    ``src`` (bool ``[B, H, W]``)."""
    sight = torch.tensor(cfg.sight_radius, dtype=I32, device=utype.device)
    t = (utype.long() - 1).clamp(0, cfg.num_types - 1)
    s2 = sight[t] ** 2
    vis = torch.zeros_like(src)
    for ox, oy, d2 in sight_offsets(max(cfg.sight_radius)):
        # a unit at (x, y) with sight s sees (x+ox, y+oy) iff d2 <= s^2
        vis = vis | shift(src & (d2 <= s2), ox, oy, False)
    return vis


def visibility(state: State, player, cfg: EngineConfig,
               plain: bool = False) -> torch.Tensor:
    """bool ``[B, H, W]``: cells within any of ``player``'s units' sight
    (fog.py:27)."""
    if _use_kernel(state, plain):
        return KN.PO_STATE(cfg, state, player, view=False)[1]
    return visibility_plain(state, player, cfg)


def visibility_plain(state: State, player, cfg: EngineConfig) -> torch.Tensor:
    me = as_player(player, state.device)
    own = (state.utype > 0) & (state.owner == me)
    return _sight_cover(own, state.utype, cfg)


def po_state(state: State, player, cfg: EngineConfig,
             plain: bool = False) -> State:
    """``player``'s view (fog.py:43): the other players' units outside its
    visibility removed, hidden resources too."""
    if _use_kernel(state, plain):
        return KN.PO_STATE(cfg, state, player)[0]
    return po_state_plain(state, player, cfg)


def po_state_plain(state: State, player, cfg: EngineConfig) -> State:
    return _view(state, player, visibility_plain(state, player, cfg))


def _view(state: State, player, vis: torch.Tensor) -> State:
    me = as_player(player, state.device)
    keep = ~((state.utype > 0) & (state.owner != me) & ~vis)
    return state.replace(busy=state.busy & keep, **{
        f: torch.where(keep, getattr(state, f), v).to(getattr(state, f).dtype)
        for f, v in VIEW_FILL.items()})


def observation_po(state: State, player, cfg: EngineConfig,
                   plain: bool = False) -> torch.Tensor:
    """int32 ``[B, 8, H, W]`` (fog.py:67): the six observation planes of
    ``player``'s view, its visibility, and the sight discs of the enemy
    units it sees."""
    if _use_kernel(state, plain):
        return KN.OBS_PO(cfg, state, (player,))[0][0]
    return observation_po_plain(state, player, cfg)


def observation_po_plain(state: State, player, cfg: EngineConfig
                         ) -> torch.Tensor:
    me = as_player(player, state.device)
    vis = visibility_plain(state, player, cfg)
    view = _view(state, player, vis)
    exists = view.utype > 0
    owner = view.owner.to(I32)
    ownerp = torch.where(exists & (owner >= 0),
                         torch.remainder(owner + me, 2) + 1, 0)
    actp = torch.where(exists & view.busy, view.atype.to(I32), 0)
    enemy = exists & (owner >= 0) & (owner != me)
    opp_vis = _sight_cover(enemy, view.utype, cfg)
    return torch.stack([
        torch.where(exists, view.hp.to(I32), 0),
        torch.where(exists, view.carried.to(I32), 0),
        ownerp,
        torch.where(exists, view.utype.to(I32), 0),
        actp,
        state.terrain.to(I32),
        vis.to(I32),
        opp_vis.to(I32),
    ], 1).to(I32)

