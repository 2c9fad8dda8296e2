"""Map pools (port of ``microrts_tpu.env.pool``): many maps, one batch.

The maps of a pool are padded to one common (H, W) with wall borders,
stacked into a bank of initial states, and each env of the batch carries
a map index (round-robin), so one step serves a heterogeneous pool and
auto-reset restores each env's own map.  On CUDA tensors the splice reads
each env's own bank row (the ``splice_obs`` kernel's batched init).  The
step is ``VecGridnetEnv.step``: it passes the engine's draws (``u01``,
``coins``, ``gen``) to the env; like the JAX pool, it has no quarantine.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.pgs import TERRAIN_WALL, PhysicalGameState
from ..engine.types import FIELD_DTYPES, State
from ..engine.utt import UnitTypeTable
from .gridnet import REWARD_NAMES, GridnetEnv
from .vec import VecGridnetEnv


def pad_pgs(pgs: PhysicalGameState, h: int, w: int) -> PhysicalGameState:
    """Embed a map at the top-left of an (h, w) board; outside = walls
    (pool.py:25)."""
    if pgs.height > h or pgs.width > w:
        raise ValueError(f"a {pgs.height}x{pgs.width} map does not fit "
                         f"{h}x{w}")
    terrain = np.full((h, w), TERRAIN_WALL, np.int8)
    terrain[:pgs.height, :pgs.width] = \
        np.asarray(pgs.terrain, np.int8).reshape(pgs.height, pgs.width)
    out = PhysicalGameState(w, h, terrain.reshape(-1))
    out.players = copy.deepcopy(pgs.players)
    out.units = copy.deepcopy(pgs.units)
    return out


class MapPoolVecEnv(VecGridnetEnv):
    """Auto-resetting vector env over a pool of maps: env ``i`` plays map
    ``i % len(map_paths)`` and resets to it.  ``env`` is the shared-shape
    ``GridnetEnv`` of the first padded map."""

    def __init__(self, map_paths: Sequence[str], num_envs: int,
                 utt: Optional[UnitTypeTable] = None, max_steps: int = 5000,
                 reward_fns=REWARD_NAMES[:6], partial_obs: bool = False,
                 device="cuda", plain: bool = False):
        utt = utt if utt is not None else UnitTypeTable(2)
        pgss = [PhysicalGameState.load(p, utt) for p in map_paths]
        self.h = max(p.height for p in pgss)
        self.w = max(p.width for p in pgss)
        padded = [pad_pgs(p, self.h, self.w) for p in pgss]
        env = GridnetEnv(None, utt, reward_fns=reward_fns,
                         partial_obs=partial_obs, device=device, plain=plain,
                         pgs=padded[0])
        # the bank of initial states [M, ...], one row per map
        inits = [GridnetEnv(None, utt, reward_fns=reward_fns,
                            device=device, pgs=p).init_state for p in padded]
        self.bank = State(**{f: torch.cat([getattr(s, f) for s in inits])
                             for f in FIELD_DTYPES})
        self.num_maps = len(map_paths)
        self.map_idx = torch.arange(num_envs, device=env.device) % \
            self.num_maps
        super().__init__(env, num_envs, max_steps, init=State(**{
            f: v.index_select(0, self.map_idx).contiguous()
            for f, v in vars(self.bank).items()}))
