"""Joint-action-space size: the BranchingFactorCalculator family.

A port of ``microrts_tpu.ops.branching`` (ai/BranchingFactorCalculator
{Long,Double,BigInteger}.java and the counting side of
rts/PlayerActionGenerator): a unit's action count is its number of legal
arms of the arm catalog (``ops.arms``; NONE included), read off the env's
masks, and the joint size is their product, in the reference's three
numeric flavors.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..engine.types import State
from .arms import arm_masks_packed, arm_space


def per_unit_action_counts(env, state: State, player) -> torch.Tensor:
    """int32 ``[B, H, W]``: the number of legal actions of each own idle
    unit, 0 at cells without one (Unit.getUnitActions' list length)."""
    mask = env.masks(state, player)
    la = arm_masks_packed(arm_space(env), mask)
    return torch.where(mask[..., 0].bool(), la.sum(-1, dtype=torch.int32), 0)


def branching_factor(env, state: State,
                     player) -> List[Tuple[int, float, float]]:
    """(exact int, float, log10) joint-action count of ``player`` for every
    lane: the BigInteger / Double / display flavors of the reference."""
    out = []
    for counts in per_unit_action_counts(env, state, player).cpu().numpy():
        counts = counts[counts > 0]
        exact = 1
        for c in counts:
            exact *= int(c)
        log10 = float(np.sum(np.log10(counts))) if counts.size else 0.0
        out.append((exact, float(exact) if exact < 1e308 else math.inf,
                    log10))
    return out
