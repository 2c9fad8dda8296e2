"""Dense per-cell unit-action ("arm") catalog, batched over envs.

A port of ``microrts_tpu.ops.arms`` (see its docstring for the Java
sources): every expressible unit action is one arm of a fixed catalog,
so per-unit search statistics are dense ``[..., H, W, A]`` tables and a
joint action is an arm plane int32 ``[..., H, W]`` (-1 where the cell
cannot act).

Catalog layout (A = 13 + 4*T + D*D arms; 90 for UTT v2, range 3):

====================  =========================================
arm index             unit action
====================  =========================================
0                     NONE
1 + d                 MOVE     dir d            (d in 0..3)
5 + d                 HARVEST  dir d
9 + d                 RETURN   dir d
13 + d*T + t          PRODUCE  dir d, type t    (t in 0..T-1)
13 + 4T + r           ATTACK   rel-window pos r (r in 0..D*D-1)
====================  =========================================

``arm_sample`` is the search bots' per-cell local bandit (K12b): the
legality of every arm, a distribution over the legal arms (uniform, the
NaiveMCTS epsilon-greedy rule, InformedNaiveMCTS's prior-weighted rule,
MLPS's UCB1 or UCTUnitActions' one-unit UCB1, treesearch.py:196-274),
one Gumbel-max draw per cell and the
gridnet action of the drawn arms.  On CUDA tensors it is the
``arm_sample`` kernel, ``arms_to_action`` the ``arms_to_action`` kernel;
CPU tensors (or ``plain=True``) take the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import kernels as KN
from ..engine.types import ATTACK, HARVEST, MOVE, NONE, PRODUCE, RETURN

I32 = torch.int32
F32 = torch.float32
MODES = ("uniform", "egreedy", "ucb", "unit_uct", "informed")


@dataclasses.dataclass(frozen=True)
class ArmSpace:
    """Static shape of the arm catalog for a (UTT, max_range) config."""
    num_types: int   # T
    diam: int        # D = 2 * max_range + 1

    @property
    def n_arms(self) -> int:
        return 13 + 4 * self.num_types + self.diam * self.diam

    @property
    def attack_base(self) -> int:
        return 13 + 4 * self.num_types


def arm_space(env) -> ArmSpace:
    ecfg = env.cfg.engine
    return ArmSpace(ecfg.num_types, 2 * ecfg.max_range + 1)


def arm_masks(sp: ArmSpace, m) -> torch.Tensor:
    """Legality per arm, bool ``[..., H, W, A]``, from
    ``Engine.legal_masks``: NONE for any unit that can act, every other
    arm its per-parameter gate AND can-act (``produce_pair`` is the joint
    (dir, type) legality)."""
    can = m["can_act"][..., None]
    return torch.cat([
        can, m["move"] & can, m["harvest"] & can, m["ret"] & can,
        (m["produce_pair"] & can[..., None]).flatten(-2),
        m["attack"] & can], -1)


def arm_masks_packed(sp: ArmSpace, mask: torch.Tensor) -> torch.Tensor:
    """``arm_masks`` from the env's packed int32 mask ``[..., H, W,
    23 + T + D*D]`` (``GridnetEnv.masks``: can-act, 6 types, move,
    harvest, return, produce dir, produce type, attack).  The produce
    pair is the outer product of produce dir and produce type: both are
    the pair's marginals, and the pair is (free neighbour) x (producible
    and affordable type)."""
    T = sp.num_types
    mb = mask.bool()
    can = mb[..., :1]
    pair = mb[..., 19:23, None] & mb[..., None, 23:23 + T]
    return torch.cat([can, mb[..., 7:19] & can,
                      pair.flatten(-2) & can,
                      mb[..., 23 + T:] & can], -1)


def arms_to_action(sp: ArmSpace, arms: torch.Tensor,
                   plain: bool = False) -> torch.Tensor:
    """Decode an arm plane int32 ``[B, H, W]`` (-1 / 0 = no-op) into the
    gridnet action int32 ``[B, H, W, 7]``."""
    if not plain and arms.device.type != "cpu":
        return KN.ARMS_TO_ACTION(sp, arms)
    return arms_to_action_plain(sp, arms)


def arms_to_action_plain(sp: ArmSpace, arms: torch.Tensor) -> torch.Tensor:
    T, ab = sp.num_types, sp.attack_base
    a = arms.clamp(min=0)
    at = torch.full_like(a, ATTACK)
    for lim, code in reversed(((1, NONE), (5, MOVE), (9, HARVEST),
                               (13, RETURN), (ab, PRODUCE))):
        at = torch.where(a < lim, code, at)
    pj = (a - 13).clamp(0, 4 * T - 1)
    comp = torch.stack([
        at, (a - 1).clamp(0, 3), (a - 5).clamp(0, 3), (a - 9).clamp(0, 3),
        pj // T, pj % T, (a - ab).clamp(0, sp.diam * sp.diam - 1)], -1)
    return torch.where((arms > 0)[..., None], comp, 0).to(I32)


def action_to_arms(sp: ArmSpace, action: torch.Tensor,
                   acting: torch.Tensor) -> torch.Tensor:
    """Inverse of ``arms_to_action``: gridnet ``[..., H, W, 7]`` -> arm
    plane int32 ``[..., H, W]`` (-1 where ``acting`` is False)."""
    T = sp.num_types
    at = action[..., 0]
    arm = torch.zeros_like(at)
    for code, val in ((MOVE, 1 + action[..., 1]),
                      (HARVEST, 5 + action[..., 2]),
                      (RETURN, 9 + action[..., 3]),
                      (PRODUCE, 13 + action[..., 4] * T + action[..., 5]),
                      (ATTACK, sp.attack_base + action[..., 6])):
        arm = torch.where(at == code, val, arm)
    return torch.where(acting, arm, -1).to(I32)


def one_hot_arms(sp: ArmSpace, arms: torch.Tensor) -> torch.Tensor:
    """bool ``[..., H, W, A]`` one-hot of an arm plane (-1 rows
    all-False)."""
    return torch.arange(sp.n_arms, device=arms.device) == arms[..., None]


def first_max(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis of a float tensor,
    as ``jnp.argmax`` picks it (every float argmax of the search bots'
    plain path goes through here)."""
    return x.argmax(-1)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=F32, device=like.device)


def sample_arms(sp: ArmSpace, gumbel: torch.Tensor, probs: torch.Tensor,
                acting: torch.Tensor) -> torch.Tensor:
    """One categorical draw per cell over ``[..., H, W, A]`` weights from
    Gumbel noise of the same shape (``argmax(log(w + 1e-20) + g)``, the
    first maximum, as ``jax.random.categorical`` draws); cells outside
    ``acting`` return -1; all-zero rows fall back to uniform."""
    w = torch.where((probs > 0).any(-1, keepdim=True), probs,
                    torch.ones_like(probs))
    arm = first_max(torch.log(w + _f32(1e-20, w)) + gumbel)
    return torch.where(acting, arm, -1).to(I32)


def arm_sample(sp: ArmSpace, mask: torch.Tensor, gumbel: torch.Tensor,
               mode: str = "uniform", tables=None,
               cur: Optional[torch.Tensor] = None,
               player: Optional[torch.Tensor] = None, maxp: int = 0,
               eps_l: float = 0.0, greedy_w: float = 0.0,
               ucb_c: float = 0.0, prior: Optional[torch.Tensor] = None,
               plain: bool = False):
    """The local bandits of one node per game (K12b).

    ``mask`` is the env's packed int32 mask ``[B, H, W, 23+T+D*D]`` of the
    node's state for the player to move.  ``mode``:

    - ``"uniform"``: every legal arm alike; ``gumbel`` float32 ``[B, K,
      H, W, A]`` gives K draws; returns (arms int32 ``[B, K, H, W]``,
      None) (UCT's candidate moves, treesearch.py:646);
    - ``"egreedy"``, ``"ucb"``, ``"unit_uct"``: NaiveMCTS's local MABs
      at node ``cur`` (int32 ``[B]``) of the tree tables ``tables =
      (tvis int32, tacc float32 [B, N+1, H, W, A], nvis int32 [B, N+1])``
      for ``player`` (int32 ``[B]``; a min node where it is not
      ``maxp``); ``gumbel`` ``[B, H, W, A]``; ``eps_l`` and ``greedy_w``
      (the greedy arm's extra weight, ``1 - eps_l`` as the caller rounds
      it) and ``ucb_c`` are the rules' constants; returns (arms int32
      ``[B, H, W]``, gridnet action int32 ``[B, H, W, 7]``);
    - ``"informed"``: ``"egreedy"`` with the learned prior float32 ``[B,
      H, W, A]`` (``ml.pretrained.make_prior_fn``) in place of the
      uniform weights (InformedNaiveMCTSNode.java:181-238,
      treesearch.py:259-271): unvisited arms weighted by the prior, else
      ``eps_l * prior`` plus ``greedy_w`` on the greedy arm, and a cell
      none of whose weights is positive uniform over its unvisited arms.
    """
    if mode not in MODES:
        raise ValueError(f"arm_sample: unknown mode {mode!r}")
    if (mode == "informed") != (prior is not None):
        raise ValueError("arm_sample: the informed mode (and only it) takes "
                         "a prior")
    if not plain and mask.device.type != "cpu":
        return KN.ARM_SAMPLE(sp, MODES.index(mode), mask, gumbel, tables,
                             cur, player, maxp, eps_l, greedy_w, ucb_c,
                             prior)
    return arm_sample_plain(sp, mask, gumbel, mode, tables, cur, player,
                            maxp, eps_l, greedy_w, ucb_c, prior)


def arm_sample_plain(sp: ArmSpace, mask, gumbel, mode="uniform",
                     tables=None, cur=None, player=None, maxp=0,
                     eps_l=0.0, greedy_w=0.0, ucb_c=0.0, prior=None):
    la = arm_masks_packed(sp, mask)
    can = mask[..., 0].bool()
    if mode == "uniform":
        arms = sample_arms(sp, gumbel, la[:, None].to(F32), can[:, None])
        return arms, None
    tvis, tacc, nvis = tables
    rows = torch.arange(mask.shape[0], device=mask.device)
    tv = tvis[rows, cur]
    ta = tacc[rows, cur]
    unv = la & (tv == 0)
    any_unv = unv.any(-1, keepdim=True)
    mean = ta / tv.clamp(min=1).to(F32)
    mean = torch.where((player == maxp)[:, None, None, None], mean, -mean)
    ninf = _f32(float("-inf"), mean)
    arm_ids = torch.arange(sp.n_arms, device=mask.device)
    if mode in ("ucb", "unit_uct"):
        n = nvis[rows, cur].clamp(min=1).to(F32)[:, None, None, None]
        tvf = tv.clamp(min=1).to(F32)
        acting = can
        if mode == "unit_uct":
            # UCTUnitActions: the first idle own unit in board order
            flat = can.flatten(1)
            first = flat.to(torch.uint8).argmax(1)
            cell = (torch.arange(flat.shape[1], device=mask.device)
                    == first[:, None]).reshape(can.shape)
            la = la & cell[..., None]
            unv = la & (tv == 0)
            exploit = (mean + _f32(1.0, mean)) * _f32(0.5, mean)
            explore = torch.sqrt(torch.clamp(torch.log(n / tvf), min=0.0))
            score = _f32(ucb_c, mean) * exploit + explore
            acting = can & cell
        else:
            # MLPS: M = the node's widest unit
            M = la.sum(-1, dtype=I32).flatten(1).amax(1).to(F32)[
                :, None, None, None]
            explore = M * torch.sqrt((M + _f32(1.0, M)) * torch.log(n)
                                     / tvf)
            score = mean + _f32(ucb_c, mean) * explore
        score = torch.where(la & ~unv, score, ninf)
        last_unv = torch.where(unv, arm_ids, -1).amax(-1)
        pick = torch.where(unv.any(-1), last_unv, first_max(score))
        dist = torch.where(la & (arm_ids == pick[..., None]),
                           _f32(1.0, mean), _f32(0.0, mean))
        arms = sample_arms(sp, gumbel, dist, acting)
    else:
        best = first_max(torch.where(la & (tv > 0), mean, ninf))
        zero = _f32(0.0, mean)
        gw = torch.where(arm_ids == best[..., None], _f32(greedy_w, mean),
                         zero)
        if mode == "informed":
            dist_vis = _f32(eps_l, mean) * prior + gw
            dist = torch.where(any_unv, torch.where(unv, prior, zero),
                               torch.where(la, dist_vis, zero))
            # a cell none of whose weights is positive: uniform over its
            # unvisited legal arms
            zrow = ~(dist > 0).any(-1, keepdim=True)
            dist = torch.where(zrow & unv, _f32(1.0, mean), dist)
        else:
            nleg = la.sum(-1, keepdim=True, dtype=I32).clamp(min=1).to(F32)
            dist_vis = _f32(eps_l, mean) / nleg + gw
            dist = torch.where(any_unv, unv.to(F32),
                               torch.where(la, dist_vis, zero))
        arms = sample_arms(sp, gumbel, dist, can)
    return arms, arms_to_action_plain(sp, arms)
