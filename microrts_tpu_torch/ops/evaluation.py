"""Evaluation functions (ai/evaluation/*), batched over envs.

A port of ``microrts_tpu.ops.evaluation``, faithful to its Java quirks:
the Sqrt variants compute ``sqrt(hp / maxHp)`` with Java INTEGER division
(0 unless at full health), SimpleEvaluationFunction divides in float.
Each function evaluates ``(state, maxplayer, cfg) -> float32 [B]``;
``maxplayer`` is 0, 1, or an int ``[B]`` of 0 and 1 (search lanes mix
players).  On CUDA tensors
every function is the ``evaluate`` kernel (K12a); ``plain=True`` runs the
plain PyTorch version on any device (the kernel's oracle).

The Sqrt family sums small integers, so its values are exact in any
order; Simple, Opt and Lanchester sum float terms, whose order differs
between the kernel, this plain version and XLA.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import kernels as KN
from ..engine.types import EngineConfig, State

F32 = torch.float32

RESOURCE = 20.0
RESOURCE_IN_WORKER = 10.0
UNIT_BONUS_MULTIPLIER = 40.0
VICTORY = 10_000.0

# SimpleOptEvaluationFunction.java:12-14 — tuned constants
OPT_RESOURCE = 0.19059792
OPT_RESOURCE_IN_WORKER = 0.60513535
OPT_UNIT_BONUS_MULTIPLIER = 0.30983887

# LanchesterEvaluationFunction weights (index 0: maps < 128 wide)
_LW = dict(base=0.12900641042498262, rax=0.23108197488337265,
           worker=0.18122298329807154, light=1.7496678034331925,
           ranged=1.6793840344563218, heavy=3.9012441116439427,
           carried=0.3566229669443759, mined=0.30141654836442761)
_LW128 = dict(base=0.48944975377829392, rax=0.55022866772062451,
              worker=-0.0078514695699861588, light=0.12587241165484406,
              ranged=0.029918374064639004, heavy=0.16414240458460899,
              carried=0.01061490087512941, mined=0.38643842595899713)
_ORDER = 1.7
# the kernel's Lanchester slots (csrc/evaluation.cu L_*)
_LNAMES = ("Base", "Barracks", "Worker", "Light", "Ranged", "Heavy")
_LKEYS = ("base", "rax", "worker", "light", "ranged", "heavy", "carried",
          "mined")

_LUTS: Dict[Tuple[EngineConfig, str, torch.device], torch.Tensor] = {}


def _lut(cfg: EngineConfig, name: str, device) -> torch.Tensor:
    key = (cfg, name, torch.device(device))
    if key not in _LUTS:
        _LUTS[key] = torch.tensor(getattr(cfg, name), dtype=torch.int32,
                                  device=device)
    return _LUTS[key]


def _players(state: State, maxplayer) -> torch.Tensor:
    """``maxplayer`` as int32 ``[B]``."""
    return torch.as_tensor(maxplayer, dtype=torch.int32,
                           device=state.device).expand(state.batch)


def _use_kernel(state: State, plain: bool) -> bool:
    return not plain and state.device.type != "cpu"


def _evaluate(fn: str, state: State, maxplayer, cfg: EngineConfig,
              plain: bool, plain_fn, type_ids=(-1,) * 6, weights=(0.0,) * 8):
    if not isinstance(maxplayer, torch.Tensor) and maxplayer not in (0, 1):
        raise ValueError(f"maxplayer must be 0 or 1, got {maxplayer}")
    p = _players(state, maxplayer)
    if _use_kernel(state, plain):
        return KN.EVALUATE(cfg, fn, state, p.contiguous(), type_ids, weights)
    return plain_fn(state, p, cfg)


def _player_planes(state: State, player: torch.Tensor, cfg: EngineConfig):
    T = cfg.num_types
    t = (state.utype.long() - 1).clamp(0, T - 1)
    mine = (state.utype > 0) & (state.owner == player[:, None, None])
    maxhp = _lut(cfg, "hp", state.device)[t]
    cost = _lut(cfg, "cost", state.device)[t]
    bal = torch.where(player == 1, state.resources[:, 1],
                      state.resources[:, 0])
    return t, mine, maxhp, cost, bal


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum((1, 2))


def _simple_base(state, player, cfg, k_res, k_carried, k_unit):
    _, mine, maxhp, cost, bal = _player_planes(state, player, cfg)
    unit_term = k_unit * cost.to(F32) * state.hp.to(F32) \
        / maxhp.clamp(min=1).to(F32)
    return bal.to(F32) * k_res + _sum(torch.where(
        mine, state.carried.to(F32) * k_carried + unit_term, 0.0))


def _simple_plain(state, p, cfg):
    k = (RESOURCE, RESOURCE_IN_WORKER, UNIT_BONUS_MULTIPLIER)
    return _simple_base(state, p, cfg, *k) - _simple_base(state, 1 - p, cfg,
                                                          *k)


def simple_eval(state: State, maxplayer, cfg: EngineConfig,
                plain: bool = False) -> torch.Tensor:
    """SimpleEvaluationFunction: base(maxplayer) - base(other)."""
    return _evaluate("simple", state, maxplayer, cfg, plain, _simple_plain)


def _sqrt_base_score(state: State, player, cfg: EngineConfig):
    """Sqrt variants' base score (Java integer division hp/maxHp) and
    whether the player has a unit."""
    _, mine, maxhp, cost, bal = _player_planes(state, player, cfg)
    ratio = torch.div(state.hp.to(torch.int32), maxhp.clamp(min=1),
                      rounding_mode="floor").to(F32)
    unit_term = UNIT_BONUS_MULTIPLIER * cost.to(F32) * torch.sqrt(ratio)
    score = bal.to(F32) * RESOURCE + _sum(torch.where(
        mine, state.carried.to(F32) * RESOURCE_IN_WORKER + unit_term, 0.0))
    return score, mine.any((1, 2))


def _sqrt_plain(state, p, cfg):
    s1, _ = _sqrt_base_score(state, p, cfg)
    s2, _ = _sqrt_base_score(state, 1 - p, cfg)
    return s1 - s2


def simple_sqrt_eval(state: State, maxplayer, cfg: EngineConfig,
                     plain: bool = False) -> torch.Tensor:
    """SimpleSqrtEvaluationFunction: s1 - s2."""
    return _evaluate("sqrt", state, maxplayer, cfg, plain, _sqrt_plain)


def _sqrt2_plain(state, p, cfg):
    s1, _ = _sqrt_base_score(state, p, cfg)
    s2, _ = _sqrt_base_score(state, 1 - p, cfg)
    return torch.where((s1 == 0) & (s2 != 0), -VICTORY,
                       torch.where((s1 != 0) & (s2 == 0), VICTORY, s1 - s2))


def simple_sqrt_eval2(state: State, maxplayer, cfg: EngineConfig,
                      plain: bool = False) -> torch.Tensor:
    """SimpleSqrtEvaluationFunction2: +-VICTORY when one side is wiped."""
    return _evaluate("sqrt2", state, maxplayer, cfg, plain, _sqrt2_plain)


def _sqrt3_plain(state, p, cfg):
    s1, any1 = _sqrt_base_score(state, p, cfg)
    s2, any2 = _sqrt_base_score(state, 1 - p, cfg)
    s1 = torch.where(any1, s1, 0.0)
    s2 = torch.where(any2, s2, 0.0)
    return torch.where(s1 + s2 == 0, 0.5, 2.0 * s1 / (s1 + s2) - 1.0)


def simple_sqrt_eval3(state: State, maxplayer, cfg: EngineConfig,
                      plain: bool = False) -> torch.Tensor:
    """SimpleSqrtEvaluationFunction3: 2*s1/(s1+s2) - 1 in [-1, 1]."""
    return _evaluate("sqrt3", state, maxplayer, cfg, plain, _sqrt3_plain)


def _opt_plain(state, p, cfg):
    k = (OPT_RESOURCE, OPT_RESOURCE_IN_WORKER, OPT_UNIT_BONUS_MULTIPLIER)
    return _simple_base(state, p, cfg, *k) - _simple_base(state, 1 - p, cfg,
                                                          *k)


def simple_opt_eval(state: State, maxplayer, cfg: EngineConfig,
                    plain: bool = False) -> torch.Tensor:
    """SimpleOptEvaluationFunction.evaluate (:17-31)."""
    return _evaluate("opt", state, maxplayer, cfg, plain, _opt_plain)


def _opt_ub_plain(state, p, cfg):
    neutral = (state.utype > 0) & (state.owner == -1)
    free = _sum(torch.where(neutral, state.carried, 0).to(F32))

    def reach(player):
        _, mine, _maxhp, cost, bal = _player_planes(state, player, cfg)
        return bal.to(F32) + _sum(torch.where(
            mine, (state.carried.to(torch.int32) + cost).to(F32), 0.0))

    zero = torch.zeros_like(p)
    return (free + torch.maximum(reach(zero), reach(zero + 1))) \
        * OPT_UNIT_BONUS_MULTIPLIER


def simple_opt_upper_bound(state: State, cfg: EngineConfig,
                           plain: bool = False) -> torch.Tensor:
    """SimpleOptEvaluationFunction.upperBound (:34-54)."""
    return _evaluate("opt_upper_bound", state, 0, cfg, plain, _opt_ub_plain)


def lanchester_eval(state: State, maxplayer, cfg: EngineConfig,
                    type_ids: dict, plain: bool = False) -> torch.Tensor:
    """LanchesterEvaluationFunction: 2*sigmoid(s_max - s_min) - 1.
    ``type_ids``: name -> id mapping for Base/Barracks/Worker/Light/
    Heavy/Ranged (absent = -1)."""
    W = _LW128 if cfg.width == 128 else _LW
    ids = tuple(int(type_ids.get(n, -1)) for n in _LNAMES)

    def plain_fn(state, p, cfg):
        return _lanchester_plain(state, p, cfg, ids, W)

    return _evaluate("lanchester", state, maxplayer, cfg, plain, plain_fn,
                     ids, tuple(W[k] for k in _LKEYS))


def _lanchester_plain(state, p, cfg, ids, W):
    def score(player):
        t, mine, maxhp, _cost, bal = _player_planes(state, player, cfg)
        hp = state.hp.to(F32)
        maxhp_f = maxhp.clamp(min=1).to(F32)
        tid = dict(zip(_LNAMES, ids))

        def is_(n):
            return mine & (t == tid[n])

        def term(n, x):
            return _sum(torch.where(is_(n), x, 0.0))

        s_build = term("Base", W["base"] * hp) + term("Barracks",
                                                      W["rax"] * hp)
        unit_score = (term("Worker", W["worker"] * hp)
                      + term("Light", W["light"] * hp / maxhp_f)
                      + term("Ranged", W["ranged"] * hp)
                      + term("Heavy", W["heavy"] * hp / maxhp_f))
        n_units = _sum(torch.where(
            is_("Worker") | is_("Light") | is_("Ranged") | is_("Heavy"),
            1.0, 0.0))
        unit_score = unit_score * torch.pow(n_units.clamp(min=1e-9),
                                            _ORDER - 1.0)
        carried = _sum(torch.where(mine, state.carried, 0).to(F32))
        return (unit_score + s_build + carried * W["carried"]
                + bal.to(F32) * W["mined"])

    s = score(p) - score(1 - p)
    return 2.0 * torch.sigmoid(s) - 1.0
