"""The script-synthesis DSL: programmatic strategies as dense rule stacks.

A port of ``microrts_tpu.synth.dsl`` (ai/synthesis/: DslAIScript.java,
DSLCommand/DSLBasicAction/*.java, grammar/dslTree/*) on batched planes.
A PROGRAM is an ordered list of commands; each command claims the
player's still-unassigned units matching its filter and gives them a
micro action, with ``If`` (boolean feature guards) and ``For`` (static
repetition) combinators.  The AST dataclasses are the JAX package's,
field for field, so ``synth.export`` texts move between the packages.

``compile_program(env, program)`` returns ``bot(state, player, noise)``
-> int32 ``[B, H, W, 7]``: the program is interpreted once per call over
``[B, H, W]`` planes, ``player`` an int or int32 ``[B]`` (one per env),
conditions per-env bools.  ``program_opponent`` wraps it as a
``bots.scripted.Opponent`` whose ``draw`` makes a ``DslNoise``.

On CUDA tensors the distance fields and descents run the ``fields.cu``
kernels (``d_enemy``, ``d_res`` and ``d_base`` in one ``distance_fields``
launch), the range cover the ``range_cover`` kernel and the in-range
target policies the ``dsl_target`` kernel; the puts, counts, conditions,
the MoveAway stencil and ``MoveToUnit``'s board-global argmax are plain
tensor ops.  On CPU tensors, or over an env built with ``plain=True``,
every piece is the plain version.

Places where parity with the JAX package is easy to lose:
- the DSL's ``_put`` overwrites wherever its mask holds (dsl.py:591-601),
  unlike the expert's first-writer-wins ``_put``;
- the target scan walks offsets sorted by d2 (stable, dy-major dx-minor
  generation), takes ``s > best_s`` strictly from ``-inf``, and ``found``
  is ``isfinite(best_s)``;
- every ``Attack(..., "Random")`` of one program reads the SAME
  per-offset uniforms (JAX's ``fold_in(key, rel)`` of one key a call):
  ``DslNoise`` holds one draw per call;
- ``IsPlayerInPosition`` splits the board at ``(W+1)//2`` and
  ``(H+1)//2``; ``Cluster``'s centroid is a floor division;
  ``DistanceFromEnemy`` uses an all-free field; ``MoveToUnit`` claims
  only units that got a MOVE.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from .. import kernels as KN
from ..bots.scripted import Opponent, _rank_by_uid
from ..engine.kernel import as_player, balance, iota, pull, shift
from ..engine.types import ATTACK, HARVEST, MOVE, PRODUCE, RETURN, State
from ..env.expert import scan_offsets
from ..env.gridnet import GridnetEnv
from ..ops.fields import (descend_direction, descend_direction_excluding,
                          distance_field, distance_field2, distance_fields)

I32 = torch.int32

# ---- program AST (hashable frozen dataclasses — a program is a static
# structure folded into the compiled bot) --------------------------------


@dataclasses.dataclass(frozen=True)
class Train:
    producer: str          # "Base" | "Barracks"
    unit: str              # type name to train
    qty: int               # stop once this many own units of ``unit``


@dataclasses.dataclass(frozen=True)
class Build:
    building: str          # "Barracks" | "Base"
    qty: int


@dataclasses.dataclass(frozen=True)
class Harvest:
    qty: int               # number of dedicated harvesters


@dataclasses.dataclass(frozen=True)
class Attack:
    filter: str = "All"    # "All" or a type name
    target: str = "Closest"  # Closest | Weakest | Strongest | MostHealthy


@dataclasses.dataclass(frozen=True)
class MoveAway:
    filter: str = "All"


@dataclasses.dataclass(frozen=True)
class Idle:
    filter: str = "All"


@dataclasses.dataclass(frozen=True)
class MoveToCoord:
    """MoveToCoordinatesBasic.java: claimed units path toward a fixed
    board coordinate."""
    x: int
    y: int
    filter: str = "All"


@dataclasses.dataclass(frozen=True)
class MoveToUnit:
    """MoveToUnitBasic.java: claimed units move toward a unit chosen by
    the target policy on ``side`` ("Enemy" | "Ally" — EnumPlayerTarget),
    without attacking."""
    filter: str = "All"
    target: str = "Closest"
    side: str = "Enemy"


@dataclasses.dataclass(frozen=True)
class Cluster:
    """ClusterBasic.java: claimed units walk toward their own centroid
    (CalcCentroide + findPath to the centroid cell)."""
    filter: str = "All"


# ---- boolean atoms (DSLBasicBoolean / AbstractConditionalFunction);
# ``op`` in {">=", "<=", "==", ">", "<"} (ConditionalBiggerThen et al.)

@dataclasses.dataclass(frozen=True)
class NAllyOfType:
    """HaveQtdUnitsbyType / NAllyUnitsofType."""
    unit: str
    k: int
    op: str = ">="


@dataclasses.dataclass(frozen=True)
class NEnemyOfType:
    """HaveQtdEnemiesbyType / NEnemyUnitsofType."""
    unit: str
    k: int
    op: str = ">="


@dataclasses.dataclass(frozen=True)
class NAllyAttacking:
    """HaveQtdUnitsAttacking / NAllyUnitsAttacking: own units whose
    in-flight action is ATTACK."""
    k: int
    op: str = ">="


@dataclasses.dataclass(frozen=True)
class NAllyHarvesting:
    """HaveQtdUnitsHarversting / NAllyUnitsHarvesting: own units whose
    in-flight action is HARVEST."""
    k: int
    op: str = ">="


@dataclasses.dataclass(frozen=True)
class EnemyInRange:
    r: int                 # true iff an enemy is within r of an own base


@dataclasses.dataclass(frozen=True)
class AllyInEnemyRange:
    """HaveUnitsinEnemyRange: some own unit stands inside an enemy's
    attack range."""


@dataclasses.dataclass(frozen=True)
class EnemyInUnitsRange:
    """HaveEnemiesinUnitsRange: some enemy stands inside an own unit's
    attack range."""


@dataclasses.dataclass(frozen=True)
class DistanceFromEnemy:
    """DistanceFromEnemy.java: the closest own-unit-to-enemy distance
    (4-neighbor grid distance, walls ignored) compares ``op`` ``d``."""
    d: int
    op: str = "<="


@dataclasses.dataclass(frozen=True)
class UnitsStrongest:
    """HaveUnitsStrongest / HaveEnemiesStrongest: ``side`` ("Ally" |
    "Enemy") has the strictly larger total hit-point mass."""
    side: str = "Ally"


@dataclasses.dataclass(frozen=True)
class IsPlayerInPosition:
    """IsPlayerInPosition.java: an own base sits in board quadrant
    ``quadrant`` (0=NW, 1=NE, 2=SW, 3=SE — getLimitOfPosition)."""
    quadrant: int


@dataclasses.dataclass(frozen=True)
class CanAfford:
    unit: str


Cond = Union[NAllyOfType, NEnemyOfType, NAllyAttacking, NAllyHarvesting,
             EnemyInRange, AllyInEnemyRange, EnemyInUnitsRange,
             DistanceFromEnemy, UnitsStrongest, IsPlayerInPosition,
             CanAfford]


@dataclasses.dataclass(frozen=True)
class If:
    cond: Cond
    then: Tuple["Command", ...]


@dataclasses.dataclass(frozen=True)
class For:
    n: int
    body: Tuple["Command", ...]


Command = Union[Train, Build, Harvest, Attack, MoveAway, Idle,
                MoveToCoord, MoveToUnit, Cluster, If, For]
Program = Tuple[Command, ...]



# ---- interpreter -------------------------------------------------------

# the in-range target policies (DSLParametersConcrete/*.java): their mode
# number in the ``dsl_target`` kernel
TARGET_MODES = {"Closest": 0, "Farthest": 1, "Weakest": 2,
                "LessHealthy": 2, "MostHealthy": 3, "Strongest": 4,
                "Random": 5}


class DslNoise(NamedTuple):
    """A compiled program's draws for ``B`` envs, one set per call: the
    ``Random`` attack target's uniforms float32 ``[B, D*D, H, W]`` by
    window offset ``rel`` (JAX: ``uniform(fold_in(key, rel), (H, W))``)
    and ``MoveToUnit(..., "Random")``'s ``[B, H, W]`` (JAX:
    ``uniform(key, (H, W))``); None where the program reads none."""
    u_rel: Optional[torch.Tensor] = None
    u_move: Optional[torch.Tensor] = None


def _walk(prog):
    for c in prog:
        yield c
        body = getattr(c, "then", None) or getattr(c, "body", None)
        if body:
            yield from _walk(body)


def program_draws(program: Program) -> Tuple[bool, bool]:
    """(reads ``u_rel``, reads ``u_move``) of ``program``."""
    cmds = list(_walk(program))
    return (any(isinstance(c, Attack) and c.target == "Random"
                for c in cmds),
            any(isinstance(c, MoveToUnit) and c.target == "Random"
                for c in cmds))


def dsl_noise_draw(env: GridnetEnv, program: Program, gen: torch.Generator,
                   batch: int) -> DslNoise:
    """``program``'s ``DslNoise`` for ``batch`` envs from ``gen``."""
    rel, move = program_draws(program)
    D = 2 * env.cfg.engine.max_range + 1
    h, w, dev = env.h, env.w, env.device
    return DslNoise(
        torch.rand((batch, D * D, h, w), generator=gen, device=dev)
        if rel else None,
        torch.rand((batch, h, w), generator=gen, device=dev)
        if move else None)


def range_cover_plain(src: torch.Tensor, rng: torch.Tensor,
                      R: int) -> torch.Tensor:
    """bool ``[B, H, W]``: cells within attack range of some unit of
    ``src`` (squared-Euclidean ranges, Unit.java:424-435; dsl.py:319-331),
    ``rng`` the int32 attack range plane."""
    cover = torch.zeros_like(src)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            d2 = dx * dx + dy * dy
            if d2 == 0:
                continue
            cover = cover | shift(src & (rng * rng >= d2), dx, dy,
                                  fill=False)
    return cover


def dsl_target_plain(mode: int, enemy: torch.Tensor, hp: torch.Tensor,
                     dmg: torch.Tensor, rng: torch.Tensor, R: int,
                     u_rel: Optional[torch.Tensor] = None):
    """``nearest_in_range_target`` (dsl.py:382-407) under policy ``mode``
    (``TARGET_MODES``): (int32 ``[B, H, W]`` window index of the chosen
    in-range enemy, bool found).  Scores are float32: 0 (Closest), d2
    (Farthest), -hp, hp, the max damage, or ``u_rel[:, rel]`` (Random);
    the first strictly larger score wins, scanned closest first."""
    D = 2 * R + 1
    best_rel = torch.zeros(enemy.shape, dtype=I32, device=enemy.device)
    best_s = torch.full(enemy.shape, float("-inf"), device=enemy.device)
    for d2, dx, dy in scan_offsets(R):
        e_at = shift(enemy, -dx, -dy, fill=False) & (d2 <= rng * rng)
        rel = (R + dy) * D + (R + dx)
        if mode == 0:
            s = torch.zeros_like(best_s)
        elif mode == 1:
            s = torch.full_like(best_s, float(d2))
        elif mode in (2, 3):
            hp_at = shift(hp, -dx, -dy, fill=0).to(torch.float32)
            s = -hp_at if mode == 2 else hp_at
        elif mode == 4:
            s = shift(dmg, -dx, -dy, fill=0).to(torch.float32)
        else:
            s = u_rel[:, rel]
        take = e_at & (s > best_s)
        best_rel = torch.where(take, rel, best_rel)
        best_s = torch.where(take, s, best_s)
    return best_rel, torch.isfinite(best_s)


def compile_program(env: GridnetEnv, program: Program):
    """Compile a DSL program into ``bot(state, player, noise)`` -> int32
    ``[B, H, W, 7]`` (``noise`` a ``DslNoise``, needed only by ``Random``
    targets)."""
    cfg = env.cfg
    ecfg = cfg.engine
    H, W, T = env.h, env.w, ecfg.num_types
    R = ecfg.max_range
    COST = list(ecfg.cost)
    eng = env.engine
    type_id = {}
    for tname in ("Worker", "Light", "Heavy", "Ranged", "Base",
                  "Barracks"):
        tid = getattr(cfg, f"{tname.lower()}_id", -1)
        if tid >= 0:
            type_id[tname] = tid
    iters = H + W
    reads_rel, reads_move = program_draws(program)
    offsets = scan_offsets(R)

    def bot(state: State, player, noise: Optional[DslNoise] = None):
        dev = state.device
        B = state.batch
        kern = eng._use_kernel(state.utype)
        plain = not kern
        if (reads_rel and (noise is None or noise.u_rel is None)) or (
                reads_move and (noise is None or noise.u_move is None)):
            raise ValueError("compile_program: the program's Random target "
                             "needs its DslNoise")

        def lk(name):
            return eng.lut(name, dev)[t]

        me = as_player(player, dev)
        t = (state.utype.long() - 1).clamp(0, T - 1)
        exists = state.utype > 0
        mine = exists & (state.owner == me)
        idle = mine & ~state.busy
        enemy = exists & (state.owner >= 0) & (state.owner != me)
        resource = exists & lk("is_resource")
        my_base = mine & lk("is_stockpile")
        passable = (state.terrain == 0) & ~exists
        free_n = torch.stack([pull(passable, d, False) for d in range(4)],
                             -1)
        any_free = free_n.any(-1)
        tdir = free_n.to(torch.uint8).argmax(-1).to(I32)
        d3 = distance_fields(torch.stack([enemy, resource, my_base], 1),
                             passable, iters, plain)
        d_enemy, d_res, d_base = [d3[:, i].contiguous() for i in range(3)]
        bal = balance(state, player).reshape(B, 1, 1)
        worker = mine & lk("can_harvest")
        uid_rank = _rank_by_uid(worker, state.uid)
        rng_plane = lk("attack_range")
        xs, ys = iota(H, W, dev)
        dmg_plane = lk("max_damage")
        ones = torch.ones((B, H, W), dtype=torch.bool, device=dev)

        def descend(dist):
            return descend_direction(dist, free_n, plain)

        def walk_to(src_mask):
            return descend(distance_field(src_mask, passable, iters, plain))

        def per_env(v):
            return v.reshape(B, 1, 1)

        def count(mask):
            return mask.flatten(1).sum(1, dtype=I32)

        def count_of(tname):
            tid = type_id.get(tname, -1)
            if tid < 0:
                return torch.zeros(B, dtype=I32, device=dev)
            return count(mine & (t == tid))

        def filt(fname):
            if fname == "All":
                return ones
            tid = type_id.get(fname, -1)
            if tid < 0:
                return ~ones
            return t == tid

        def _cmp(a, op, b):
            return {">=": a >= b, "<=": a <= b, "==": a == b,
                    ">": a > b, "<": a < b}[op]

        def range_cover(src_mask):
            if kern:
                return KN.RANGE_COVER(ecfg, state, src_mask)
            return range_cover_plain(src_mask, rng_plane, R)

        def anyp(mask):
            return mask.flatten(1).any(1)

        def cond_value(c) -> torch.Tensor:
            if isinstance(c, NAllyOfType):
                return _cmp(count_of(c.unit), c.op, c.k)
            if isinstance(c, NEnemyOfType):
                tid = type_id.get(c.unit, -1)
                n = count(enemy & (t == tid)) if tid >= 0 \
                    else torch.zeros(B, dtype=I32, device=dev)
                return _cmp(n, c.op, c.k)
            if isinstance(c, NAllyAttacking):
                return _cmp(count(mine & state.busy
                                  & (state.atype == ATTACK)), c.op, c.k)
            if isinstance(c, NAllyHarvesting):
                return _cmp(count(mine & state.busy
                                  & (state.atype == HARVEST)), c.op, c.k)
            if isinstance(c, EnemyInRange):
                return anyp((d_base <= c.r) & enemy)
            if isinstance(c, AllyInEnemyRange):
                return anyp(mine & range_cover(enemy))
            if isinstance(c, EnemyInUnitsRange):
                return anyp(enemy & range_cover(mine & lk("can_attack")))
            if isinstance(c, DistanceFromEnemy):
                d_free = distance_field(enemy, ones, iters, plain)
                dmin = torch.where(mine, d_free, H * W).flatten(1).min(
                    1).values
                return _cmp(dmin, c.op, c.d)
            if isinstance(c, UnitsStrongest):
                own_hp = torch.where(mine, state.hp, 0).flatten(1).sum(
                    1, dtype=I32)
                foe_hp = torch.where(enemy, state.hp, 0).flatten(1).sum(
                    1, dtype=I32)
                return (own_hp > foe_hp) if c.side == "Ally" \
                    else (foe_hp > own_hp)
            if isinstance(c, IsPlayerInPosition):
                east = xs >= (W + 1) // 2
                south = ys >= (H + 1) // 2
                quad = {0: ~east & ~south, 1: east & ~south,
                        2: ~east & south, 3: east & south}[c.quadrant]
                return anyp(my_base & quad)
            if isinstance(c, CanAfford):
                tid = type_id.get(c.unit, -1)
                if tid < 0:
                    return torch.zeros(B, dtype=torch.bool, device=dev)
                return bal.reshape(B) >= COST[tid]
            raise TypeError(c)

        targets = {}

        def target(policy):
            if policy not in targets:
                mode = TARGET_MODES[policy]
                u = noise.u_rel if mode == 5 else None
                targets[policy] = (
                    KN.DSL_TARGET(ecfg, state, player, mode, u, offsets)
                    if kern
                    else dsl_target_plain(mode, enemy, state.hp, dmg_plane,
                                          rng_plane, R, u))
            return targets[policy]

        def run(cmds, out, claimed, gate):
            for cmd in cmds:
                g = per_env(gate)
                if isinstance(cmd, If):
                    out, claimed = run(cmd.then, out, claimed,
                                       gate & cond_value(cmd.cond))
                elif isinstance(cmd, For):
                    for _ in range(cmd.n):
                        out, claimed = run(cmd.body, out, claimed, gate)
                elif isinstance(cmd, Train):
                    pid = type_id.get(cmd.producer, -1)
                    uid_t = type_id.get(cmd.unit, -1)
                    if pid < 0 or uid_t < 0:
                        continue
                    ok = (idle & ~claimed & (t == pid) & g
                          & per_env(count_of(cmd.unit) < cmd.qty)
                          & (bal >= COST[uid_t]) & any_free)
                    _put(out, ok, PRODUCE, p4=tdir, p5=uid_t)
                    claimed = claimed | ok
                elif isinstance(cmd, Build):
                    bid = type_id.get(cmd.building, -1)
                    if bid < 0:
                        continue
                    builder = (idle & ~claimed & worker & g
                               & per_env(count_of(cmd.building) < cmd.qty)
                               & (bal >= COST[bid]) & any_free)
                    # only the lowest-uid eligible worker builds
                    first = _first(builder, state.uid)
                    _put(out, first, PRODUCE, p4=tdir, p5=bid)
                    claimed = claimed | first
                elif isinstance(cmd, Harvest):
                    hu = idle & ~claimed & worker & g & (uid_rank < cmd.qty)
                    adj_res = torch.stack([pull(resource, d, False)
                                           for d in range(4)], -1)
                    adj_base = torch.stack([pull(my_base, d, False)
                                            for d in range(4)], -1)
                    carrying = state.carried > 0
                    h_here = hu & ~carrying & adj_res.any(-1)
                    hdir = adj_res.to(torch.uint8).argmax(-1).to(I32)
                    _put(out, h_here, HARVEST, p2=hdir)
                    r_here = hu & carrying & adj_base.any(-1)
                    rdir = adj_base.to(torch.uint8).argmax(-1).to(I32)
                    _put(out, r_here, RETURN, p3=rdir)
                    m_res = descend(d_res)
                    m_base = descend(d_base)
                    _put(out, hu & ~carrying & ~h_here & (m_res >= 0), MOVE,
                         p1=m_res)
                    _put(out, hu & carrying & ~r_here & (m_base >= 0), MOVE,
                         p1=m_base)
                    claimed = claimed | hu
                elif isinstance(cmd, Attack):
                    unit_ok = (idle & ~claimed & mine & lk("can_attack")
                               & filt(cmd.filter) & g)
                    rel, found = target(cmd.target)
                    shoot = unit_ok & found
                    _put(out, shoot, ATTACK, p6=rel)
                    mdir = descend(d_enemy)
                    _put(out, unit_ok & ~shoot & (mdir >= 0), MOVE, p1=mdir)
                    claimed = claimed | unit_ok
                elif isinstance(cmd, MoveAway):
                    # move-family commands only ever claim MOBILE units
                    unit_ok = (idle & ~claimed & mine & filt(cmd.filter)
                               & lk("can_move") & g)
                    # ascend the enemy distance field; a unit's own cell
                    # is occupied (INF) so its value = 1 + min neighbour
                    CAP = H * W
                    d_fin = d_enemy.clamp_max(CAP)
                    d_here = torch.minimum(d_fin, 1 + torch.stack(
                        [pull(d_fin, d, fill=CAP) for d in range(4)]).min(
                        0).values)
                    away = (CAP - torch.where(mine, d_here, d_fin)).to(I32)
                    mdir = descend(away)
                    _put(out, unit_ok & (mdir >= 0), MOVE, p1=mdir)
                    claimed = claimed | unit_ok
                elif isinstance(cmd, MoveToCoord):
                    unit_ok = (idle & ~claimed & mine & filt(cmd.filter)
                               & lk("can_move") & g)
                    mdir = walk_to((xs == cmd.x) & (ys == cmd.y)
                                   & ones)
                    _put(out, unit_ok & (mdir >= 0), MOVE, p1=mdir)
                    claimed = claimed | unit_ok
                elif isinstance(cmd, MoveToUnit):
                    unit_ok = (idle & ~claimed & mine & filt(cmd.filter)
                               & lk("can_move") & g)
                    side = enemy if cmd.side == "Enemy" else mine
                    if cmd.target == "Closest":
                        if cmd.side == "Enemy":
                            mdir = descend(d_enemy)
                        else:
                            # closest OTHER ally (MoveToUnitBasic): route
                            # toward the nearest DISTINCT source
                            st2 = distance_field2(mine, passable, iters,
                                                  plain)
                            flatpos = (ys * W + xs).expand(B, H, W) \
                                .contiguous()
                            mdir = descend_direction_excluding(
                                st2, free_n, flatpos, plain)
                    else:
                        hp_f = state.hp.to(torch.float32)
                        if cmd.target == "Farthest":
                            score = distance_field(mine, ones, iters,
                                                   plain).to(torch.float32)
                        elif cmd.target in ("Weakest", "LessHealthy"):
                            score = -hp_f
                        elif cmd.target == "MostHealthy":
                            score = hp_f
                        elif cmd.target == "Strongest":
                            score = dmg_plane.to(torch.float32)
                        else:
                            score = noise.u_move
                        s = torch.where(side, score, float("-inf")) \
                            .reshape(B, -1)
                        pick = s.argmax(1)
                        src = torch.zeros((B, H * W), dtype=torch.bool,
                                          device=dev)
                        src[torch.arange(B, device=dev), pick] = True
                        mdir = walk_to(src.reshape(B, H, W)
                                       & per_env(anyp(side)))
                    walk = unit_ok & (mdir >= 0)
                    _put(out, walk, MOVE, p1=mdir)
                    # only units that actually received a MOVE are claimed
                    claimed = claimed | walk
                elif isinstance(cmd, Cluster):
                    unit_ok = (idle & ~claimed & mine & filt(cmd.filter)
                               & lk("can_move") & g)
                    n = count(unit_ok).clamp_min(1)
                    cx = torch.where(unit_ok, xs, 0).flatten(1).sum(
                        1, dtype=I32) // n
                    cy = torch.where(unit_ok, ys, 0).flatten(1).sum(
                        1, dtype=I32) // n
                    mdir = walk_to((xs == per_env(cx)) & (ys == per_env(cy)))
                    _put(out, unit_ok & (mdir >= 0), MOVE, p1=mdir)
                    claimed = claimed | unit_ok
                elif isinstance(cmd, Idle):
                    unit_ok = (idle & ~claimed & mine & filt(cmd.filter)
                               & g)
                    claimed = claimed | unit_ok
                else:
                    raise TypeError(cmd)
            return out, claimed

        out = torch.zeros((B, H, W, 7), dtype=I32, device=dev)
        claimed = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
        run(program, out, claimed,
            torch.ones(B, dtype=torch.bool, device=dev))
        return out

    return bot


def program_opponent(env: GridnetEnv, program: Program) -> Opponent:
    """``compile_program(env, program)`` as an opponent whose ``draw``
    makes the program's ``DslNoise``."""
    def draw(gen: torch.Generator, batch: int) -> DslNoise:
        return dsl_noise_draw(env, program, gen, batch)
    return Opponent(compile_program(env, program), draw)


def _first(mask, uid):
    """Keep only the lowest-uid True cell of each env."""
    return mask & (_rank_by_uid(mask, uid) == 0)


def _put(out, mask, atype, p1=None, p2=None, p3=None, p4=None, p5=None,
         p6=None) -> None:
    """Overwrite the action type and the given columns wherever ``mask``
    holds (dsl.py:591-601; no first-writer rule).  In place."""
    cols = (atype, p1, p2, p3, p4, p5, p6)
    for i, v in enumerate(cols):
        if v is None:
            continue
        out[..., i] = torch.where(mask, v, out[..., i])


# ---- reference programs (the hand-written DslAIScript seed,
# DslAIScript.java:41-90: train 20 workers, 1 harvester, attack-closest) --

SEED_PROGRAM: Program = (
    Train("Base", "Worker", 20),
    Harvest(1),
    Attack("All", "Closest"),
)
