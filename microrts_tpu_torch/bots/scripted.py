"""Scripted bots on batched planes (port of ``microrts_tpu.bots.scripted``:
``passive_bot``, ``random_bot``, ``random_biased_single_unit_bot``, the
``rush_bot`` family and its partially observable ``po_*`` rushes).

A bot is ``bot(state, player, u) -> int32 [B, H, W, 7]`` gridnet actions.
Its randomness comes in as ``u``, float32 uniforms in [0, 1) of shape
``[B, H, W, 2]`` made by the caller (e.g. with a ``torch.Generator``), so
the same draws can be fed to the JAX package in tests.  The rush bots are
deterministic and take no uniforms.  An ``Opponent`` pairs a bot with
``draw(gen, B)``, which makes the noise the bot reads (the trainer, the
tournaments and the search bots draw through it).  ``distribution_bot``
(UnitActionProbabilityDistributionAI with fixed type weights) reads a
``DistributionNoise``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import kernels as KN
from ..engine.kernel import as_player, pull, shift
from ..engine.types import ATTACK, HARVEST, INF, MOVE, PRODUCE, RETURN, State
from ..env.gridnet import GridnetEnv
from ..models.gridnet_policy import gumbel_noise
from ..ops.fields import descend_direction_plain, distance_field_plain

I32 = torch.int32


def passive_bot(env: GridnetEnv):
    """PassiveAI (ai/PassiveAI.java:28-55): never acts."""
    def bot(state: State, player: int, u=None) -> torch.Tensor:
        return torch.zeros((state.batch, env.h, env.w, 7), dtype=I32,
                           device=state.device)
    return bot


def random_bot(env: GridnetEnv, bias: float = 1.0):
    """RandomAI (bias=1) / RandomBiasedAI (bias=5: harvest, return and
    attack weighted 5x, RandomBiasedAI.java:25-60), as scripted.py:38-103
    samples it: a float32 threshold walk over the 6 action classes with
    ``u[..., 0]``, then the ``min(int(u1*n), n-1)``-th legal parameter of
    the chosen class with ``u[..., 1]``.  On CUDA tensors this is the
    fused ``actor`` kernel (legal masks + sampling)."""
    weights = (1.0, 1.0, float(bias), float(bias), 1.0, float(bias))

    def bot(state: State, player: int, u: torch.Tensor) -> torch.Tensor:
        if env.engine._use_kernel(u):
            return KN.ACTOR(env.cfg.engine, state, player, u=u,
                            weights=weights)[0]
        return random_bot_plain(env, state, player, u, weights)

    return bot


@dataclasses.dataclass(frozen=True)
class Opponent:
    """A bot that owns its randomness: ``bot(state, player, noise)`` reads
    what ``draw(gen, B)`` makes for a batch of ``B`` states (None for a
    deterministic bot).  JAX's bots draw the same kinds of noise from a
    key instead, so a test can make it there and hand it over."""
    bot: Callable
    draw: Callable = lambda gen, batch: None

    def __call__(self, state: State, player: int, noise=None) -> torch.Tensor:
        return self.bot(state, player, noise)


def uniform_draw(env: GridnetEnv) -> Callable:
    """``draw`` of RandomBiasedAI's two uniforms per cell: float32 ``[B,
    H, W, 2]`` on the env's device."""
    def draw(gen: torch.Generator, batch: int) -> torch.Tensor:
        return torch.rand((batch, env.h, env.w, 2), generator=gen,
                          device=env.device)
    return draw


def random_opponent(env: GridnetEnv, bias: float = 5.0) -> Opponent:
    """``random_bot(env, bias)`` as an opponent: two uniforms per cell,
    ``uniform(key, (H, W, 2))`` in the JAX package (scripted.py:71)."""
    return Opponent(random_bot(env, bias), uniform_draw(env))


class SingleUnitNoise(NamedTuple):
    """``random_biased_single_unit_bot``'s draws for ``B`` states: the
    inner RandomBiasedAI's uniforms float32 ``[B, H, W, 2]`` (JAX: k0)
    and the unit pick's ``[B, H, W]`` (k1)."""
    u: torch.Tensor
    r: torch.Tensor


def random_biased_single_unit_bot(env: GridnetEnv, bias: float = 5.0):
    """RandomBiasedSingleUnitAI (ai/RandomBiasedSingleUnitAI.java:76-110,
    scripted.py:108-124): RandomBiasedAI's actions (the ``actor`` kernel
    on CUDA tensors) kept for ONE idle own unit, the argmax of
    ``where(can_act, r, -1)`` (the first in row-major order on a tie);
    every other unit idles.  ``noise`` is a ``SingleUnitNoise``."""
    inner = random_bot(env, bias)

    def bot(state: State, player, noise: SingleUnitNoise) -> torch.Tensor:
        a = inner(state, player, noise.u)
        can = ((state.utype > 0) & ~state.busy
               & (state.owner == as_player(player, state.device)))
        score = torch.where(can, noise.r, -1.0).reshape(state.batch, -1)
        chosen = torch.zeros_like(score, dtype=torch.bool).scatter_(
            1, score.argmax(1, keepdim=True), True).reshape(can.shape)
        return torch.where((chosen & can)[..., None], a, 0)

    return bot


def single_unit_opponent(env: GridnetEnv, bias: float = 5.0) -> Opponent:
    """``random_biased_single_unit_bot`` as an opponent: its draws are a
    ``SingleUnitNoise``."""
    def draw(gen: torch.Generator, batch: int) -> SingleUnitNoise:
        shape = (batch, env.h, env.w)
        return SingleUnitNoise(
            torch.rand(shape + (2,), generator=gen, device=env.device),
            torch.rand(shape, generator=gen, device=env.device))
    return Opponent(random_biased_single_unit_bot(env, bias), draw)


class DistributionNoise(NamedTuple):
    """``distribution_bot``'s draws for ``B`` states: the type draw's
    Gumbels float32 ``[B, H, W, 6]`` (JAX: k1) and the inner RandomAI's
    uniforms ``[B, H, W, 2]`` (k2)."""
    gumbel: torch.Tensor
    u: torch.Tensor


def distribution_bot(env: GridnetEnv, type_weights) -> Opponent:
    """UnitActionProbabilityDistributionAI (ai/stochastic/*) with a fixed
    positive weight per action type ``type_weights`` [6] (NONE, MOVE,
    HARVEST, RETURN, PRODUCE, ATTACK), scripted.py:509-528: every acting
    unit draws its type from the weights of its legal types (all alike
    where none has weight), its parameters as RandomAI draws them.  On
    CUDA tensors the masks and the inner RandomAI are one ``actor``
    launch."""
    weights = (1.0,) * 6
    tw_all = torch.tensor([float(v) for v in type_weights],
                          dtype=torch.float32)

    def bot(state: State, player, noise: DistributionNoise) -> torch.Tensor:
        if env.engine._use_kernel(noise.u):
            base, mask = KN.ACTOR(env.cfg.engine, state, player, u=noise.u,
                                  weights=weights, masks=True)
        else:
            base = random_bot_plain(env, state, player, noise.u, weights)
            mask = env.masks_plain(state, player)
        tw = torch.where(mask[..., 1:7].bool(), tw_all.to(mask.device), 0.0)
        tw = torch.where(tw.sum(-1, keepdim=True) > 0, tw,
                         torch.ones_like(tw))
        at = (torch.log(tw + 1e-9) + noise.gumbel).argmax(-1)
        out = base.clone()
        out[..., 0] = torch.where(mask[..., 0].bool(), at, 0).to(I32)
        return out

    def draw(gen: torch.Generator, batch: int) -> DistributionNoise:
        shape = (batch, env.h, env.w)
        return DistributionNoise(
            gumbel_noise(shape + (6,), gen, env.device),
            torch.rand(shape + (2,), generator=gen, device=env.device))

    return Opponent(bot, draw)


def kth_legal(L: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Index of the (j+1)-th True along the last axis of bool ``L``
    (``j`` int32); 0 when out of range."""
    hit = L & (torch.cumsum(L.to(I32), -1) == (j + 1)[..., None])
    return hit.to(torch.uint8).argmax(-1).to(I32)


def random_bot_plain(env: GridnetEnv, state: State, player: int,
                     u: torch.Tensor, weights) -> torch.Tensor:
    T = env.cfg.engine.num_types
    B, H, W = state.utype.shape
    m = env.engine.legal_masks(state, player)
    tm = m["type"]
    f32 = torch.float32

    # weighted type draw: a threshold walk over the 6 classes, in float32
    w = [torch.where(tm[..., i], weights[i], 0.0).to(f32) for i in range(6)]
    tot = w[0]
    for i in range(1, 6):
        tot = tot + w[i]
    x = u[..., 0] * tot
    acc = torch.zeros_like(x)
    at = torch.zeros((B, H, W), dtype=I32, device=u.device)
    chosen = torch.zeros_like(tm[..., 0])
    for i in range(6):
        acc = acc + w[i]
        hit = ~chosen & (x < acc)
        at = torch.where(hit, i, at)
        chosen = chosen | hit

    def pick(L):
        n = L.sum(-1, dtype=I32)
        j = torch.minimum((u[..., 1] * n).to(I32), (n - 1).clamp(min=0))
        return kth_legal(L, j)

    mv = pick(m["move"])
    hv = pick(m["harvest"])
    rt = pick(m["ret"])
    pj = pick(m["produce_pair"].reshape(B, H, W, -1))
    ak = pick(m["attack"])
    out = torch.stack([at, mv, hv, rt, pj // T, pj % T, ak], -1)
    return torch.where(m["can_act"][..., None], out, 0).to(I32)


def passive_opponent(env: GridnetEnv) -> Opponent:
    """PassiveAI as an opponent: no draws."""
    return Opponent(passive_bot(env))


# ----------------------------------------------------------------------
# the rush family (K10, with K9's fields inside)

EXPAND_RADIUS = 8   # BasicConfigurableScript.java:46 BASE_RESOURCE_RADIUS
# the decisions of ``rush_bot_plain``, in the order they are taken
RUSH_BRANCHES = ("train_worker", "train_combat", "rebuild_base", "return",
                 "move_home", "harvest", "move_to_resource", "build_barracks",
                 "expand_build", "expand_move", "attack", "move_to_enemy")


@dataclasses.dataclass(frozen=True)
class RushSpec:
    """Behaviour spec of the whole scripted-bot variant family
    (ai/abstraction/*.java); the defaults are plain WorkerRush.  Field
    meanings as in the JAX package (scripted.py:127): ``combat_type``
    Worker | Light | Heavy | Ranged | Mixed (the first affordable of
    Light > Ranged > Heavy); ``n_harvesters`` (-1: every worker
    harvests); ``defense_frac`` (> 0: engage only within ``H *
    defense_frac`` path steps of an enemy or the own base);
    ``rebuild_base``; ``max_workers`` (0: unlimited); ``expand``."""
    combat_type: str = "Worker"
    n_harvesters: int = 1
    defense_frac: float = 0.0
    rebuild_base: bool = False
    max_workers: int = 0
    expand: bool = False


@dataclasses.dataclass(frozen=True)
class RushPlan:
    """A ``RushSpec`` resolved against one env's unit type table: the
    integers the ``rush`` kernel takes, shared with the plain version."""
    iters: int
    need_barracks: int
    mixed: int
    combat_id: int
    n_harvesters: int
    max_workers: int
    rebuild_base: int
    expand: int
    expand_radius: int
    defense: int
    defense_thresh: int
    worker_id: int
    base_id: int
    barracks_id: int
    ladder: Tuple[int, ...]                 # mixed: light, ranged, heavy
    offsets: Tuple[Tuple[int, int], ...]    # attack scan (dx, dy)


def rush_plan(env: GridnetEnv, spec: RushSpec = RushSpec()) -> RushPlan:
    cfg = env.cfg
    R = cfg.engine.max_range
    mixed = spec.combat_type == "Mixed"
    ladder = tuple(t for t in (cfg.light_id, cfg.ranged_id, cfg.heavy_id)
                   if t >= 0) if mixed else ()
    if mixed and not ladder:
        raise ValueError("a Mixed rush needs a Light, Ranged or Heavy type")
    # closest first, stable over the dy-outer, dx-inner order
    # (scripted.py:341-343); the unit's own cell is skipped
    offs = sorted(((dx * dx + dy * dy, dx, dy) for dy in range(-R, R + 1)
                   for dx in range(-R, R + 1)), key=lambda z: z[0])
    return RushPlan(
        iters=env.h + env.w,
        need_barracks=int(spec.combat_type != "Worker"
                          and cfg.barracks_id >= 0),
        mixed=int(mixed),
        combat_id=-1 if mixed else getattr(
            cfg, f"{spec.combat_type.lower()}_id"),
        n_harvesters=spec.n_harvesters, max_workers=spec.max_workers,
        rebuild_base=int(spec.rebuild_base), expand=int(spec.expand),
        expand_radius=EXPAND_RADIUS, defense=int(spec.defense_frac > 0.0),
        defense_thresh=int(env.h * spec.defense_frac),
        worker_id=cfg.worker_id, base_id=cfg.base_id,
        barracks_id=cfg.barracks_id, ladder=ladder,
        offsets=tuple((dx, dy) for d2, dx, dy in offs if d2 > 0))


def rush_bot(env: GridnetEnv, spec: RushSpec = RushSpec()):
    """WorkerRush / LightRush / HeavyRush / RangedRush and the variant
    family (scripted.py:190): base trains workers, a worker builds a
    barracks that trains the combat type, the lowest-uid workers harvest,
    every other combat-capable unit attacks in range or walks down the
    enemy distance field.  On CUDA tensors this is the ``rush`` kernel."""
    plan = rush_plan(env, spec)

    def bot(state: State, player: int, u=None) -> torch.Tensor:
        if env.engine._use_kernel(state.utype):
            return KN.RUSH(env.cfg.engine, plan, state, player)
        return rush_bot_plain(env, plan, state, player)

    bot.plan = plan
    return bot


def rush_opponent(env: GridnetEnv, spec: RushSpec = RushSpec()) -> Opponent:
    """A rush bot as an opponent: deterministic, no draws."""
    return Opponent(rush_bot(env, spec))


def rush_bot_plain(env: GridnetEnv, plan: RushPlan, state: State,
                   player: int, counts: Optional[Dict[str, int]] = None
                   ) -> torch.Tensor:
    """scripted.py:221-358 in PyTorch, batched over the leading axis.
    With ``counts``, each decision adds the number of cells it sets under
    its name (``RUSH_BRANCHES``)."""
    eng = env.engine
    ecfg = env.cfg.engine
    B, H, W = state.utype.shape
    R = ecfg.max_range
    D = 2 * R + 1
    dev = state.utype.device
    cost = ecfg.cost
    me = int(player)
    t = (state.utype.long() - 1).clamp(0, ecfg.num_types - 1)

    def lk(name):
        return eng.lut(name, dev)[t]

    exists = state.utype > 0
    mine = exists & (state.owner == me)
    idle = mine & ~state.busy
    enemy = exists & (state.owner >= 0) & (state.owner != me)
    resource = exists & lk("is_resource")
    my_base = mine & lk("is_stockpile")
    my_barracks = (mine & (t == plan.barracks_id) if plan.need_barracks
                   else torch.zeros_like(mine))
    passable = (state.terrain == 0) & ~exists
    free_n = torch.stack([pull(passable, d, fill=False) for d in range(4)], -1)
    any_free = free_n.any(-1)
    d_enemy = distance_field_plain(enemy, passable, plan.iters)
    d_res = distance_field_plain(resource, passable, plan.iters)
    d_base = distance_field_plain(my_base, passable, plan.iters)
    balance = state.resources[:, 1 if me == 1 else 0][:, None, None]

    def per_env(x):
        return x[:, None, None]

    out = torch.zeros((B, H, W, 7), dtype=torch.int32, device=dev)

    def put(name, mask, atype, **cols):
        if counts is not None:
            counts[name] = counts.get(name, 0) + int(mask.sum())
        _set(out, mask, atype, **cols)

    # base: train workers (capped by max_workers)
    worker = mine & lk("can_harvest")
    train_w = (idle & my_base & (plan.worker_id >= 0)
               & (balance >= cost[max(plan.worker_id, 0)]) & any_free)
    if plan.max_workers > 0:
        train_w &= per_env(worker.sum((1, 2)) < plan.max_workers)
    tdir = first_true(free_n)
    put("train_worker", train_w, PRODUCE, pdir=tdir, ptype=plan.worker_id)

    # barracks: the combat type ("Mixed": the first affordable of the
    # ladder, else its last entry)
    if plan.need_barracks:
        if plan.mixed:
            ctype = torch.full_like(balance, plan.ladder[-1])
            can_aff = torch.zeros_like(balance, dtype=torch.bool)
            for tid in reversed(plan.ladder):
                ok = balance >= cost[tid]
                ctype = torch.where(ok, tid, ctype)
                can_aff = can_aff | ok
            train_c = idle & my_barracks & can_aff & any_free
        else:
            ctype = plan.combat_id
            train_c = (idle & my_barracks
                       & (balance >= cost[max(plan.combat_id, 0)]) & any_free)
        put("train_combat", train_c, PRODUCE, pdir=tdir, ptype=ctype)

    # base rebuild: the oldest worker rebuilds a lost base
    harv_rank = _rank_by_uid(worker, state.uid)
    build_base = torch.zeros_like(worker)
    if plan.rebuild_base and plan.base_id >= 0:
        base_pend = (per_env(~my_base.any(-1).any(-1))
                     & (balance >= cost[plan.base_id]))
        build_base = idle & worker & (harv_rank == 0) & base_pend & any_free
        put("rebuild_base", build_base, PRODUCE, pdir=tdir, ptype=plan.base_id)

    # harvesters: the lowest-uid workers run the harvest loop
    all_harvest = plan.n_harvesters < 0
    is_harv = worker if all_harvest else worker & (
        harv_rank < plan.n_harvesters)
    hu = idle & is_harv & ~build_base
    adj_res = torch.stack([pull(resource, d, fill=False) for d in range(4)],
                          -1)
    adj_base = torch.stack([pull(my_base, d, fill=False) for d in range(4)],
                           -1)
    carrying = state.carried > 0
    put("return", hu & carrying & adj_base.any(-1), RETURN,
        rdir=first_true(adj_base))
    mdir_b = descend_direction_plain(d_base, free_n)
    put("move_home", hu & carrying & ~adj_base.any(-1) & (mdir_b >= 0),
        MOVE, mdir=mdir_b)
    put("harvest", hu & ~carrying & adj_res.any(-1), HARVEST,
        hdir=first_true(adj_res))
    mdir_r = descend_direction_plain(d_res, free_n)
    put("move_to_resource", hu & ~carrying & ~adj_res.any(-1)
        & (mdir_r >= 0), MOVE, mdir=mdir_r)

    # builder: the first idle worker after the harvesters builds a
    # barracks (when every worker harvests, the oldest one)
    special_rank = 0 if all_harvest else plan.n_harvesters
    if plan.need_barracks:
        build = (idle & worker & (harv_rank == special_rank)
                 & per_env(~my_barracks.any(-1).any(-1))
                 & (balance >= cost[max(plan.barracks_id, 0)]) & any_free)
        put("build_barracks", build, PRODUCE, pdir=tdir, ptype=plan.barracks_id)
        fighter_min_rank = plan.n_harvesters + 1
    else:
        fighter_min_rank = plan.n_harvesters
    if all_harvest:
        fighter_min_rank = 1 << 30   # harvesting workers never fight

    # expansion: a second base next to the nearest resource far from the
    # own bases, once a barracks stands and at most one base is owned
    if plan.expand and plan.base_id >= 0:
        far_res = resource & (d_base > plan.expand_radius)
        d_far = distance_field_plain(far_res, passable, plan.iters)
        want = per_env(my_barracks.any(-1).any(-1)
                       & (my_base.sum((1, 2)) <= 1)
                       & far_res.any(-1).any(-1)) \
            & (balance >= cost[plan.base_id])
        expander = (idle & worker & (harv_rank == special_rank) & want
                    & ~build_base)
        adj_far = torch.stack([pull(far_res, d, fill=False)
                               for d in range(4)], -1)
        exp_build = expander & adj_far.any(-1) & any_free
        put("expand_build", exp_build, PRODUCE, pdir=tdir, ptype=plan.base_id)
        mdir_x = descend_direction_plain(d_far, free_n)
        put("expand_move", expander & ~exp_build & (mdir_x >= 0), MOVE,
            mdir=mdir_x)

    # fighters: attack in range, else move toward the nearest enemy
    fighter = (idle & mine & lk("can_attack")
               & (~worker | (harv_rank >= fighter_min_rank)))
    if plan.defense:
        # a unit's own cell is occupied: its distance is 1 + the least of
        # its neighbours'
        d_en_here = torch.stack([pull(d_enemy, d, fill=INF)
                                 for d in range(4)]).min(0).values + 1
        d_ba_here = torch.stack([pull(d_base, d, fill=INF)
                                 for d in range(4)]).min(0).values + 1
        fighter &= ((d_en_here < plan.defense_thresh)
                    | (d_ba_here < plan.defense_thresh))
    rng = lk("attack_range")
    best = torch.zeros((B, H, W), dtype=torch.int32, device=dev)
    found = torch.zeros_like(enemy)
    for dx, dy in plan.offsets:
        e_at = shift(enemy, -dx, -dy, fill=False) & (dx * dx + dy * dy
                                                     <= rng * rng)
        best = torch.where(~found & e_at, (R + dy) * D + (R + dx), best)
        found = found | e_at
    put("attack", fighter & found, ATTACK, rel=best)
    mdir_e = descend_direction_plain(d_enemy, free_n)
    put("move_to_enemy", fighter & ~found & (mdir_e >= 0), MOVE,
        mdir=mdir_e)
    return out


def first_true(b: torch.Tensor) -> torch.Tensor:
    """``argmax`` of a bool stack over its last axis: the first True, 0
    when none."""
    return b.to(torch.uint8).argmax(-1).to(I32)


def _rank_by_uid(mask: torch.Tensor, uid: torch.Tensor) -> torch.Tensor:
    """Rank of each masked cell by ascending unit id (0 = oldest unit),
    per env."""
    B = mask.shape[0]
    key = torch.where(mask, uid, 1 << 30).reshape(B, -1)
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(key.shape[1], device=key.device)
                  .expand_as(order).contiguous())
    return rank.reshape(mask.shape).to(I32)


_COLS = dict(mdir=1, hdir=2, rdir=3, pdir=4, ptype=5, rel=6)


def _set(out: torch.Tensor, mask: torch.Tensor, atype: int, **cols) -> None:
    """Where ``mask``: the action type and the given columns (in place;
    the other columns keep what an earlier decision wrote)."""
    out[..., 0] = torch.where(mask, atype, out[..., 0])
    for name, val in cols.items():
        c = _COLS[name]
        out[..., c] = torch.where(mask, val, out[..., c])


def worker_rush(env):  # WorkerRush.java
    return rush_bot(env, RushSpec("Worker"))


def light_rush(env):   # LightRush.java
    return rush_bot(env, RushSpec("Light"))


def heavy_rush(env):   # HeavyRush.java
    return rush_bot(env, RushSpec("Heavy"))


def ranged_rush(env):  # RangedRush.java
    return rush_bot(env, RushSpec("Ranged"))


# the defense family (ai/abstraction/{Worker,Light,Heavy,Ranged}Defense
# .java): rush behaviour with the H/2 engage standoff
def worker_defense(env):
    return rush_bot(env, RushSpec("Worker", defense_frac=0.5))


def light_defense(env):
    return rush_bot(env, RushSpec("Light", defense_frac=0.5))


def heavy_defense(env):
    return rush_bot(env, RushSpec("Heavy", defense_frac=0.5))


def ranged_defense(env):
    return rush_bot(env, RushSpec("Ranged", defense_frac=0.5))


# the economy family (see the JAX package's docstrings for each Java
# source; EMRDeterministico coincides with EconomyMilitaryRush, and
# EconomyRushBurster's uniform military pick is the affordability ladder)
ECONOMY = RushSpec("Mixed", n_harvesters=-1, max_workers=4,
                   rebuild_base=True)


def worker_rush_plus_plus(env):   # WorkerRushPlusPlus.java
    return rush_bot(env, RushSpec("Worker", rebuild_base=True))


def economy_rush(env):            # EconomyRush.java:48-60
    return rush_bot(env, ECONOMY)


def economy_military_rush(env):   # EconomyMilitaryRush.java
    return rush_bot(env, ECONOMY)


def emr_deterministico(env):      # EMRDeterministico.java:153-160
    return rush_bot(env, ECONOMY)


def economy_rush_burster(env):    # EconomyRushBurster.java
    return rush_bot(env, dataclasses.replace(ECONOMY, max_workers=6))


def simple_economy_rush(env):     # SimpleEconomyRush.java:145
    return rush_bot(env, dataclasses.replace(ECONOMY, max_workers=3))


def crush_v1(env):                # CRush_V1.java:383-415
    return rush_bot(env, RushSpec("Ranged", n_harvesters=-1, max_workers=5,
                                  rebuild_base=True))


def crush_v2(env):                # CRush_V2.java:154
    return rush_bot(env, RushSpec("Ranged", n_harvesters=2,
                                  rebuild_base=True))


def po_wrap(env: GridnetEnv, bot):
    """Partial-observability wrapper (scripted.py:481): the bot sees only
    its fog-of-war view (ai/abstraction/partialobservability/PO*Rush.java:
    the same policy on the PartiallyObservableGameState).  On CUDA tensors
    the view is the ``po_state`` kernel."""
    def wrapped(state: State, player, u=None) -> torch.Tensor:
        return bot(env.po_view(state, player), player, u)

    return wrapped


def po_worker_rush(env):   # POWorkerRush.java
    return po_wrap(env, worker_rush(env))


def po_light_rush(env):    # POLightRush.java
    return po_wrap(env, light_rush(env))


def po_heavy_rush(env):    # POHeavyRush.java
    return po_wrap(env, heavy_rush(env))


def po_ranged_rush(env):   # PORangedRush.java
    return po_wrap(env, ranged_rush(env))
