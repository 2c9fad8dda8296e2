"""Program synthesis: search the DSL grammar for strong scripts.

A port of ``microrts_tpu.synth.search`` (ai/synthesis/grammar + runners):
candidate programs are sampled and mutated with ``random.Random`` exactly
as the JAX package does (the same programs for the same seed), and a
GENERATION is evaluated as one batch of lockstep games: every (program,
opponent, side, repeat) lane steps together, each program acting on its
own lanes and each opponent on its own (``eval.tournament._groups``),
with finished lanes frozen.  Fitness is the mean outcome (win 1, draw ½).

Search = (1+λ) hill-climbing over the grammar with structural mutations
(replace, insert, delete, swap a command).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bots.scripted import Opponent
from ..engine.types import State
from ..env.gridnet import GridnetEnv
from ..eval.tournament import _groups, act_grouped
from .dsl import (AllyInEnemyRange, Attack, Build, Cluster, Cond,
                  DistanceFromEnemy, EnemyInRange, EnemyInUnitsRange,
                  Harvest, Idle, If, IsPlayerInPosition, MoveAway,
                  MoveToCoord, MoveToUnit, NAllyAttacking,
                  NAllyHarvesting, NAllyOfType, NEnemyOfType, Program,
                  Train, UnitsStrongest, program_opponent)

UNIT_TYPES = ("Worker", "Light", "Heavy", "Ranged")
TARGETS = ("Closest", "Farthest", "Weakest", "LessHealthy", "Strongest",
           "MostHealthy", "Random")
OPS = (">=", "<=", ">")


def random_command(rng: random.Random, depth: int = 0, hw=(8, 8)):
    kinds = ["train", "build", "harvest", "attack", "moveaway", "idle",
             "movecoord", "moveunit", "cluster"]
    if depth == 0:
        kinds += ["if"] * 3
    k = rng.choice(kinds)
    if k == "train":
        unit = rng.choice(UNIT_TYPES)
        prod = "Base" if unit == "Worker" else "Barracks"
        return Train(prod, unit, rng.randint(1, 20))
    if k == "build":
        return Build("Barracks", rng.randint(1, 2))
    if k == "harvest":
        return Harvest(rng.randint(1, 3))
    if k == "attack":
        return Attack(rng.choice(("All",) + UNIT_TYPES),
                      rng.choice(TARGETS))
    if k == "moveaway":
        return MoveAway(rng.choice(("All",) + UNIT_TYPES))
    if k == "idle":
        return Idle(rng.choice(("All",) + UNIT_TYPES))
    if k == "movecoord":
        return MoveToCoord(rng.randrange(hw[1]), rng.randrange(hw[0]),
                           rng.choice(("All",) + UNIT_TYPES))
    if k == "moveunit":
        return MoveToUnit(rng.choice(("All",) + UNIT_TYPES),
                          rng.choice(TARGETS),
                          rng.choice(("Enemy", "Ally")))
    if k == "cluster":
        return Cluster(rng.choice(("All",) + UNIT_TYPES))
    cond = random_cond(rng)
    body = tuple(random_command(rng, depth + 1, hw)
                 for _ in range(rng.randint(1, 2)))
    return If(cond, body)


def random_cond(rng: random.Random) -> Cond:
    draws = (
        lambda: NAllyOfType(rng.choice(UNIT_TYPES), rng.randint(1, 6),
                            rng.choice(OPS)),
        lambda: NEnemyOfType(rng.choice(UNIT_TYPES), rng.randint(1, 6),
                             rng.choice(OPS)),
        lambda: NAllyAttacking(rng.randint(1, 4), rng.choice(OPS)),
        lambda: NAllyHarvesting(rng.randint(1, 3), rng.choice(OPS)),
        lambda: EnemyInRange(rng.randint(2, 10)),
        lambda: AllyInEnemyRange(),
        lambda: EnemyInUnitsRange(),
        lambda: DistanceFromEnemy(rng.randint(2, 12),
                                  rng.choice(("<=", ">"))),
        lambda: UnitsStrongest(rng.choice(("Ally", "Enemy"))),
        lambda: IsPlayerInPosition(rng.randrange(4)),
    )
    return rng.choice(draws)()


def random_program(rng: random.Random, n_cmds: int = 4) -> Program:
    prog = tuple(random_command(rng) for _ in range(n_cmds))
    # always end with a default attack so no unit pool deadlocks
    return prog + (Attack("All", "Closest"),)


def mutate(prog: Program, rng: random.Random) -> Program:
    cmds = list(prog)
    op = rng.choice(["replace", "insert", "delete", "swap"])
    if op == "replace" or not cmds:
        i = rng.randrange(len(cmds)) if cmds else 0
        cmds[i:i + 1] = [random_command(rng)]
    elif op == "insert" and len(cmds) < 8:
        cmds.insert(rng.randrange(len(cmds) + 1), random_command(rng))
    elif op == "delete" and len(cmds) > 2:
        del cmds[rng.randrange(len(cmds) - 1)]   # keep the tail attack
    elif op == "swap" and len(cmds) > 2:
        i, j = rng.sample(range(len(cmds) - 1), 2)
        cmds[i], cmds[j] = cmds[j], cmds[i]
    return tuple(cmds)


DONE_CHECK = 16   # ticks between the host's all-done checks


def _check_opponents(opponents) -> None:
    for o in opponents:
        if not isinstance(o, Opponent):
            raise TypeError(f"opponents must be bots.scripted.Opponent "
                            f"(stateless bots), got {type(o).__name__}")


def act_groups(env: GridnetEnv, bots: Sequence[Opponent], s: State,
               which: torch.Tensor, players: torch.Tensor,
               gen: torch.Generator) -> torch.Tensor:
    """Actions int32 ``[L, H, W, 7]`` of lane ``l`` by ``bots[which[l]]``
    for player ``players[l]``: each (bot, player) group acts on its own
    lanes with noise drawn from ``gen``; groups without lanes are
    skipped."""
    def call(k, sb, lanes):
        bot = bots[k // 2]
        return bot(sb, k % 2, bot.draw(gen, sb.batch))
    return act_grouped(env, s, _groups(which * 2 + players, 2 * len(bots)),
                       call)


def play_lanes(env: GridnetEnv, prog_bots: Sequence[Opponent],
               opponents: Sequence[Opponent], pis, ois, sides,
               max_cycles: int, gen: torch.Generator,
               on_tick=None, start=None):
    """Lockstep games: lane ``l`` is program ``pis[l]`` on seat
    ``sides[l]`` against opponent ``ois[l]``; ``max_cycles`` steps, lanes
    frozen once done (search.py:101-114).  ``on_tick(tick, state)`` sees
    the state before each step.  ``start`` = (state, done, winner) goes on
    from there instead of from a reset.  Returns (winner int32 [L], the
    final state, the done flags)."""
    dev = env.device
    L = len(pis)
    pis = torch.as_tensor(pis, dtype=torch.long, device=dev)
    ois = torch.as_tensor(ois, dtype=torch.long, device=dev)
    sides = torch.as_tensor(sides, dtype=torch.long, device=dev)
    if start is None:
        s = env.reset(L)
        done = torch.zeros(L, dtype=torch.bool, device=dev)
        winner = torch.full((L,), -1, dtype=torch.int32, device=dev)
    else:
        s, done, winner = start
    seat0 = (sides == 0)[:, None, None, None]
    for tick in range(max_cycles):
        if on_tick is not None:
            on_tick(tick, s)
        elif tick % DONE_CHECK == 0 and bool(done.all()):
            break
        ac = act_groups(env, prog_bots, s, pis, sides, gen)
        ao = act_groups(env, opponents, s, ois, 1 - sides, gen)
        a0 = torch.where(seat0, ac, ao)
        a1 = torch.where(seat0, ao, ac)
        s2, _, d2 = env.step(s, a0, a1, gen=gen)
        s = s2.select(done, s)
        winner = torch.where(done, winner,
                             torch.where(d2, env.engine.winner(s2), -1))
        done = done | d2
    return winner, s, done


def evaluate_population(env: GridnetEnv, programs: Sequence[Program],
                        opponents: Sequence[Opponent],
                        games_per_pair: int = 2, max_cycles: int = 1200,
                        seed: int = 0, out: Optional[dict] = None,
                        on_tick=None) -> np.ndarray:
    """Fitness per program: one batched run over every (program,
    opponent, side, repeat) lane (the DSL_RunBattle analog).  Returns
    float64 ``[len(programs)]`` mean scores in [0, 1].  The draws of
    stochastic bots and of the engine come from a generator seeded with
    ``seed`` on the env's device.  ``out`` (a dict) receives the lanes'
    ``winner`` (int32 ``[L]``), final ``state`` and ``done`` flags and the
    lanes' ``bots``, ``pis``, ``ois`` and ``sides`` (``play_lanes``'s
    arguments, to go on from there).  ``on_tick``: see ``play_lanes``
    (the run then takes all ``max_cycles`` ticks)."""
    _check_opponents(opponents)
    bots = [program_opponent(env, p) for p in programs]
    P, O = len(bots), len(opponents)
    lanes = [(pi, oi, side, g)
             for pi in range(P) for oi in range(O)
             for side in (0, 1) for g in range(games_per_pair)]
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    pis, ois = [l[0] for l in lanes], [l[1] for l in lanes]
    sides = [l[2] for l in lanes]
    winner, final, done = play_lanes(env, bots, opponents, pis, ois, sides,
                                     max_cycles, gen, on_tick)
    if out is not None:
        out.update(winner=winner, state=final, done=done, bots=bots,
                   pis=pis, ois=ois, sides=sides)
    sides = np.asarray(sides)
    w = winner.cpu().numpy()
    scores = np.where(w == sides, 1.0, np.where(w == 1 - sides, 0.0, 0.5))
    fit = np.zeros(P)
    for l, sc in zip(lanes, scores):
        fit[l[0]] += sc
    return fit / (O * 2 * games_per_pair)


@dataclasses.dataclass
class SynthesisResult:
    program: Program
    fitness: float
    history: List[Tuple[int, float]]


def synthesize(env: GridnetEnv, opponents: Sequence[Opponent],
               generations: int = 8, population: int = 4,
               games_per_pair: int = 2, max_cycles: int = 1200,
               seed: int = 0,
               seed_program: Optional[Program] = None) -> SynthesisResult:
    """(1+λ) hill-climbing: each generation evaluates the incumbent plus
    ``population-1`` mutations in one batched run and keeps the best
    (search.py:175-198)."""
    rng = random.Random(seed)
    from .dsl import SEED_PROGRAM
    best = seed_program or SEED_PROGRAM
    best_f = -1.0
    history: List[Tuple[int, float]] = []
    for g in range(generations):
        cands = [best] + [mutate(best, rng)
                          for _ in range(population - 1)]
        fits = evaluate_population(env, cands, opponents,
                                   games_per_pair, max_cycles,
                                   seed=seed + g)
        i = int(np.argmax(fits))
        if fits[i] >= best_f:
            best, best_f = cands[i], float(fits[i])
        history.append((g, best_f))
    return SynthesisResult(best, best_f, history)
