"""The odometer enumerator (ops/enumerate.py) and the branching factor
(ops/branching.py) of the port's plain path against the JAX package's:
the same SEQUENCE of joint actions (arms and valid flags, exhaustion
included) on recorded states of melee4x4light2 and basesWorkers8x8 at
several ticks for both players, and the first 16 draws on 16x16; the
same SET as tests/test_enumerate.py's refimpl oracle (the Java
PlayerActionGenerator semantics); the empty joint action where no unit
can act; the draws of inactive lanes untouched.  Tolerance: exact."""

import functools
import random

import numpy as np
import pytest
import jax
import torch

from microrts_tpu import refimpl
from microrts_tpu.engine.pgs import PhysicalGameState
from microrts_tpu.engine.types import state_from_pgs
from microrts_tpu.engine.utt import UnitTypeTable
from microrts_tpu.interop.bridge import candidates_from_actions
from microrts_tpu.interop.fuzz import actions_to_pairs
from microrts_tpu.ops import branching as JB
from microrts_tpu.ops.enumerate import enumerate_joint_actions as jax_enum
from microrts_tpu.utils.assets import asset_path as jax_asset_path
from microrts_tpu_torch.engine.types import state_from_numpy
from microrts_tpu_torch.ops import branching as BR
from microrts_tpu_torch.ops import enumerate as EN

from test_enumerate import _oracle_joint_actions
from torch_parity import (assert_eq, envs, jax_state, leaves, port_trajectory,
                          torch_one_thread)  # noqa: F401 (a fixture)
from torch_playout_parity import cat, remove_player

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAPS = ("maps/melee4x4light2.xml", "maps/8x8/basesWorkers8x8.xml")
TICKS = (0, 6, 14, 30)
K = 64   # more than either small map's joint actions: exhaustion shows


@functools.lru_cache(maxsize=None)
def _states(map_rel):
    """(JAX env, port env, recorded states: 3 lanes at each of TICKS,
    player 1's units removed in the last lane of every tick)."""
    jenv, env = envs(map_rel)
    rec = port_trajectory(env, 3, max(TICKS) + 1, 7, set(TICKS))
    return jenv, env, {t: remove_player(s, [2], 1) for t, s in rec.items()}


@functools.lru_cache(maxsize=None)
def _jax_enum(jenv, player, n):
    return jax.jit(jax.vmap(lambda s: jax_enum(jenv, s, player, n)))


@pytest.mark.parametrize("player", [0, 1])
@pytest.mark.parametrize("tick", TICKS)
@pytest.mark.parametrize("map_rel", MAPS)
def test_enumeration_sequence_matches_jax(map_rel, tick, player):
    jenv, env, states = _states(map_rel)
    s = states[tick]
    ja, jv = _jax_enum(jenv, player, K)(jax_state(s))
    arms, valid = EN.enumerate_joint_actions(env, s, player, K)
    assert_eq(ja, arms, f"{map_rel} t{tick} p{player} arms")
    assert_eq(jv, valid, f"{map_rel} t{tick} p{player} valid")
    n = valid.sum(1)
    assert (n > 0).all() and (n < K).all(), n   # exhausted in K draws
    if player == 1:   # no own unit in lane 2: the empty action, once
        assert bool(valid[2, 0]) and not bool(valid[2, 1:].any())
        assert bool((arms[2, 0] == -1).all())


def test_enumeration_16x16_first_draws_match_jax():
    jenv, env = envs("maps/16x16/basesWorkers16x16.xml")
    rec = port_trajectory(env, 4, 41, 3, {0, 40})
    s = cat([rec[0], rec[40]])
    for player in (0, 1):
        ja, jv = _jax_enum(jenv, player, 16)(jax_state(s))
        arms, valid = EN.enumerate_joint_actions(env, s, player, 16)
        assert_eq(ja, arms, f"16x16 p{player} arms")
        assert_eq(jv, valid, f"16x16 p{player} valid")
        assert bool(valid.all(1).any())   # a lane with 16 or more


def test_inactive_lanes_and_rows_untouched():
    """``next_action`` on row ``row[b]`` of a 3-row table advances only
    the active lanes' rows: the others keep their odometers, and their
    draws are -1 / invalid."""
    _, env, states = _states(MAPS[1])
    s = states[6]
    init, nxt = EN.make_enumerator(env)
    od1, ctx1 = init(s, 0)
    od = EN.Odometer(od1.choice.repeat(1, 3, 1), od1.more.repeat(1, 3))
    ctx = EN.EnumCtx(*[t.repeat((1, 3) + (1,) * (t.dim() - 2))
                       for t in ctx1])
    row = torch.tensor([2, 0, 1], dtype=torch.int32)
    act = torch.tensor([True, False, True])
    want = [nxt(od1, ctx1)[:2] for _ in range(3)]
    before = od.choice.clone()
    for k in range(3):
        arms, valid, trips = nxt(od, ctx, row, act)
        for b in range(3):
            if act[b]:
                assert torch.equal(arms[b], want[k][0][b])
                assert bool(valid[b]) == bool(want[k][1][b])
            else:
                assert bool((arms[b] == -1).all()) and not bool(valid[b])
                assert int(trips[b]) == 0
    for b in range(3):
        for r in range(3):
            if act[b] and r == int(row[b]):   # walked as the one-row table
                assert torch.equal(od.choice[b, r], od1.choice[b, 0])
                assert bool(od.more[b, r]) == bool(od1.more[b, 0])
            else:
                assert torch.equal(od.choice[b, r], before[b, r]), (b, r)
                assert bool(od.more[b, r]), (b, r)


@pytest.mark.parametrize("map_rel", MAPS)
def test_branching_factor_matches_jax(map_rel):
    jenv, env, states = _states(map_rel)
    for tick in TICKS:
        s = states[tick]
        js = jax_state(s)
        for player in (0, 1):
            got = BR.branching_factor(env, s, player)
            counts = BR.per_unit_action_counts(env, s, player)
            for b in range(s.batch):
                jb = jax.tree.map(lambda x: x[b], js)
                assert_eq(JB.per_unit_action_counts(jenv, jb, player),
                          counts[b], f"{map_rel} t{tick} counts")
                assert got[b] == JB.branching_factor(jenv, jb, player)


@pytest.mark.parametrize("map_rel,ticks", [
    ("maps/melee4x4light2.xml", 12),
    ("maps/8x8/basesWorkers8x8.xml", 16),
])
def test_enumeration_matches_oracle_set(map_rel, ticks):
    """tests/test_enumerate.py's lockstep walk (refimpl GameState and the
    JAX engine, random legal actions): at every tick, for both players,
    the port's enumeration of the same state (converted) is the oracle's
    set of consistent joint actions."""
    jenv, env = envs(map_rel)
    utt = UnitTypeTable(2)
    pgs = PhysicalGameState.load(jax_asset_path(map_rel), utt)
    gs = refimpl.GameState(pgs.clone(), utt)
    state = state_from_pgs(pgs.clone(), jenv.cfg.engine)
    issue_j = jax.jit(jenv.engine.issue)
    cycle_j = jax.jit(jenv.engine.cycle)
    rng = random.Random(7)
    W = env.w
    compared = 0
    for _ in range(ticks):
        ps = state_from_numpy(leaves(state))
        for player in (0, 1):
            oracle = _oracle_joint_actions(gs, player, jenv)
            if oracle is None:
                continue
            n = max(len(oracle) + 8, 16)
            arms, valid = EN.enumerate_joint_actions(env, ps, player, n)
            arms, valid = arms[0].reshape(n, -1).numpy(), valid[0].numpy()
            got = {frozenset((int(c), int(a[c]))
                             for c in np.nonzero(a >= 0)[0])
                   for a, v in zip(arms, valid) if v}
            assert got == oracle, (gs.time, player, len(got), len(oracle))
            assert int(valid.sum()) == len(oracle)   # no repeats
            compared += 1
        actions = []
        for player in (0, 1):
            used, spent = set(), 0
            for a in gs.unit_actions.values():
                pos, res = refimpl.resource_usage(a.action, a.unit, gs.pgs,
                                                  utt)
                used.update(pos)
                spent += res[player]
            budget = gs.pgs.players[player].resources
            for u in list(gs.pgs.units):
                if u.player != player or gs.get_assignment(u) is not None:
                    continue
                choices = list(gs.get_unit_actions(u, 1))
                rng.shuffle(choices)
                for ua in choices:
                    pos, res = refimpl.resource_usage(ua, u, gs.pgs, utt)
                    if any(p in used for p in pos) \
                            or spent + res[player] > budget:
                        continue
                    used.update(pos)
                    spent += res[player]
                    actions.append(((u.x, u.y), ua))
                    break
        gs.issue_safe(actions_to_pairs(gs, actions))
        state = issue_j(state, candidates_from_actions(actions, env.h, W))
        gs.cycle()
        state, _ = cycle_j(state)
        if gs.gameover():
            break
    assert compared >= 4
