"""Helpers of the believe-state parity tests: WorkerRush (player 0)
against LightRush (player 1) on basesWorkers8x8 or basesWorkersBarracks8x8,
whose starts hide each side's units (and barracks) from the other, 8 envs
that open with 4k random ticks each
(the port's plain path); JAX's ``believe_state_bot`` ``init`` and
``step`` vmapped and jitted with an inner bot that returns the sampled
world it is handed; the comparison of whole memories.

Both observers' memories are made at tick 120 and updated at every tick
to tick 231.  Lanes 8-15 are the same games with the memory's seen types
cleared after ``init``, so that first sightings infer producers (the
rushes never do here: a base's sight covers the other side's barracks
when it is built) and the real producers' later sightings drop them."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import believestate as JB
from microrts_tpu_torch.bots import believestate as BS
from microrts_tpu_torch.bots import scripted as S
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State

from torch_parity import BIAS, assert_eq, assert_state_eq, envs, jax_state

MAP = "maps/8x8/basesWorkers8x8.xml"
BARRACKS_MAP = "maps/8x8/basesWorkersBarracks8x8.xml"
GAMES = 8
START, END = 120, 232      # memories made at START, updated to END - 1
RULES = {1: ("forgotten",),
         2: ("remembered", "moved_to_fog", "forgotten_by_uid", "forgotten"),
         3: ("remembered", "moved_to_fog", "forgotten_by_uid", "inferred",
             "relocated", "dropped")}


@functools.lru_cache(maxsize=None)
def trajectory(map_rel=MAP):
    """(JAX env, port env, the port's plain states at ticks START..END-1
    of 2 x GAMES lanes: the games twice) on ``map_rel``."""
    jenv, env = envs(map_rel)
    p0, p1 = S.worker_rush(env), S.light_rush(env)
    rnd = S.random_bot(env, BIAS)
    rng = np.random.default_rng(8)
    s = env.reset(GAMES)
    early = (torch.arange(GAMES) * 4)[:, None, None, None]
    out = []
    for t in range(END):
        if t >= START:
            out.append(State(**{f: torch.cat([getattr(s, f)] * 2)
                                for f in FIELD_DTYPES}))
        u = [torch.from_numpy(rng.random((GAMES, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        a0 = torch.where(t < early, rnd(s, 0, u[0]), p0(s, 0))
        a1 = torch.where(t < early, rnd(s, 1, u[1]), p1(s, 1))
        s, _, _ = env.step(s, a0, a1)
    return jenv, env, out


@functools.lru_cache(maxsize=None)
def _jax_fns(jenv, level):
    sb = JB.believe_state_bot(jenv, lambda w, p, k: w, level=level)
    init = jax.jit(jax.vmap(sb.init))
    step = jax.jit(jax.vmap(lambda s, m, p: sb.step(s, m, p,
                                                    jax.random.PRNGKey(0))))
    return init, step


def jax_bot(jenv, level, player):
    """JAX's ``init(states)`` and ``step(states, mem)`` (returning the
    sampled world) of a believe-state bot for observer ``player``, vmapped
    over lanes and jitted (the player traced: one compile for both)."""
    init, step = _jax_fns(jenv, level)

    def players(js):
        return jnp.full(js.utype.shape[0], player, jnp.int32)
    return (lambda js: init(js, players(js)),
            lambda js, m: step(js, m, players(js)))


def identity_bot(level, env):
    return BS.believe_state_bot(env, S.Opponent(lambda w, p, n: w),
                                level=level)


def assert_mem_eq(jm, m, where):
    assert_eq(np.asarray(jm.b_utype), m.b_utype.numpy(), f"{where}: b_utype")
    assert_eq(np.asarray(jm.b_hp), m.b_hp.numpy(), f"{where}: b_hp")
    assert_eq(np.asarray(jm.b_uid), m.b_uid.numpy(), f"{where}: b_uid")
    assert_eq(np.asarray(jm.seen_type), m.seen_type.numpy(),
              f"{where}: seen_type")
    assert_eq(np.asarray(jm.prev_vis), m.prev_vis.numpy(),
              f"{where}: prev_vis")
    assert_state_eq(jm.prev, m.prev, f"{where}: prev")


def _clear_seen(jm, m):
    half = torch.arange(2 * GAMES) >= GAMES
    m.seen_type[half] = False
    seen = jnp.where(jnp.asarray(half.numpy())[:, None], False, jm.seen_type)
    return jm._replace(seen_type=seen), m


def check_level(level, map_rel=MAP):
    """Memories and worlds of ``level`` equal to JAX's at every tick, for
    both observers, on ``map_rel``; every rule of the level fired."""
    jenv, env, states = trajectory(map_rel)
    bot = identity_bot(level, env)
    counts = dict.fromkeys(BS.RULES, 0)
    for player in (0, 1):
        jinit, jstep = jax_bot(jenv, level, player)
        js = jax_state(states[0])
        jm, m = _clear_seen(jinit(js), bot.init(states[0], player))
        assert_mem_eq(jm, m, f"level {level} p{player} init")
        for t, s in enumerate(states):
            jworld, jm = jstep(jax_state(s), jm)
            m, world = bot.update(s, m, player, counts)
            where = f"level {level} p{player} tick {START + t}"
            assert_mem_eq(jm, m, where)
            assert_state_eq(jworld, world, f"{where}: world")
    print(f"{map_rel} level {level}: rules fired {counts}")
    for rule in RULES[level]:
        assert counts[rule] > 0, (rule, counts)


