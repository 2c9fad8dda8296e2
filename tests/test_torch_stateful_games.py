"""The stateful game loop (``bots/believestate.py``
``play_matches_stateful``, plain path on the CPU) against the JAX
package's (believestate.py:348-408, followed line by line: the
fast-forward to the next decision frame, both stateful bots stepped, the
env's step, the finished lanes frozen), on JAX's draws, 4 games on
basesWorkers8x8 from the start to 3 cycles: BS3_NaiveMCTS (the
believe-state memory around NaiveMCTS at JAX's small budget with 2
playouts) against POWorkerRush, and ContinuingNaiveMCTS at the same
budget against WorkerRush.  Winners, frames, final states and the
stateful bots' final memories are equal in every game where no float
argmax of the port came within 1e-6 of its runner-up
(tests/torch_treesearch_parity.py; the margins are printed).  JAX runs
its bots eagerly under ``vmap`` around their jitted parts
(tests/torch_stateful_parity.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import treesearch as JTS
from microrts_tpu.config import make_bot as jax_make_bot
from microrts_tpu_torch.bots import believestate as BS
from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State

from torch_believe_parity import assert_mem_eq, jax_bot
from torch_parity import assert_eq, assert_state_eq, torch_one_thread  # noqa
from torch_stateful_parity import eager_continuing, jax_env_step
from torch_tournament_parity import _pieces
from torch_treesearch_parity import (TINY, _jax_eval, _jit, _jitted_parts,
                                     _lax_loops,
                                     assert_tree_eq, eager_tree_loops,
                                     held_games, naive_noise,
                                     recording_margins, tree_envs)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GAME = dict(TINY, n_playouts=2)
N_GAMES = 4
MAX_CYCLES = 3


def _jax_games(jenv, init0, step0, opp_name, seed):
    """JAX's stateful loop of player 0's stateful bot (``init0(states)``,
    ``step0(states, mem, keys) -> (actions, mem)``, over the lanes)
    against the stateless ``opp_name``, checking every frame that every
    lane is done (the loop's ``chunk`` 1): (winners, final states, bot 0's
    final memory, each frame's player-0 keys)."""
    f = _pieces(jenv, MAX_CYCLES)
    opp = _jit(jax.vmap(jax_make_bot(opp_name, jenv), in_axes=(0, None, 0)))
    env_step = jax_env_step(jenv)
    keys = jax.random.split(jax.random.PRNGKey(seed), N_GAMES)
    s = jax.vmap(jenv.reset)(keys)
    m0 = init0(s)
    done = jnp.zeros(N_GAMES, bool)
    winner = jnp.full(N_GAMES, -1, jnp.int32)
    frame_keys = []
    for _ in range(MAX_CYCLES):
        s, d_ff = f["ff"](s, done)
        s, d_ff = f["ff"](s, d_ff)
        winner = jnp.where(done, winner, jnp.where(d_ff, f["winner"](s), -1))
        done = done | d_ff | (s.time >= MAX_CYCLES)
        ks = f["split3"](keys)
        keys, k0, k1 = ks[:, 0], ks[:, 1], ks[:, 2]
        frame_keys.append(k0)
        a0, m0n = step0(s, m0, k0)
        a1 = opp(s, 1, k1)
        s2, done2 = env_step(s, a0, a1)
        s = f["freeze"](done, s, s2)
        m0 = f["freeze"](done, m0, m0n)
        winner = jnp.where(done, winner, jnp.where(done2, f["winner"](s2),
                                                   -1))
        done = done | done2
        if bool(done.all()):
            break
    return np.asarray(winner), s, m0, frame_keys


def _port_games(env, bot0, opp_name, frame_keys, monkeypatch):
    """The port's loop on JAX's draws: (winners, final states, frames,
    bot 0's final memory, the games held by the float margins)."""
    memory = []
    real = bot0.step

    def step(s, m, p, nz, live=None):
        a, m2 = real(s, m, p, nz, live)
        memory[:] = [m2]
        return a, m2
    bot0.step = step

    def noise(frame, player):
        if player == 1:
            return None
        return naive_noise(env, frame_keys[min(frame, len(frame_keys) - 1)],
                           GAME)
    margins = []
    with recording_margins(monkeypatch, margins):
        w, s, fr = BS.play_matches_stateful(
            env, bot0, BS.stateless(make_bot(opp_name, env)), N_GAMES,
            MAX_CYCLES, chunk=1, noise=noise)
    held, m = held_games(margins)
    print(f"{opp_name}: smallest margin per game {m.tolist()}")
    assert held.any()
    return w, s, fr, memory[0], held


def _check(jw, js, w, s, fr, frames, held):
    assert fr == frames and frames >= 2
    assert_eq(jw[held], w.numpy()[held], "winners")
    rows = torch.from_numpy(held)
    assert_state_eq(jax.tree.map(lambda x: x[held], js),
                    State(**{f: getattr(s, f)[rows] for f in FIELD_DTYPES}),
                    "final states")
    assert bool((s.time >= MAX_CYCLES).all())


def test_bs3_vs_po_worker_rush_matches_jax(monkeypatch):
    jenv, env = tree_envs()
    # JAX's step is its memory update and sample_world (jitted: the
    # believe-state bot with an inner bot that returns the world), then
    # its inner bot on the world (eager)
    jinit, jworld = jax_bot(jenv, 3, 0)

    def init0(s):
        with _lax_loops():
            return jinit(s)
    with _jitted_parts(jenv):
        inner = jax.vmap(JTS.naive_mcts_bot(jenv, eval_fn=_jax_eval(jenv),
                                            **GAME), in_axes=(0, None, 0))

        def step0(s, m, k):
            with _lax_loops():    # (traced with JAX's own loops)
                world, m = jworld(s, m)
            return inner(world, 0, k), m
        with eager_tree_loops():
            jw, js, jm, keys = _jax_games(jenv, init0, step0,
                                          "POWorkerRush", 80)
    bot = BS.believe_state_bot(env, TS.naive_mcts_bot(env, **GAME), level=3)
    w, s, fr, m, held = _port_games(env, bot, "POWorkerRush", keys,
                                    monkeypatch)
    _check(jw, js, w, s, fr, len(keys), held)
    sel = np.flatnonzero(held)
    jm = jax.tree.map(lambda x: x[sel], jm)
    idx = torch.from_numpy(sel)
    assert_mem_eq(jm, BS.BelieveMem(
        prev=State(**{f: getattr(m.prev, f)[idx] for f in FIELD_DTYPES}),
        **{f: getattr(m, f)[idx] for f in BS.BelieveMem.PLANES}),
        "BS3 memory")


def test_continuing_vs_worker_rush_matches_jax(monkeypatch):
    jenv, env = tree_envs()
    with eager_continuing(jenv, GAME):
        cont = JTS.naive_mcts_continuing(jenv, **GAME)
        jw, js, jtree, keys = _jax_games(
            jenv, lambda s: jax.vmap(cont.init, in_axes=(0, None))(s, 0),
            lambda s, m, k: jax.vmap(cont.step, in_axes=(0, 0, None, 0))(
                s, m, 0, k), "WorkerRush", 81)
    bot = TS.naive_mcts_continuing(env, **GAME)
    w, s, fr, tree, held = _port_games(env, bot, "WorkerRush", keys,
                                       monkeypatch)
    _check(jw, js, w, s, fr, len(keys), held)
    assert_tree_eq(jtree, tree, held, "final trees")
