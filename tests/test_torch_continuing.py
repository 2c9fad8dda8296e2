"""ContinuingNaiveMCTS (``bots/treesearch.py`` ``naive_mcts_continuing``:
tree reuse across decisions, plain path on the CPU) against the JAX
package's, at its small budget (6 playouts, 12 nodes, 4 children, depth
3) as player 0 against WorkerRush on the 4 recorded 8x8 games of
tests/torch_treesearch_parity.py, on JAX's draws: at each of 3
consecutive decision frames (the step, the env's step with WorkerRush's
reply, the fast-forward to the next decision frame) the kept trees, every
array of them, and the actions are equal, and some tree holds more nodes
than one fresh search can make (the re-root found the real state).  Then
the anytime budget (``per_frame``): one step of lanes whose last
decision lies 1, 2, 3 and 10 frames back searches 2, 4, 6 and 6
iterations.  Floats are held as tests/torch_treesearch_parity.py holds
them: a game leaves the comparison from the frame where a float argmax
of the port came within 1e-6 of its runner-up (the margins are
printed).  JAX runs its own step eagerly under ``vmap`` around its jitted
parts (tests/torch_stateful_parity.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import treesearch as JTS
from microrts_tpu.config import make_bot as jax_make_bot
from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State
from microrts_tpu_torch.ops.playout import fast_forward

from torch_parity import (assert_eq, assert_state_eq, jax_state,
                          torch_one_thread)  # noqa: F401
from torch_stateful_parity import eager_continuing, jax_env_step
from torch_tournament_parity import _pieces
from torch_treesearch_parity import (TINY, _jit, assert_tree_eq, games,
                                     held_games, naive_noise,
                                     recording_margins)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

FRAMES = 3
T_END = 10_000


def test_continuing_trees_match_jax_over_frames(monkeypatch):
    jenv, env, s = games()
    B = s.batch
    f = _pieces(jenv, T_END)
    rush_j = _jit(jax.vmap(jax_make_bot("WorkerRush", jenv),
                           in_axes=(0, None, 0)))
    jstep = jax_env_step(jenv)
    rush = make_bot("WorkerRush", env)
    keys = jax.random.split(jax.random.PRNGKey(70), B)
    js = jax_state(s)
    jdone = jnp.zeros(B, bool)
    frames = []
    with eager_continuing(jenv, TINY):
        cont = JTS.naive_mcts_continuing(jenv, **TINY)
        jm = jax.vmap(cont.init, in_axes=(0, None))(js, 0)
        for _ in range(FRAMES):
            ks = f["split3"](keys)
            keys, k0, k1 = ks[:, 0], ks[:, 1], ks[:, 2]
            ja, jm = jax.vmap(cont.step, in_axes=(0, 0, None, 0))(
                js, jm, 0, k0)
            frames.append((k0, jm, ja))
            js, d = jstep(js, ja, rush_j(js, 1, k1))
            jdone = jdone | d
            js, jdone = f["ff"](js, jdone)
            js, jdone = f["ff"](js, jdone)

    bot = TS.naive_mcts_continuing(env, **TINY)
    m = bot.init(s, 0)
    done = torch.zeros(B, dtype=torch.bool)
    held = np.ones(B, bool)
    sizes = []
    for i, (k0, jtree, ja) in enumerate(frames):
        margins = []
        with recording_margins(monkeypatch, margins):
            act, m = bot.step(s, m, 0, naive_noise(env, k0, TINY))
        h, mg = held_games(margins)
        held &= h
        print(f"frame {i}: smallest margin per game {mg.tolist()}")
        assert held.any()
        assert_tree_eq(jtree, m, held, f"frame {i}")
        assert_eq(np.asarray(ja)[held], act.numpy()[held],
                  f"frame {i}: action")
        sizes.append(m.nnodes.tolist())
        s, _, d = env.step(s, act, rush(s, 1))
        done = done | d
        for _ in range(2):
            s, done = fast_forward(env, s, done, t_end=T_END, max_events=1)
    rows = torch.from_numpy(held)
    assert_state_eq(jax.tree.map(lambda x: x[held], js),
                    State(**{f: getattr(s, f)[rows] for f in FIELD_DTYPES}),
                    "final states")
    print("nodes a frame", sizes)
    # a fresh search makes at most 1 + n_playouts nodes: reuse made more
    assert max(max(x) for x in sizes[1:]) > 1 + TINY["n_playouts"], sizes


def test_anytime_budget_follows_the_frames_elapsed(monkeypatch):
    jenv, env, s = games()
    B = s.batch
    per_frame = 2
    dt = torch.tensor([1, 2, 3, 10], dtype=torch.int32)[:B]
    want = (dt * per_frame).clamp(per_frame, TINY["n_playouts"])
    keys = jax.random.split(jax.random.PRNGKey(71), B)
    js = jax_state(s)
    with eager_continuing(jenv, TINY):
        cont = JTS.naive_mcts_continuing(jenv, per_frame=per_frame, **TINY)
        jtree, jt = jax.vmap(cont.init, in_axes=(0, None))(js, 0)
        jt = jt - jnp.asarray(dt.numpy())
        ja, (jtree, jt2) = jax.vmap(cont.step, in_axes=(0, 0, None, 0))(
            js, (jtree, jt), 0, keys)
    bot = TS.naive_mcts_continuing(env, per_frame=per_frame, **TINY)
    tree, t0 = bot.init(s, 0)
    margins = []
    with recording_margins(monkeypatch, margins):
        act, (tree, t1) = bot.step(s, (tree, t0 - dt), 0,
                                   naive_noise(env, keys, TINY))
    held, mg = held_games(margins)
    print(f"smallest margin per game {mg.tolist()}")
    assert held.any()
    assert_tree_eq(jtree, tree, held, "per_frame")
    assert_eq(np.asarray(ja)[held], act.numpy()[held], "per_frame action")
    assert_eq(np.asarray(jt2), t1.numpy(), "last decision time")
    assert torch.equal(t1, s.time)
    # every iteration passes the fresh root once
    assert torch.equal(tree.nvis[:, 0], want), (tree.nvis[:, 0], want)
