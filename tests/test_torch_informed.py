"""InformedNaiveMCTS (``bots.treesearch.informed_naive_mcts_bot``: the
prior of ``ml.pretrained.make_prior_fn`` in ``arm_sample``'s informed mode,
the model's own playouts) against the JAX package's on the CPU, with JAX's
draws: whole trees and actions.

JAX's search runs eagerly under ``vmap`` around its jitted parts, as in
``tests/torch_treesearch_parity.py``; the prior and the rollout bot are
jitted whole.  The playouts' draws are the model's Gumbels: per
iteration's key ``kp`` and decision ``d``, ``split(split(kp, n_dec)[d])``
and a ``gumbel(k, (H, W, A))`` a side.  Floats: the prior sums its
exponentials in another order than XLA (2e-6 apart at most,
``tests/test_torch_pretrained.py``), so a game is held exactly only where
every float argmax of the port's plain path led its runner-up by at least
1e-6 (``recording_margins``); at least one game must be.
"""

import functools

import numpy as np
import pytest
import jax
import torch

from microrts_tpu.bots import treesearch as JTS
from microrts_tpu.ml import pretrained as JP
from microrts_tpu.utils.assets import asset_path as jax_asset_path
from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.config import pretrained_wr
from microrts_tpu_torch.ml.pretrained import load_pretrained
from microrts_tpu_torch.ops import arms as AR

from torch_parity import assert_eq, torch_one_thread  # noqa: F401
from torch_treesearch_parity import (TINY, _both_players, _jax_eval,
                                     _jitted_parts, _lanes, _naive_iter_fn,
                                     _t, assert_tree_eq, eager_tree_loops,
                                     held_games, recording_margins)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

KW = dict(TINY, n_playouts=4, playout_len=12)
SEED = 5


@functools.lru_cache(maxsize=None)
def _jax_model(jenv):
    jm = JP.load_pretrained(jax_asset_path(
        "bayesianmodels/ActionInterdependenceModel-WR.xml"), jenv)
    return (jm, jax.jit(JP.make_prior_fn(jenv, jm)),
            jax.jit(JP.pretrained_bayes_bot(jenv, jm), static_argnums=1))


@functools.lru_cache(maxsize=None)
def _jax_trees():
    """JAX's InformedNaiveMCTS trees and actions of both players' lanes
    (its registry's wiring: prior, eps0 0.4, eps_l 0.3, model playouts)."""
    jenv, _, _, js2, pl, keys = _both_players(SEED)
    _, prior, rollout = _jax_model(jenv)
    with _jitted_parts(jenv):
        bot = JTS.naive_mcts_bot(jenv, eval_fn=_jax_eval(jenv),
                                 prior_fn=prior, rollout_bot=rollout,
                                 eps0=0.4, eps_l=0.3, **KW)

        def one(s, k, p):
            t = bot.search(bot.init_tree(s, p), p, s.time, k)
            return t, bot.best_action(t)
        with eager_tree_loops():
            return jax.vmap(one)(js2, keys, pl)


class InformedNoise:
    """``TS.MCTSNoise`` holding the draws of JAX's key tree for per-game
    ``keys``: the descent steps' as NaiveMCTS's, the playouts' the
    model's Gumbels ``[n_dec, 2, B, H, W, A]``."""

    def __init__(self, env, keys, kw):
        sp = AR.arm_space(env)
        D, C, A = kw["max_depth"], kw["max_children"], sp.n_arms
        n_dec = max(2, kw["playout_len"] // 4)
        fn = _naive_iter_fn(D, C, env.h, env.w, A)
        gum = jax.jit(jax.vmap(lambda k: jax.random.gumbel(
            k, (env.h, env.w, A))))
        self.steps, self.plays = [], []
        for _ in range(kw["n_playouts"]):
            keys, kp, out = fn(keys)
            self.steps.append([TS.TreeStep(_t(a), _t(b).to(torch.int32),
                                           _t(c), _t(g))
                               for a, b, c, g in out])
            dk = jax.vmap(lambda k: jax.random.split(k, n_dec))(kp)
            play = []
            for d in range(n_dec):
                ks = jax.vmap(jax.random.split)(dk[:, d])
                play.append(np.stack([np.asarray(gum(ks[:, 0])),
                                      np.asarray(gum(ks[:, 1]))]))
            self.plays.append(torch.from_numpy(np.stack(play)))

    def step(self, it, d):
        return self.steps[it][d]

    def play(self, it):
        return self.plays[it]


@pytest.mark.parametrize("player", [0, 1])
def test_informed_trees_and_actions_equal_jax(monkeypatch, player):
    """One InformedNaiveMCTS decision (4 iterations, depth 3, 12-tick model
    playouts) of recorded 8x8 games for ``player``: whole trees (row N
    too) and the chosen actions equal JAX's in the held games; the prior
    and the model's rollouts reach every descent step and playout."""
    jenv, env, s, _, _, keys = _both_players(SEED)
    B = s.batch
    jtree, jact = _jax_trees()
    pm = load_pretrained(pretrained_wr(), env)
    bot = TS.informed_naive_mcts_bot(env, pm, **KW)
    nz = InformedNoise(env, keys[player * B:(player + 1) * B], KW)
    calls = []
    real = TS.arm_sample

    def arm_sample(*a, **k):
        calls.append(a[3])
        return real(*a, **k)
    monkeypatch.setattr(TS, "arm_sample", arm_sample)
    margins = []
    with recording_margins(monkeypatch, margins):
        tree = bot.bot.init_tree(s, player)
        bot.bot.search(tree, player, s.time, nz)
        act = bot.bot.best_action(tree)
    assert set(calls) == {"informed"}
    held, m = held_games(margins)
    print(f"informed p{player}: smallest margin per game {m.tolist()}")
    assert held.any(), m
    assert_tree_eq(_lanes(jtree, player, B), tree, held,
                   f"informed p{player}")
    assert_eq(np.asarray(jact)[player * B:(player + 1) * B][held],
              act.numpy()[held], f"informed p{player} action")
    assert int(tree.nnodes.min()) > 1
