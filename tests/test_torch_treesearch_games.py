"""NaiveMCTS in games: the port's ``play_matches`` runner
(eval/tournament.py ``_games_fn``, fixed pair) of ``naive_mcts_bot`` at
JAX's small budget with 2 playouts a decision (the search at the full
small budget is test_torch_treesearch.py's; the JAX search's CPU
compiles take most of this file's time) as player 0 against WorkerRush,
4 games on basesWorkers8x8 for 2 decision frames, on JAX's draws,
against the JAX package's game loop (tests/torch_treesearch_parity.py):
winners and final states equal.  Pools and ``make_bot`` are in
test_torch_treesearch_bots.py."""

import pytest
import torch

from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.eval import tournament as TN

from torch_parity import assert_eq, assert_state_eq, torch_one_thread  # noqa
from torch_treesearch_parity import TINY, games, jax_naive_games

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAX_CYCLES = 2
GAME = dict(TINY, n_playouts=2)


def test_naive_mcts_games_match_jax():
    _, env, _ = games()
    n = 4
    jw, js, noise, frames = jax_naive_games(GAME, n, MAX_CYCLES, 60)
    run = TN._games_fn(env, [TS.naive_mcts_bot(env, **GAME),
                             make_bot("WorkerRush", env)], MAX_CYCLES,
                       fixed_pair=True)
    z = torch.zeros(n, dtype=torch.int64)
    w, s, fr = run(z, z + 1, noise=noise)
    assert fr == frames and frames >= 2
    assert_eq(jw, w, "winners")
    assert_state_eq(js, s, "final states")
    assert bool((s.time >= MAX_CYCLES).all())
