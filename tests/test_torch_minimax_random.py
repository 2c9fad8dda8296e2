"""IDRTMinimaxRandomized (bots/minimax.py) of the port's plain path
against the JAX package's on 4 recorded 8x8 games, each player a case,
on JAX's draws (the coin table of every DFS lane built from JAX's key
tree, tests/torch_minimax_parity.py): the scores (mean - population std
over the repeats) within 1e-6 relative and the actions equal in every
game whose top two scores are more than 1e-6 apart (the margins are
printed); at least one game is held.  K 4, R 4, lookahead 12, stack 6,
budget 60 (tests/test_minimax.py:118-121's; the scores then mix won,
lost and even repeats, so the std is read).  A game whose top scores tie
exactly counts its gap to the next distinct score, as
tests/torch_treesearch_parity.py's margins do.  SampledABCD is in
test_torch_sampled_abcd.py."""

import numpy as np
import pytest
import jax

from microrts_tpu_torch.bots import minimax as MM

from torch_minimax_parity import (games, held_games, jax_randomized,
                                  randomized_coins)
from torch_parity import assert_eq, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

RAND_KW = dict(k_moves=4, repeats=4, lookahead=12, stack_cap=6,
               node_budget=60)


@pytest.mark.parametrize("player", [0, 1])
def test_idrt_minimax_randomized_matches_jax(player):
    _, env, s = games()
    K, R, budget = RAND_KW["k_moves"], RAND_KW["repeats"], \
        RAND_KW["node_budget"]
    keys = jax.random.split(jax.random.PRNGKey(60 + player), s.batch)
    ja, jscore = jax_randomized(RAND_KW, s, player, keys)
    coins = randomized_coins(keys, K, R, budget)
    bot = MM.idrt_minimax_randomized_bot(env, **RAND_KW)
    scores, seen = bot.bot.scores, []   # the decision's own scores
    bot.bot.scores = lambda *a: seen.append(scores(*a)) or seen[-1]
    act = bot(s, player, coins)
    _, valid, score, _ = seen[0]
    np.testing.assert_allclose(score.numpy(), jscore, rtol=1e-6, atol=0)
    held = held_games("IDRTMinimaxRandomized", score.numpy(), player)
    assert_eq(ja[held], act.numpy()[held], "action")
    assert bool(valid.any(1).all())
    assert bool((act[..., 0] > 0).any())
