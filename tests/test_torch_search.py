"""``monte_carlo_bot`` (bots/search.py), the flat Monte Carlo bot of
``make_bot("MonteCarlo")``: the port's plain path against the JAX
package's, actions equal, for player 0 with K=3 candidates and one
playout each (the default ``n_eval``).  ``n_eval`` > 1 and player 1 are in
test_torch_search_wide.py, the other two bots in
test_torch_search_rounds.py.

JAX's bots run eagerly under ``vmap`` around the env's jitted parts and a
jitted RandomBiasedAI (tests/torch_search_parity.py); the port takes every
uniform JAX's key tree draws (the fields of ``MCNoise``, ``NaiveNoise``,
``UCTNoise``).  The games are recorded 8x8 states of RandomBiasedAI
self-play in which both players have idle units; the budget is small
(``playout_len`` 8: two decisions per playout)."""

import pytest
import torch

from microrts_tpu_torch.bots.scripted import Opponent
from microrts_tpu_torch.bots.search import MCNoise
from microrts_tpu_torch.config import PORTED_BOTS, make_bot

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_search_parity import check_monte_carlo, games

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_monte_carlo_bot_matches_jax():
    check_monte_carlo(0, 1)


def test_make_bot_monte_carlo_draws_the_jax_defaults():
    """``make_bot("MonteCarlo")``: K=12 candidates, ``playout_len`` 48 (12
    decisions), one playout each; its draws cover every lane."""
    _, env, s = games()
    bot = make_bot("ai.montecarlo.MonteCarlo", env)
    assert isinstance(bot, Opponent) and "MonteCarlo" in PORTED_BOTS
    nz = bot.draw(torch.Generator().manual_seed(0), s.batch)
    assert isinstance(nz, MCNoise)
    L = s.batch * 12
    assert nz.cand.shape == (L, env.h, env.w, 2)
    assert nz.opp.shape == (L, env.h, env.w, 2)
    assert nz.play.shape == (12, 2, L, env.h, env.w, 2)
    with pytest.raises(NotImplementedError, match="item 10"):
        make_bot("PortfolioAI", env)
