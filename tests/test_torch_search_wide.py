"""``monte_carlo_bot`` (bots/search.py) with two playouts per candidate
(``n_eval`` = 2: lanes ``(b * K + k) * 2 + e``, the values averaged), for
player 1 (the candidate is player 1's action, the rollout policy player
0's): the port's plain path against the JAX package's, actions equal.

JAX's bots run eagerly under ``vmap`` around the env's jitted parts and a
jitted RandomBiasedAI (tests/torch_search_parity.py); the port takes every
uniform JAX's key tree draws (the fields of ``MCNoise``, ``NaiveNoise``,
``UCTNoise``).  The games are recorded 8x8 states of RandomBiasedAI
self-play in which both players have idle units; the budget is small
(``playout_len`` 8: two decisions per playout)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_search_parity import check_monte_carlo

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_monte_carlo_bot_with_two_playouts_matches_jax():
    check_monte_carlo(1, 2)
