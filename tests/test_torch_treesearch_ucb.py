"""The UCB1 local rule of MLPSMCTS (``mlps_mcts_bot``: per-unit UCB1
with M, the node's widest unit; bots/treesearch.py) against the JAX
package's, as in test_torch_treesearch.py (4 recorded 8x8 games, each
player a case, JAX's small budget, whole trees and actions equal under
the 1e-6 margin rule; UCB1 takes a ``log`` and a ``sqrt``)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import TINY, check_naive

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_mlps_mcts_trees_match_jax(monkeypatch, player):
    # mlps_mcts_bot's arguments (treesearch.py:808-817)
    kw = dict(TINY, local_policy="ucb", ucb_c=0.05, eps0=1.0, eps_g=0.0)
    tree = check_naive(monkeypatch, kw, 45, player)
    assert bool((tree.tvis[:, 0].sum((1, 2, 3)) > 0).all())
