"""The one-unit UCB1 rule of UCTUnitActions (``uct_unit_actions_bot``:
one unit a level, the first idle unit in board order;
bots/treesearch.py) against the JAX package's, as in
test_torch_treesearch.py (4 recorded 8x8 games, each player a case,
JAX's small budget, whole trees and actions equal under the 1e-6 margin
rule)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import TINY, check_naive

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_uct_unit_actions_trees_match_jax(monkeypatch, player):
    # uct_unit_actions_bot's arguments (treesearch.py:797-805)
    kw = dict(TINY, local_policy="unit_uct", ucb_c=0.05, eps0=1.0,
              eps_g=0.0)
    tree = check_naive(monkeypatch, kw, 46, player)
    # one unit decides a level: one acting cell a root edge
    edges = (tree.carms[:, 0] >= 0).flatten(2).sum(2)
    assert bool((edges[tree.children[:, 0] >= 0] == 1).all())
