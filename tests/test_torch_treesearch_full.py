"""``naive_mcts_bot`` (bots/treesearch.py) against the JAX package's, as
in test_torch_treesearch.py (4 recorded 8x8 games, each player a case,
JAX's small budget, whole trees and actions equal under the 1e-6 margin
rule), on trees that fill: 4 nodes, ``nnodes == N``, where a descent
stops at a node that cannot expand."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import TINY, check_naive

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_naive_mcts_full_tree_matches_jax(monkeypatch, player):
    kw = dict(TINY, max_nodes=4)
    tree = check_naive(monkeypatch, kw, 44, player)
    assert bool((tree.nnodes == kw["max_nodes"]).all())
