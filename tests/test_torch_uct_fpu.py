"""``uct_tree_bot`` with the first-play urgency (UCTFirstPlayUrgency,
``fpu`` 0.5: an unvisited candidate competes with that fixed score)
against the JAX package's, as in test_torch_uct_tree.py (4 recorded 8x8
games, each player a case, whole trees and actions equal under the 1e-6
margin rule)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import UCT_TINY, check_uct

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_uct_first_play_urgency_trees_match_jax(monkeypatch, player):
    tree = check_uct(monkeypatch, dict(UCT_TINY, fpu=0.5), 51, player)
    assert int(tree.nnodes.min()) > 1
