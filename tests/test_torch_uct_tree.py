"""``uct_tree_bot`` (bots/treesearch.py, UCT with tree growth over K
uniformly sampled candidate joint actions a node) against the JAX
package's, for 4 recorded 8x8 games at a small budget (6 playouts, 12
nodes, 4 candidates, depth 3, ``playout_len`` 8), each player a case:
every array of the trees (node states, players, terminal flags, depths,
visits, candidate arm planes, candidate visits and values, children,
node counts; the scratch row too) and the actions equal, the floats
exactly in every game where no float argmax of the port came within
1e-6 of its runner-up (UCB1 takes a ``log`` and a ``sqrt``;
tests/torch_treesearch_parity.py).  The first-play urgency is in
test_torch_uct_fpu.py."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import UCT_TINY, check_uct

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_uct_tree_trees_match_jax(monkeypatch, player):
    tree = check_uct(monkeypatch, UCT_TINY, 50, player)
    assert int(tree.nnodes.min()) > 2
    assert bool((tree.avis[:, 0] > 0).all())
