"""``naive_mcts_bot`` (bots/treesearch.py): ``init_tree`` + ``search`` +
``best_action`` of the port's plain path against the JAX package's, for
4 recorded 8x8 games at JAX's own small budget (6 playouts, 12 nodes, 4
children, depth 3, ``playout_len`` 8), each player a case: every array
of the trees (node states, players, terminal flags, depths, values,
visits, the per-unit tables, children, edge arm planes, child counts,
node counts; the scratch row too) and the actions equal, the integers
exactly, the floats exactly in every game where no float argmax of the
port came within 1e-6 of its runner-up (tests/torch_treesearch_parity.py;
the margins are printed).  The expansion runs the port's ``issue_env``
where JAX's runs the full ``issue``.

Here: NaiveMCTS (epsilon-greedy local bandits, ``eps_g`` 0).  One JAX
search a file, both players in one vmap (its CPU compiles are most of a
file's time): the global bandit's random slot is in
test_torch_treesearch_global.py, TwoPhase in
test_torch_treesearch_variants.py, full trees in
test_torch_treesearch_full.py, MLPS in test_torch_treesearch_ucb.py,
UCTUnitActions in test_torch_treesearch_unit_uct.py, UCT in
test_torch_uct_tree.py and test_torch_uct_fpu.py."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import TINY, check_naive

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_naive_mcts_trees_match_jax(monkeypatch, player):
    tree = check_naive(monkeypatch, TINY, 40, player)
    assert int(tree.nnodes.min()) > 2
    assert bool((tree.nchild[:, 0] > 1).any())
