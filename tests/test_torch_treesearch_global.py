"""``naive_mcts_bot`` (bots/treesearch.py) against the JAX package's, as
in test_torch_treesearch.py (4 recorded 8x8 games, each player a case,
JAX's small budget, whole trees and actions equal under the 1e-6 margin
rule), with ``eps_g`` 0.3: the global bandit's random slot (a draw of
``randint(k1, (), 0, max(nch, 1))``, the port's ``[B, C]`` table
indexed by the child count)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import TINY, check_naive

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_naive_mcts_global_bandit_slot_matches_jax(monkeypatch, player):
    tree = check_naive(monkeypatch, dict(TINY, eps_g=0.3, eps0=0.2), 41,
                       player)
    assert bool((tree.nchild[:, 0] > 1).any())
