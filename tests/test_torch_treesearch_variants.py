"""``naive_mcts_bot`` (bots/treesearch.py) against the JAX package's, as
in test_torch_treesearch.py (4 recorded 8x8 games, each player a case,
JAX's small budget, whole trees and actions equal under the 1e-6 margin
rule): TwoPhaseNaiveMCTS's epsilons (``eps0`` 1 for the first half of
the iterations, then 0: explore, then exploit the global bandit)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import TINY, check_naive

pytestmark = pytest.mark.usefixtures("torch_one_thread")

# TwoPhaseNaiveMCTS (microrts_tpu/config.py:228-230)
TWO_PHASE = dict(eps0=1.0, eps_l=0.3, eps_g=0.0, phase2=(0.0, 0.3, 0.0),
                 phase1_ratio=0.5)


@pytest.mark.parametrize("player", [0, 1])
def test_two_phase_naive_mcts_trees_match_jax(monkeypatch, player):
    tree = check_naive(monkeypatch, dict(TINY, **TWO_PHASE), 43, player)
    assert bool((tree.nchild[:, 0] > 0).all())
