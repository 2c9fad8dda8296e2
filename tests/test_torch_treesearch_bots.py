"""NaiveMCTS and UCT in the port's pools: ``round_robin`` runs NaiveMCTS
on its own lanes only; ``make_bot``'s seven tree-search names build the
JAX package's configurations, the unported names still refuse."""

import pytest
import torch

from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.bots.scripted import Opponent
from microrts_tpu_torch.config import PORTED_BOTS, TREE_BOTS, make_bot
from microrts_tpu_torch.eval import tournament as TN

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_treesearch_parity import TINY, games

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_round_robin_runs_naive_mcts_on_its_lanes_only():
    """In a pool, ``round_robin`` hands NaiveMCTS only the lanes that play
    it: 3 bots, 6 ordered pairs, one game each, so 2 lanes a side."""
    _, env, _ = games()
    calls = []
    nm = TS.naive_mcts_bot(env, **dict(TINY, n_playouts=2))

    def bot(s, player, noise):
        calls.append((s.batch, player, noise.batch))
        return nm.bot(s, player, noise)
    res = TN.round_robin(env, {"NaiveMCTS": Opponent(bot, nm.draw),
                               "PassiveAI": make_bot("PassiveAI", env),
                               "WorkerRush": make_bot("WorkerRush", env)},
                         games_per_pair=1, max_cycles=2, seed=0)
    assert int(res.games.sum()) == 12
    assert {(b, p, n) for b, p, n in calls} == {(2, 0, 2), (2, 1, 2)}


def test_make_bot_builds_the_tree_search_bots():
    _, env, _ = games()
    want = dict(NaiveMCTS=(96, 16, 10), TwoPhaseNaiveMCTS=(96, 16, 10),
                MLPSMCTS=(96, 16, 10), UCTUnitActions=(96, 16, 10),
                UCT=(96, 8, 8), DownsamplingUCT=(96, 4, 8),
                UCTFirstPlayUrgency=(96, 8, 8))
    assert set(TREE_BOTS) == set(want) and set(want) <= set(PORTED_BOTS)
    for name, dims in want.items():
        bot = make_bot(name, env)
        assert isinstance(bot, Opponent) and bot.bot.dims == dims, name
    assert isinstance(make_bot("ai.mcts.naivemcts.NaiveMCTS", env).draw(
        torch.Generator(), 2), TS.MCTSNoise)
    assert isinstance(make_bot("ai.mcts.uct.UCT", env).draw(
        torch.Generator(), 2), TS.UCTTreeNoise)
    for name, item in (("SCV", "item 10"),
                       ("PortfolioAI", "item 10"),
                       ("InformedNaiveMCTS", "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            make_bot(name, env)
    with pytest.raises(NotImplementedError, match="item 11"):
        TS.naive_mcts_bot(env, prior_fn=lambda s, p, la: la)
