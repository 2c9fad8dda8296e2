"""NaiveMCTS and UCT in the port's pools: ``round_robin`` runs NaiveMCTS
on its own lanes only; NaiveMCTS plays out with an ``Opponent`` from
``make_bot`` as its rollout; ``make_bot``'s seven tree-search names build
the JAX package's configurations, the unported names still refuse."""

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


class _Recorded:
    """A ``MCTSNoise`` whose descent-step draws are kept (``keep``) or
    replayed from ``steps``; ``play`` passes through."""

    def __init__(self, inner, steps):
        self.inner, self.steps = inner, steps

    def step(self, it, d):
        if (it, d) not in self.steps:
            self.steps[(it, d)] = self.inner.step(it, d)
        return self.steps[(it, d)]

    def play(self, it):
        return self.inner.play(it)


@pytest.mark.parametrize("rollout", ["WorkerRush",
                                     "RandomBiasedSingleUnitAI"])
def test_naive_mcts_plays_out_with_an_opponent_rollout(rollout):
    """NaiveMCTS with ``rollout_bot`` an ``Opponent`` from ``make_bot``:
    its playouts draw through the rollout's own ``draw`` (None for the
    deterministic WorkerRush, a ``SingleUnitNoise`` for the single-unit
    bot), one draw a side and decision for every game.  With WorkerRush
    the trees equal those of the same search whose rollout is WorkerRush's
    bare function, fed RandomBiasedAI's uniforms that it ignores."""
    _, env, s = games()
    B = s.batch
    kw = dict(TINY, n_playouts=3)
    ro = make_bot(rollout, env)
    seen = []

    def rbot(st, player, noise):
        seen.append((st.batch, type(noise)))
        return ro.bot(st, player, noise)
    bot = TS.naive_mcts_bot(env, rollout_bot=Opponent(rbot, ro.draw), **kw)
    steps = {}
    nz = _Recorded(bot.draw(torch.Generator().manual_seed(3), B), steps)
    tree = bot.bot.init_tree(s, 0)
    bot.bot.search(tree, 0, s.time, nz)
    act = bot.bot.best_action(tree)
    n_dec = max(2, kw["playout_len"] // 4)
    want = type(ro.draw(torch.Generator(), B))
    assert seen and set(seen) == {(B, want)}
    assert len(seen) <= kw["n_playouts"] * n_dec * 2
    assert act.shape == (B, env.h, env.w, 7) and act.dtype == torch.int32
    assert bool((tree.nchild[:, 0] > 0).any())
    if rollout != "WorkerRush":
        return
    bare = TS.naive_mcts_bot(env, rollout_bot=ro.bot, **kw)
    tree2 = bare.bot.init_tree(s, 0)
    bare.bot.search(tree2, 0, s.time, _Recorded(
        bare.draw(torch.Generator().manual_seed(4), B), steps))
    for f in type(tree).FIELDS:
        assert torch.equal(getattr(tree, f), getattr(tree2, f)), f
    assert torch.equal(act, bare.bot.best_action(tree2))


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
                       ("PortfolioAI", "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            make_bot(name, env)
    # the learned models (item 11) are ported: InformedNaiveMCTS builds,
    # and prior_fn is taken
    informed = make_bot("InformedNaiveMCTS", env)
    assert isinstance(informed, Opponent)
    assert informed.bot.dims == (96, 16, 10)
    assert isinstance(informed.draw(torch.Generator(), 2), TS.MCTSNoise)
    assert isinstance(TS.naive_mcts_bot(env, prior_fn=lambda s, p, m: m),
                      Opponent)
