"""ABCD (bots/minimax.py) of the port's plain path against the JAX
package's on 4 recorded 8x8 games, each player a case, at
tests/test_minimax.py's sizes (depth 2, WorkerRush playouts of 8 ticks,
budget 60): actions, the root value (``value_fn``) and whole stacks (row
S too: states, odometers, packed contexts, alpha/beta/best, movers, the
root action) equal, the floats exactly (tests/torch_minimax_parity.py
runs JAX's DFS on concrete values around its jitted parts).  IDABCD is
in test_torch_id_abcd.py.  ``make_bot`` builds the six minimax names
with the JAX registry's arguments."""

import pytest
import torch

from microrts_tpu.bots import minimax as JMM
from microrts_tpu_torch.bots import minimax as MM
from microrts_tpu_torch.bots.scripted import Opponent
from microrts_tpu_torch.config import (JAVA_AI_ALIASES, MINIMAX_BOTS,
                                       PORTED_BOTS, make_bot)

from torch_minimax_parity import ABCD_KW, check_dfs, games
from torch_parity import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_abcd_matches_jax(player):
    act, stk = check_dfs(JMM.abcd_bot, MM.abcd_bot, ABCD_KW, player)
    assert bool(stk.root_set.any()) and int(stk.npush.max()) > 4
    assert bool((act[..., 0] > 0).any())


def test_make_bot_builds_the_minimax_bots():
    _, env, _ = games()
    want = dict(ABCD=(5, 512), RTMinimax=(12, 512),
                IDRTMinimaxRandomized=(8, 8, 10, 96), SampledABCD=(8, 100))
    assert set(MINIMAX_BOTS) == {"ABCD", "SampledABCD", "IDABCD",
                                 "RTMinimax", "IDRTMinimax",
                                 "IDRTMinimaxRandomized"}
    assert set(MINIMAX_BOTS) <= set(PORTED_BOTS)
    for name in MINIMAX_BOTS:
        bot = make_bot(name, env)
        assert isinstance(bot, Opponent), name
        if name in want:
            assert bot.bot.dims == want[name], name
    assert make_bot("IDABCD", env).bot.dims == tuple(
        (d + 1, 512) for d in (1, 2, 3, 4))
    assert make_bot("IDRTMinimax", env).bot.dims == ((12, 512),) * 3
    for java, short in JAVA_AI_ALIASES.items():
        if short in MINIMAX_BOTS:
            assert make_bot(java, env).bot.dims == make_bot(short,
                                                            env).bot.dims
    g = torch.Generator()
    assert make_bot("IDRTMinimaxRandomized", env).draw(g, 3).shape == (
        3, 8, 8, 97)
    assert make_bot("SampledABCD", env).draw(g, 3).shape == (
        2, 7, 3, env.h, env.w, 2)
    assert make_bot("ABCD", env).draw(g, 3) is None
