"""RTMinimax and IDRTMinimax (bots/minimax.py) of the port's plain path
against the JAX package's on 4 recorded 8x8 games, each player a case,
at tests/test_minimax.py's sizes (lookahead 12, stack 6, budget 60;
IDRTMinimax over lookaheads 6 and 12): actions, every search's root
value and whole stacks equal, the floats exactly
(tests/torch_minimax_parity.py)."""

import pytest

from microrts_tpu.bots import minimax as JMM
from microrts_tpu_torch.bots import minimax as MM

from torch_minimax_parity import RT_KW, check_dfs
from torch_parity import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_rt_minimax_matches_jax(player):
    act, stk = check_dfs(JMM.rt_minimax_bot, MM.rt_minimax_bot, RT_KW,
                         player)
    assert int(stk.npush.max()) > 4


@pytest.mark.parametrize("player", [0, 1])
def test_idrt_minimax_matches_jax(player):
    kw = dict(RT_KW, lookaheads=(6, 12))
    del kw["lookahead"]
    check_dfs(JMM.idrt_minimax_bot, MM.idrt_minimax_bot, kw, player,
              "lookaheads")
