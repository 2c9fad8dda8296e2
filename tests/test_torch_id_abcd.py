"""IDABCD (bots/minimax.py) of the port's plain path against the JAX
package's on 4 recorded 8x8 games, each player a case: the depth
schedule 1, 2 with WorkerRush playouts of 8 ticks and budget 60
(tests/test_minimax.py:118-121's): actions, every search's root value and
whole stacks equal, the floats exactly (tests/torch_minimax_parity.py)."""

import pytest

from microrts_tpu.bots import minimax as JMM
from microrts_tpu_torch.bots import minimax as MM

from torch_minimax_parity import ABCD_KW, check_dfs
from torch_parity import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("player", [0, 1])
def test_id_abcd_matches_jax(player):
    kw = dict(ABCD_KW, depths=(1, 2))
    del kw["max_depth"]
    check_dfs(JMM.id_abcd_bot, MM.id_abcd_bot, kw, player, "depths")
