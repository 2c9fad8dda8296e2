"""K10 (with K9's fields): the port's plain rush bots against the JAX
package's ``rush_bot``, bit-equal, for the four rushes and the four
defenses (``make_bot`` names; the economy family and CRush are in
test_torch_rush_economy.py).

The states come from plain WorkerRush-vs-LightRush playouts of the port
on basesWorkers8x8 and basesWorkersBarracks8x8 (4 envs each, the envs
made to differ by a few random opening ticks), every 8th tick, plus
copies with the bases removed and the resources raised (the rebuild
branch); both players' actions are compared on all of them at once.  The
compared states must make the bots train, build, harvest, return, walk
home, walk to a resource, attack and walk toward the enemy: the test
counts each decision.  The ``rush`` kernel is held to these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import pytest

from torch_parity import torch_one_thread, assert_eq
from torch_rush_parity import (branch_counts, jax_actions, port_bot,
                               recorded_states)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

NAMES = ("WorkerRush", "LightRush", "HeavyRush", "RangedRush",
         "WorkerDefense", "LightDefense", "HeavyDefense", "RangedDefense")


@pytest.mark.parametrize("name", NAMES)
def test_rush_bot_matches_jax(name):
    env, _, s = recorded_states()
    want = jax_actions(NAMES)
    bot = port_bot(name, env)
    for p in (0, 1):
        got = bot(s, p)
        assert_eq(want[(name, p)], got, f"{name} p{p}")
        assert (got[..., 0] > 0).any()


def test_recorded_states_exercise_every_branch():
    counts = branch_counts(NAMES)
    for b in ("train_worker", "train_combat", "build_barracks", "harvest",
              "return", "move_home", "move_to_resource", "attack",
              "move_to_enemy"):
        assert counts.get(b, 0) > 0, (b, counts)
