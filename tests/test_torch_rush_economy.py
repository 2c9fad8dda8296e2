"""K10: the port's plain rush bots against the JAX package's
``rush_bot``, bit-equal, for the economy family, WorkerRushPlusPlus and
CRush (``make_bot`` names) and for a spec with the expansion branch on.
The states and what is compared are those of test_torch_rush.py; here
the decisions counted include the base rebuild (on the copies with the
bases removed) and the expansion."""

import pytest

from torch_parity import torch_one_thread, assert_eq
from torch_rush_parity import (branch_counts, jax_actions, port_bot,
                               recorded_states)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

NAMES = ("WorkerRushPlusPlus", "EconomyRush", "EconomyMilitaryRush",
         "EMRDeterministico", "EconomyRushBurster", "SimpleEconomyRush",
         "CRush_V1", "CRush_V2", "expand")


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
    for b in ("train_worker", "train_combat", "rebuild_base",
              "build_barracks", "harvest", "return", "move_home",
              "move_to_resource", "expand_move", "attack", "move_to_enemy"):
        assert counts.get(b, 0) > 0, (b, counts)
