"""The expert macro env in self-play: ``ExpertEnv.step`` (both players
on macros) of the port's plain path against the JAX package's for 100
ticks of 8 envs on basesWorkers8x8, macros drawn each tick from the legal
ones with numpy and the macros' draws JAX's, from the keys its ``step``
splits.  Every state plane, both players' role tables, rewards and dones
bit-equal at every tick (``torch_expert_parity.expert_game``)."""

import pytest

from torch_expert_parity import expert_game
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_expert_step_matches_jax():
    expert_game("step")
