"""The expert macro env against a scripted bot: ``ExpertEnv.step_vs``
(player 0 on macros against WorkerRush, both acting on the pre-step
state) of the port's plain path against the JAX package's for 100 ticks
of 8 envs on basesWorkers8x8.  Macros are drawn each tick from the legal
ones (``action_mask``) with numpy, the same into both; the macros' own
draws are JAX's, from the per-env keys its ``step_vs`` splits.  JAX's
``ExpertEnv.step_vs`` runs eagerly under ``vmap`` around jitted parts.
Every state plane, the role tables, rewards and dones bit-equal at every
tick (``torch_expert_parity.expert_game``)."""

import pytest

from torch_expert_parity import expert_game
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_expert_step_vs_matches_jax():
    expert_game("step_vs")
