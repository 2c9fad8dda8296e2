"""The DSL interpreter (``synth/dsl.py``): the port's plain compiled
programs against the JAX package's on WorkerRush-vs-LightRush records of
basesWorkers8x8 and basesWorkersBarracks8x8 (bases removed in some),
both players: one case a command (``torch_dsl_parity.COMMANDS``) and one
per in-range target policy of ``Attack``, the ``Random`` policy's
uniforms JAX's own (``fold_in(key, rel)`` of one key a call).  The
``MoveToUnit`` targets and the conditions are in test_torch_dsl_moves.py
and test_torch_dsl_conds.py.  Tolerance: exact."""

import pytest

from torch_dsl_parity import ATTACKS, COMMANDS, check_program, dsl_records
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_command_matches_jax(name):
    env, jenv, s = dsl_records()
    acted = check_program(env, jenv, COMMANDS[name], s)
    assert acted.any() or name == "Build"


@pytest.mark.parametrize("target", sorted(ATTACKS))
def test_attack_target_matches_jax(target):
    env, jenv, s = dsl_records()
    assert check_program(env, jenv, ATTACKS[target], s).any()
