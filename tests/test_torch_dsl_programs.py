"""Whole DSL programs: the port's plain compiled ``SEED_PROGRAM`` (on
the DSL records of basesWorkers8x8 and on random-play states of
basesWorkers16x16) and ``random_program(random.Random(s))`` for s = 0-8
against the JAX package's, both players; the rest of the 20 random
programs are in test_torch_dsl_random.py.  Tolerance: exact."""

import pytest

from microrts_tpu_torch.synth.dsl import SEED_PROGRAM

from torch_dsl_parity import check_program, check_random_program, dsl_records
from torch_parity import envs, port_trajectory, torch_one_thread  # noqa

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_seed_program_matches_jax():
    env, jenv, s = dsl_records()
    assert check_program(env, jenv, SEED_PROGRAM, s).any()


def test_seed_program_on_16x16_matches_jax():
    jenv, env = envs("maps/16x16/basesWorkers16x16.xml")
    s = port_trajectory(env, 4, 41, 9, {40})[40]
    assert check_program(env, jenv, SEED_PROGRAM, s).any()


@pytest.mark.parametrize("seed", range(9))
def test_random_program_matches_jax(seed):
    check_random_program(seed)
