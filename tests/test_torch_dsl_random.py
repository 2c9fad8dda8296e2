"""Random DSL programs, continued from test_torch_dsl_programs.py:
``random_program(random.Random(s))`` for s = 9-19, the port's plain
compiled program against the JAX package's on the DSL records, both
players (the same program drawn by both packages).  Tolerance: exact."""

import pytest

from torch_dsl_parity import check_random_program
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("seed", range(9, 20))
def test_random_program_matches_jax(seed):
    check_random_program(seed)
