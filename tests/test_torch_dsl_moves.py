"""``MoveToUnit`` of the DSL (``synth/dsl.py``): the port's plain
compiled programs against the JAX package's on the DSL records
(``torch_dsl_parity.dsl_records``), both players, every target policy on
both sides (Ally Closest routes to the nearest OTHER ally through
``distance_field2``/``descend_direction_excluding``; the others to one
board-global pick, Random's from JAX's ``uniform(key, (H, W))``), each
followed by an attack.  Tolerance: exact."""

import pytest

from torch_dsl_parity import MOVES, check_program, dsl_records
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("name", sorted(MOVES))
def test_move_to_unit_matches_jax(name):
    env, jenv, s = dsl_records()
    assert check_program(env, jenv, MOVES[name], s).any()
