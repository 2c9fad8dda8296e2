"""The DSL's conditions, second half of ``torch_dsl_parity.CONDS``
(see test_torch_dsl_conds.py): the port's plain compiled programs
against the JAX package's on the DSL records, both players.  Tolerance:
exact."""

import pytest

from torch_dsl_parity import CONDS, check_condition
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("name", sorted(CONDS)[8:])
def test_condition_rest_matches_jax(name):
    check_condition(name)
