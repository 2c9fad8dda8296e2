"""The DSL's conditions (``synth/dsl.py`` ``cond_value``): the port's
plain compiled programs against the JAX package's on the DSL records
(``torch_dsl_parity.dsl_records``), both players, each condition
guarding a harvest and an attack with every other unit kept idle, so
that the actions show the per-env value of the condition: the first half
of ``torch_dsl_parity.CONDS`` here, the rest in
test_torch_dsl_conds2.py.  ``EnemyInRange`` never holds in the JAX
package (``d_base`` is a field over free cells, so an enemy's own
occupied cell is INF), and the port keeps that.  Tolerance: exact."""

import pytest

from torch_dsl_parity import CONDS, check_condition
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("name", sorted(CONDS)[:8])
def test_condition_matches_jax(name):
    check_condition(name)
