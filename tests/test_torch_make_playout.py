"""K8 on a whole playout: the port's plain ``make_playout`` (with
``gamma`` < 1 and ``n_eval`` > 1) against the JAX package's, values
bit-equal, on the recorded 8x8 states of tests/test_torch_playout.py
(``run_playout`` is in test_torch_run_playout.py; 16x16 and
``make_playout_two`` are in test_torch_playout.py).  JAX's own code runs eagerly
under ``vmap`` around the env's jitted parts, its scan and while loop as
Python loops (tests/torch_playout_parity.py); the port takes the
uniforms JAX's key tree draws (``split(key, n_decisions)``, then ``k0,
k1 = split(k)`` for the two sides)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_playout_parity import check_make_playout

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_make_playout_matches_jax():
    """8x8, discounted (``gamma`` 0.9), two playouts per state."""
    check_make_playout("maps/8x8/basesWorkers8x8.xml", 0.9, 2)
