"""K8 on a whole playout: the port's plain ``run_playout`` against the
JAX package's, final states and dones bit-equal, one playout per lane,
on the recorded 8x8 and 16x16 states of tests/test_torch_playout.py.  JAX's own code runs eagerly under ``vmap`` around the env's
jitted parts, its scan and while loop as Python loops
(tests/torch_playout_parity.py); the port takes the uniforms JAX's key
tree draws (``split(key, n_decisions)``, then ``k0, k1 = split(k)`` for
the two sides)."""

import pytest

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_playout_parity import check_run_playout

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("map_rel", ["maps/8x8/basesWorkers8x8.xml",
                                     "maps/16x16/basesWorkers16x16.xml"])
def test_run_playout_matches_jax(map_rel):
    check_run_playout(map_rel)
