"""The port's full ``issue`` against the JAX package's on random
candidate tables over recorded partially observable 16x16 states, under
all three move-conflict policies (see test_torch_issue.py and
``torch_po_parity.check_random_tables``).  Tolerance: exact, whole
states.
"""

from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

from torch_parity import torch_one_thread  # noqa: F401
from torch_po_parity import (cat_states, check_random_tables, po_records,
                             rush_trajectory)


def test_issue_matches_jax_on_random_tables_16x16(torch_one_thread):
    """PO states of basesWorkers16x16 under RandomBiasedAI and under the
    WorkerRush mirror (workers crowd around the bases: chains)."""
    env = GridnetEnv(asset_path("maps/16x16/basesWorkers16x16.xml"),
                     partial_obs=True, device="cpu")
    rush = rush_trajectory(env, 6, 141, set(range(40, 141, 10)))
    s = cat_states(list(rush.values())
                   + [r[0] for r in po_records(env, 6, 48, seed=3,
                                               every=8)])
    check_random_tables(env, s, seed=6)
