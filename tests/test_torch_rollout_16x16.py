"""The port's policy-driven rollout vs the JAX package's on
basesWorkers16x16 at the published width (64, 4 blocks), fp32 model,
RandomBiasedAI opponent: 2 envs, 2 steps.  What is compared and the
tolerances are those of test_torch_rollout.py (its 8x8 cases)."""

from torch_rollout_parity import check_pair, run_pair


def test_rollout_16x16_full_width():
    r = run_pair("maps/16x16/basesWorkers16x16.xml", n=2, steps=2,
                 max_steps=100, selfplay=False, seed=2)
    check_pair(r)
    assert (r["traj"].action[..., 0] > 0).any()
