"""A whole PPO update of the port (``PPOTrainer.update``, plain path on the
CPU) against the JAX package's.

Both trainers start from the same envs and the same fp32 parameters of a
``GridnetPolicy`` of width 16 with one block (basesWorkers8x8, 8 envs, 4
steps, 2 epochs x 2 minibatches); the port's rollout takes the noise
JAX's key tree draws (see test_torch_rollout.py).  JAX's ``update`` runs
unjitted, its ``lax.scan``s as Python loops (``_py_scan``, which honours
``reverse`` for the GAE) around a jitted ``_loss``.

The whole update uses SGD after ``clip_by_global_norm(0.5)``: Adam
amplifies float32 reduction-order noise on near-zero gradients into
full-``lr`` steps (microrts_tpu/train/ppo.py:221-225), so it is held on
one minibatch step instead (test_torch_ppo.py).

Tolerances:
* the rollout (obs, masks, actions, rewards, dones, the final states):
  exact;
* after the SGD update, each parameter's displacement 1e-4 relative +
  1e-5 x the leaf's largest displacement + 2 float32 ulps of the
  parameter (``p + u`` rounds to the parameter's own ulp, far coarser
  than a step of lr x g) absolute; the loss terms of the
  last minibatch 1e-4 relative; ``mean_reward`` 1e-6 relative;
  ``episodes`` and ``wins`` exact.
"""

import numpy as np
import pytest
import jax

from microrts_tpu_torch.models.gridnet_policy import params_from_flax

from torch_parity import torch_one_thread, assert_eq, assert_state_eq
from torch_rollout_parity import run_update, trainer_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"


def _displacement(after, before):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("opponent", ["RandomBiasedAI", "WorkerRush"])
def test_update_matches_jax(opponent):
    jtr, jts, tr, ts = trainer_pair(MAP, n=8, steps=4, opponent=opponent,
                                    tx="sgd", seed=5, max_steps=3)
    p0 = {k: v.clone() for k, v in tr.model.state_dict().items()}
    jts2, jm, ts2, tm, jt, t = run_update(jtr, jts, tr, ts)

    for f in ("obs", "mask", "action", "reward", "done"):
        assert_eq(getattr(jt, f), getattr(t, f), f)
    assert_state_eq(jts2.env_states, ts2.env_states, "final")
    assert_eq(jts2.env_steps, ts2.env_steps, "final steps")
    assert t.done.any() and (t.action[..., 0] > 0).any()
    assert ts2.update_count == 1 and int(jts2.update_count) == 1

    jp = params_from_flax(jax.tree.map(np.asarray, jts2.params))
    jp0 = params_from_flax(jax.tree.map(np.asarray, jts.params))
    got = _displacement(tr.model.state_dict(), p0)
    want = _displacement(jp, jp0)
    for k in want:
        w, g = want[k].numpy(), got[k].numpy()
        tol = (1e-4 * np.abs(w) + 1e-5 * np.abs(w).max()
               + 2.0 ** -22 * np.abs(jp[k].numpy()))
        bad = np.abs(g - w) > tol
        assert not bad.any(), (k, np.argwhere(bad)[0], g[bad][0], w[bad][0])
    assert max(float(v.abs().max()) for v in got.values()) > 0
    for k in ("pg_loss", "v_loss", "entropy", "ratio"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(tm["mean_reward"]),
                               float(jm["mean_reward"]), rtol=1e-6)
    assert int(tm["episodes"]) == int(jm["episodes"]) > 0
    assert int(tm["wins"]) == int(jm["wins"])


def test_update_sharded_is_not_ported():
    jtr, jts, tr, ts = trainer_pair(MAP, n=2, steps=1, opponent="PassiveAI",
                                    tx="sgd", seed=0, minibatches=1)
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        tr.update_sharded(ts)
