"""The port's policy-driven rollout (``microrts_tpu_torch.train.ppo``,
plain path on the CPU) vs the JAX package's ``PPOTrainer._rollout``.

Both trainers start from the same envs and the same fp32 policy
parameters (flax's, through ``params_from_flax``); the port is handed the
noise JAX's key tree draws: ``base = fold_in(key, update_count)``,
``env_key = fold_in(base, i)``, per step ``split(k, 3)`` -> (sample,
opponent, carry), the sample key split in 7 for the components' gumbels,
the opponent's ``uniform(okey, (H, W, 2))`` (RandomBiasedAI) or, in
self-play, its own 7 gumbels.  JAX's ``lax.scan`` over the steps runs as a
Python loop and the env's parts are jitted one by one (compiling the whole
scan takes minutes on a CPU).  The 16x16 case at full width is in
test_torch_rollout_16x16.py, so that each file stays under a minute.

Tolerances: obs, mask, action, reward, done, wins and every plane of the
final states exact; per-env logprob 1e-5 relative; value 1e-4 absolute.
The model is fp32 so that actions can be held exact: the test also
asserts that the smallest top-2 margin of masked logits + gumbel over the
sampled cells exceeds the largest logit difference between the packages,
so an action mismatch is a fault, not a near-tie.

Also: a terminal (gameover) env through the port's epilogue plain
functions, against JAX's ``_rewards``/``dones``/``VecGridnetEnv.step``.
"""

import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.env.vec import VecGridnetEnv as JaxVec
from microrts_tpu_torch.env.vec import VecGridnetEnv

from torch_parity import (assert_eq, assert_state_eq, envs, jax_fns,
                          jax_state, port_trajectory)
from torch_rollout_parity import check_pair, run_pair


def test_rollout_8x8_random_opponent_with_resets():
    """basesWorkers8x8, 4 envs, 4 steps, RandomBiasedAI opponent,
    max_steps 3: every env auto-resets at the third step."""
    r = run_pair("maps/8x8/basesWorkers8x8.xml", n=4, steps=4, max_steps=3,
                 selfplay=False, seed=0)
    check_pair(r)
    assert r["traj"].done[2].all() and not r["traj"].done[:2].any()
    assert (r["traj"].action[..., 0] > 0).any()


def test_rollout_8x8_selfplay():
    r = run_pair("maps/8x8/basesWorkersBarracks8x8.xml", n=4, steps=2,
                 max_steps=50, selfplay=True, seed=1)
    check_pair(r)


# ----------------------------------------------------------------------
# terminal envs through the epilogue

def _kill_player(s, env, player, batch_rows):
    """The State with every unit of ``player`` removed in the given envs."""
    utype, owner = s.utype.clone(), s.owner.clone()
    for b in batch_rows:
        gone = owner[b] == player
        utype[b][gone] = 0
        owner[b][gone] = -1
    return s.replace(utype=utype, owner=owner)


@pytest.mark.parametrize("map_rel", ["maps/8x8/basesWorkers8x8.xml",
                                     "maps/8x8/melee8x8Mixed6.xml"])
def test_epilogue_terminal_envs(map_rel):
    """A gameover in the step: rewards (winloss +-1), dones and the reset
    splice of VecGridnetEnv.step against JAX, with one env where player 1
    has lost, one where player 0 has lost, and one still playing."""
    jenv, env = envs(map_rel)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    n = 4
    s = port_trajectory(env, n, 12, seed=4, keep={11})[11]
    # player 1 has one unit left in env 0, player 0 none in env 1
    s = _kill_player(s, env, 0, [1])
    u, o = s.utype.clone(), s.owner.clone()
    cells = (o[0] == 1).nonzero()
    for y, x in cells[1:]:
        u[0, y, x], o[0, y, x] = 0, -1
    s = s.replace(utype=u, owner=o)
    steps = torch.tensor([3, 0, 7, 1], dtype=torch.int32)
    a = torch.zeros((n, env.h, env.w, 7), dtype=torch.int32)
    js = jax_state(s)
    jvec = JaxVec(jenv, n, max_steps=8)
    vec = VecGridnetEnv(env, n, max_steps=8)
    jout = jvec.step(js, jnp.asarray(steps.numpy()), jnp.asarray(a.numpy()),
                     jnp.asarray(a.numpy()))
    out = vec.step(s, steps, a, a, onehot=(0, 1))
    assert_state_eq(jout[0], out[0], "spliced")
    for name, x, y in zip(("steps", "obs", "rewards", "dones", "reset"),
                          jout[1:], out[1:]):
        assert_eq(x, y, name)
    assert out[5][1] and out[5][2]      # p0 lost; max_steps reached
    win = env.cfg.reward_fns.index("winloss")
    assert out[3][1, 0, win] == -1 and out[3][1, 1, win] == 1
    for i, p in enumerate((0, 1)):
        assert_eq(jax.vmap(lambda x: jenv.observation_onehot(x, p))(
            jout[0]), out[6][i], f"onehot p{p}")
    # dones on the post-step state alone
    post = env.step(s, a, a)[0]
    assert_eq(jax.vmap(jenv.dones)(jax_state(post)), env.dones(post), "dones")
