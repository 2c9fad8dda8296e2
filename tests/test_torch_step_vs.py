"""``GridnetEnv.step_vs`` (an external player-0 action against a scripted
opponent, JNIGridnetClient.gameStep) of the port's plain path against the
JAX package's for 16 steps of 8 envs on basesWorkers8x8, RandomBiasedAI
actions for player 0 (the same int actions into both) and WorkerRush as
the opponent: states bit-equal, player 0's rewards within 1e-6, dones
equal."""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu.bots import scripted as JS
from microrts_tpu_torch.bots.scripted import random_bot, worker_rush

from torch_parity import (assert_eq, assert_state_eq, envs, jax_state,
                          port_trajectory, torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"


def test_step_vs_matches_jax():
    jenv, env = envs(MAP)
    jrush = JS.worker_rush(jenv)
    key = jax.random.PRNGKey(0)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step_vs(
        s, a, lambda st, p: jrush(st, p, key))))
    s = port_trajectory(env, 8, 5, 11, {4})[4]
    js = jax_state(s)
    bot, rush = random_bot(env, 5.0), worker_rush(env)
    rng = np.random.default_rng(3)
    acted = 0
    for t in range(16):
        u = torch.from_numpy(rng.random((8, env.h, env.w, 2),
                                        dtype=np.float32))
        a0 = bot(s, 0, u)
        js, jr, jd = jstep(js, np.asarray(a0.numpy()))
        s, r, d = env.step_vs(s, a0, lambda st, p: rush(st, p))
        assert_state_eq(js, s, f"step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-6)
        assert_eq(jd, d, f"step {t} done")
        acted += int((s.busy & (s.owner == 1)).sum())
    assert acted > 0
