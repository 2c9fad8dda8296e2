"""RandomBiasedSingleUnitAI and the state ``snapshot`` of the port (plain
path on the CPU) vs the JAX package.

``random_biased_single_unit_bot`` on recorded random-bot states of two
8x8 maps, for both players, with the uniforms JAX's bot draws from its
per-env keys (``k0, k1 = split(key)``: RandomBiasedAI's ``uniform(k0,
(H, W, 2))``, the unit pick's ``uniform(k1, (H, W))``) handed to the
port; ``snapshot`` of every env of those batches.  Tolerance: exact.
"""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu.bots.scripted import (
    random_biased_single_unit_bot as jax_single_unit_bot)
from microrts_tpu.engine.types import snapshot as jax_snapshot
from microrts_tpu_torch.bots.scripted import (SingleUnitNoise,
                                              random_biased_single_unit_bot)
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.engine.types import snapshot

from torch_parity import assert_eq, envs, jax_state, port_trajectory

MAPS = ["maps/8x8/basesWorkers8x8.xml", "maps/8x8/melee8x8Mixed6.xml"]
B = 6


@pytest.fixture(scope="module", params=MAPS, ids=lambda m: m.split("/")[-1])
def case(request):
    jenv, env = envs(request.param)
    traj = port_trajectory(env, B, 41, seed=5, keep={0, 20, 40})
    return jenv, env, [traj[t] for t in (0, 20, 40)]


def test_single_unit_bot_matches_jax(case):
    jenv, env, states = case
    H, W = env.h, env.w
    jbot = jax.jit(jax.vmap(jax_single_unit_bot(jenv), in_axes=(0, None, 0)))

    def noise(k):
        k0, k1 = jax.random.split(k)
        return (jax.random.uniform(k0, (H, W, 2)),
                jax.random.uniform(k1, (H, W)))
    draws = jax.jit(jax.vmap(noise))
    bot = random_biased_single_unit_bot(env)
    key = jax.random.PRNGKey(7)
    acted = 0
    for i, s in enumerate(states):
        for p in (0, 1):
            key, k = jax.random.split(key)
            keys = jax.random.split(k, B)
            u, r = (torch.from_numpy(np.array(x)) for x in draws(keys))
            got = bot(s, p, SingleUnitNoise(u, r))
            assert_eq(jbot(jax_state(s), p, keys), got, f"state {i} p{p}")
            n = (got != 0).any(-1).sum((1, 2))
            assert (n <= 1).all()
            acted += int(n.sum())
    assert acted > 0
    opp = make_bot("RandomBiasedSingleUnitAI", env)
    gen = torch.Generator()
    nz = opp.draw(gen, B)
    assert nz.u.shape == (B, H, W, 2) and nz.r.shape == (B, H, W)
    assert opp(states[1], 0, nz).shape == (B, H, W, 7)


def test_snapshot_matches_jax(case):
    jenv, env, states = case
    for s in states:
        js = jax_state(s)
        for b in range(B):
            one = jax.tree.map(lambda x: x[b], js)
            assert snapshot(s, b) == jax_snapshot(one), b
