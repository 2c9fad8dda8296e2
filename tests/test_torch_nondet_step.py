"""UTT v3's random damage through the port's env steps (plain path on the
CPU) against the JAX package, JAX's own draws fed in: ``GridnetEnv.step``
with ``frame_skip=2`` and all eight rewards, and ``step_vs`` against a
passive opponent (the uniforms of ``uniform(split(key)[1], (H, W))`` per
env and cycle).  Tolerance: exact, every plane, reward and done.
"""

import jax
import torch

from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.env.gridnet import REWARD_NAMES

from torch_nondet_parity import MELEE, cycle_u01, v3_envs, with_keys
from torch_parity import (BIAS, assert_eq, assert_state_eq, draw, jax_fns,
                          torch_one_thread)  # noqa: F401

B = 6


def test_step_frame_skip_matches_jax(torch_one_thread):
    """``GridnetEnv.step`` under v3 with ``frame_skip=2`` and all eight
    rewards, both packages stepping their own states from JAX's random
    bots' draws: states, rewards and dones equal at every step."""
    jenv, env = v3_envs("maps/8x8/melee8x8Mixed6.xml", frame_skip=2,
                        reward_fns=REWARD_NAMES)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    bot = random_bot(env, BIAS)
    s = env.reset(B)
    js = with_keys(s, jax.random.split(jax.random.PRNGKey(5), B))
    key = jax.random.PRNGKey(9)
    step = jax.vmap(jenv.step)
    closer = 0
    for t in range(24):
        key, k0, k1 = jax.random.split(key, 3)
        (ks0, u0), (ks1, u1) = draw(fns, k0, B), draw(fns, k1, B)
        k1s, ua = cycle_u01(js.key, env.h, env.w)
        _, ub = cycle_u01(k1s, env.h, env.w)
        js, jr, jd = step(js, fns.bot(js, 0, ks0), fns.bot(js, 1, ks1))
        s, tr, td = env.step(s, bot(s, 0, torch.from_numpy(u0)),
                             bot(s, 1, torch.from_numpy(u1)),
                             u01=torch.stack([ua, ub]))
        assert_state_eq(js, s, f"step {t}")
        assert_eq(jr, tr, f"rewards step {t}")
        assert_eq(jd, td, f"done step {t}")
        closer += int((tr[..., 6:] != 0).sum())
    assert closer > 0


def test_step_vs_matches_jax(torch_one_thread):
    """``GridnetEnv.step_vs`` under v3 (one cycle, its uniforms from the
    key) with RandomBiasedAI's actions for player 0 against a passive
    opponent: states, player 0's rewards and dones equal at every step;
    ``gen`` draws when no uniforms are given."""
    jenv, env = v3_envs(MELEE, reward_fns=REWARD_NAMES)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    bot = random_bot(env, BIAS)
    s = env.reset(B)
    js = with_keys(s, jax.random.split(jax.random.PRNGKey(6), B))
    key = jax.random.PRNGKey(8)
    none = jax.numpy.zeros((env.h, env.w, 7), jax.numpy.int32)
    step_vs = jax.vmap(lambda st, a: jenv.step_vs(st, a,
                                                  lambda st1, p: none))

    def passive(st, p):
        return torch.zeros((st.batch, env.h, env.w, 7), dtype=torch.int32)
    for t in range(8):
        key, k0 = jax.random.split(key)
        ks0, u0 = draw(fns, k0, B)
        _, u01 = cycle_u01(js.key, env.h, env.w)
        js, jr, jd = step_vs(js, fns.bot(js, 0, ks0))
        s, tr, td = env.step_vs(s, bot(s, 0, torch.from_numpy(u0)), passive,
                                u01=u01[None])
        assert_state_eq(js, s, f"step {t}")
        assert_eq(jr, tr, f"rewards step {t}")
        assert_eq(jd, td, f"done step {t}")
    out = env.step_vs(s, bot(s, 0, torch.from_numpy(u0)), passive,
                      gen=torch.Generator())
    assert out[1].shape == (B, len(REWARD_NAMES))
