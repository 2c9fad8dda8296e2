"""The ``closertoenemybase`` / ``closertoenemyunit`` rewards of the port
(plain path on the CPU) vs the JAX package's ``_closer_reward``.

Each step of a WorkerRush-vs-LightRush trajectory on basesWorkers8x8 and
of a random-bot trajectory on melee4x4light2 (no base on the board) is
scored by both packages from the same pre- and post-step states, for
both players; the 8x8 steps are scored again with player 1's base
removed from both boards (no enemy base for player 0) and with player
0's mobile units removed from the post board (no distance: reward 0).
Tolerance: float32 equality (both compute one correctly rounded sqrt per
unit and one subtraction; expected difference 0).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.env.gridnet import REWARD_NAMES

from torch_parity import (BIAS, assert_eq, envs, jax_state,
                          torch_one_thread)  # noqa: F401

NAMES = ("closertoenemybase", "closertoenemyunit")


def jax_closer(jenv):
    """Jitted JAX ``_closer_reward`` of both names and both players:
    float32 ``[B, 2, 2]`` (player, name)."""
    def one(pre, post):
        return jnp.stack([jnp.stack([jenv._closer_reward(n, pre, post, p)
                                     for n in NAMES]) for p in (0, 1)])
    return jax.jit(jax.vmap(one))


def port_closer(env, pre, post):
    return torch.stack([torch.stack([env._closer_reward(n, pre, post, p)
                                     for n in NAMES], 1) for p in (0, 1)], 1)


def without(s, mask):
    """``s`` with the units under bool ``mask`` removed."""
    return s.replace(utype=torch.where(mask, 0, s.utype).to(s.utype.dtype),
                     owner=torch.where(mask, -1, s.owner).to(s.owner.dtype))


def check(jfn, env, pre, post, where):
    got = port_closer(env, pre, post)
    assert_eq(jfn(jax_state(pre), jax_state(post)), got, where)
    return got


@pytest.mark.parametrize("map_rel,rush", [
    ("maps/8x8/basesWorkers8x8.xml", True),
    ("maps/melee4x4light2.xml", False)],
    ids=["basesWorkers8x8-rush", "melee4x4light2-random"])
def test_closer_rewards_match_jax(map_rel, rush, torch_one_thread):
    jenv, env = envs(map_rel, reward_fns=REWARD_NAMES)
    jfn = jax_closer(jenv)
    B = 4
    s = env.reset(B)
    rng = np.random.default_rng(1)
    if rush:
        bots = (make_bot("WorkerRush", env), make_bot("LightRush", env))
        act = [lambda s, p=p: bots[p](s, p) for p in (0, 1)]
    else:
        rb = random_bot(env, BIAS)
        act = [lambda s, p=p: rb(s, p, torch.from_numpy(
            rng.random((B, env.h, env.w, 2), dtype=np.float32)))
            for p in (0, 1)]
    base_id = env.cfg.base_id
    nonzero = [0, 0]
    for t in range(120):
        post, r, _ = env.step(s, act[0](s), act[1](s))
        got = check(jfn, env, s, post, f"step {t}")
        assert torch.equal(r[..., 6:], got), f"step {t}: env.step's rewards"
        nonzero[0] += int((got[..., 0] != 0).sum())
        nonzero[1] += int((got[..., 1] != 0).sum())
        if rush:
            base1 = [(x.utype - 1 == base_id) & (x.owner == 1)
                     for x in (s, post)]
            got = check(jfn, env, without(s, base1[0]),
                        without(post, base1[1]), f"no base, step {t}")
            assert (got[:, 0, 0] == 0).all()
            mobile0 = (post.owner == 0) & (post.utype - 1 != base_id)
            got = check(jfn, env, s, without(post, mobile0),
                        f"no mobile unit, step {t}")
            assert (got[:, 0] == 0).all()
        s = post
    if rush:
        assert nonzero[0] > 0 and nonzero[1] > 0, nonzero
    else:
        assert nonzero[0] == 0 and nonzero[1] > 0, nonzero
