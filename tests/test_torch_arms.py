"""The arm catalog (``microrts_tpu_torch.ops.arms``) against the JAX
package's ``ops.arms`` on recorded 8x8 and 16x16 states (RandomBiasedAI
self-play with busy, idle and terminal lanes), both players: the arm
legality from ``legal_masks`` and from the env's packed 79-channel mask
(produce pairs as the outer product of produce dir and produce type),
``sample_arms`` with JAX's Gumbels, ``arms_to_action``,
``action_to_arms`` and its round trip, ``one_hot_arms``.  Tolerance:
exact."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.ops import arms as JA
from microrts_tpu_torch.ops import arms as AR

from torch_parity import assert_eq, jax_state, torch_one_thread  # noqa: F401
from torch_playout_parity import recorded

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAPS = ["maps/8x8/basesWorkers8x8.xml", "maps/16x16/basesWorkers16x16.xml"]


@functools.lru_cache(maxsize=None)
def _jax_fns(jenv):
    sp = JA.arm_space(jenv)
    H, W = jenv.h, jenv.w
    v = jax.vmap

    def legal(s, p):
        m = jenv.engine.legal_masks(s, p)
        return JA.arm_masks(sp, m), m["can_act"]

    def sample(k, la, can):
        g = jax.random.gumbel(k, (H, W, sp.n_arms))
        return JA.sample_arms(sp, k, la.astype(jnp.float32), can), g

    return dict(
        legal=jax.jit(v(legal, in_axes=(0, None))),
        sample=jax.jit(v(sample)),
        to_action=jax.jit(v(lambda a: JA.arms_to_action(sp, a))),
        to_arms=jax.jit(v(lambda a, ac: JA.action_to_arms(sp, a, ac))),
        one_hot=jax.jit(v(lambda a: JA.one_hot_arms(sp, a))))


@pytest.mark.parametrize("map_rel", MAPS, ids=lambda m: m.split("/")[-1])
def test_arm_catalog_matches_jax(map_rel):
    jenv, env, s = recorded(map_rel)
    f = _jax_fns(jenv)
    sp = AR.arm_space(env)
    assert sp.n_arms == JA.arm_space(jenv).n_arms == 90
    js = jax_state(s)
    for p in (0, 1):
        jla, jcan = f["legal"](js, p)
        m = env.engine.legal_masks(s, p)
        la = AR.arm_masks(sp, m)
        assert_eq(jla, la, f"arm_masks p{p}")
        assert_eq(jla, AR.arm_masks_packed(sp, env.masks(s, p)),
                  f"arm_masks from the packed mask p{p}")
        keys = jax.random.split(jax.random.PRNGKey(p), s.batch)
        jarms, g = f["sample"](keys, jla, jcan)
        arms = AR.sample_arms(sp, torch.from_numpy(np.array(g)),
                              la.to(torch.float32), m["can_act"])
        assert_eq(jarms, arms, f"sample_arms p{p}")
        assert (arms > 0).any() and (arms < 0).any()
        act = AR.arms_to_action_plain(sp, arms)
        assert_eq(f["to_action"](jarms), act, f"arms_to_action p{p}")
        assert_eq(f["to_arms"](f["to_action"](jarms), jcan),
                  AR.action_to_arms(sp, act, m["can_act"]),
                  f"action_to_arms p{p}")
        # round trip: NONE arms (0) survive, non-acting cells stay -1
        assert torch.equal(AR.action_to_arms(sp, act, arms >= 0), arms)
        assert_eq(f["one_hot"](jarms), AR.one_hot_arms(sp, arms),
                  f"one_hot_arms p{p}")
        # every sampled arm is legal
        oh = AR.one_hot_arms(sp, arms)
        assert bool((~oh | la).all())


def test_arms_to_action_covers_every_arm():
    """Every arm index of the catalog decodes as JAX decodes it."""
    jenv, env, _ = recorded(MAPS[1])
    f = _jax_fns(jenv)
    sp = AR.arm_space(env)
    arms = torch.arange(-1, sp.n_arms, dtype=torch.int32)
    plane = torch.full((1, env.h * env.w), -1, dtype=torch.int32)
    plane[0, :arms.numel()] = arms
    plane = plane.reshape(1, env.h, env.w)
    assert_eq(f["to_action"](jnp.asarray(plane.numpy())),
              AR.arms_to_action_plain(sp, plane), "arms_to_action")
