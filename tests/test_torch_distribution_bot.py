"""``distribution_bot`` (UnitActionProbabilityDistributionAI with fixed
type weights) against the JAX package's on the CPU with JAX's draws, and
the port's registry of the JAX package's 54 names.

The type draw is ``argmax(log(w + 1e-9) + gumbel)`` in both packages: a
unit's action is held equal where the winner leads by at least 1e-6 (the
units below are counted); everything else is integer.
"""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu.bots import scripted as JS
from microrts_tpu.config import JAVA_AI_ALIASES as JAX_ALIASES
from microrts_tpu_torch.bots.scripted import (DistributionNoise, Opponent,
                                              distribution_bot)
from microrts_tpu_torch.bots.believestate import StatefulBot
from microrts_tpu_torch.config import (JAVA_AI_ALIASES, LEARNED_BOTS,
                                       PORTED_BOTS, _NOT_PORTED, make_bot)

from torch_parity import assert_eq, jax_state, torch_one_thread  # noqa
from torch_playout_parity import recorded

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MARGIN = 1e-6
WEIGHTS = [(1.0, 2.0, 3.0, 3.0, 1.5, 4.0), (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)]


@pytest.mark.parametrize("weights", WEIGHTS)
def test_distribution_bot_equals_jax(weights):
    """Recorded 8x8 states, both players and a per-env player vector:
    the actions equal JAX's from the same keys (the type draw's Gumbels
    from ``k1``, RandomAI's uniforms from ``k2``); a weight vector with
    no legal type falls back to uniform over the legal types."""
    jenv, env, s = recorded("maps/8x8/basesWorkers8x8.xml")
    jbot = jax.jit(jax.vmap(JS.distribution_bot(jenv, weights),
                            in_axes=(0, None, 0)))
    keys = jax.random.split(jax.random.PRNGKey(4), s.batch)
    ks = jax.vmap(jax.random.split)(keys)
    gum = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (env.h, env.w, 6)))(ks[:, 0])))
    u = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, (env.h, env.w, 2)))(ks[:, 1])))
    bot = distribution_bot(env, weights)
    js = jax_state(s)
    held = 0
    for p in (0, 1):
        got = bot(s, p, DistributionNoise(gum, u))
        mask = env.masks(s, p)
        tw = torch.where(mask[..., 1:7].bool(), torch.tensor(weights), 0.0)
        tw = torch.where(tw.sum(-1, keepdim=True) > 0, tw, 1.0)
        x = (torch.log(tw + 1e-9) + gum).double()
        top = x.amax(-1, keepdim=True)
        gap = top[..., 0] - torch.where(x < top, x, -np.inf).amax(-1)
        keep = (gap >= MARGIN) | ~mask[..., 0].bool()
        assert_eq(np.asarray(jbot(js, p, keys))[keep.numpy()], got[keep],
                  f"p{p}")
        held += int((keep & mask[..., 0].bool()).sum())
    assert held > 0
    nz = bot.draw(torch.Generator().manual_seed(0), 3)
    assert nz.gumbel.shape == (3, env.h, env.w, 6)
    assert nz.u.shape == (3, env.h, env.w, 2)


def test_registry_builds_45_names_and_refuses_9():
    """Of the JAX registry's 54 names, the port builds 45 (the learned
    models among them) and refuses 9, each citing ROADMAP item 10."""
    env = recorded("maps/8x8/basesWorkers8x8.xml")[1]
    assert JAVA_AI_ALIASES == JAX_ALIASES
    assert len(PORTED_BOTS) == 45 and len(_NOT_PORTED) == 9
    assert not set(PORTED_BOTS) & set(_NOT_PORTED)
    for name in LEARNED_BOTS:
        bot = make_bot(name, env)
        assert isinstance(bot, Opponent), name
    for name in list(_NOT_PORTED) + [j for j, n in JAVA_AI_ALIASES.items()
                                     if n in _NOT_PORTED]:
        with pytest.raises(NotImplementedError, match="item 10"):
            make_bot(name, env)
    built = [n for n in PORTED_BOTS
             if isinstance(make_bot(n, env), (Opponent, StatefulBot))]
    assert len(built) == 45
