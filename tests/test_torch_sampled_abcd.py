"""SampledABCD (bots/minimax.py) of the port's plain path against the
JAX package's on 4 recorded 8x8 games, each player a case, on JAX's
RandomBiasedAI uniforms for the candidates (tests/torch_minimax_parity.py;
JAX's bot runs eagerly under ``vmap`` around its jitted parts): the
maximin values within 1e-6 relative and the actions equal in every game
whose top two values are more than 1e-6 apart (the margins are
printed); at least one game is held.  K 4, WorkerRush playouts of 8
ticks."""

import numpy as np
import pytest
import jax

from microrts_tpu_torch.bots import minimax as MM

from torch_minimax_parity import (games, held_games, jax_sampled,
                                  sampled_uniforms)
from torch_parity import assert_eq, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SAMPLED_KW = dict(k_moves=4, playout_len=8)


@pytest.mark.parametrize("player", [0, 1])
def test_sampled_abcd_matches_jax(player):
    _, env, s = games()
    keys = jax.random.split(jax.random.PRNGKey(70 + player), s.batch)
    ja, jval = jax_sampled(SAMPLED_KW, s, player, keys)
    u = sampled_uniforms(keys, SAMPLED_KW["k_moves"], env.h, env.w)
    bot = MM.sampled_abcd_bot(env, **SAMPLED_KW)
    _, V = bot.bot.values(s, player, u)
    val = V.amin(2).numpy()
    np.testing.assert_allclose(val, jval, rtol=1e-6, atol=0)
    held = held_games("SampledABCD", val, player)
    assert_eq(ja[held], bot(s, player, u).numpy()[held], "action")
