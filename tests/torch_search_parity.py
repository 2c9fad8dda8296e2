"""Helpers of the search-bot parity tests: recorded 8x8 games, the JAX
package's search bots run eagerly under ``vmap`` around the env's jitted
parts and a jitted RandomBiasedAI, and the uniforms JAX's key tree draws
for them, laid out as the port's ``MCNoise``, ``NaiveNoise`` and
``UCTNoise``.  (Jitting a whole JAX search bot takes minutes of CPU
compile; the eager run takes tens of seconds.)"""

import functools

import numpy as np
import jax
import torch

from microrts_tpu.bots import search as JSE
from microrts_tpu_torch.bots import search as SE
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State

from torch_parity import assert_eq, jax_state
from torch_playout_parity import (eager_loops, jax_random_bot, playout_noise,
                                  recorded)

MAP = "maps/8x8/basesWorkers8x8.xml"
L, N_DEC = 8, 2


@functools.lru_cache(maxsize=None)
def games():
    """Six recorded games in which both players have idle units."""
    jenv, env, s = recorded(MAP)
    rows = [i for i in range(s.batch)
            if all(bool(((s.utype[i] > 0) & (s.owner[i] == p)
                         & ~s.busy[i]).any()) for p in (0, 1))][:6]
    idx = torch.tensor(rows)
    return jenv, env, State(**{f: getattr(s, f)[idx] for f in FIELD_DTYPES})


def jax_bot(make, jenv, **kw):
    """A JAX search bot built with a jitted RandomBiasedAI (the same
    function) and run eagerly under vmap over games."""
    real = JSE.random_bot
    JSE.random_bot = lambda env, bias: jax_random_bot(env, bias)
    try:
        bot = make(jenv, playout_len=L, n_decisions=N_DEC, **kw)
    finally:
        JSE.random_bot = real

    def run(js, player, keys):
        with eager_loops():
            return np.asarray(jax.vmap(bot, in_axes=(0, None, 0))(
                js, player, keys))
    return run


def uniform(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, shape))(keys)))


def split(keys, n):
    """``[..., 2]`` keys -> ``[..., n, 2]``."""
    flat = keys.reshape(-1, 2)
    return jax.vmap(lambda k: jax.random.split(k, n))(flat).reshape(
        keys.shape[:-1] + (n, 2))


def first_tick(keys, h, w):
    """``k0, key = split(k)``: the opponent's uniforms and the playout's
    (``[n_dec, 2, L, H, W, 2]``) for keys ``[L, 2]``."""
    ks = split(keys, 2)
    return (uniform(ks[:, 0], (h, w, 2)),
            playout_noise(ks[:, 1], N_DEC, h, w))


def mc_noise(keys, K, n_eval, h, w):
    ks = split(keys, K + 1)                          # [B, K+1, 2]
    cand = uniform(ks[:, :K].reshape(-1, 2), (h, w, 2))
    vk = split(ks[:, K], K)                          # [B, K, 2]
    ek = split(vk, n_eval).reshape(-1, 2)            # lane (b*K+k)*n+e
    opp, play = first_tick(ek, h, w)
    return SE.MCNoise(cand, opp, play)


def rounds(rkeys, h, w):
    """Per round keys ``[B, R, 2]`` -> (opp ``[R, B, H, W, 2]``, play
    ``[R, n_dec, 2, B, H, W, 2]``)."""
    out = [first_tick(rkeys[:, r], h, w) for r in range(rkeys.shape[1])]
    return (torch.stack([o for o, _ in out]), torch.stack([p for _, p in out]))


def naive_noise(keys, R, h, w):
    rk = split(keys, R)                              # [B, R, 2]
    k3 = split(rk, 3)                                # [B, R, 3, 2]
    fresh = torch.stack([uniform(k3[:, r, 0], (h, w, 2)) for r in range(R)])
    explore = torch.stack([uniform(k3[:, r, 1], (h, w, 1))
                           for r in range(R)])
    opp, play = rounds(k3[:, :, 2], h, w)
    return SE.NaiveNoise(fresh, explore, opp, play)


def uct_noise(keys, K, R, h, w):
    kc = split(keys, 2)                              # [B, 2, 2]
    cand = uniform(split(kc[:, 0], K).reshape(-1, 2), (h, w, 2))
    opp, play = rounds(split(kc[:, 1], R), h, w)
    return SE.UCTNoise(cand, opp, play)


def check_monte_carlo(player, n_eval, K=3):
    """``monte_carlo_bot``'s actions equal to JAX's on ``games()``."""
    jenv, env, s = games()
    jbot = jax_bot(JSE.monte_carlo_bot, jenv, n_candidates=K, n_eval=n_eval)
    bot = SE.monte_carlo_bot(env, n_candidates=K, playout_len=L,
                             n_eval=n_eval, n_decisions=N_DEC)
    keys = jax.random.split(jax.random.PRNGKey(10 + player), s.batch)
    want = jbot(jax_state(s), player, keys)
    got = bot(s, player, mc_noise(keys, K, n_eval, env.h, env.w))
    assert_eq(want, got, f"monte_carlo_bot p{player} n_eval {n_eval}")
    assert (got[..., 0] > 0).any()
