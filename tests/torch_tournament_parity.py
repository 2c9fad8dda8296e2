"""Helpers of the tournament parity tests: the JAX package's game loop
(``eval/tournament.py`` ``chunk_fn``, :81-107) as a Python loop of its
jitted pieces, and the per-frame draws of its key tree handed to the
port's runner as its ``noise`` source.

JAX's ``play_matches`` compiles for minutes on a CPU (its only test is
marked heavy), so the reference follows ``chunk_fn`` line by line:
``fast_forward`` (jitted with ``max_events=1`` and applied twice: its
unrolled default), the winner of lanes finished there, the time cap, the
keys' ``split(k, 3)``, both bots (every pool bot on every lane, each lane
taking its own bot's action: what ``lax.switch`` computes), ``env.step``
(gridnet.py:385-392: decode, ``issue_env``, decode, ``issue_env``,
``cycle``, each jitted and vmapped; the step's rewards change no state
and are left out), the winner of lanes finished by the step and the
select that freezes finished lanes."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.config import make_bot as jax_make_bot
from microrts_tpu.ops import playout as JPO

from torch_parity import jax_fns
from torch_playout_parity import patched_envs
from torch_rollout_parity import _draws


def _sizes(jenv):
    ecfg = jenv.cfg.engine
    return (6, 4, 4, 4, 4, ecfg.num_types, (2 * ecfg.max_range + 1) ** 2)


@functools.lru_cache(maxsize=None)
def _pieces(jenv, max_cycles):
    v = jax.vmap
    te = jnp.int32(max_cycles)
    return dict(
        ff=jax.jit(v(lambda s, d: JPO.fast_forward(jenv, s, d, t_end=te,
                                                   max_events=1))),
        winner=jax.jit(v(jenv.engine.winner)),
        split3=jax.jit(v(lambda k: jax.random.split(k, 3))),
        uniform=jax.jit(v(lambda k: jax.random.uniform(
            k, (jenv.h, jenv.w, 2)))),
        freeze=jax.jit(lambda m, old, new: jax.tree.map(
            lambda a, b: jnp.where(m.reshape((-1,) + (1,) * (a.ndim - 1)),
                                   a, b), old, new)))


@functools.lru_cache(maxsize=None)
def named_bot(jenv, name):
    """(JAX bot ``name`` vmapped over lanes and jitted, what it draws)."""
    kind = "uniform" if name in ("RandomBiasedAI", "RandomAI") else None
    return (jax.jit(jax.vmap(jax_make_bot(name, jenv), in_axes=(0, None, 0))),
            kind)


def jax_games(map_rel, names, i, j, keys, max_cycles):
    """JAX's games of pool ``names`` (lanes play ``names[i]`` vs
    ``names[j]``) from per-lane ``keys``: see ``jax_bot_games``."""
    jenv, _ = patched_envs(map_rel)
    return jax_bot_games(jenv, [named_bot(jenv, n) for n in names], i, j,
                         keys, max_cycles)


def jax_bot_games(jenv, bots, i, j, keys, max_cycles):
    """JAX's games of the pool ``bots`` ([(bot vmapped over lanes, what it
    draws: None, "uniform" or "gumbel" (the 7 categoricals of
    ``sample_action``))]) from per-lane ``keys``.  Returns (winners numpy
    int32, final JAX State, noise): ``noise(frame, player, bot, lanes)``
    gives the port what each frame's keys draw for that bot."""
    f = _pieces(jenv, max_cycles)
    fns = jax_fns(jenv)
    kinds = [k for _, k in bots]
    bots = [b for b, _ in bots]

    def step(s, a0, a1):
        s1 = fns.issue_env(s, fns.decode(s, a0, 0)[0])
        s2 = fns.issue_env(s1, fns.decode(s1, a1, 1)[0])
        return fns.cycle(s2)

    B = len(i)
    s = jax.vmap(jenv.reset)(keys)
    done = jnp.zeros(B, bool)
    winner = jnp.full(B, -1, jnp.int32)
    frame_keys = []
    for _ in range(max_cycles):
        s, d_ff = f["ff"](s, done)
        s, d_ff = f["ff"](s, d_ff)
        winner = jnp.where(done, winner, jnp.where(d_ff, f["winner"](s), -1))
        done = done | d_ff | (s.time >= max_cycles)
        ks = f["split3"](keys)
        keys, k0, k1 = ks[:, 0], ks[:, 1], ks[:, 2]
        frame_keys.append((k0, k1))
        a = []
        for player, pool, k in ((0, i, k0), (1, j, k1)):
            acts = [b(s, player, k) for b in bots]
            a.append(jnp.stack(acts)[np.asarray(pool), np.arange(B)])
        s2, done2 = step(s, a[0], a[1])
        s = f["freeze"](done, s, s2)
        winner = jnp.where(done, winner,
                           jnp.where(done2, f["winner"](s2), -1))
        done = done | done2
        if bool(done.all()):     # later frames change nothing
            break

    gumbels = _draws(jenv.h, jenv.w, _sizes(jenv))[1]

    @functools.lru_cache(maxsize=None)
    def draws(frame, player, kind):
        k = frame_keys[min(frame, len(frame_keys) - 1)][player]
        # after the last frame every lane is finished: any draws will do
        return torch.from_numpy(np.array(
            f["uniform"](k) if kind == "uniform" else gumbels(k)))

    def noise(frame, player, bot, lanes):
        if kinds[bot] is None:
            return None
        u = draws(frame, player, kinds[bot])
        return u if lanes is None else u[lanes]

    return np.asarray(winner), s, noise
