"""Helpers of the synthesis parity tests.  JAX's ``evaluate_population``
and ``probe_states`` jit a whole vmapped game loop with ``lax.switch``
over the programs (over a minute of CPU compile on 4x4, again for every
population), so the JAX side here follows them line by line
(search.py:97-126, clean.py:148-170) with jitted pieces: each program
and opponent vmapped over the lanes with a per-lane player (one compile
each at XLA's lowest optimization level), JAX's env step as its decode,
``issue_env`` and ``cycle`` jitted and vmapped (gridnet.py:384-395),
``lax.switch`` as a per-lane select, ``lax.scan`` as a
Python loop.  JAX's own ``synthesize``, ``clean_program`` and
``shrink_program`` then run with these stand-ins monkeypatched in."""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from microrts_tpu.config import make_bot as jax_make_bot
from microrts_tpu.synth import dsl as JD
from microrts_tpu_torch.config import make_bot

from torch_dsl_parity import _jit_fast
from torch_parity import envs, jax_fns

# melee4x4light2: the games end within a cut max_cycles
MAP = "maps/melee4x4light2.xml"
OPPONENTS = ("WorkerRush", "LightRush")


@functools.lru_cache(maxsize=None)
def synth_pair():
    """(JAX env, its OPPONENTS, port env on the CPU, its OPPONENTS)."""
    jenv, env = envs(MAP)
    return (jenv, [jax_make_bot(n, jenv) for n in OPPONENTS],
            env, [make_bot(n, env) for n in OPPONENTS])


@functools.lru_cache(maxsize=None)
def _lane_bot(bot):
    return _jit_fast(jax.vmap(bot))


def _program_bot(jenv, prog):
    return _lane_bot(_compiled(jenv, prog))


@functools.lru_cache(maxsize=None)
def _compiled(jenv, prog):
    return JD.compile_program(jenv, prog)


@functools.lru_cache(maxsize=None)
def _env_fns(jenv):
    """(the state and done of JAX's env step, gridnet.py:384-395: the
    decode of each player against its in-flight claims, ``issue_env``
    after each, one ``cycle``; its rewards are not read here), the winner
    and the key split, on batched jitted parts (``torch_parity.JaxFns``)."""
    fns = jax_fns(jenv)

    def step(s, a0, a1):
        c0, _, _ = fns.decode(s, a0, 0)
        s1 = fns.issue_env(s, c0)
        c1, _, _ = fns.decode(s1, a1, 1)
        return fns.cycle(fns.issue_env(s1, c1))
    return (step, jax.jit(jax.vmap(jenv.engine.winner)),
            jax.jit(jax.vmap(lambda k: jax.random.split(k, 3))))


def _switch(fns, idx, s, players, keys):
    """``lax.switch(idx, fns, ...)`` under vmap: every branch on every
    lane, then each lane's own."""
    outs = [f(s, players, keys) for f in fns]
    out = outs[0]
    for i in range(1, len(outs)):
        out = jnp.where((idx == i)[:, None, None, None], outs[i], out)
    return out


def play(jenv, cand_fns, opp_fns, pis, ois, sides, keys, max_cycles,
         snap_every=None):
    """search.py:97-114's ``one_game`` over lanes (programs on ``sides``,
    opponents on the other seat); returns (winner int32 [L], final
    state, snapshots before every ``snap_every`` ticks)."""
    step, winner_fn, split3 = _env_fns(jenv)
    L = len(pis)
    s = jax.vmap(jenv.reset)(keys)
    done = jnp.zeros(L, bool)
    winner = jnp.full(L, -1, jnp.int32)
    k = keys
    snaps = []
    pis, ois, sides = (jnp.asarray(x, jnp.int32) for x in (pis, ois, sides))
    for t in range(max_cycles):
        if snap_every is not None and t % snap_every == 0:
            snaps.append(s)
        ks = split3(k)
        k, k0, k1 = ks[:, 0], ks[:, 1], ks[:, 2]
        ac = _switch(cand_fns, pis, s, sides, k0)
        ao = _switch(opp_fns, ois, s, 1 - sides, k1)
        seat0 = (sides == 0)[:, None, None, None]
        a0 = jnp.where(seat0, ac, ao)
        a1 = jnp.where(seat0, ao, ac)
        s2, d2 = step(s, a0, a1)
        s = jax.tree.map(lambda a, b: jnp.where(
            done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), s, s2)
        winner = jnp.where(done, winner,
                           jnp.where(d2, winner_fn(s2), -1))
        done = done | d2
    return winner, s, snaps


def jax_evaluate_population(jenv, programs, opponents, games_per_pair=2,
                            max_cycles=1200, seed=0, out=None):
    """JAX's ``evaluate_population`` (search.py:119-165) on jitted pieces;
    ``out`` (a dict) receives the lanes' winners and final state."""
    cands = [_program_bot(jenv, p) for p in programs]
    opps = [_lane_bot(b) for b in opponents]
    P, O = len(cands), len(opps)
    lanes = [(pi, oi, side, g)
             for pi in range(P) for oi in range(O)
             for side in (0, 1) for g in range(games_per_pair)]
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(len(lanes), dtype=jnp.uint32))
    winner, s, _ = play(jenv, cands, opps, [l[0] for l in lanes],
                        [l[1] for l in lanes], [l[2] for l in lanes], keys,
                        max_cycles)
    if out is not None:
        out.update(winner=np.asarray(winner), state=s)
    sides = np.asarray([l[2] for l in lanes])
    w = np.asarray(winner)
    scores = np.where(w == sides, 1.0, np.where(w == 1 - sides, 0.0, 0.5))
    res = np.zeros(P)
    for l, sc in zip(lanes, scores):
        res[l[0]] += sc
    return res / (O * 2 * games_per_pair)


def jax_probe_states(jenv, program, opponents, n_snaps=24, stride=17,
                     seed=0):
    """JAX's ``probe_states`` (clean.py:117-170) on jitted pieces."""
    lanes = [(oi, seat) for oi in range(len(opponents)) for seat in (0, 1)]
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(len(lanes), dtype=jnp.uint32))
    _, _, snaps = play(jenv, [_program_bot(jenv, program)],
                       [_lane_bot(b) for b in opponents], [0] * len(lanes),
                       [l[0] for l in lanes], [l[1] for l in lanes], keys,
                       (n_snaps - 1) * stride + 1, snap_every=stride)
    L, n = len(lanes), len(lanes) * n_snaps
    flat = jax.tree.map(lambda *xs: jnp.stack(xs, 1).reshape(
        (n,) + xs[0].shape[1:]), *snaps)
    seats = jnp.repeat(jnp.asarray([l[1] for l in lanes], jnp.int32),
                       n_snaps)
    probe_keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(seed + 1), jnp.arange(n, dtype=jnp.uint32))
    return flat, seats, probe_keys


def jax_mismatch_counts(jenv, base, candidates, states, seats, keys):
    """JAX's ``mismatch_counts`` (clean.py:173-196), one candidate at a
    time."""
    a_base = _program_bot(jenv, base)(states, seats, keys)
    return np.asarray([int(jnp.any(
        (_program_bot(jenv, c)(states, seats, keys) != a_base).reshape(
            seats.shape[0], -1), 1).sum()) for c in candidates])
