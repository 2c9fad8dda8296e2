"""Helpers of the decision-frame parity tests (playouts, evaluation,
search bots, tournaments): recorded states of the port's plain path with
busy, idle and terminal lanes, the JAX package's env with its parts
jitted, and its loops run eagerly.

Jitting JAX's whole playout or search bot takes minutes of CPU compile,
so its own code runs eagerly under ``vmap`` around jitted parts, with
``lax.scan`` as a Python loop (``_py_scan``) and ``lax.while_loop`` as a
fixed number of select-frozen body applications (``_py_while``: exactly
what ``vmap`` of a while loop does, as long as every lane's condition
turns false within that many iterations)."""

import contextlib
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import scripted as JS
from microrts_tpu.ops import evaluation as JE
from microrts_tpu.ops import playout as JPO
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State
from microrts_tpu_torch.ops import evaluation as E
from microrts_tpu_torch.ops import playout as PO

from torch_parity import (assert_eq, assert_state_eq, envs, jax_fns,
                          jax_state, port_trajectory)
from torch_rollout_parity import _py_scan

MAX_SKIP = 512

WHILE_ITERS = 8   # > fast_forward's max_events, the only while loop here


def _py_while(cond, body, init):
    c = init
    for _ in range(WHILE_ITERS):
        keep = cond(c)
        c = jax.tree.map(lambda a, b: jnp.where(keep, b, a), c, body(c))
    return c


@contextlib.contextmanager
def eager_loops():
    """Run ``lax.scan`` and ``lax.while_loop`` as Python loops."""
    scan, wl = jax.lax.scan, jax.lax.while_loop
    jax.lax.scan, jax.lax.while_loop = _py_scan, _py_while
    try:
        yield
    finally:
        jax.lax.scan, jax.lax.while_loop = scan, wl


@functools.lru_cache(maxsize=None)
def patched_envs(map_rel):
    """(JAX env with its step parts and legal masks jitted, port env on
    the CPU)."""
    jenv, env = envs(map_rel)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    jenv.engine = jenv.engine._replace(
        legal_masks=jax.jit(jenv.engine.legal_masks))
    return jenv, env


@functools.lru_cache(maxsize=None)
def jax_random_bot(jenv, bias=5.0):
    return jax.jit(JS.random_bot(jenv, bias))


def cat(states):
    return State(**{f: torch.cat([getattr(s, f) for s in states])
                    for f in FIELD_DTYPES})


def idle(s: State, rows) -> State:
    """A copy of ``s`` with no busy unit in ``rows``."""
    busy = s.busy.clone()
    busy[list(rows)] = False
    return s.replace(busy=busy)


def remove_player(s: State, rows, player) -> State:
    """A copy of ``s`` with ``player``'s units removed in ``rows``."""
    m = torch.zeros_like(s.busy)
    m[list(rows)] = True
    gone = m & (s.owner == player)
    return s.replace(utype=torch.where(gone, 0, s.utype),
                     owner=torch.where(gone, -1, s.owner),
                     busy=s.busy & ~gone)


@functools.lru_cache(maxsize=None)
def recorded(map_rel, batch=3, ticks=(5, 20, 45)):
    """Port states of a RandomBiasedAI self-play trajectory at ``ticks``,
    plus copies with no busy unit, with player 1 wiped out and with both
    wiped out: (JAX env, port env, State)."""
    jenv, env = patched_envs(map_rel)
    rec = port_trajectory(env, batch, max(ticks) + 1, len(map_rel),
                          set(ticks))
    base = cat([rec[t] for t in ticks])
    n = base.batch
    s = cat([base, idle(base, range(n)),
             remove_player(base, range(n), 1),
             remove_player(remove_player(base, range(n), 0), range(n), 1)])
    return jenv, env, s


def split_uniforms(keys, h, w):
    """JAX's ``act2`` draws of one decision for keys ``[L, 2]``: numpy
    ``[2, L, H, W, 2]`` (``k0, k1 = split(k)``, a uniform each)."""
    ks = jax.vmap(jax.random.split)(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (h, w, 2)))
    return np.stack([np.asarray(u(ks[:, 0])), np.asarray(u(ks[:, 1]))])


def playout_noise(keys, n_decisions, h, w):
    """The uniforms JAX's ``run_playout`` draws from per-lane ``keys``
    ``[L, 2]``: float32 ``[n_decisions, 2, L, H, W, 2]``."""
    dk = jax.vmap(lambda k: jax.random.split(k, n_decisions))(keys)
    return torch.from_numpy(np.stack([split_uniforms(dk[:, d], h, w)
                                      for d in range(n_decisions)]))


def check_make_playout(map_rel, gamma, n_eval):
    """``make_playout``'s values equal to JAX's on the recorded states of
    ``map_rel``."""
    jenv, env, s = recorded(map_rel)
    ecfg = jenv.cfg.engine
    L, n_dec = 16, 4
    jeval = jax.jit(lambda st, p: JE.simple_sqrt_eval3(st, p, ecfg))
    jplay = JPO.make_playout(jenv, L, jeval, gamma=gamma,
                             rollout_bot=jax_random_bot(jenv),
                             n_eval=n_eval, n_decisions=n_dec)
    keys = jax.random.split(jax.random.PRNGKey(7), s.batch)
    players = np.arange(s.batch, dtype=np.int32) % 2
    t0 = (s.time - 3).numpy()
    js = jax_state(s)
    with eager_loops():
        jv = jax.vmap(jplay)(js, jnp.asarray(players), jnp.asarray(t0),
                             keys)
    ekeys = jax.vmap(lambda k: jax.random.split(k, n_eval))(keys).reshape(
        -1, 2) if n_eval > 1 else keys
    noise = playout_noise(ekeys, n_dec, env.h, env.w)
    play = PO.make_playout(env, L, lambda st, p: E.simple_sqrt_eval3(
        st, p, env.cfg.engine), gamma=gamma, n_eval=n_eval,
        n_decisions=n_dec)
    v = play(s, torch.from_numpy(players), torch.from_numpy(t0), noise)
    assert_eq(jv, v, "playout value")
    assert len(set(v.tolist())) > 2


def check_run_playout(map_rel):
    """``run_playout``'s final states and dones equal to JAX's on the
    recorded states of ``map_rel``, one playout per lane."""
    jenv, env, s = recorded(map_rel)
    L, n_dec = 16, 4
    keys = jax.random.split(jax.random.PRNGKey(7), s.batch)
    js = jax_state(s)
    jbot = jax_random_bot(jenv)

    def act2(st, k):
        k0, k1 = jax.random.split(k)
        return jbot(st, 0, k0), jbot(st, 1, k1)

    with eager_loops():
        jf, jd = jax.vmap(lambda st, k: JPO.run_playout(
            jenv, act2, st, k, L, n_dec, MAX_SKIP))(js, keys)
    bot = random_bot(env, 5.0)
    got, gd = PO.run_playout(
        env, lambda st, nz: (bot(st, 0, nz[0]), bot(st, 1, nz[1])), s,
        playout_noise(keys, n_dec, env.h, env.w), L, n_dec, MAX_SKIP)
    assert_state_eq(jf, got, "run_playout")
    assert_eq(jd, gd, "run_playout done")
    assert (got.time - s.time).max() > 4
