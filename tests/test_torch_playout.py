"""K8 (ops/playout.py): the port's plain ``decision_point``, ``can_act``,
``fast_forward``, ``playout_step``, ``make_playout`` (at 16x16;
discounted and with ``n_eval`` > 1 in test_torch_make_playout.py;
``run_playout`` in test_torch_run_playout.py)
and ``make_playout_two`` against the JAX package's, bit-equal, on
recorded 8x8 and 16x16 states of
RandomBiasedAI self-play (busy units), copies with no busy unit, with one
player wiped out (terminal) and with both wiped out, under no cap, a
per-lane ``t_end`` that the jump reaches mid-jump, and a cap already
passed.

JAX's ``fast_forward`` runs with ``max_events=1``, looped in Python for
more events (that equals its unrolled form), and in its while-loop form
at its default ``max_events=2``.  JAX's own code runs eagerly under
``vmap`` around the env's jitted parts (tests/torch_playout_parity.py):
compiling a whole playout takes minutes of CPU.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.ops import evaluation as JE
from microrts_tpu.ops import playout as JPO
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.ops import evaluation as E
from microrts_tpu_torch.ops import playout as PO

from torch_parity import torch_one_thread, assert_eq, assert_state_eq, \
    jax_state
from torch_playout_parity import (check_make_playout, eager_loops,
                                  jax_random_bot, playout_noise, recorded)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAPS = ("maps/8x8/basesWorkers8x8.xml", "maps/16x16/basesWorkers16x16.xml")
MAX_SKIP = 512


@functools.lru_cache(maxsize=None)
def _jax_fns(jenv):
    """JAX's functions vmapped and run eagerly around the env's jitted
    parts (no compile of the whole function)."""
    v = jax.vmap

    def ff(s, d, te):
        return JPO.fast_forward(jenv, s, d, te, MAX_SKIP, max_events=1)

    def ff_none(s, d):
        return JPO.fast_forward(jenv, s, d, None, MAX_SKIP, max_events=1)

    def ff_loop(s, d, te):
        with eager_loops():
            return JPO.fast_forward(jenv, s, d, te, MAX_SKIP, unroll=False)

    def step(s, a0, a1, te, jump):
        return v(lambda *a: JPO.playout_step(
            jenv, *a[:3], 10, jump_to_event=jump, t_end=a[3],
            max_skip=MAX_SKIP))(s, a0, a1, te)

    return dict(
        dp=v(JPO.decision_point),
        can_act=v(JPO.can_act, in_axes=(0, None)),
        ff=v(ff), ff_none=v(ff_none), ff_loop=v(ff_loop), step=step,
        step_none=v(lambda s, a0, a1: JPO.playout_step(
            jenv, s, a0, a1, 10, jump_to_event=True, max_skip=MAX_SKIP)))


def _caps(s):
    """Per-lane caps: mid-jump for most lanes, already passed for some."""
    rng = np.random.default_rng(s.batch)
    add = rng.integers(1, 12, s.batch).astype(np.int32)
    add[::5] = -3
    return (s.time + torch.from_numpy(add)).to(torch.int32)


def _done(s):
    d = torch.zeros(s.batch, dtype=torch.bool)
    d[1::7] = True
    return d


@pytest.mark.parametrize("map_rel", MAPS)
def test_decision_point_and_can_act_match_jax(map_rel):
    jenv, env, s = recorded(map_rel)
    f = _jax_fns(jenv)
    js = jax_state(s)
    dp = PO.decision_point(s)
    assert_eq(f["dp"](js), dp, "decision_point")
    assert dp.any() and not dp.all()
    for p in (0, 1):
        assert_eq(f["can_act"](js, p), PO.can_act(s, p), f"can_act p{p}")


@pytest.mark.parametrize("map_rel", MAPS)
def test_fast_forward_matches_jax(map_rel):
    jenv, env, s = recorded(map_rel)
    f = _jax_fns(jenv)
    done0 = _done(s)
    te = _caps(s)
    moved = 0
    for cap in ("none", "lanes", 2000):
        js, jd = jax_state(s), jnp.asarray(done0.numpy())
        for n in (1, 2, 3):
            if cap == "none":
                js, jd = f["ff_none"](js, jd)
                got, gd = PO.fast_forward(env, s, done0, None, MAX_SKIP,
                                          max_events=n)
            else:
                t = te if cap == "lanes" else cap
                js, jd = f["ff"](js, jd, jnp.broadcast_to(
                    jnp.asarray(np.asarray(t, np.int32)), (s.batch,)))
                got, gd = PO.fast_forward(env, s, done0, t, MAX_SKIP,
                                          max_events=n)
            assert_state_eq(js, got, f"fast_forward {cap} x{n}")
            assert_eq(jd, gd, f"fast_forward done {cap} x{n}")
            moved += int((got.time != s.time).sum())
        # the while-loop form: the same as two unrolled event steps
        if cap != "none":
            t = te if cap == "lanes" else torch.full((s.batch,), cap,
                                                     dtype=torch.int32)
            jl, jld = f["ff_loop"](jax_state(s), jnp.asarray(done0.numpy()),
                                   jnp.asarray(t.numpy()))
            got, gd = PO.fast_forward(env, s, done0, t, MAX_SKIP)
            assert_state_eq(jl, got, f"fast_forward while form {cap}")
            assert_eq(jld, gd, "fast_forward while form done")
    assert moved > 0


def _actions(env, s, seed):
    rng = np.random.default_rng(seed)
    bot = random_bot(env, 5.0)
    u = [torch.from_numpy(rng.random((s.batch, env.h, env.w, 2),
                                     dtype=np.float32)) for _ in (0, 1)]
    return bot(s, 0, u[0]), bot(s, 1, u[1])


@pytest.mark.parametrize("map_rel", MAPS)
def test_playout_step_matches_jax(map_rel):
    jenv, env, s = recorded(map_rel)
    f = _jax_fns(jenv)
    a0, a1 = _actions(env, s, 3)
    ja0, ja1 = jnp.asarray(a0.numpy()), jnp.asarray(a1.numpy())
    te = _caps(s)
    js = jax_state(s)
    for jump in (False, True):
        jn, jd = f["step"](js, ja0, ja1, jnp.asarray(te.numpy()), jump)
        got, gd = PO.playout_step(env, s, a0, a1, 10, jump_to_event=jump,
                                  t_end=te if jump else None,
                                  max_skip=MAX_SKIP)
        assert_state_eq(jn, got, f"playout_step jump={jump}")
        assert_eq(jd, gd, f"playout_step done jump={jump}")
        if not jump:    # the bot path's NONE(10) pads, one tick later
            assert ((got.atype == 0) & got.busy & (got.aticks == 9)).any()
    jn, jd = f["step_none"](js, ja0, ja1)
    got, gd = PO.playout_step(env, s, a0, a1, 10, jump_to_event=True,
                              max_skip=MAX_SKIP)
    assert_state_eq(jn, got, "playout_step no cap")
    assert_eq(jd, gd, "playout_step no cap done")


def test_make_playout_matches_jax_16x16():
    """16x16, undiscounted, one playout per state (the search bots'
    setting)."""
    check_make_playout(MAPS[1], 1.0, 1)


def test_make_playout_two_matches_jax():
    """The portfolio family's two-policy playout: ``me`` and ``opp`` bound
    to their players, the lanes' ``player`` mixed (16x16)."""
    jenv, env, s = recorded(MAPS[1])
    ecfg = jenv.cfg.engine
    L, n_dec = 16, 4
    jbot = jax_random_bot(jenv)
    jeval = jax.jit(lambda st, p: JE.simple_sqrt_eval3(st, p, ecfg))
    jrun = JPO.make_playout_two(jenv, L, jeval, n_decisions=n_dec)
    keys = jax.random.split(jax.random.PRNGKey(9), s.batch)
    players = np.arange(s.batch, dtype=np.int32) % 2
    with eager_loops():
        jv = jax.vmap(lambda st, p, k: jrun(
            st, p, lambda x, kk: jbot(x, p, kk),
            lambda x, kk: jbot(x, 1 - p, kk), k))(
                jax_state(s), jnp.asarray(players), keys)
    bot = random_bot(env, 5.0)
    p = torch.from_numpy(players)
    run = PO.make_playout_two(env, L, lambda st, q: E.simple_sqrt_eval3(
        st, q, env.cfg.engine), n_decisions=n_dec)
    me = lambda st, u: torch.where((p == 0)[:, None, None, None],
                                   bot(st, 0, u), bot(st, 1, u))
    opp = lambda st, u: torch.where((p == 0)[:, None, None, None],
                                    bot(st, 1, u), bot(st, 0, u))
    v = run(s, p, me, opp, playout_noise(keys, n_dec, env.h, env.w))
    assert_eq(jv, v, "make_playout_two value")
    assert len(set(v.tolist())) > 2
