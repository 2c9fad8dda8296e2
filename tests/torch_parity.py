"""Shared helpers of the ``test_torch_*`` parity tests.

The same inputs go through the JAX package and the PyTorch port
(``microrts_tpu_torch``, plain path on the CPU).  JAX functions are jitted
one by one and cached per config: jitting the whole vmapped env step takes
~40 s to compile on a CPU, its parts a few seconds together.  Randomness
is drawn in JAX (threefry keys) and the same uniforms are handed to the
port, whose bots take uniforms instead of keys.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots.scripted import random_bot as jax_random_bot
from microrts_tpu.engine import types as JT
from microrts_tpu.env.vec import VecGridnetEnv as JaxVec
from microrts_tpu.env.gridnet import GridnetEnv as JaxEnv
from microrts_tpu.utils.assets import asset_path as jax_asset_path
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine.types import (FIELD_DTYPES, Candidates,
                                             state_to_numpy)
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.env.vec import VecGridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

BIAS = 5.0
CAND_FIELDS = Candidates.FIELDS


@pytest.fixture
def torch_one_thread():
    """Run a test with one intra-op torch thread (restored after it): the
    port's CPU tests are small, and the driver runs several test processes
    at once on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(js) -> dict:
    """numpy leaves of a (batched) JAX State, without the key."""
    return {f: np.asarray(getattr(js, f)) for f in FIELD_DTYPES}


def assert_state_eq(js, ts, where=""):
    got = state_to_numpy(ts)
    for f in FIELD_DTYPES:
        a = np.asarray(getattr(js, f))
        b = got[f]
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        if not np.array_equal(a, b):
            idx = tuple(np.argwhere(a != b)[0])
            raise AssertionError(f"{where}: state.{f} differs at {idx}: "
                                 f"jax {a[idx]} port {b[idx]}")


def assert_cand_eq(jc, tc, where=""):
    for f in CAND_FIELDS:
        a = np.asarray(getattr(jc, f))
        b = getattr(tc, f).numpy()
        if not np.array_equal(a, b):
            idx = tuple(np.argwhere(a != b)[0])
            raise AssertionError(f"{where}: cand.{f} differs at {idx}: "
                                 f"jax {a[idx]} port {b[idx]}")


def assert_eq(a, b, where=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    if not np.array_equal(a, b):
        idx = tuple(np.argwhere(a != b)[0])
        raise AssertionError(f"{where}: differs at {idx}: jax {a[idx]} "
                             f"port {b[idx]}")


def envs(map_rel: str, **kw):
    """(JAX env, port env on the CPU) over the same map file."""
    return (JaxEnv(jax_asset_path(map_rel), **kw),
            GridnetEnv(asset_path(map_rel), device="cpu", **kw))


_JIT = {}


class JaxFns:
    """Jitted JAX functions of one env config, shared by every map of the
    same size and UTT.  The player is a traced argument, so each function
    compiles once for both players."""

    def __init__(self, jenv):
        eng = jenv.engine
        H, W = jenv.h, jenv.w
        v = jax.vmap
        self.legal = jax.jit(v(lambda s, p: (eng.legal_masks(s, p),
                                             jenv.masks(s, p)),
                               in_axes=(0, None)))
        self.validate = jax.jit(v(eng.validate))
        self.issue_env = jax.jit(v(eng.issue_env))
        self.cycle = jax.jit(v(eng.cycle))
        self.over = jax.jit(v(lambda s: (eng.gameover(s), eng.winner(s))))
        self.claims = jax.jit(v(jenv._inflight_claims))
        self.spent = jax.jit(v(jenv._inflight_spent, in_axes=(0, None)))
        self.decode = jax.jit(v(
            lambda s, a, p: jenv.decode(s, a, p, jenv._inflight_claims(s),
                                        jenv._inflight_spent(s, p)),
            in_axes=(0, 0, None)))
        self.bot = jax.jit(v(jax_random_bot(jenv, BIAS), in_axes=(0, None, 0)))
        self.uniform = jax.jit(v(lambda k: jax.random.uniform(k, (H, W, 2))))
        # unbatched parts for ``patch``
        self._parts = dict(
            decode=jax.jit(jenv.decode), _rewards=jax.jit(jenv._rewards),
            _inflight_claims=jax.jit(jenv._inflight_claims),
            _inflight_spent=jax.jit(jenv._inflight_spent),
            dones=jax.jit(jenv.dones), observation=jax.jit(jenv.observation))
        self._eng = dict(issue_env=jax.jit(eng.issue_env),
                         cycle=jax.jit(eng.cycle),
                         gameover=jax.jit(eng.gameover),
                         winner=jax.jit(eng.winner))

    def patch(self, jenv):
        """Route a JAX env's own ``step``, ``dones`` and ``observation``
        (and so ``VecGridnetEnv.step``) through jitted parts: their own
        code then runs eagerly under ``vmap`` around compiled pieces."""
        for name, fn in self._parts.items():
            setattr(jenv, name, fn)
        jenv.engine = jenv.engine._replace(**self._eng)
        return jenv


def jax_fns(jenv) -> JaxFns:
    key = jenv.cfg
    if key not in _JIT:
        _JIT[key] = JaxFns(jenv)
    return _JIT[key]


def draw(fns, key, batch):
    """Split ``key`` into per-env keys and the uniforms JAX's random_bot
    draws from them: (keys, numpy uniforms [B, H, W, 2])."""
    ks = jax.random.split(key, batch)
    return ks, np.array(fns.uniform(ks))


def port_trajectory(env, batch, ticks, seed, keep):
    """Port plain states of a random-bot self-play trajectory (no
    resets), at the ticks in ``keep``: {tick: State}."""
    rng = np.random.default_rng(seed)
    bot = random_bot(env, BIAS)
    s = env.reset(batch)
    out = {}
    for t in range(ticks):
        if t in keep:
            out[t] = s
        u = [torch.from_numpy(rng.random((batch, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        s, _, _ = env.step(s, bot(s, 0, u[0]), bot(s, 1, u[1]))
    return out


def garbage(rng, nvec, shape, rate, base=None):
    """Gridnet actions with each component uniform over ``nvec`` at a
    fraction ``rate`` of cells (all cells when ``base`` is None)."""
    g = np.stack([rng.integers(0, n, shape) for n in nvec], -1).astype(np.int32)
    if base is None:
        return g
    return np.where(rng.random(shape + (1,)) < rate, g, base).astype(np.int32)


def jax_state(s):
    """A port State batch as a batched JAX State (any key: this path never
    reads it)."""
    return JT.State(**{k: jnp.asarray(v) for k, v in state_to_numpy(s).items()},
                    key=jnp.zeros((s.batch, 2), jnp.uint32))


def garbage_cand(rng, env, shape):
    """Candidates with every field drawn over (and past) its range."""
    T, R = env.cfg.engine.num_types, env.cfg.engine.max_range
    ys, xs = np.meshgrid(np.arange(env.h), np.arange(env.w), indexing="ij")
    c = dict(atype=rng.integers(-1, 6, shape), aparam=rng.integers(-1, 5, shape),
             atx=xs + rng.integers(-R - 1, R + 2, shape),
             aty=ys + rng.integers(-R - 1, R + 2, shape),
             aptype=rng.integers(0, T, shape),
             rank=np.broadcast_to(ys * env.w + xs, shape).copy())
    c = {k: v.astype(np.int32) for k, v in c.items()}
    return (JT.Candidates(**{k: jnp.asarray(v) for k, v in c.items()}),
            Candidates(**{k: torch.from_numpy(v) for k, v in c.items()}))


def check_legal_masks(env, fns, states):
    for s in states:
        js = jax_state(s)
        for p in (0, 1):
            jm, jpacked = fns.legal(js, p)
            tm = env.engine.legal_masks(s, p)
            for k in jm:
                assert_eq(jm[k], tm[k], f"legal_masks[{k}] p{p}")
            assert_eq(jpacked, env.masks(s, p), f"masks p{p}")


def check_validate_eta_issue_env(env, fns, states, seed):
    rng = np.random.default_rng(seed)
    for i, s in enumerate(states):
        js = jax_state(s)
        jc, tc = garbage_cand(rng, env, tuple(s.utype.shape))
        assert_eq(fns.validate(js, jc), env.engine.validate(s, tc), "validate")
        jn = fns.issue_env(js, jc)
        assert_state_eq(jn, env.engine.issue_env(s, tc), f"issue_env state {i}")
        # eta_of is internal to the JAX engine; issue_env stores it as the
        # ticks of every cell it puts an action on
        put = ((s.utype > 0) & ~s.busy & (tc.atype >= 0)
               & (s.owner >= 0)).numpy()
        assert put.any()
        assert_eq(np.asarray(jn.aticks)[put],
                  env.engine.eta_of(s, tc).numpy()[put].astype(np.int16),
                  "eta_of")


def check_cycle_gameover_winner(env, fns, states):
    for i, s in enumerate(states):
        js = jax_state(s)
        jn, jd = fns.cycle(js)
        tn, td = env.engine.cycle(s)
        assert_state_eq(jn, tn, f"cycle state {i}")
        assert_eq(jd, td, "cycle done")
        over, win = fns.over(js)
        assert_eq(over, env.engine.gameover(s), "gameover")
        assert_eq(win, env.engine.winner(s), "winner")


def vec_trajectory(map_rel, batch, ticks, max_steps):
    """Step JAX's and the port's VecGridnetEnv side by side with the same
    JAX-drawn uniforms, comparing every output every tick; returns the
    number of env resets seen."""
    jenv, env = envs(map_rel)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    jvec = JaxVec(jenv, batch, max_steps=max_steps)
    vec = VecGridnetEnv(env, batch, max_steps=max_steps)
    key = jax.random.PRNGKey(len(map_rel))
    key, k = jax.random.split(key)
    js, jsteps = jvec.reset(k)
    s, steps = vec.reset()
    assert_state_eq(js, s, "reset")
    bot = random_bot(env, BIAS)
    resets = 0
    for t in range(ticks):
        key, k0, k1 = jax.random.split(key, 3)
        (ks0, u0), (ks1, u1) = draw(fns, k0, batch), draw(fns, k1, batch)
        a0, a1 = fns.bot(js, 0, ks0), fns.bot(js, 1, ks1)
        ta0 = bot(s, 0, torch.from_numpy(u0))
        ta1 = bot(s, 1, torch.from_numpy(u1))
        assert_eq(a0, ta0, f"t{t} actions p0")
        assert_eq(a1, ta1, f"t{t} actions p1")
        js, jsteps, jobs, jrew, jdn, jrm = jvec.step(js, jsteps, a0, a1)
        s, steps, obs, rew, dn, rm = vec.step(s, steps, ta0, ta1)
        assert_state_eq(js, s, f"t{t}")
        for name, a, b in (("steps", jsteps, steps), ("obs", jobs, obs),
                           ("rewards", jrew, rew), ("dones", jdn, dn),
                           ("reset_mask", jrm, rm)):
            assert_eq(a, b, f"t{t} {name}")
        resets += int(rm.sum())
    return resets
