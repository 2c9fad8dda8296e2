"""Helpers of the partially observable parity tests: the JAX package's
fog functions and full ``issue`` jitted per config, the CANCEL_RANDOM
coins drawn as its ``issue`` draws them, its PO env routed through jitted
parts, and recorded PO step inputs of the port's plain path."""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.engine import fog as JF
from microrts_tpu.engine import kernel as JK
from microrts_tpu.engine.types import EngineConfig as JaxEngineConfig
from microrts_tpu.engine.utt import UnitTypeTable as JaxUTT
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine.kernel import make_engine
from microrts_tpu_torch.engine.types import (FIELD_DTYPES, Candidates,
                                             EngineConfig, State)
from microrts_tpu_torch.engine.utt import UnitTypeTable

from torch_parity import BIAS, assert_state_eq, jax_fns, jax_state

POLICIES = (1, 2, 3)


@functools.lru_cache(maxsize=None)
def jax_fog(cfg):
    """JAX's visibility, po_state and observation_po of one engine config,
    vmapped over states and per-env players (int32 [B]) and jitted
    together: (vis, view, obs)."""
    def one(s, p):
        return (JF.visibility(s, p, cfg), JF.po_state(s, p, cfg),
                JF.observation_po(s, p, cfg))
    return jax.jit(jax.vmap(one))


def players_of(player, batch):
    """``player`` (an int or a torch int32 [B]) as the numpy int32 [B] the
    JAX side takes."""
    if isinstance(player, torch.Tensor):
        return player.numpy()
    return np.full(batch, player, np.int32)


@functools.lru_cache(maxsize=None)
def jax_issue(h, w, policy):
    """(JAX engine config, its ``issue`` vmapped and jitted) for a UTT v2
    board of h x w under move-conflict ``policy``."""
    cfg = JaxEngineConfig.from_utt(JaxUTT(2, policy), h, w)
    return cfg, jax.jit(jax.vmap(JK.make_engine(cfg).issue))


def port_engine(h, w, policy):
    return make_engine(EngineConfig.from_utt(UnitTypeTable(2, policy), h, w))


@functools.lru_cache(maxsize=None)
def _coin_fn(h, w):
    return jax.jit(jax.vmap(lambda k, oc: jax.random.bernoulli(
        jax.random.fold_in(k, oc), 0.5, (h, w, 4))))


def coins_of(js):
    """The coins JAX's ``issue`` draws for a batched JAX State, as a bool
    torch [B, H, W, 4] (kernel.py:355-358)."""
    h, w = js.utype.shape[-2:]
    return torch.from_numpy(np.array(_coin_fn(h, w)(js.key, js.order_ctr)))


def keyed(s, seed):
    """A port State batch as a batched JAX State with per-env keys."""
    return jax_state(s).replace(
        key=jax.random.split(jax.random.PRNGKey(seed), s.batch))


def po_records(env, batch, ticks, seed, every=1):
    """The port's plain PO step inputs along a RandomBiasedAI self-play
    trajectory (no resets): every ``every``-th tick, (state, candidates
    of player 0, state after its issue, candidates of player 1)."""
    rng = np.random.default_rng(seed)
    bot = random_bot(env, BIAS)
    eng = env.engine
    s = env.reset(batch)
    out = []
    for t in range(ticks):
        u = [torch.from_numpy(rng.random((batch, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        a0, a1 = bot(s, 0, u[0]), bot(s, 1, u[1])
        c0 = env.decode(s, a0, 0, view=env.po_view(s, 0))
        s1 = eng.issue(s, c0)
        c1 = env.decode(s1, a1, 1, view=env.po_view(s1, 1))
        if t % every == 0:
            out.append((s, c0, s1, c1))
        s, _ = eng.cycle(eng.issue(s1, c1))
    return out


def rush_trajectory(env, batch, ticks, keep, seed=0):
    """Port plain states of WorkerRush against WorkerRush (whose workers
    walk to the enemy base) at the ticks in ``keep``: {tick: State}; env k
    opens with 3k ticks of RandomBiasedAI for both players, so that the
    envs differ."""
    from microrts_tpu_torch.bots import scripted as S
    p0 = p1 = S.worker_rush(env)
    rnd = random_bot(env, BIAS)
    rng = np.random.default_rng(seed)
    s = env.reset(batch)
    early = (torch.arange(batch) * 3)[:, None, None, None]
    out = {}
    for t in range(ticks):
        if t in keep:
            out[t] = s
        u = [torch.from_numpy(rng.random((batch, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        a0 = torch.where(t < early, rnd(s, 0, u[0]), p0(s, 0))
        a1 = torch.where(t < early, rnd(s, 1, u[1]), p1(s, 1))
        s, _, _ = env.step(s, a0, a1)
    return out


def cat_states(states):
    return State(**{f: torch.cat([getattr(s, f) for s in states])
                    for f in FIELD_DTYPES})


def cat_cands(cands):
    return Candidates(**{f: torch.cat([getattr(c, f) for c in cands])
                         for f in Candidates.FIELDS})


def random_table(rng, s, cfg, cells):
    """Candidates for the units of ``s`` in ``cells`` (bool [B, H, W]),
    most of them claims (a move, or a produce of a type the unit makes)
    toward a free neighbour where one is free, some other actions and
    parameters out of range; ranks a random permutation of the cells per
    env.  Units next to the same free cell then claim it together."""
    B, H, W = s.utype.shape
    shape = (B, H, W)
    T = cfg.num_types
    utype = s.utype.numpy().astype(np.int64)
    free = (s.terrain.numpy() == 0) & (utype == 0)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # the free neighbours of each cell, up/right/down/left
    fd = np.zeros(shape + (4,), bool)
    for d, (dx, dy) in enumerate(((0, -1), (1, 0), (0, 1), (-1, 0))):
        nx, ny = xs + dx, ys + dy
        ok = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
        fd[..., d] = ok & free[:, np.clip(ny, 0, H - 1),
                               np.clip(nx, 0, W - 1)]
    pick = np.argmax(np.where(fd, rng.random(shape + (4,)), -1.0), -1)
    param = np.where(fd.any(-1) & (rng.random(shape) < 0.9), pick,
                     rng.integers(-1, 5, shape))
    t = np.clip(utype - 1, 0, T - 1)
    makes = np.asarray(cfg.produces, bool)[t]            # [B, H, W, T]
    ptype = np.argmax(np.where(makes, rng.random(shape + (T,)), -1.0), -1)
    mover = np.asarray(cfg.can_move, bool)[t]
    at = np.where(makes.any(-1) & (rng.random(shape) < 0.6), 4,
                  np.where(mover, 1, 0))
    at = np.where(rng.random(shape) < 0.15,
                  rng.integers(-1, 6, shape), at)
    at = np.where(cells.numpy() & (utype > 0), at, -1)
    rank = np.stack([rng.permutation(H * W).reshape(H, W)
                     for _ in range(B)])
    c = dict(atype=at, aparam=param,
             atx=xs + rng.integers(-3, 4, shape),
             aty=ys + rng.integers(-3, 4, shape),
             aptype=np.where(rng.random(shape) < 0.9, ptype,
                             rng.integers(0, T, shape)), rank=rank)
    return Candidates(**{k: torch.from_numpy(
        np.broadcast_to(v, shape).astype(np.int32)) for k, v in c.items()})


def jax_cand(c):
    from microrts_tpu.engine.types import Candidates as JC
    return JC(**{f: jnp.asarray(getattr(c, f).numpy())
                 for f in Candidates.FIELDS})


# jit at XLA's lowest optimization level: these pieces compile in about
# half the time and give the same integers
_jit_fast = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


class JaxPOFns:
    """A JAX PO env's ``step``, ``observation`` and ``observation_onehot``
    routed through jitted parts (its own code runs eagerly under ``vmap``
    around them): the shared ``JaxFns`` parts of its config, plus its
    full ``issue``, ``po_state`` and its own (8-plane) observation; and
    both players' masks of a batch (``VecGridnetEnv.masks``), jitted."""

    def __init__(self, jenv):
        self.fns = jax_fns(jenv)
        self.issue = _jit_fast(jenv.engine.issue)
        # these two are also called inside jitted functions, where a jit
        # takes no compiler options
        self.po_state = jax.jit(JF.po_state, static_argnums=2)
        self.observation = jax.jit(jenv.observation)
        self.onehot = _jit_fast(jax.vmap(jenv.observation_onehot,
                                         in_axes=(0, None)))
        self.masks = _jit_fast(lambda s: jnp.stack([jax.vmap(
            jenv.masks, in_axes=(0, None))(s, p) for p in (0, 1)]))

    def patch(self, jenv, monkeypatch):
        self.fns.patch(jenv)
        jenv.engine = jenv.engine._replace(issue=self.issue)
        jenv.observation = self.observation
        monkeypatch.setattr(JF, "po_state", self.po_state)
        return jenv


def check_random_tables(env, s, seed):
    """Two issues a tick on the states ``s`` (prior-tick claims in flight)
    under each move-conflict policy, the port's ``issue`` against JAX's on
    the same random candidate tables (whole states), with the stockpiles
    and the cancelation counter drawn: a table for half the units, then
    one for the other half on the result (whose claims are then
    same-tick), so that claims meet reserved targets, produces the
    resource cancel, new claims each other and earlier same-tick claims,
    and ALTERNATING starts from both parities.  Every conflict kind must
    occur; returns the counts."""
    H, W, cfg = env.h, env.w, env.cfg.engine
    rng = np.random.default_rng(seed)
    s = s.replace(
        resources=torch.from_numpy(rng.integers(0, 12, (s.batch, 2))
                                   .astype(np.int32)),
        cancel_ctr=torch.from_numpy(rng.integers(0, 6, s.batch)
                                    .astype(np.int32)))
    assert bool((s.busy & (s.atime < s.time[:, None, None])).any())
    counts = {}
    for policy in POLICIES:
        _, jissue = jax_issue(H, W, policy)
        eng = port_engine(H, W, policy)
        half = torch.from_numpy(rng.random(tuple(s.utype.shape)) < 0.5)
        st = s
        for k, cells in enumerate((half, ~half)):
            tc = random_table(rng, st, cfg, cells)
            js = keyed(st, 10 * policy + k)
            jn = jissue(js, jax_cand(tc))
            coins = coins_of(js) if policy == 2 else None
            n = eng.issue_plain(st, tc, coins, counts)
            assert_state_eq(jn, n, f"policy {policy} issue {k}")
            st = n
        if policy == 3:
            assert bool((st.cancel_ctr > s.cancel_ctr).any())
    print("conflicts", counts)
    assert set(counts) == set(eng.ISSUE_CONFLICTS)
    assert min(counts.values()) > 0, counts
    return counts
