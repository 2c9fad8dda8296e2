"""Helpers of the minimax parity tests: the JAX package's minimax bots on
the recorded 8x8 games, and their draws laid out as the port's noise.

Jitting a whole JAX ABCD or SampledABCD bot takes ~100 s of CPU compile
(the WorkerRush playout inside the DFS's ``while_loop``), so the
depth-first searches run game by game on concrete values: ``lax.while_loop``
and ``lax.cond`` as Python control flow (``concrete_loops``: only the
taken branch runs, the loop runs exactly its trips), around jitted parts
(the enumerator's ``init`` and ``next_action``, ``_issue_player``,
``_advance``, WorkerRush and the evaluation).  The final
carry of every DFS loop is recorded, so the root values and the whole
stacks can be read.  IDRTMinimaxRandomized compiles in ~30 s and is
jitted whole, its scores read off its ``argmax``'s input while tracing.
SampledABCD runs eagerly under ``vmap`` (``eager_loops``) around jitted
bots and env parts, its maximin values read off its ``argmax``.

Floats: the evaluation is exact (tests/test_torch_evaluate.py), so are
the DFS's comparisons; the randomized scores' mean and population std
may round an ulp apart between XLA and PyTorch, so a game is held there
only where the top two scores are more than ``MARGIN`` apart."""

import contextlib
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import minimax as JMM
from microrts_tpu.bots import scripted as JS
from microrts_tpu.bots import treesearch as JTS
from microrts_tpu.ops import enumerate as JEN
from microrts_tpu.ops import evaluation as JE
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State

from torch_parity import assert_eq, jax_state
from torch_playout_parity import eager_loops, jax_random_bot
from torch_rollout_parity import _py_scan
from torch_treesearch_parity import (_jit, _py_fori,
                                     _traced_with_lax, games, tree_envs)

# tests/test_minimax.py:118-121's sizes
ABCD_KW = dict(max_depth=2, playout_len=8, node_budget=60)
RT_KW = dict(lookahead=12, stack_cap=6, node_budget=60)
MARGIN = 1e-6
DFS_CARRY = 16   # the length of _make_dfs's while-loop carry


def _py_while(cond, body, init):
    c = init
    while bool(cond(c)):
        c = body(c)
    return c


def _py_cond(pred, true_fn, false_fn, *operands):
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


@contextlib.contextmanager
def concrete_loops(carries):
    """``lax.while_loop``, ``cond``, ``scan`` and ``fori_loop`` as Python
    control flow on concrete values; the final carry of every DFS loop is
    appended to ``carries``."""
    now = (jax.lax.while_loop, jax.lax.cond, jax.lax.scan, jax.lax.fori_loop)

    def while_loop(cond, body, init):
        out = _py_while(cond, body, init)
        if isinstance(out, tuple) and len(out) == DFS_CARRY:
            carries.append(out)
        return out
    jax.lax.while_loop, jax.lax.cond = while_loop, _py_cond
    jax.lax.scan, jax.lax.fori_loop = _py_scan, _py_fori
    try:
        yield
    finally:
        (jax.lax.while_loop, jax.lax.cond, jax.lax.scan,
         jax.lax.fori_loop) = now


def _lax_jit(fn, **kw):
    """``fn`` jitted, traced with JAX's own loops."""
    return _jit(_traced_with_lax(fn), **kw)


@functools.lru_cache(maxsize=None)
def _parts(jenv):
    """JAX's minimax helpers, jitted (the same functions, compiled)."""
    init, nxt = JEN.make_enumerator(jenv)
    adv = _lax_jit(lambda s: JTS._advance(jenv, s))
    issue = _lax_jit(lambda s, a, p: JTS._issue_player(jenv, s, a, p))
    return dict(init=_lax_jit(init), next=_lax_jit(nxt),
                advance=lambda env, s, max_wait=512: adv(s),
                issue=lambda env, s, a, p: issue(s, a, p),
                rush=jax.jit(_traced_with_lax(JS.worker_rush(jenv))),
                eval=jax.jit(lambda st, pl: JE.simple_sqrt_eval3(
                    st, pl, jenv.cfg.engine)))


@contextlib.contextmanager
def _jitted_minimax(jenv):
    """JAX's minimax module with its enumerator, issue and advance
    jitted (its playouts run on concrete values around the jitted
    WorkerRush and evaluation the bots are given)."""
    P = _parts(jenv)
    real = dict(make_enumerator=JMM.make_enumerator, _advance=JMM._advance,
                _issue_player=JMM._issue_player)
    JMM.make_enumerator = lambda env: (P["init"], P["next"])
    JMM._advance, JMM._issue_player = P["advance"], P["issue"]
    try:
        yield P
    finally:
        for n, f in real.items():
            setattr(JMM, n, f)


def lane(s: State, b: int):
    """Game ``b`` of a port State batch as one unbatched JAX State."""
    js = jax_state(State(**{f: getattr(s, f)[b:b + 1] for f in FIELD_DTYPES}))
    return jax.tree.map(lambda x: x[0], js)


def jax_dfs(make, kw, s: State, player: int):
    """JAX's ``make(jenv, **kw)`` bot (ABCD / RTMinimax and their ID
    variants) on every game of ``s``, one by one: (actions numpy ``[B, H,
    W, 7]``, the final DFS carries of each game, one per search)."""
    jenv, _ = tree_envs()
    with _jitted_minimax(jenv) as P:
        extra = dict(eval_fn=P["eval"])
        if make in (JMM.abcd_bot, JMM.id_abcd_bot):
            extra["playout_bot"] = P["rush"]
        bot = make(jenv, **kw, **extra)
        acts, carries = [], []
        for b in range(s.batch):
            out = []
            with concrete_loops(out):
                acts.append(np.asarray(bot(lane(s, b), player,
                                           jax.random.PRNGKey(b))))
            carries.append(out)
    return np.stack(acts), carries


# ----------------------------------------------------------------------
# IDRTMinimaxRandomized: JAX's coins, the bot jitted whole

@functools.lru_cache(maxsize=None)
def _coin_fn(budget):
    """The coin table of one DFS key: entry 0 the root entry's coin
    (``k0``), entry n the n-th push's (the ``kE`` split off after ``kF``,
    minimax.py:101-102, :130-131, :202, :234)."""
    def coin(k):
        return jax.random.randint(jax.random.split(k)[1], (), 0, 2)

    def push(key, _):
        key, kE = jax.random.split(key)
        return key, coin(kE)

    def f(key):
        key, k0 = jax.random.split(key)
        key, _ = jax.random.split(key)
        _, out = jax.lax.scan(push, key, None, length=budget)
        return jnp.concatenate([coin(k0)[None], out]).astype(jnp.int32)
    return jax.jit(jax.vmap(f))


def randomized_coins(keys, K, R, budget):
    """int32 ``[B, K, R, budget + 1]``: the coins of JAX's randomized
    bot's DFS lanes for per-game ``keys`` ``[B, 2]`` (``split(key, K)``
    per root action, ``split(k, R)`` per repeat)."""
    B = keys.shape[0]
    ks = jax.vmap(lambda k: jax.random.split(k, K))(keys).reshape(-1, 2)
    ks = jax.vmap(lambda k: jax.random.split(k, R))(ks).reshape(-1, 2)
    return torch.from_numpy(np.array(_coin_fn(budget)(ks))).reshape(
        B, K, R, budget + 1)


@functools.lru_cache(maxsize=None)
def _jax_randomized(kw_items):
    jenv, _ = tree_envs()
    bot = JMM.idrt_minimax_randomized_bot(jenv, eval_fn=_parts(jenv)["eval"],
                                          **dict(kw_items))
    real = jnp.argmax

    def f(s, k, player):
        seen = []

        def argmax(x, *a, **k2):
            seen.append(x)
            return real(x, *a, **k2)
        jnp.argmax = argmax
        try:
            act = bot(s, player, k)
        finally:
            jnp.argmax = real
        return act, seen[-1]
    return _jit(jax.vmap(f, in_axes=(0, 0, None)))


def jax_randomized(kw, s: State, player: int, keys):
    """JAX's IDRTMinimaxRandomized on every game of ``s`` (one jit of the
    whole bot, vmapped, the player traced): (actions, scores float32 ``[B,
    K]``)."""
    act, sc = _jax_randomized(tuple(sorted(kw.items())))(
        jax_state(s), keys, jnp.int32(player))
    return np.asarray(act), np.asarray(sc)


# ----------------------------------------------------------------------
# SampledABCD: JAX's uniforms, the bot eager around jitted parts

@functools.lru_cache(maxsize=None)
def _uniform_fn(K, h, w):
    def side(k):
        ks = jax.random.split(k, K)[1:]
        return jax.vmap(lambda kk: jax.random.uniform(kk, (h, w, 2)))(ks)

    def f(key):
        kA, kB, _ = jax.random.split(key, 3)
        return jnp.stack([side(kA), side(kB)])
    return jax.jit(jax.vmap(f))


def sampled_uniforms(keys, K, h, w):
    """float32 ``[2, K - 1, B, H, W, 2]``: RandomBiasedAI's uniforms of
    JAX's SampledABCD candidates for per-game ``keys`` (``kA, kB, kP =
    split(key, 3)``; ``split(kA, K)[1:]`` this side's, ``kB``'s the
    opponent's)."""
    u = np.array(_uniform_fn(K, h, w)(keys))        # [B, 2, K-1, H, W, 2]
    return torch.from_numpy(u).permute(1, 2, 0, 3, 4, 5).contiguous()


def jax_sampled(kw, s: State, player: int, keys):
    """JAX's SampledABCD on every game of ``s``, one by one: (actions,
    maximin values float32 ``[B, K]``)."""
    jenv, _ = tree_envs()
    P = _parts(jenv)
    real_rb, real_argmax = JS.random_bot, jnp.argmax
    rb = jax_random_bot(jenv, 5.0)
    JS.random_bot = lambda env, bias: rb
    K = kw["k_moves"]
    seen = []

    def argmax(x, *a, **k):
        if not isinstance(x, jax.core.Tracer) and x.shape == (K,):
            seen.append(np.asarray(x))
        return real_argmax(x, *a, **k)
    try:
        bot = JMM.sampled_abcd_bot(jenv, playout_bot=P["rush"],
                                   eval_fn=P["eval"], **kw)
        acts, vals = [], []
        for b in range(s.batch):
            jnp.argmax = argmax
            try:
                with eager_loops():
                    acts.append(np.asarray(bot(lane(s, b), player,
                                               keys[b])))
            finally:
                jnp.argmax = real_argmax
            vals.append(seen[-1])
    finally:
        JS.random_bot = real_rb
    return np.stack(acts), np.stack(vals)


def top_gaps(x: np.ndarray) -> np.ndarray:
    """Per row, the gap between the largest value and the largest value
    below it (inf where there is none)."""
    x = np.asarray(x, np.float64)
    top = x.max(-1, keepdims=True)
    below = np.where(x < top, x, -np.inf).max(-1)
    return np.where(np.isfinite(top[..., 0]), top[..., 0] - below, np.inf)


def assert_stack_eq(carry, stk, b, where):
    """Game ``b`` of the port's stacks equal to JAX's final DFS carry of
    that game: every row (row S too) of the states, odometers, contexts
    and scalars, the root action and flags, the stack pointer, ``done``
    and the trip count."""
    from microrts_tpu_torch.ops.enumerate import unpack_arms
    (states, ochoice, omore, ctxs, alpha, beta, best, mover, nextsim,
     down_arms, root_arms, root_set, sp, _, done, it) = carry
    n1 = stk.alpha.shape[1]
    A = np.asarray(ctxs.la).shape[-1]
    got = dict(alpha=alpha, beta=beta, best=best, mover=mover,
               nextsim=nextsim, down_arms=down_arms, root_arms=root_arms,
               root_set=root_set, sp=sp, done=done, it=it)
    for f, a in got.items():
        assert_eq(a, getattr(stk, f)[b], f"{where} game {b}: {f}")
    assert_eq(ochoice, stk.od.choice[b], f"{where} game {b}: choice")
    assert_eq(omore, stk.od.more[b], f"{where} game {b}: more")
    assert_eq(ctxs.la, unpack_arms(stk.ctx.la[b], A).reshape(
        np.asarray(ctxs.la).shape), f"{where} game {b}: la")
    for f in ("claimed0", "spent0", "balance"):
        assert_eq(getattr(ctxs, f), getattr(stk.ctx, f)[b],
                  f"{where} game {b}: {f}")
    for f in FIELD_DTYPES:
        got = getattr(stk.states, f)[b * n1:(b + 1) * n1]
        assert_eq(getattr(states, f), got, f"{where} game {b}: states.{f}")


def check_dfs(jmake, make, kw, player, deepening=None):
    """The port's ``make(env, **kw)`` (ABCD / RTMinimax) — or, with
    ``deepening`` (the schedule's argument name), the ID variant over it —
    on the recorded games against JAX's: actions, every search's root
    value and whole stacks equal."""
    jenv, env, s = games()
    ja, carries = jax_dfs(jmake, kw, s, player)
    bot = make(env, **kw)
    if deepening:   # the bot's own searches, each one's result recorded
        outs, runs = [], list(bot.bot.runs)
        bot.bot.runs[:] = [lambda st, p, r=r, **kw: outs.append(
            r(st, p, **kw)) or outs[-1] for r in runs]
        act = bot(s, player)
    else:
        outs = [bot.bot.run(s, player)]
        act = outs[0][0]
    assert len(outs) == len(carries[0])
    for i, (_, val, stk) in enumerate(outs):
        for b in range(s.batch):
            c = carries[b][i]
            assert_stack_eq(c, stk, b, f"search {i}")
            assert_eq(np.asarray(c[6])[0], val[b], f"search {i} value")
    assert_eq(ja, act, "action")
    return act, stk


def held_games(name, score, player):
    """The games whose top two scores are more than ``MARGIN`` apart
    (bool ``[B]``), the gaps printed; at least one."""
    gap = top_gaps(score)
    print(f"{name} p{player}: top-two gap per game {gap.tolist()}")
    held = gap > MARGIN
    assert held.any(), gap
    return held
