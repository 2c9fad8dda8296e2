"""Helpers of the tree-search parity tests: the JAX package's
``naive_mcts_bot`` and ``uct_tree_bot`` run eagerly under ``vmap`` around
the env's jitted parts (``lax.fori_loop``, ``lax.scan`` and
``lax.while_loop`` as Python loops: jitting a JAX tree-search bot takes
minutes of CPU compile), the draws of their key trees laid out as the
port's noise sources, the float argmaxes' margins of the port's plain
path, and the comparison of whole trees.

Floats: the playout values are exact (tests/test_torch_make_playout.py),
so are the sums and quotients of the tables; ``log`` and ``sqrt`` may
round an ulp apart between XLA and PyTorch.  Every float argmax of the
port's plain path (``ops.arms.first_max``) is recorded: per game, the gap
between the largest value and the largest value below it.  A game whose
gaps all reach ``MARGIN`` is held exactly; at least one game must be."""

import contextlib
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import scripted as JS
from microrts_tpu.bots import treesearch as JTS
from microrts_tpu.ops import evaluation as JE
from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State
from microrts_tpu_torch.ops import arms as AR

from torch_parity import assert_eq, jax_state, leaves
from torch_playout_parity import (eager_loops, jax_random_bot, patched_envs,
                                  playout_noise, recorded)

MAP = "maps/8x8/basesWorkers8x8.xml"
# JAX's own small budget (tests/test_treesearch.py TINY)
TINY = dict(n_playouts=6, max_nodes=12, max_children=4, max_depth=3,
            playout_len=8)
UCT_TINY = dict(n_playouts=6, max_nodes=12, n_candidates=4, max_depth=3,
                playout_len=8)
MARGIN = 1e-6
# the helpers' compiles at LLVM's lowest level (no fast math: the same
# IEEE results), about half the CPU compile time; nested jits take their
# caller's options
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


def _py_fori(lower, upper, body, init, **kw):
    v = init
    for i in range(lower, upper):
        v = body(i, v)
    return v


@contextlib.contextmanager
def eager_tree_loops():
    """``eager_loops`` and ``lax.fori_loop`` as a Python loop."""
    fori = jax.lax.fori_loop
    jax.lax.fori_loop = _py_fori
    try:
        with eager_loops():
            yield
    finally:
        jax.lax.fori_loop = fori


@functools.lru_cache(maxsize=None)
def tree_envs():
    """(JAX env with its parts, ``issue`` and ``gameover`` jitted, the
    port env on the CPU)."""
    jenv, env = patched_envs(MAP)
    eng = jenv.engine
    if not hasattr(eng.issue, "lower"):
        jenv.engine = eng._replace(issue=jax.jit(eng.issue))
    return jenv, env


@functools.lru_cache(maxsize=None)
def games(n=4):
    """``n`` recorded 8x8 games (RandomBiasedAI self-play at ticks 5, 20,
    45) in which both players have idle units."""
    jenv, env = tree_envs()
    s = recorded(MAP)[2]
    rows = [i for i in range(s.batch)
            if all(bool(((s.utype[i] > 0) & (s.owner[i] == p)
                         & ~s.busy[i]).any()) for p in (0, 1))][:n]
    idx = torch.tensor(rows)
    return jenv, env, State(**{f: getattr(s, f)[idx] for f in FIELD_DTYPES})


@functools.lru_cache(maxsize=None)
def _jax_eval(jenv):
    ecfg = jenv.cfg.engine
    return _jit(lambda s, p: JE.simple_sqrt_eval3(s, p, ecfg))


_LAX_LOOPS = (jax.lax.scan, jax.lax.while_loop, jax.lax.fori_loop)
# JAX's module-level helpers that the tree-search closures call, jitted
# whole (the same functions, compiled; the env's parts are jitted already)
_HELPERS = ("_row", "_get_state", "_set_state", "_can_act", "_advance",
            "_issue_player", "arm_masks", "sample_arms", "arms_to_action",
            "one_hot_arms")
_REAL = {n: getattr(JTS, n) for n in _HELPERS}


@contextlib.contextmanager
def _lax_loops():
    """JAX's own loops (while a jitted part is traced)."""
    now = (jax.lax.scan, jax.lax.while_loop, jax.lax.fori_loop)
    jax.lax.scan, jax.lax.while_loop, jax.lax.fori_loop = _LAX_LOOPS
    try:
        yield
    finally:
        jax.lax.scan, jax.lax.while_loop, jax.lax.fori_loop = now


def _traced_with_lax(fn):
    def f(*a):
        with _lax_loops():
            return fn(*a)
    return f


@functools.lru_cache(maxsize=None)
def _jitted_helpers(jenv):
    R = _REAL
    sp = JTS.arm_space(jenv)
    adv = _jit(_traced_with_lax(lambda s: R["_advance"](jenv, s)))
    issue = _jit(lambda s, a, p: R["_issue_player"](jenv, s, a, p))
    sample = _jit(lambda k, pr, ac: R["sample_arms"](sp, k, pr, ac))
    return dict(
        _row=jax.jit(R["_row"]), _get_state=jax.jit(R["_get_state"]),
        _set_state=jax.jit(R["_set_state"]),
        _can_act=jax.jit(R["_can_act"]),
        _advance=lambda env, s, max_wait=512: adv(s),
        _issue_player=lambda env, s, a, p: issue(s, a, p),
        arm_masks=jax.jit(R["arm_masks"], static_argnums=0),
        sample_arms=lambda _, k, pr, ac: sample(k, pr, ac),
        arms_to_action=jax.jit(R["arms_to_action"], static_argnums=0),
        one_hot_arms=jax.jit(R["one_hot_arms"], static_argnums=0))


@contextlib.contextmanager
def _jitted_parts(jenv):
    """JAX's rollout bot and the tree search's helpers jitted."""
    real, jitted = JS.random_bot, jax_random_bot(jenv, 5.0)
    JS.random_bot = lambda env, bias: jitted
    for n, f in _jitted_helpers(jenv).items():
        setattr(JTS, n, f)
    try:
        yield
    finally:
        JS.random_bot = real
        for n, f in _REAL.items():
            setattr(JTS, n, f)


def jax_naive_search(jenv, kw, js, players, keys):
    """JAX's ``init_tree`` + ``search`` + ``best_action`` of
    ``naive_mcts_bot(jenv, **kw)`` for every lane (``players`` int32, one
    per lane): (tree, action)."""
    with _jitted_parts(jenv):
        bot = JTS.naive_mcts_bot(jenv, eval_fn=_jax_eval(jenv), **kw)

        def one(s, k, p):
            t = bot.search(bot.init_tree(s, p), p, s.time, k)
            return t, bot.best_action(t)
        with eager_tree_loops():
            return jax.vmap(one)(js, keys, players)


def jax_uct_search(jenv, kw, js, players, keys):
    """JAX's ``uct_tree_bot(jenv, **kw)`` for every lane, its final tree
    read off the iterations' loop: (tree, action)."""
    trees = []

    def fori(lower, upper, body, init, **k):
        out = _py_fori(lower, upper, body, init)
        if upper == kw["n_playouts"] and isinstance(out, tuple) \
                and isinstance(out[0], JTS._UCTTree):
            trees.append(out[0])
        return out
    with _jitted_parts(jenv):
        bot = JTS.uct_tree_bot(jenv, eval_fn=_jax_eval(jenv), **kw)

        def one(s, k, p):
            act = bot(s, p, k)
            return trees[-1], act
        with eager_tree_loops():
            jax.lax.fori_loop = fori
            return jax.vmap(one)(js, keys, players)


# ----------------------------------------------------------------------
# JAX's draws as the port's noise

def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _naive_iter_fn(D, C, h, w, A):
    def f(key):
        key, kd, kp = jax.random.split(key, 3)
        k, out = kd, []
        for _ in range(D + 2):
            k, k0, k1, k2, k3 = jax.random.split(k, 5)
            out.append((jax.random.uniform(k0),
                        jnp.stack([jax.random.randint(k1, (), 0, m)
                                   for m in range(1, C + 1)]),
                        jax.random.uniform(k2),
                        jax.random.gumbel(k3, (h, w, A))))
        return key, kp, out
    return _jit(jax.vmap(f))


class ArrayMCTSNoise:
    """``TS.MCTSNoise`` holding the draws of JAX's key tree for per-game
    ``keys`` ``[B, 2]`` (``search``'s key)."""

    def __init__(self, env, keys, n_playouts, D, C, n_dec):
        sp = AR.arm_space(env)
        fn = _naive_iter_fn(D, C, env.h, env.w, sp.n_arms)
        self.steps, self.plays = [], []
        for _ in range(n_playouts):
            keys, kp, out = fn(keys)
            self.steps.append([TS.TreeStep(_t(a), _t(b).to(torch.int32),
                                           _t(c), _t(g))
                               for a, b, c, g in out])
            self.plays.append(playout_noise(kp, n_dec, env.h, env.w))

    def step(self, it, d):
        return self.steps[it][d]

    def play(self, it):
        return self.plays[it]


@functools.lru_cache(maxsize=None)
def _uct_fns(D, K, h, w, A):
    def cands(k):
        return jax.vmap(lambda kk: jax.random.gumbel(kk, (h, w, A)))(
            jax.random.split(k, K))

    def it(key):
        key, kd, kp = jax.random.split(key, 3)
        k, out = kd, []
        for _ in range(D + 2):
            k, kc2 = jax.random.split(k)
            out.append(cands(kc2))
        return key, kp, jnp.stack(out)

    def root(key):
        key, kc = jax.random.split(key)
        return key, cands(kc)
    return _jit(jax.vmap(root)), _jit(jax.vmap(it))


class ArrayUCTNoise:
    """``TS.UCTTreeNoise`` holding the draws of JAX's key tree for the
    bot's per-game ``keys`` ``[B, 2]``."""

    def __init__(self, env, keys, n_playouts, D, K, n_dec):
        sp = AR.arm_space(env)
        root, it = _uct_fns(D, K, env.h, env.w, sp.n_arms)
        keys, r = root(keys)
        self.r = _t(r)
        self.steps, self.plays = [], []
        for _ in range(n_playouts):
            keys, kp, out = it(keys)
            self.steps.append(_t(out))          # [B, D+2, K, H, W, A]
            self.plays.append(playout_noise(kp, n_dec, env.h, env.w))

    def root(self):
        return self.r

    def step(self, i, d):
        return self.steps[i][:, d]

    def play(self, i):
        return self.plays[i]


def naive_noise(env, keys, kw):
    n_dec = kw.get("n_decisions") or max(2, kw["playout_len"] // 4)
    return ArrayMCTSNoise(env, keys, kw["n_playouts"], kw["max_depth"],
                          kw["max_children"], n_dec)


def uct_noise(env, keys, kw):
    n_dec = kw.get("n_decisions") or max(2, kw["playout_len"] // 4)
    return ArrayUCTNoise(env, keys, kw["n_playouts"], kw["max_depth"],
                         kw["n_candidates"], n_dec)


# ----------------------------------------------------------------------
# margins and trees

@contextlib.contextmanager
def recording_margins(monkeypatch, margins):
    """Record, per game, the smallest gap of every float argmax of the
    port's plain path into ``margins`` (a list of float64 ``[B]``)."""
    real = AR.first_max

    def first_max(x):
        top = x.amax(-1, keepdim=True)
        below = torch.where(x < top, x, float("-inf")).amax(-1)
        gap = (top[..., 0] - below).to(torch.float64)
        gap = torch.where(torch.isinf(top[..., 0]), float("inf"), gap)
        margins.append(gap.flatten(1).amin(1) if gap.dim() > 1 else gap)
        return real(x)
    monkeypatch.setattr(AR, "first_max", first_max)
    yield


def held_games(margins):
    m = torch.stack(margins).amin(0)
    return (m >= MARGIN).numpy(), m


def assert_tree_eq(jtree, tree, games, where):
    """Every array of the JAX tree equal to the port's, in ``games``."""
    B, n1 = tree.nplayer.shape
    for f in type(tree).FIELDS:
        a = np.asarray(getattr(jtree, f))
        b = getattr(tree, f).numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert_eq(a[games], b[games], f"{where}: {f}")
    js = leaves(jtree.states)
    for f in FIELD_DTYPES:
        got = getattr(tree.states, f).numpy()
        got = got.reshape((B, n1) + got.shape[1:])
        assert_eq(js[f][games], got[games], f"{where}: states.{f}")


def _both_players(seed):
    """(JAX env, port env, the recorded games, JAX's lanes: every game
    for player 0 then for player 1, their players and keys)."""
    jenv, env, s = games()
    js = jax_state(s)
    js2 = jax.tree.map(lambda x: jnp.concatenate([x, x]), js)
    players = jnp.repeat(jnp.arange(2, dtype=jnp.int32), s.batch)
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * s.batch)
    return jenv, env, s, js2, players, keys


def _lanes(tree, player, B):
    sl = slice(player * B, (player + 1) * B)
    return jax.tree.map(lambda x: x[sl], tree)


@functools.lru_cache(maxsize=None)
def _jax_trees(kind, kw_items, seed):
    """JAX's trees and actions of both players' lanes (one vmap of 8
    lanes, so that the two players' tests of a file share one search)."""
    jenv, _, _, js2, pl, keys = _both_players(seed)
    search = jax_naive_search if kind == "naive" else jax_uct_search
    return search(jenv, dict(kw_items), js2, pl, keys)


def _check(kind, monkeypatch, kw, seed, p):
    jenv, env, s, js2, pl, keys = _both_players(seed)
    B = s.batch
    jtree, jact = _jax_trees(kind, tuple(sorted(kw.items())), seed)
    margins = []
    with recording_margins(monkeypatch, margins):
        lane_keys = keys[p * B:(p + 1) * B]
        if kind == "naive":
            bot = TS.naive_mcts_bot(env, **kw).bot
            nz = naive_noise(env, lane_keys, kw)
            tree = bot.init_tree(s, p)
        else:
            bot = TS.uct_tree_bot(env, **kw).bot
            nz = uct_noise(env, lane_keys, kw)
            tree = bot.init_tree(s, p, nz.root())
        bot.search(tree, p, s.time, nz)
        act = bot.best_action(tree)
    held, m = held_games(margins)
    print(f"{kind} {kw} p{p}: smallest margin per game {m.tolist()}")
    assert held.any(), m
    assert_tree_eq(_lanes(jtree, p, B), tree, held, f"{kind} p{p}")
    assert_eq(np.asarray(jact)[p * B:(p + 1) * B][held],
              act.numpy()[held], f"{kind} p{p} action")
    return tree


def check_naive(monkeypatch, kw, seed, player):
    """``naive_mcts_bot(**kw)``'s tree and action for ``player`` equal to
    JAX's on the recorded games; returns the port's tree."""
    return _check("naive", monkeypatch, kw, seed, player)


def check_uct(monkeypatch, kw, seed, player):
    """``uct_tree_bot(**kw)``'s tree and action for ``player`` equal to
    JAX's on the recorded games; returns the port's tree."""
    return _check("uct", monkeypatch, kw, seed, player)


# ----------------------------------------------------------------------
# games

def jax_naive_games(kw, n_games, max_cycles, seed):
    """JAX's game loop (eval/tournament.py ``chunk_fn``, followed line by
    line as tests/torch_tournament_parity.py does) of ``naive_mcts_bot(**kw)``
    as player 0 vs WorkerRush from per-lane keys.  Returns (winners numpy,
    final JAX State, ``noise(frame, player, bot, lanes)`` for the port's
    runner: the NaiveMCTS draws of each frame's keys)."""
    from microrts_tpu.config import make_bot as jax_make_bot
    from torch_tournament_parity import _pieces
    jenv, env = tree_envs()
    f = _pieces(jenv, max_cycles)

    def step(s, a0, a1):
        # env.step's state: decode, issue_env, decode, issue_env, cycle,
        # the env's own jitted parts (compiled once for the playouts too)
        def dec(st, a, p):
            return jenv.decode(st, a, p, jenv._inflight_claims(st),
                               jenv._inflight_spent(st, p))[0]
        eng = jenv.engine
        s1 = eng.issue_env(s, dec(s, a0, 0))
        return eng.cycle(eng.issue_env(s1, dec(s1, a1, 1)))
    rush = _jit(jax.vmap(jax_make_bot("WorkerRush", jenv),
                         in_axes=(0, None, 0)))
    with _jitted_parts(jenv):
        bot = JTS.naive_mcts_bot(jenv, eval_fn=_jax_eval(jenv), **kw)

        def naive(s, k):
            with eager_tree_loops():
                return jax.vmap(bot, in_axes=(0, None, 0))(s, 0, k)

        keys = jax.random.split(jax.random.PRNGKey(seed), n_games)
        s = jax.vmap(jenv.reset)(keys)
        done = jnp.zeros(n_games, bool)
        winner = jnp.full(n_games, -1, jnp.int32)
        frame_keys = []
        for _ in range(max_cycles):
            s, d_ff = f["ff"](s, done)
            s, d_ff = f["ff"](s, d_ff)
            winner = jnp.where(done, winner,
                               jnp.where(d_ff, f["winner"](s), -1))
            done = done | d_ff | (s.time >= max_cycles)
            ks = f["split3"](keys)
            keys, k0, k1 = ks[:, 0], ks[:, 1], ks[:, 2]
            frame_keys.append(k0)
            a0, a1 = naive(s, k0), rush(s, 1, k1)
            s2, done2 = jax.vmap(step)(s, a0, a1)
            s = f["freeze"](done, s, s2)
            winner = jnp.where(done, winner,
                               jnp.where(done2, f["winner"](s2), -1))
            done = done | done2
            if bool(done.all()):
                break

    def noise(frame, player, b, lanes):
        if b == 1:
            return None
        k = frame_keys[min(frame, len(frame_keys) - 1)]
        return naive_noise(env, k, kw)
    return np.asarray(winner), s, noise, len(frame_keys)
