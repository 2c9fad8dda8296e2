"""Alpha-beta search considering durations: ABCD, RTMinimax, their
iterative-deepening and randomized variants, and SampledABCD.

A port of ``microrts_tpu.bots.minimax`` (see its docstring for the Java
sources, ai/minimax/ABCD and ai/minimax/RTMiniMax, the semantics matched
and the documented budget divergences).  The Java recursion is an
iterative depth-first search over a fixed explicit stack of ``S + 1``
rows a lane (row ``S`` the write scratch, as JAX's), every lane of the
batch one search: node ``i`` of lane ``b`` keeps its ``State`` in row ``b
* (S + 1) + i`` of a stacked ``State``, its odometer (``ops.enumerate``)
and scalars in ``[B, S + 1, ...]`` tables.

One trip of the search, for every lane at once (minimax.py:151-232):
lanes whose node is finished (odometer exhausted or ``beta <= alpha``)
pop, the others draw their node's next joint action (``enum_next``,
K12e); a valid draw is issued for the node's mover (``arms_to_action``,
``decode``, ``issue_env``), the state advanced to the next decision point
(``event_jump`` + ``cycle``) and the child entered: its mover, the leaf
test, the mask of its mover (``actor``) and, where a pushing lane reaches
a leaf, the leaf's value (a WorkerRush playout of ``playout_len`` ticks
for ABCD, the evaluation for RTMinimax; skipped in a trip where no
pushing lane reaches a leaf).  ``minimax_step`` (K12f) then applies the
pop or the push in place: the strict first-best backup with alpha-beta,
the root's best action, the child's rows, its odometer context (packed
legal arms, in-flight claims and spend) and the per-lane state of the
node now on top.  CPU tensors (or an env built with ``plain=True``) take
the plain versions beside each kernel.

Randomness enters as tensors: IDRTMinimaxRandomized reads a coin table
int32 ``[B, K, R, budget + 1]`` (entry 0 the root entry's coin, entry
``n`` the ``n``-th push's); SampledABCD reads RandomBiasedAI's uniforms
float32 ``[2, K - 1, B, H, W, 2]`` for its candidates.  The others draw
nothing (WorkerRush is deterministic).  Where the env needs the engine's
draws (UTT v3's damage; CANCEL_RANDOM's coins under fog for SampledABCD's
first tick), every bot's noise also holds an ``ops.playout.EngineNoise``
that draws them on demand (the DFS's cycles depend on the search); JAX
draws them from the states' keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import kernels as KN
from ..engine.types import FIELD_DTYPES, State
from ..env.gridnet import GridnetEnv
from ..ops.arms import arm_space, arms_to_action, first_max
from ..ops.enumerate import EnumCtx, Odometer, ctx_of, make_enumerator
from ..ops.playout import EngineNoise, can_act, make_playout, repeat_lanes
from .scripted import Opponent, random_bot, worker_rush
from .search import _default_eval
from .treesearch import ADVANCE_EVENTS, _advance, _issue_player, stacked_rows

I32 = torch.int32
F32 = torch.float32
VICTORY = float(np.float32(1e5))


@dataclasses.dataclass
class Stack:
    """The DFS stacks of ``B`` lanes (``S + 1`` rows each, row ``S`` the
    scratch)."""
    states: State             # [B * (S+1)] rows b * (S+1) + i
    cur: State                # [B] the state of row sp[b]
    od: Odometer              # choice i32 [B, S+1, HW], more bool [B, S+1]
    ctx: EnumCtx              # [B, S+1, ...]
    alpha: torch.Tensor       # f32 [B, S+1]
    beta: torch.Tensor        # f32 [B, S+1]
    best: torch.Tensor        # f32 [B, S+1]
    mover: torch.Tensor       # i32 [B, S+1]
    nextsim: torch.Tensor     # i32 [B, S+1]
    down_arms: torch.Tensor   # i32 [B, S+1, H, W] the arms pushed below
    root_arms: torch.Tensor   # i32 [B, H, W]
    root_set: torch.Tensor    # bool [B] a root child fully evaluated
    sp: torch.Tensor          # i32 [B] the row on top
    done: torch.Tensor        # bool [B] the root popped
    it: torch.Tensor          # i32 [B] trips taken
    npush: torch.Tensor       # i32 [B] pushes made

    FIELDS = ("alpha", "beta", "best", "mover", "nextsim", "down_arms",
              "root_arms", "root_set", "sp", "done", "it", "npush")

    def tensors(self) -> dict:
        """Every table by name (``od.*``, ``ctx.*`` and the fields)."""
        out = {f: getattr(self, f) for f in self.FIELDS}
        out.update({f"od.{f}": getattr(self.od, f) for f in Odometer._fields})
        out.update({f"ctx.{f}": getattr(self.ctx, f)
                    for f in EnumCtx._fields})
        return out

    def clone(self) -> "Stack":
        return Stack(
            states=self.states.clone(), cur=self.cur.clone(),
            od=Odometer(*[t.clone() for t in self.od]),
            ctx=EnumCtx(*[t.clone() for t in self.ctx]),
            **{f: getattr(self, f).clone() for f in self.FIELDS})


class Trip(NamedTuple):
    """One trip's inputs to ``minimax_step`` for ``B`` lanes: which lanes
    run (``live``), pop (``live & finish``) and push (``push``); the drawn
    arms int32 ``[B, H, W]``; and the entered child of the pushing lanes:
    its state, its mover's packed mask int32 ``[B, H, W, M]``, mover and
    alternation int32 ``[B]``, leaf flag and initial best float32 ``[B]``
    (``st2`` None where no lane pushes)."""
    live: torch.Tensor
    finish: torch.Tensor
    push: torch.Tensor
    arms: torch.Tensor
    st2: Optional[State] = None
    mask2: Optional[torch.Tensor] = None
    mover2: Optional[torch.Tensor] = None
    nextsim2: Optional[torch.Tensor] = None
    leaf2: Optional[torch.Tensor] = None
    best2: Optional[torch.Tensor] = None


def new_stack(state: State, S: int, ctx0: EnumCtx, more0, mover0, nextsim0,
              best0) -> Stack:
    """The stacks of ``state``'s lanes with the root entered
    (minimax.py:185-197): every row the root's state and context."""
    B, dev = state.batch, state.device
    HW = state.utype.shape[1] * state.utype.shape[2]
    n1 = S + 1

    def rows0(x, fill, dt):
        t = torch.full((B, n1), fill, dtype=dt, device=dev)
        t[:, 0] = x
        return t
    omore = torch.zeros((B, n1), dtype=torch.bool, device=dev)
    omore[:, 0] = more0
    return Stack(
        states=State(**{f: getattr(state, f).repeat_interleave(n1, 0)
                        for f in FIELD_DTYPES}),
        cur=state.clone(),
        od=Odometer(torch.zeros((B, n1, HW), dtype=I32, device=dev), omore),
        ctx=EnumCtx(*[t.expand((B, n1) + t.shape[2:]).contiguous()
                      for t in ctx0]),
        alpha=torch.full((B, n1), -VICTORY, dtype=F32, device=dev),
        beta=torch.full((B, n1), VICTORY, dtype=F32, device=dev),
        best=rows0(best0, 0.0, F32), mover=rows0(mover0, 0, I32),
        nextsim=rows0(nextsim0, 0, I32),
        down_arms=torch.full((B, n1) + tuple(state.utype.shape[1:]), -1,
                             dtype=I32, device=dev),
        root_arms=torch.full(tuple(state.utype.shape), -1, dtype=I32,
                             device=dev),
        root_set=torch.zeros(B, dtype=torch.bool, device=dev),
        sp=torch.zeros(B, dtype=I32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        it=torch.zeros(B, dtype=I32, device=dev),
        npush=torch.zeros(B, dtype=I32, device=dev))


# ======================================================================
# K12f: one trip's pop or push

def minimax_step(env: GridnetEnv, stk: Stack, trip: Trip, maxp: int) -> None:
    """Apply one trip's pop (``live & finish`` lanes) or push (``push``
    lanes) to every lane's stack in place (minimax.py:159-225) and count
    the trip (``it``: 1 a trip, 2 a push, as JAX counts) of every live
    lane."""
    if env.engine._use_kernel(stk.alpha):
        KN.MINIMAX_STEP(env.cfg.engine, arm_space(env), stk, trip, maxp)
    else:
        minimax_step_plain(env, stk, trip, maxp)


def _put(t: torch.Tensor, rows, idx, on, val) -> None:
    """``t[b, idx[b]] = val[b]`` where ``on[b]``."""
    old = t[rows, idx]
    m = on.reshape((-1,) + (1,) * (old.dim() - 1))
    t[rows, idx] = torch.where(m, val, old)


def minimax_step_plain(env, stk: Stack, trip: Trip, maxp: int) -> None:
    B, n1 = stk.alpha.shape
    S = n1 - 1
    rows = torch.arange(B, device=stk.alpha.device)
    L = stk.sp.long()
    pop = trip.live & trip.finish

    # pop: strict first-best backup into the parent (row S where it does
    # not apply), alpha at a max node, beta at a min node
    v = stk.best[rows, L]
    at_root = L == 0
    P = (L - 1).clamp(min=0)
    is_max = stk.mover[rows, P] == maxp
    bp = stk.best[rows, P]
    better = torch.where(is_max, v > bp, v < bp) & ~at_root
    a_new = torch.maximum(stk.alpha[rows, P], v)
    b_new = torch.minimum(stk.beta[rows, P], v)
    _put(stk.best, rows, torch.where(better, P, S), pop, v)
    _put(stk.alpha, rows, torch.where(is_max & ~at_root, P, S), pop, a_new)
    _put(stk.beta, rows, torch.where(is_max | at_root, S, P), pop, b_new)
    hit = pop & better & (P == 0)
    stk.root_arms.copy_(torch.where(hit[:, None, None], stk.down_arms[:, 0],
                                    stk.root_arms))
    stk.root_set |= hit
    nxt = torch.where(pop, P, L)
    cur = stk.cur.select(pop, stacked_rows(stk.states, n1, P))

    # push: the anytime fallback, the child's rows and context
    push = trip.push
    if trip.st2 is not None:
        first = push & at_root & ~stk.root_set
        stk.root_arms.copy_(torch.where(first[:, None, None], trip.arms,
                                        stk.root_arms))
        C = (L + 1).clamp(max=S)
        flat = rows * n1 + C
        for f in FIELD_DTYPES:
            t = getattr(stk.states, f)
            m = push.reshape((-1,) + (1,) * (t.dim() - 1))
            t[flat] = torch.where(m, getattr(trip.st2, f), t[flat])
        ctx = ctx_of(env, trip.st2, trip.mover2, trip.mask2)
        for name, val in zip(EnumCtx._fields, ctx):
            _put(getattr(stk.ctx, name), rows, C, push, val[:, 0])
        _put(stk.od.choice, rows, C, push, torch.zeros_like(
            stk.od.choice[:, 0]))
        _put(stk.od.more, rows, C, push, ~trip.leaf2)
        _put(stk.alpha, rows, C, push, stk.alpha[rows, L])
        _put(stk.beta, rows, C, push, stk.beta[rows, L])
        _put(stk.best, rows, C, push, trip.best2)
        _put(stk.mover, rows, C, push, trip.mover2)
        _put(stk.nextsim, rows, C, push, trip.nextsim2)
        _put(stk.down_arms, rows, L, push, trip.arms)
        stk.npush += push.to(I32)
        nxt = torch.where(push, C, nxt)
        cur = cur.select(push, trip.st2)
    for f in FIELD_DTYPES:
        getattr(stk.cur, f).copy_(getattr(cur, f))
    stk.sp.copy_(nxt.to(I32))
    stk.done |= pop & at_root
    # a trip costs 1, a push 2 (JAX's push adds 1 to the draw's count)
    stk.it += trip.live.to(I32) + push.to(I32)


# ======================================================================
# the shared DFS

def _make_dfs(env: GridnetEnv, *, alt: bool, max_depth: int,
              lookahead: Optional[int], stack_cap: int, node_budget: int,
              playout_len: int, playout_bot: Optional[Callable], eval_fn,
              randomized: bool = False):
    """The fixed-stack alpha-beta DFS (minimax.py:69-260).
    ``lookahead=None`` cuts leaves by ply depth (ABCD), otherwise by game
    time (RTMinimax); ``randomized`` picks the mover of a simultaneous
    node by the coin table (IDRTMinimaxRandomized).

    Returns ``run(state, maxp, coins=None, draws=None) -> (action int32
    [B, H, W, 7], root value float32 [B], Stack)``; ``draws`` (an
    ``EngineNoise``) gives the cycles' damage uniforms under random
    damage."""
    eng = env.engine
    S = stack_cap
    sp_arm = arm_space(env)
    init_enum, next_action = make_enumerator(env)
    playout = make_playout(env, playout_len, eval_fn, gamma=1.0,
                           rollout_bot=playout_bot)
    no_noise = [(None, None)] * playout.n_decisions
    plain = env.engine.plain

    def entry(st: State, level, nextsim_in, coin, t0, maxp: int):
        """Node entry (minimax.py:80-121): (mover, alternation, leaf)."""
        can_max, can_min = can_act(st, maxp), can_act(st, 1 - maxp)
        both = can_max & can_min
        stay = torch.where(can_max, maxp, 1 - maxp)
        if alt and randomized:
            mover, nextsim = torch.where(both, coin, stay), nextsim_in
        elif alt:
            mover = torch.where(both, nextsim_in, stay)
            nextsim = torch.where(both, 1 - nextsim_in, nextsim_in)
        else:
            mover, nextsim = stay, nextsim_in
        term = eng.gameover(st) | ~(can_max | can_min)
        cut = (level >= max_depth if lookahead is None
               else st.time >= t0 + lookahead)
        return mover.to(I32), nextsim.to(I32), term | cut | (level >= S - 1)

    def u01(draws, cycles: int, lanes: int):
        if not env.random_damage:
            return None
        if draws is None:
            raise ValueError("minimax: random damage (UTT v3) needs draws")
        return draws.u01(cycles, lanes)

    def first_best(st: State, mover, leaf, want, maxp: int, t0, draws):
        """A node's initial best: the leaf's value (played out only where
        ``want`` holds a lane), else -/+ VICTORY."""
        v = torch.zeros(st.batch, dtype=F32, device=st.device)
        if bool(want.any()):
            v = playout(st, maxp, t0, no_noise,
                        u01=u01(draws, playout.n_cycles, st.batch))
        return torch.where(leaf, v, torch.where(mover == maxp, -VICTORY,
                                                VICTORY)).to(F32)

    def run(state: State, maxp: int, coins: Optional[torch.Tensor] = None,
            draws: Optional[EngineNoise] = None):
        maxp = int(maxp)
        B, dev = state.batch, state.device
        rows = torch.arange(B, device=dev)
        t0 = state.time
        zero = torch.zeros(B, dtype=I32, device=dev)
        mover0, nextsim0, leaf0 = entry(
            state, zero, torch.full((B,), maxp, dtype=I32, device=dev),
            None if coins is None else coins[:, 0], t0, maxp)
        best0 = first_best(state, mover0, leaf0, leaf0, maxp, t0, draws)
        stk = new_stack(state, S, ctx_of(env, state, mover0,
                                         env.masks(state, mover0)),
                        ~leaf0, mover0, nextsim0, best0)
        for _ in range(node_budget):
            live = ~stk.done & (stk.it < node_budget)
            if not bool(live.any()):
                break
            L = stk.sp.long()
            finish = ~stk.od.more[rows, L] | (stk.beta[rows, L]
                                              <= stk.alpha[rows, L])
            draw = live & ~finish
            arms, valid, _ = next_action(stk.od, stk.ctx, stk.sp, draw)
            push = draw & valid
            trip = Trip(live, finish, push, arms)
            if bool(push.any()):
                st1 = _issue_player(env, stk.cur, arms_to_action(
                    sp_arm, arms, plain=plain), stk.mover[rows, L])
                st2, _ = _advance(env, st1, u01=u01(draws, ADVANCE_EVENTS, B))
                coin = (None if coins is None
                        else coins[rows, (stk.npush + 1).long()])
                mover2, nextsim2, leaf2 = entry(st2, stk.sp + 1,
                                                stk.nextsim[rows, L], coin,
                                                t0, maxp)
                trip = trip._replace(
                    st2=st2, mask2=env.masks(st2, mover2), mover2=mover2,
                    nextsim2=nextsim2, leaf2=leaf2,
                    best2=first_best(st2, mover2, leaf2, push & leaf2, maxp,
                                     t0, draws))
            minimax_step(env, stk, trip, maxp)

        act = arms_to_action(sp_arm, stk.root_arms, plain=plain)
        if playout_bot is not None:
            # the budget fallback (minimax.py:242-251): the playout
            # policy's own action where no root child finished
            act = torch.where(stk.root_set[:, None, None, None], act,
                              playout_bot(state, maxp))
        can = can_act(state, maxp) & ~eng.gameover(state)
        return (torch.where(can[:, None, None, None], act, 0),
                stk.best[:, 0].clone(), stk)

    run.dims = (S, node_budget)
    return run


def _engine_draw(env: GridnetEnv):
    """``draw`` of a bot whose only noise is the engine's draws: an
    ``EngineNoise`` where the env needs them, else None."""
    def draw(gen: torch.Generator, batch: int) -> Optional[EngineNoise]:
        if env.needs_draws:
            return EngineNoise(env, gen)
        return None
    return draw


def _dfs_opponent(env: GridnetEnv, run) -> Opponent:
    def bot(state: State, player: int, noise=None) -> torch.Tensor:
        return run(state, player, draws=noise)[0]

    bot.run = run
    bot.value_fn = lambda state, player, coins=None, draws=None: run(
        state, player, coins, draws)[1]
    bot.dims = run.dims
    return Opponent(bot, _engine_draw(env))


def abcd_bot(env: GridnetEnv, max_depth: int = 4, playout_len: int = 100,
             node_budget: int = 512, playout_bot: Optional[Callable] = None,
             eval_fn: Optional[Callable] = None) -> Opponent:
    """ABCD, the "alt" alternation (ai/minimax/ABCD/ABCD.java:86-193):
    depth 4, WorkerRush playouts of 100 ticks, SimpleSqrtEval3.  The
    bot exposes ``run``, ``value_fn`` and ``dims`` (stack rows, budget)."""
    if playout_bot is None:
        playout_bot = worker_rush(env)
    return _dfs_opponent(env, _make_dfs(
        env, alt=True, max_depth=max_depth, lookahead=None,
        stack_cap=max_depth + 1, node_budget=node_budget,
        playout_len=playout_len, playout_bot=playout_bot,
        eval_fn=_default_eval(env, eval_fn)))


def rt_minimax_bot(env: GridnetEnv, lookahead: int = 50, stack_cap: int = 12,
                   node_budget: int = 512,
                   eval_fn: Optional[Callable] = None) -> Opponent:
    """RTMinimax: alpha-beta to a game-time horizon, leaves evaluated
    directly (ai/minimax/RTMiniMax/RTMinimax.java:97-180)."""
    return _dfs_opponent(env, _make_dfs(
        env, alt=False, max_depth=0, lookahead=lookahead,
        stack_cap=stack_cap, node_budget=node_budget, playout_len=0,
        playout_bot=None, eval_fn=_default_eval(env, eval_fn)))


def _deepening(env: GridnetEnv, runs) -> Opponent:
    """A fixed deepening schedule: every search runs, the last (deepest)
    one's action wins (IDABCD, IDRTMinimax.java:118-163)."""
    def bot(state: State, player: int, noise=None) -> torch.Tensor:
        act = None
        for run in runs:
            act = run(state, player, draws=noise)[0]
        return act

    bot.runs = runs
    bot.dims = tuple(run.dims for run in runs)
    return Opponent(bot, _engine_draw(env))


def id_abcd_bot(env: GridnetEnv, depths=(1, 2, 3, 4), playout_len: int = 100,
                node_budget: int = 512,
                playout_bot: Optional[Callable] = None,
                eval_fn: Optional[Callable] = None) -> Opponent:
    """IDABCD: ABCD over the depth schedule ``depths``."""
    return _deepening(env, [abcd_bot(env, d, playout_len, node_budget,
                                playout_bot, eval_fn).bot.run
                       for d in depths])


def idrt_minimax_bot(env: GridnetEnv, lookaheads=(25, 50, 100),
                     stack_cap: int = 12, node_budget: int = 512,
                     eval_fn: Optional[Callable] = None) -> Opponent:
    """IDRTMinimax: RTMinimax over the lookahead schedule ``lookaheads``."""
    return _deepening(env, [rt_minimax_bot(env, la, stack_cap, node_budget,
                                      eval_fn).bot.run
                       for la in lookaheads])


def idrt_minimax_randomized_bot(env: GridnetEnv, k_moves: int = 8,
                                repeats: int = 8, lookahead: int = 25,
                                stack_cap: int = 10, node_budget: int = 96,
                                eval_fn: Optional[Callable] = None
                                ) -> Opponent:
    """IDRTMinimaxRandomized (ai/minimax/RTMiniMax/IDRTMinimaxRandomized
    .java, minimax.py:401-461): the first ``k_moves`` enumerated root
    actions of each game are each searched ``repeats`` times by the
    coin-flip DFS, all ``B * K * R`` searches as lanes of one DFS, and
    scored ``mean - std`` (population std) over the repeats; the first
    best score wins.  ``noise``: the coin table int32 ``[B, K, R, budget
    + 1]`` (``draw``), or under random damage the pair (coin table,
    ``EngineNoise``)."""
    eval_fn = _default_eval(env, eval_fn)
    sp = arm_space(env)
    init_enum, next_action = make_enumerator(env)
    inner = _make_dfs(env, alt=True, max_depth=0, lookahead=lookahead,
                      stack_cap=stack_cap, node_budget=node_budget,
                      playout_len=0, playout_bot=None, eval_fn=eval_fn,
                      randomized=True)
    K, R = k_moves, repeats
    plain = env.engine.plain

    def draw(gen: torch.Generator, batch: int):
        coins = torch.randint(0, 2, (batch, K, R, node_budget + 1),
                              generator=gen, device=env.device, dtype=I32)
        return (coins, EngineNoise(env, gen)) if env.random_damage else coins

    def scores(state: State, player: int, noise):
        """(root arms int32 [B, K, H, W], valid [B, K], scores float32
        [B, K], the ``B * K * R`` DFS stacks) of the first K root
        actions."""
        maxp = int(player)
        B = state.batch
        coins, draws = noise if isinstance(noise, tuple) else (noise, None)
        od, ctx = init_enum(state, maxp)
        got = [next_action(od, ctx) for _ in range(K)]
        arms = torch.stack([g[0] for g in got], 1)
        valid = torch.stack([g[1] for g in got], 1)
        st1 = _issue_player(env, repeat_lanes(state, K), arms_to_action(
            sp, arms.flatten(0, 1), plain=plain), maxp)
        st2, done2 = _advance(env, st1, u01=None if draws is None
                              else draws.u01(ADVANCE_EVENTS, st1.batch))
        _, vs, stk = inner(repeat_lanes(st2, R), maxp,
                           coins.reshape(B * K * R, -1), draws)
        vs = vs.reshape(B, K, R)
        ev = eval_fn(st2, maxp).reshape(B, K, 1)
        vs = torch.where(done2.reshape(B, K, 1), ev, vs)
        mean = vs.mean(-1)
        std = torch.sqrt(((vs - mean[..., None]) ** 2).mean(-1))
        return (arms, valid, torch.where(valid, mean - std, float("-inf")),
                stk)

    def bot(state: State, player: int, noise) -> torch.Tensor:
        arms, valid, score, _ = bot.scores(state, player, noise)
        rows = torch.arange(state.batch, device=state.device)
        act = arms_to_action(sp, arms[rows, first_max(score)], plain=plain)
        can = (can_act(state, player) & ~env.engine.gameover(state)
               & valid.any(1))
        return torch.where(can[:, None, None, None], act, 0)

    bot.scores = scores
    bot.dims = (K, R, stack_cap, node_budget)
    return Opponent(bot, draw)


def sampled_abcd_bot(env: GridnetEnv, k_moves: int = 8,
                     playout_len: int = 100,
                     playout_bot: Optional[Callable] = None,
                     eval_fn: Optional[Callable] = None,
                     n_decisions: Optional[int] = None) -> Opponent:
    """SampledABCD (minimax.py:264-331): one simultaneous ply of
    ``k_moves`` candidate joint actions a side (candidate 0 the playout
    policy's, WorkerRush by default; the rest RandomBiasedAI draws), the
    K x K children played out with the playout policy on both sides for
    ``playout_len`` ticks as lanes of one batch, maximin with the first
    best.  ``noise``: RandomBiasedAI's uniforms float32 ``[2, K - 1, B, H,
    W, 2]`` (this side's candidates, then the opponent's), or where the
    env needs the engine's draws the pair (uniforms, ``EngineNoise``)."""
    eval_fn = _default_eval(env, eval_fn)
    if playout_bot is None:
        playout_bot = worker_rush(env)
    sampler = random_bot(env, 5.0)
    K = k_moves
    H, W = env.h, env.w
    cont = make_playout(env, playout_len, eval_fn, gamma=1.0,
                        rollout_bot=playout_bot, n_decisions=n_decisions)
    no_noise = [(None, None)] * cont.n_decisions

    def draw(gen: torch.Generator, batch: int):
        u = torch.rand((2, K - 1, batch, H, W, 2), generator=gen,
                       device=env.device)
        if env.needs_draws:
            return u, EngineNoise(env, gen)
        return u

    def cands(state: State, pl: int, u: torch.Tensor) -> torch.Tensor:
        """[B, K, H, W, 7]: the playout policy's action, then K - 1
        RandomBiasedAI draws (``u`` ``[K - 1, B, H, W, 2]``)."""
        B = state.batch
        rnd = sampler(repeat_lanes(state, K - 1), pl,
                      u.transpose(0, 1).reshape(B * (K - 1), H, W, 2))
        return torch.cat([playout_bot(state, pl)[:, None],
                          rnd.reshape(B, K - 1, H, W, 7)], 1)

    def values(state: State, player: int, noise):
        """(this side's candidates [B, K, H, W, 7], the K x K playout
        values float32 [B, K, K])."""
        p = int(player)
        B = state.batch
        u, draws = noise if isinstance(noise, tuple) else (noise, None)
        mine, theirs = cands(state, p, u[0]), cands(state, 1 - p, u[1])
        am = mine.repeat_interleave(K, 1).flatten(0, 1)
        ao = theirs.repeat(1, K, 1, 1, 1).flatten(0, 1)
        lanes = repeat_lanes(state, K * K)
        a0, a1 = (am, ao) if p == 0 else (ao, am)
        L = lanes.batch
        if draws is None:
            s1 = env.advance(lanes, a0, a1)[2]
            v = cont(s1, p, lanes.time, no_noise)
        else:
            s1 = env.advance(lanes, a0, a1, draws.coins(L),
                             draws.u01(env.step_cycles, L))[2]
            v = cont(s1, p, lanes.time, no_noise,
                     u01=draws.u01(cont.n_cycles, L))
        return mine, v.reshape(B, K, K)

    def bot(state: State, player: int, noise) -> torch.Tensor:
        mine, V = values(state, player, noise)
        rows = torch.arange(state.batch, device=state.device)
        act = mine[rows, first_max(V.amin(2))]
        can = can_act(state, player) & ~env.engine.gameover(state)
        return torch.where(can[:, None, None, None], act, 0)

    bot.values = values
    bot.dims = (K, playout_len)
    return Opponent(bot, draw)
