"""Decision-point fast-forward playouts (GameState.getNextChangeTime analog).

A port of ``microrts_tpu.ops.playout`` (see its docstring for the Java
sources and the budget semantics), batched over the leading axis of the
states.  Between action completions nothing in a state can change, so an
EVENT step jumps ``min(busy aticks) - 1`` dead ticks in closed form
(``time += k``, busy ``aticks -= k``) and then runs the one real ``cycle``
of the completion tick; on CUDA tensors the jump is the ``event_jump``
kernel (K8) and the cycle the ``cycle`` kernel with the lanes that take
it as its ``active`` flag.

Randomness enters as tensors: a playout's rollout bots read one pair of
noise inputs per decision (``noise[d][0]`` for player 0, ``noise[d][1]``
for player 1), e.g. uniforms float32 ``[n_decisions, 2, B, H, W, 2]`` for
RandomBiasedAI on both sides (``playout_noise``).  Under UTT v3's random
damage each cycle a playout runs reads float32 uniforms ``[B, H, W]``
(``u01`` arguments: one slice a cycle, in the order the cycles run; an
event jump runs no cycle for the ticks it skips, as in JAX).

JAX's ``fast_forward`` has an unrolled and a while-loop form; both are
exactly ``max_events`` applications of one select-frozen event step, so
the port has one loop and no ``unroll`` flag.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .. import kernels as KN
from ..engine.types import INF, State

I32 = torch.int32


def can_act(s: State, player: int) -> torch.Tensor:
    """GameState.canExecuteAnyAction: any own idle unit, bool ``[B]``."""
    return ((s.utype > 0) & (s.owner == int(player)) & ~s.busy).any((1, 2))


def decision_point(s: State) -> torch.Tensor:
    """True where ANY unit of EITHER player can be issued an action, bool
    ``[B]``."""
    return ((s.utype > 0) & (s.owner >= 0) & ~s.busy).any((1, 2))


def _t_end(s: State, t_end) -> Optional[torch.Tensor]:
    """``t_end`` (None, an int, or int32 ``[B]``) as int32 ``[B]``."""
    if t_end is None:
        return None
    return torch.as_tensor(t_end, dtype=I32, device=s.device).expand(
        s.batch).contiguous()


def event_jump(env, s: State, t_end: Optional[torch.Tensor], max_skip: int,
               done: Optional[torch.Tensor] = None):
    """The closed-form jump (K8): ``fast_forward``'s gated event step when
    ``done`` is given, else ``playout_step``'s jump.  Returns (the jumped
    State, take bool ``[B]``: the lane runs the completion tick's cycle,
    gameover of the jumped state bool ``[B]``, or None for the gated
    step, whose caller does not read it)."""
    if env.engine._use_kernel(s.utype):
        return KN.EVENT_JUMP(s, t_end, max_skip, done)
    return event_jump_plain(env, s, t_end, max_skip, done)


def event_jump_plain(env, s: State, t_end: Optional[torch.Tensor],
                     max_skip: int, done: Optional[torch.Tensor] = None):
    aticks = s.aticks.to(I32)
    min_eta = torch.where(s.busy, aticks, INF).amin((1, 2))
    k = (min_eta - 1).clamp(0, max_skip)
    do_cycle = torch.ones_like(s.busy[:, 0, 0])
    if t_end is not None:
        k = torch.minimum(k, (t_end - s.time).clamp(min=0))
        do_cycle = (s.time + k) < t_end
    live = do_cycle
    if done is not None:
        live = ~done & ~decision_point(s)
        if t_end is not None:
            live = live & (s.time < t_end)
        k = torch.where(live, k, 0)
    s_j = s.replace(time=s.time + k,
                    aticks=torch.where(s.busy, aticks - k[:, None, None],
                                       aticks)).canon()
    over = None if done is not None else env.engine.gameover(s_j)
    return s_j, live & do_cycle, over


def _u(u01: Optional[torch.Tensor], i: int) -> Optional[torch.Tensor]:
    return None if u01 is None else u01[i]


def playout_step(env, s: State, a0: torch.Tensor, a1: torch.Tensor,
                 none_duration: int = 10, jump_to_event: bool = False,
                 t_end=None, max_skip: int = 512,
                 u01: Optional[torch.Tensor] = None):
    """One self-play EVENT with the bot path's NONE(``none_duration``)
    padding and no rewards (playout.py:58-106): decode and issue both
    players, then one ``cycle`` (damage uniforms ``u01`` float32 ``[B, H,
    W]``), or with ``jump_to_event`` the jump to the earliest completion
    and its cycle (skipped where the jump reaches ``t_end`` first).
    Returns (state, gameover bool ``[B]``)."""
    eng = env.engine
    c0 = env.decode(s, a0, 0, none_duration)
    s1 = eng.issue_env(s, c0)
    c1 = env.decode(s1, a1, 1, none_duration)
    s2 = eng.issue_env(s1, c1)
    if not jump_to_event:
        return eng.cycle(s2, u01=u01)
    te = _t_end(s2, t_end)
    s_j, take, over = event_jump(env, s2, te, max_skip)
    if te is None:
        return eng.cycle(s_j, u01=u01)
    s3, d3 = eng.cycle(s_j, take, u01)
    return s3, torch.where(take, d3, over)


def fast_forward(env, s: State, done: torch.Tensor, t_end=None,
                 max_skip: int = 512, max_events: int = 2,
                 u01: Optional[torch.Tensor] = None):
    """``max_events`` event steps (playout.py:109-194), each frozen by
    select once a lane is done, at a decision point or at ``t_end``.
    Never "until a decision point": a longer chain is finished by the
    caller's next iteration.  ``u01``: the damage uniforms float32
    ``[max_events, B, H, W]``.  Returns (state, done)."""
    te = _t_end(s, t_end)
    for i in range(max_events):
        s_j, take, _ = event_jump(env, s, te, max_skip, done)
        s, d_c = env.engine.cycle(s_j, take, _u(u01, i))
        done = done | d_c
    return s, done


def playout_cycles(n_decisions: int) -> int:
    """The cycles of a playout of ``n_decisions`` decisions: one a
    decision, then the trailing ``fast_forward``'s two."""
    return n_decisions + 2


def run_playout(env, act2: Callable, s: State, noise: Sequence,
                playout_len: int, n_decisions: int, max_skip: int = 512,
                none_duration: int = 10,
                live: Optional[torch.Tensor] = None,
                u01: Optional[torch.Tensor] = None):
    """One fast-forward playout per lane (playout.py:197-233).
    ``act2(state, noise[d]) -> (a0, a1)`` gives both players' gridnet
    actions at decision ``d``.  Returns (final state, done) after up to
    ``playout_len`` game ticks or ``n_decisions`` decision steps, and the
    trailing coast to the cap.  Lanes outside ``live`` (bool ``[B]``) keep
    their state, as finished ones do.  ``u01``: the damage uniforms
    float32 ``[playout_cycles(n_decisions), B, H, W]``."""
    t_end = s.time + int(playout_len)
    done = env.engine.gameover(s)
    if live is not None:
        done = done | ~live
    for d in range(n_decisions):
        live = ~done & (s.time < t_end)
        a0, a1 = act2(s, noise[d])
        s2, d2 = playout_step(env, s, a0, a1, none_duration,
                              jump_to_event=True, t_end=t_end,
                              max_skip=max_skip, u01=_u(u01, d))
        s = s.select(live, s2)
        done = done | (live & d2)
    return fast_forward(env, s, done, t_end, max_skip,
                        u01=None if u01 is None else u01[n_decisions:])


def decisions_for(playout_len: int) -> int:
    """Default decision budget for a ``playout_len``-tick playout."""
    return max(2, playout_len // 4)


def playout_noise(env, gen: torch.Generator, n_decisions: int,
                  lanes: int) -> torch.Tensor:
    """RandomBiasedAI's uniforms for ``n_decisions`` decisions of both
    sides: float32 ``[n_decisions, 2, lanes, H, W, 2]``."""
    return torch.rand((n_decisions, 2, lanes, env.h, env.w, 2),
                      generator=gen, device=env.device)


def repeat_lanes(s: State, n: int) -> State:
    """Every lane ``n`` times in a row (lane ``b * n + i``)."""
    if n == 1:
        return s
    return State(**{f: v.repeat_interleave(n, 0) for f, v in vars(s).items()})


def make_playout(env, playout_len: int, eval_fn: Callable,
                 gamma: float = 1.0, rollout_bot: Optional[Callable] = None,
                 n_eval: int = 1, n_decisions: Optional[int] = None,
                 max_skip: int = 512):
    """``playout(state, player, t0, noise) -> value float32 [B]``
    (playout.py:244-290): a fast-forward playout with ``rollout_bot``
    (default RandomBiasedAI) on both sides, scored by ``eval_fn(state,
    player)`` and discounted by ``gamma^((t_final - t0) / 10)``;
    ``playout_len=0`` evaluates the state itself.  With ``n_eval > 1``
    each state is played out ``n_eval`` times (lanes ``b * n_eval + i``
    of ``noise``) and the values are averaged.  ``noise[d][p]`` is side
    ``p``'s draw at decision ``d``: ``playout.draw(gen, lanes)`` makes
    them, RandomBiasedAI's uniforms ``[n_decisions, 2, lanes, H, W, 2]``
    or, for a ``rollout_bot`` that is an ``Opponent``, its ``draw``:
    stacked the same way where it is a tensor (a pretrained model's
    Gumbels ``[n_decisions, 2, lanes, H, W, A]``), else a list of
    ``n_decisions`` pairs (None for a deterministic bot, a NamedTuple
    such as a ``SingleUnitNoise``).  ``live`` (bool
    ``[B]``) are the lanes played out; the others' values are their
    states' own.  ``u01``: the damage uniforms float32
    ``[playout.n_cycles, B * n_eval, H, W]``.  ``playout.n_decisions`` is
    the budget."""
    if rollout_bot is None:
        from ..bots.scripted import random_bot
        rollout_bot = random_bot(env, 5.0)
    if n_decisions is None:
        n_decisions = decisions_for(playout_len)
    rollout_draw = getattr(rollout_bot, "draw", None)

    def draw(gen: torch.Generator, lanes: int):
        if rollout_draw is None:
            return playout_noise(env, gen, n_decisions, lanes)
        nz = [(rollout_draw(gen, lanes), rollout_draw(gen, lanes))
              for _ in range(n_decisions)]
        if isinstance(nz[0][0], torch.Tensor):
            return torch.stack([torch.stack(p) for p in nz])
        return nz

    def act2(s, nz):
        return rollout_bot(s, 0, nz[0]), rollout_bot(s, 1, nz[1])

    def one(s: State, player, t0, noise, live, u01):
        if playout_len > 0:
            sf, _ = run_playout(env, act2, s, noise, playout_len,
                                n_decisions, max_skip, live=live, u01=u01)
        else:
            sf = s
        v = eval_fn(sf, player)
        if gamma == 1.0:
            return v
        dt = (sf.time - t0).to(torch.float32)
        g = torch.tensor(gamma, dtype=torch.float32, device=dt.device)
        return v * torch.pow(g, dt / 10.0)

    def playout(s: State, player, t0, noise,
                live: Optional[torch.Tensor] = None,
                u01: Optional[torch.Tensor] = None):
        if n_eval <= 1:
            return one(s, player, t0, noise, live, u01)
        if isinstance(player, torch.Tensor):
            player = player.repeat_interleave(n_eval, 0)
        if live is not None:
            live = live.repeat_interleave(n_eval, 0)
        t0 = torch.as_tensor(t0, dtype=I32, device=s.device).expand(
            s.batch).repeat_interleave(n_eval, 0)
        v = one(repeat_lanes(s, n_eval), player, t0, noise, live, u01)
        return v.reshape(s.batch, n_eval).mean(1)

    playout.n_decisions = n_decisions
    playout.n_cycles = playout_cycles(n_decisions) if playout_len > 0 else 0
    playout.draw = draw
    return playout


def make_playout_two(env, playout_len: int, eval_fn: Callable,
                     n_decisions: Optional[int] = None,
                     max_skip: int = 512):
    """Two-policy fast-forward playout for the portfolio family
    (playout.py:293-315): ``run(state, player, me, opp, noise) -> value``
    where ``me``/``opp`` are ``(state, noise) -> [B, H, W, 7]`` already
    bound to their player and ``noise[d]`` is the pair (me's, opp's) of
    decision ``d``; ``u01`` the damage uniforms float32 ``[run.n_cycles,
    B, H, W]``."""
    if n_decisions is None:
        n_decisions = decisions_for(playout_len)

    def run(state: State, player, me: Callable, opp: Callable, noise,
            u01: Optional[torch.Tensor] = None):
        p0 = (torch.as_tensor(player, device=state.device) == 0).reshape(
            -1, 1, 1, 1)

        def act2(s, nz):
            am, ao = me(s, nz[0]), opp(s, nz[1])
            return torch.where(p0, am, ao), torch.where(p0, ao, am)

        sf, _ = run_playout(env, act2, state, noise, playout_len,
                            n_decisions, max_skip, u01=u01)
        return eval_fn(sf, player)

    run.n_decisions = n_decisions
    run.n_cycles = playout_cycles(n_decisions)
    return run


class EngineNoise:
    """The engine's draws made on demand from ``gen``, for searches whose
    number of cycles depends on the search (the minimax DFS):
    ``u01(cycles, lanes)`` (``GridnetEnv.draw_u01``) and ``coins(lanes)``
    (``GridnetEnv.draw_coins``), each None where the env needs none."""

    def __init__(self, env, gen: torch.Generator):
        self.env, self.gen = env, gen

    def u01(self, cycles: int, lanes: int) -> Optional[torch.Tensor]:
        return self.env.draw_u01(self.gen, cycles, lanes)

    def coins(self, lanes: int) -> Optional[torch.Tensor]:
        return self.env.draw_coins(self.gen, lanes)
