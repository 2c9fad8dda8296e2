"""Playout search bots (port of ``microrts_tpu.bots.search``).

One decision of a batch of ``B`` games samples candidate joint actions,
plays each out with RandomBiasedAI on both sides (``ops.playout``) and
scores the final states with an evaluation function (``ops.evaluation``,
by default ``simple_sqrt_eval3``).  The candidates of all games are lanes
of one batch: every ``State`` field is replicated with
``repeat_interleave`` (lane ``b * K + k``, then ``* n_eval + e``), so a
decision is one pass of the engine's kernels over ``B * K * n_eval``
lanes, and the best candidate is taken back with ``argmax`` (the first
maximum, as ``jnp.argmax``).

Each constructor returns a ``bots.scripted.Opponent``: ``draw(gen, B)``
makes every uniform the bot reads, one tensor per use in the JAX key
tree (the fields of ``MCNoise``, ``NaiveNoise`` and ``UCTNoise``), so a
test can hand the port the draws of JAX's keys.  Where the env needs the
engine's draws (UTT v3's damage, CANCEL_RANDOM's coins under fog), the
noise also carries them (``u01``, ``coins``; None otherwise): JAX draws
them from the states' keys.

``monte_carlo_bot`` (MonteCarlo.java, flat MC), ``naive_sampling_bot``
(hill climbing on joint actions) and ``uct_bot`` (DownsamplingUCT).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..engine.types import State
from ..env.gridnet import GridnetEnv
from ..ops.evaluation import simple_sqrt_eval3
from ..ops.playout import _u, make_playout, playout_noise, repeat_lanes
from .scripted import Opponent, random_bot


class MCNoise(NamedTuple):
    """``monte_carlo_bot``'s draws for ``B`` games: the candidates'
    uniforms ``[B * K, H, W, 2]`` (JAX: ``keys[:K]``), the first tick's
    opponent uniforms and the playouts' ``[n_decisions, 2, L, H, W, 2]``
    over the ``L = B * K * n_eval`` playout lanes (JAX: ``split(key)`` of
    each ``split(split(keys[-1], K)[k], n_eval)[e]``).  ``u01``: the
    damage uniforms float32 ``[step_cycles + n_cycles, L, H, W]`` of the
    first tick's and the playout's cycles; ``coins``: the first tick's
    bool ``[2, L, H, W, 4]``."""
    cand: torch.Tensor
    opp: torch.Tensor
    play: torch.Tensor
    u01: Optional[torch.Tensor] = None
    coins: Optional[torch.Tensor] = None


class NaiveNoise(NamedTuple):
    """``naive_sampling_bot``'s draws, one slice per round ``r``: the
    fresh candidate's uniforms ``[R, B, H, W, 2]`` (JAX: k1), the
    exploration coins ``[R, B, H, W, 1]`` (k2), the first tick's opponent
    uniforms ``[R, B, H, W, 2]`` and the playout's ``[R, n_decisions, 2,
    B, H, W, 2]`` (k3); ``u01`` ``[R, step_cycles + n_cycles, B, H, W]``
    and ``coins`` ``[R, 2, B, H, W, 4]`` as ``MCNoise``'s, per round."""
    fresh: torch.Tensor
    explore: torch.Tensor
    opp: torch.Tensor
    play: torch.Tensor
    u01: Optional[torch.Tensor] = None
    coins: Optional[torch.Tensor] = None


class UCTNoise(NamedTuple):
    """``uct_bot``'s draws: the candidates' uniforms ``[B * K, H, W, 2]``
    (JAX: ``split(kc, K)``), and per round the first tick's opponent
    uniforms ``[R, B, H, W, 2]`` and the playout's ``[R, n_decisions, 2,
    B, H, W, 2]`` (``split(kr, R)``); ``u01`` and ``coins`` per round,
    as ``NaiveNoise``'s."""
    cand: torch.Tensor
    opp: torch.Tensor
    play: torch.Tensor
    u01: Optional[torch.Tensor] = None
    coins: Optional[torch.Tensor] = None


def _uniforms(env: GridnetEnv, gen, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=env.device)


def engine_draws(env: GridnetEnv, gen, cycles: int, lanes: int,
                 rounds: int):
    """(u01, coins) of ``rounds`` first ticks and playouts of ``lanes``
    lanes: the damage uniforms float32 ``[rounds, step_cycles + cycles,
    lanes, H, W]`` and the first tick's coins bool ``[rounds, 2, lanes,
    H, W, 4]``, each None where the env needs none."""
    u01 = [env.draw_u01(gen, env.step_cycles + cycles, lanes)
           for _ in range(rounds)]
    coins = [env.draw_coins(gen, lanes) for _ in range(rounds)]
    return (None if u01[0] is None else torch.stack(u01),
            None if coins[0] is None else torch.stack(coins))


def _default_eval(env: GridnetEnv, eval_fn: Optional[Callable]) -> Callable:
    if eval_fn is not None:
        return eval_fn
    ecfg, plain = env.cfg.engine, env.engine.plain
    return lambda s, p: simple_sqrt_eval3(s, p, ecfg, plain=plain)


def _playout_value(env, rollout, cont, state: State, cand: torch.Tensor,
                   player: int, u_opp: torch.Tensor, play,
                   u01: Optional[torch.Tensor] = None,
                   coins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The candidate's first tick against the rollout policy through the
    env's own step (NONE(1) pads, search.py:58-61), then the shared
    fast-forward playout: float32 ``[B]``.  ``u01``: the first tick's
    then the playout's damage uniforms; ``coins``: the first tick's."""
    opp = rollout(state, 1 - player, u_opp)
    a0, a1 = (cand, opp) if player == 0 else (opp, cand)
    C = env.step_cycles
    s = env.advance(state, a0, a1, coins,
                    None if u01 is None else u01[:C])[2]
    return cont(s, player, state.time, play,
                u01=None if u01 is None else u01[C:])


def _pick(cands: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cands[b, idx[b]]`` of ``[B, K, ...]``."""
    return cands[torch.arange(cands.shape[0], device=cands.device), idx]


def monte_carlo_bot(env: GridnetEnv, n_candidates: int = 12,
                    playout_len: int = 48,
                    eval_fn: Optional[Callable] = None,
                    candidate_bias: float = 5.0, n_eval: int = 1,
                    n_decisions: Optional[int] = None) -> Opponent:
    """Flat Monte Carlo (search.py:33-80): K candidate actions from
    RandomBiasedAI (``candidate_bias``), each played out ``n_eval`` times
    with RandomBiasedAI on both sides for ``playout_len`` ticks, scored by
    ``eval_fn`` (mean over ``n_eval``); the argmax candidate."""
    K = n_candidates
    eval_fn = _default_eval(env, eval_fn)
    sampler = random_bot(env, candidate_bias)
    rollout = random_bot(env, 5.0)
    cont = make_playout(env, playout_len, eval_fn, gamma=1.0,
                        rollout_bot=rollout, n_decisions=n_decisions)
    H, W = env.h, env.w

    def draw(gen: torch.Generator, batch: int) -> MCNoise:
        L = batch * K * n_eval
        return MCNoise(_uniforms(env, gen, batch * K, H, W, 2),
                       _uniforms(env, gen, L, H, W, 2),
                       playout_noise(env, gen, cont.n_decisions, L),
                       *(_u(x, 0) for x in engine_draws(
                           env, gen, cont.n_cycles, L, 1)))

    def bot(state: State, player: int, noise: MCNoise) -> torch.Tensor:
        B = state.batch
        sk = repeat_lanes(state, K)
        cands = sampler(sk, player, noise.cand)
        lanes = repeat_lanes(sk, n_eval)
        v = _playout_value(env, rollout, cont, lanes,
                           cands.repeat_interleave(n_eval, 0), player,
                           noise.opp, noise.play, noise.u01, noise.coins)
        best = v.reshape(B, K, n_eval).mean(2).argmax(1)
        return _pick(cands.reshape(B, K, H, W, 7), best)

    return Opponent(bot, draw)


def naive_sampling_bot(env: GridnetEnv, n_rounds: int = 16,
                       playout_len: int = 48, epsilon: float = 0.33,
                       eval_fn: Optional[Callable] = None,
                       n_decisions: Optional[int] = None) -> Opponent:
    """Iterated hill climbing on joint actions (search.py:83-136): each
    round epsilon-mutates the best joint action so far with a fresh
    RandomBiasedAI sample, plays it out once and keeps it iff the
    playout value improves."""
    eval_fn = _default_eval(env, eval_fn)
    sampler = random_bot(env, 5.0)
    rollout = random_bot(env, 5.0)
    cont = make_playout(env, playout_len, eval_fn, gamma=1.0,
                        rollout_bot=rollout, n_decisions=n_decisions)
    H, W, R = env.h, env.w, n_rounds

    def draw(gen: torch.Generator, batch: int) -> NaiveNoise:
        play = torch.stack([playout_noise(env, gen, cont.n_decisions, batch)
                            for _ in range(R)])
        return NaiveNoise(_uniforms(env, gen, R, batch, H, W, 2),
                          _uniforms(env, gen, R, batch, H, W, 1),
                          _uniforms(env, gen, R, batch, H, W, 2), play,
                          *engine_draws(env, gen, cont.n_cycles, batch, R))

    def bot(state: State, player: int, noise: NaiveNoise) -> torch.Tensor:
        B, dev = state.batch, state.device
        best_a = torch.zeros((B, H, W, 7), dtype=torch.int32, device=dev)
        best_v = torch.full((B,), float("-inf"), device=dev)
        for r in range(R):
            fresh = sampler(state, player, noise.fresh[r])
            explore = noise.explore[r] < epsilon
            keep_best = ~explore if r > 0 else torch.zeros_like(explore)
            cand = torch.where(keep_best, best_a, fresh)
            v = _playout_value(env, rollout, cont, state, cand, player,
                               noise.opp[r], noise.play[r],
                               _u(noise.u01, r), _u(noise.coins, r))
            improve = v > best_v
            best_a = torch.where(improve[:, None, None, None], cand, best_a)
            best_v = torch.where(improve, v, best_v)
        return best_a

    return Opponent(bot, draw)


def ucb1(visits: torch.Tensor, values: torch.Tensor,
         c_uct: float) -> torch.Tensor:
    """UCB1 of every arm (float32 ``[B, K]``): inf for an arm not yet
    visited."""
    total = visits.sum(1, keepdim=True)
    n = visits.clamp(min=1)
    return torch.where(
        visits > 0,
        values / n + c_uct * torch.sqrt(torch.log(total.clamp(min=1)) / n),
        float("inf"))


def uct_bot(env: GridnetEnv, n_candidates: int = 8, n_rounds: int = 24,
            playout_len: int = 48, c_uct: float = 1.4,
            eval_fn: Optional[Callable] = None,
            n_decisions: Optional[int] = None) -> Opponent:
    """DownsamplingUCT (search.py:139-188): K sampled candidates, UCB1
    bandit rounds over them (one playout per visit, values in [0, 1]),
    the most visited candidate."""
    K = n_candidates
    eval_fn = _default_eval(env, eval_fn)
    sampler = random_bot(env, 5.0)
    rollout = random_bot(env, 5.0)
    cont = make_playout(env, playout_len, eval_fn, gamma=1.0,
                        rollout_bot=rollout, n_decisions=n_decisions)
    H, W, R = env.h, env.w, n_rounds

    def draw(gen: torch.Generator, batch: int) -> UCTNoise:
        play = torch.stack([playout_noise(env, gen, cont.n_decisions, batch)
                            for _ in range(R)])
        return UCTNoise(_uniforms(env, gen, batch * K, H, W, 2),
                        _uniforms(env, gen, R, batch, H, W, 2), play,
                        *engine_draws(env, gen, cont.n_cycles, batch, R))

    def bot(state: State, player: int, noise: UCTNoise) -> torch.Tensor:
        B, dev = state.batch, state.device
        cands = sampler(repeat_lanes(state, K), player,
                        noise.cand).reshape(B, K, H, W, 7)
        visits = torch.zeros((B, K), device=dev)
        values = torch.zeros((B, K), device=dev)
        rows = torch.arange(B, device=dev)
        for r in range(R):
            arm = ucb1(visits, values, c_uct).argmax(1)
            v = _playout_value(env, rollout, cont, state, cands[rows, arm],
                               player, noise.opp[r], noise.play[r],
                               _u(noise.u01, r), _u(noise.coins, r))
            visits[rows, arm] += 1
            values[rows, arm] += (v + 1.0) * 0.5
        return _pick(cands, visits.argmax(1))

    return Opponent(bot, draw)
