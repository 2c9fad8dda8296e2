"""Tournaments: batched bot-vs-bot games (port of
``microrts_tpu.eval.tournament``, the Tournament.java / RoundRobinTournament
analogs).

Every game (ordered pairing x repetition) is one lane of a batch of
lockstep games.  The loop advances DECISION FRAME by decision frame
(tournament.py:81-107): ``fast_forward`` coasts to the next frame (K8 and
the cycle kernel), the lanes finished there take their winner, both bots
act, and the env's own step (NONE(1) pads) advances one tick; finished
lanes are frozen by select.  Lanes drift apart in game time; a lane ends
at game over or when its time reaches ``max_cycles``.

Bots are ``bots.scripted.Opponent``s: each frame draws the bot's noise
(``draw``) from a ``torch.Generator`` seeded with ``seed`` on the env's
device, or takes it from ``noise(frame, player, bot, lanes)`` (the tests
hand over JAX's draws that way).  In a pool, a bot runs only on the lanes
that use it (``index_select`` of the states, ``index_copy_`` of its
actions), and bots without lanes are skipped: the same trajectories as
JAX's ``lax.switch``.  ``chunk`` is only the interval between the host's
checks that every lane is done.

Where the env needs the engine's draws (UTT v3's damage uniforms for the
frame's cycles, CANCEL_RANDOM's coins under fog for its step), each frame
draws them (``frame_draws``) from the generator before the bots' noise,
or takes them from ``noise(frame, None, None, None)``; JAX draws them from
the states' keys inside its jitted loop.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..engine.types import State
from ..env.gridnet import GridnetEnv
from ..ops.playout import fast_forward

CHUNK = 256   # frames between the host's all-done checks
FF_EVENTS = 2  # the event steps of a frame's fast_forward


class FrameDraws(NamedTuple):
    """The engine's draws of one decision frame of ``B`` games: the
    damage uniforms float32 ``[FF_EVENTS + step_cycles, B, H, W]`` of the
    frame's ``fast_forward`` and then its step (None under deterministic
    damage), and the step's coins bool ``[2, B, H, W, 4]`` (None unless
    the env's ``random_coins``)."""
    u01: Optional[torch.Tensor]
    coins: Optional[torch.Tensor]


def frame_draws(env: GridnetEnv, gen: torch.Generator,
                batch: int) -> Optional[FrameDraws]:
    """One frame's ``FrameDraws`` from ``gen``; None (nothing drawn) when
    the env needs no draws."""
    if not env.needs_draws:
        return None
    return FrameDraws(env.draw_u01(gen, FF_EVENTS + env.step_cycles, batch),
                      env.draw_coins(gen, batch))


def frame_step(env: GridnetEnv, s: State, done, max_cycles: int,
               fd: Optional[FrameDraws]):
    """A frame's coast (``fast_forward``) with its draws.  Returns (a
    function stepping the env from the bots' actions with the frame's
    draws, the coasted state, its done flags)."""
    u = None if fd is None else fd.u01
    s, d_ff = fast_forward(env, s, done, t_end=max_cycles,
                           max_events=FF_EVENTS,
                           u01=None if u is None else u[:FF_EVENTS])

    def advance(s, a0, a1):
        return env.advance(s, a0, a1, None if fd is None else fd.coins,
                           None if u is None else u[FF_EVENTS:])[2:]
    return advance, s, d_ff


def _index_state(s: State, idx: torch.Tensor) -> State:
    return State(**{f: v.index_select(0, idx) for f, v in vars(s).items()})


def _groups(pool_idx: torch.Tensor, n_bots: int):
    """[(bot, lanes or None for every lane)] of the bots that have lanes."""
    if n_bots == 1 or bool((pool_idx == pool_idx[0]).all()):
        return [(int(pool_idx[0]), None)]
    out = []
    for b in range(n_bots):
        lanes = (pool_idx == b).nonzero().flatten()
        if lanes.numel():
            out.append((b, lanes))
    return out


def act_grouped(env: GridnetEnv, s: State, groups, call) -> torch.Tensor:
    """Actions int32 ``[B, H, W, 7]`` of the groups of ``_groups``:
    ``call(k, state, lanes)`` acts for group ``k`` on its lanes' state
    (``lanes`` None and the whole state when one group has every lane)."""
    if len(groups) == 1 and groups[0][1] is None:
        return call(groups[0][0], s, None)
    out = torch.empty((s.batch, env.h, env.w, 7), dtype=torch.int32,
                      device=s.device)
    for k, lanes in groups:
        out.index_copy_(0, lanes, call(k, _index_state(s, lanes), lanes))
    return out


def _games_fn(env: GridnetEnv, bots: Sequence, max_cycles: int,
              chunk: int = CHUNK, fixed_pair: bool = False):
    """The batched-game runner for a bot pool (tournament.py:36-128).

    Returns ``run(i, j, gen=None, noise=None) -> (winners int32 [B], final
    State, frames)``: ``i``/``j`` are per-game pool indices of player 0 /
    player 1 (int64 ``[B]``), winners 0, 1 or -1 (draw or cycle cutoff).
    ``fixed_pair=True`` takes ``bots == [bot0, bot1]`` with every lane
    playing bot0 as player 0 and bot1 as player 1."""
    if fixed_pair and len(bots) != 2:
        raise ValueError("fixed_pair takes exactly two bots")
    eng = env.engine

    def act(s, player, groups, frame, gen, noise):
        def call(b, sb, lanes):
            nz = (noise(frame, player, b, lanes) if noise is not None
                  else bots[b].draw(gen, sb.batch))
            return bots[b](sb, player, nz)
        return act_grouped(env, s, groups, call)

    def run(i: torch.Tensor, j: torch.Tensor,
            gen: Optional[torch.Generator] = None,
            noise: Optional[Callable] = None):
        B = int(i.shape[0])
        dev = env.device
        if fixed_pair:
            g0, g1 = [(0, None)], [(1, None)]
        else:
            g0, g1 = _groups(i.to(dev), len(bots)), _groups(j.to(dev),
                                                            len(bots))
        s = env.reset(B)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        winner = torch.full((B,), -1, dtype=torch.int32, device=dev)
        frame = 0
        draws = env.needs_draws
        while frame < max_cycles:
            for _ in range(min(chunk, max_cycles - frame)):
                fd = None
                if draws:
                    fd = (noise(frame, None, None, None) if noise is not None
                          else frame_draws(env, gen, B))
                advance, s, d_ff = frame_step(env, s, done, max_cycles, fd)
                winner = torch.where(done, winner, torch.where(
                    d_ff, eng.winner(s), -1))
                done = done | d_ff | (s.time >= max_cycles)
                a0 = act(s, 0, g0, frame, gen, noise)
                a1 = act(s, 1, g1, frame, gen, noise)
                s2, done2 = advance(s, a0, a1)
                winner = torch.where(done, winner, torch.where(
                    done2, eng.winner(s2), -1))
                s = s2.select(done, s)
                done = done | done2
                frame += 1
            if bool(done.all()):      # every lane finished
                break
        return winner, s, frame

    return run


def _generator(env: GridnetEnv, seed: int) -> torch.Generator:
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    return gen


def play_matches(env: GridnetEnv, bot0, bot1, n_games: int,
                 max_cycles: int = 2000, seed: int = 0, chunk: int = CHUNK,
                 noise: Optional[Callable] = None) -> np.ndarray:
    """``n_games`` lockstep games of bot0 (player 0) vs bot1 (player 1).
    Returns winners int32 ``[n_games]``: 0, 1, or -1 (draw / cycle
    cutoff)."""
    run = _games_fn(env, [bot0, bot1], max_cycles, chunk, fixed_pair=True)
    z = torch.zeros(n_games, dtype=torch.int64)
    w, _, _ = run(z, z + 1, _generator(env, seed), noise)
    return w.cpu().numpy()


def play_matches_both(env: GridnetEnv, bot0, bot1, n_games: int,
                      max_cycles: int = 2000, seed: int = 0,
                      chunk: int = CHUNK, noise=(None, None)):
    """Both orderings (the two-position pairing of Tournament.java):
    ``n_games`` lanes of bot0-vs-bot1, then ``n_games`` of bot1-vs-bot0,
    two fixed-pair runs drawing from one generator in turn (``noise``:
    one source per run).  Returns (w01, w10)."""
    gen = _generator(env, seed)
    z = torch.zeros(n_games, dtype=torch.int64)
    w01, _, _ = _games_fn(env, [bot0, bot1], max_cycles, chunk,
                          fixed_pair=True)(z, z + 1, gen, noise[0])
    w10, _, _ = _games_fn(env, [bot1, bot0], max_cycles, chunk,
                          fixed_pair=True)(z, z + 1, gen, noise[1])
    return w01.cpu().numpy(), w10.cpu().numpy()


@dataclasses.dataclass
class TournamentResult:
    names: List[str]
    wins: np.ndarray    # [n, n] wins[i, j] = games bot i beat bot j
    ties: np.ndarray    # [n, n]
    games: np.ndarray   # [n, n]

    def table(self) -> str:
        n = len(self.names)
        width = max(len(s) for s in self.names) + 2
        lines = ["round-robin results (wins/ties/games per ordered pairing):"]
        header = " " * width + "".join(f"{s:>{width}}" for s in self.names)
        lines.append(header)
        for i in range(n):
            row = f"{self.names[i]:>{width}}"
            for j in range(n):
                if i == j:
                    row += f"{'-':>{width}}"
                else:
                    row += (f"{int(self.wins[i, j])}/"
                            f"{int(self.ties[i, j])}/"
                            f"{int(self.games[i, j])}").rjust(width)
            lines.append(row)
        score = self.wins.sum(1) + 0.5 * self.ties.sum(1)
        order = np.argsort(-score)
        lines.append("ranking: " + ", ".join(
            f"{self.names[i]} ({score[i]:.1f})" for i in order))
        return "\n".join(lines)


def pairings(n: int, games_per_pair: int, play_both_positions: bool = True):
    """Per-game pool indices (i, j), int64 numpy ``[G]`` each, in
    ``round_robin``'s lane order."""
    pairs = [(a, b) for a in range(n) for b in range(n) if a != b] \
        if play_both_positions else list(itertools.combinations(range(n), 2))
    ii = np.repeat([p[0] for p in pairs], games_per_pair).astype(np.int64)
    jj = np.repeat([p[1] for p in pairs], games_per_pair).astype(np.int64)
    return ii, jj


def tally(names: List[str], ii, jj, w) -> TournamentResult:
    n = len(names)
    wins = np.zeros((n, n), np.int64)
    ties = np.zeros((n, n), np.int64)
    games = np.zeros((n, n), np.int64)
    for g, (i, j) in enumerate(zip(ii, jj)):
        if w[g] == 0:
            wins[i, j] += 1
        elif w[g] == 1:
            wins[j, i] += 1
        else:
            ties[i, j] += 1
            ties[j, i] += 1
        games[i, j] += 1
        games[j, i] += 1
    return TournamentResult(names, wins, ties, games)


def round_robin(env: GridnetEnv, bots: Dict[str, object],
                games_per_pair: int = 4, max_cycles: int = 2000,
                seed: int = 0, play_both_positions: bool = True,
                chunk: int = CHUNK, noise: Optional[Callable] = None
                ) -> TournamentResult:
    """RoundRobinTournament (:22): every ordered pair plays
    ``games_per_pair`` games (both positions unless disabled), all as
    lanes of one batch."""
    names = list(bots)
    ii, jj = pairings(len(names), games_per_pair, play_both_positions)
    run = _games_fn(env, [bots[nm] for nm in names], max_cycles, chunk)
    w, _, _ = run(torch.from_numpy(ii), torch.from_numpy(jj),
                  _generator(env, seed), noise)
    return tally(names, ii, jj, w.cpu().numpy())
