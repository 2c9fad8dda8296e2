"""Program cleaning: strip behaviorally-dead structure from synthesized
scripts.

A port of ``microrts_tpu.synth.clean`` (ai/synthesis/runners/cleanAST/
PerformCleanerAST.java and PerformCleanerASTOptim.java):

* ``clean_program`` (PerformCleanerAST) — BEHAVIORAL equivalence: an
  edit is accepted only if the shrunk program emits the identical
  ``[H, W, 7]`` action tensor on every probe state.  Probe states come
  from real rollouts of the program itself (``probe_states``).
* ``shrink_program`` (PerformCleanerASTOptim) — FITNESS preservation:
  an edit is accepted if the shrunk program's fitness
  (``synth.search.evaluate_population``) stays within ``tol`` of the
  incumbent's.

Each round scores every candidate edit over the whole probe batch (one
batch of envs per candidate) or in one batched tournament.  Two known
low-severity faults of the JAX package's cleaner are reproduced, not
fixed (``node_count`` ignores ``For.n``; ``shrink_program``'s docstring
claim about drift holds only for ``tol == 0``): a fix lands in both
packages together.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..bots.scripted import Opponent
from ..engine.types import FIELD_DTYPES, State
from ..env.gridnet import GridnetEnv
from .dsl import (DslNoise, For, If, Program, compile_program,
                  program_opponent)
from .search import _check_opponents, evaluate_population, play_lanes


def node_count(prog: Program) -> int:
    """Total AST nodes (commands + conditions), the cleaner's size metric."""
    n = 0
    for c in prog:
        if isinstance(c, If):
            n += 1 + node_count(c.then) + 1   # the If, its body, its cond
        elif isinstance(c, For):
            n += 1 + node_count(c.body)
        else:
            n += 1
    return n


def edit_candidates(prog: Program) -> List[Tuple[str, Program]]:
    """Single-edit shrink neighborhood of a program.

    Mirrors the deletions PerformCleanerAST tries line by line: drop a
    top-level command, unguard an ``If`` (splice its body in place —
    tests whether the guard ever mattered), unroll a ``For`` by one,
    and drop one command inside an ``If``/``For`` body (one level deep,
    like the Java cleaner's per-line descent)."""
    cands: List[Tuple[str, Program]] = []
    for i, c in enumerate(prog):
        rest = prog[:i] + prog[i + 1:]
        cands.append((f"drop[{i}] {type(c).__name__}", rest))
        if isinstance(c, If):
            cands.append((f"unguard[{i}]", prog[:i] + c.then + prog[i + 1:]))
            for j in range(len(c.then)):
                body = c.then[:j] + c.then[j + 1:]
                ed = (prog[:i]
                      + ((If(c.cond, body),) if body else ())
                      + prog[i + 1:])
                cands.append((f"drop[{i}].then[{j}]", ed))
        elif isinstance(c, For):
            if c.n > 1:
                cands.append((f"unroll[{i}] For({c.n}->{c.n - 1})",
                              prog[:i] + (For(c.n - 1, c.body),)
                              + prog[i + 1:]))
            else:
                cands.append((f"unwrap[{i}] For(1)",
                              prog[:i] + c.body + prog[i + 1:]))
            for j in range(len(c.body)):
                body = c.body[:j] + c.body[j + 1:]
                ed = (prog[:i]
                      + ((For(c.n, body),) if body else ())
                      + prog[i + 1:])
                cands.append((f"drop[{i}].body[{j}]", ed))
    # dedupe identical resulting programs (e.g. unwrap == drop for empty For)
    seen, out = set(), []
    for label, p in cands:
        if p != prog and p not in seen:
            seen.add(p)
            out.append((label, p))
    return out


def probe_states(env: GridnetEnv, program: Program,
                 opponents: Sequence[Opponent], n_snaps: int = 24,
                 stride: int = 17, seed: int = 0):
    """States the program actually visits: play it against each opponent
    from both seats and snapshot the board every ``stride`` cycles, BEFORE
    each stride (ticks 0, stride, 2*stride, ...), finished games frozen
    (clean.py:117-170).

    Returns ``(states, seats, noise)``: a State batch of ``len(opponents)
    * 2 * n_snaps`` probes (lane-major: lane (opponent, seat), then
    snapshot), the program's seat in each (int32), and one ``DslNoise``
    for the probes (both kinds of uniforms, drawn from a generator seeded
    with ``seed + 1``), shared by base and candidate so that stochastic
    target policies compare deterministically."""
    _check_opponents(opponents)
    lanes = [(oi, seat) for oi in range(len(opponents)) for seat in (0, 1)]
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)
    snaps = []

    def on_tick(tick, s):
        if tick % stride == 0:
            snaps.append(s)

    play_lanes(env, [program_opponent(env, program)], opponents,
               [0] * len(lanes), [l[0] for l in lanes],
               [l[1] for l in lanes], (n_snaps - 1) * stride + 1, gen,
               on_tick)
    L, n = len(lanes), len(lanes) * n_snaps
    states = State(**{f: torch.stack([getattr(x, f) for x in snaps], 1)
                      .reshape((n,) + tuple(getattr(snaps[0], f).shape[1:]))
                      for f in FIELD_DTYPES})
    seats = torch.tensor([l[1] for l in lanes], dtype=torch.int32,
                         device=env.device).repeat_interleave(n_snaps)
    gen.manual_seed(seed + 1)
    D = 2 * env.cfg.engine.max_range + 1
    noise = DslNoise(
        torch.rand((n, D * D, env.h, env.w), generator=gen,
                   device=env.device),
        torch.rand((n, env.h, env.w), generator=gen, device=env.device))
    return states, seats, noise


def mismatch_counts(env: GridnetEnv, base: Program,
                    candidates: Sequence[Program], states: State,
                    seats: torch.Tensor, noise: DslNoise) -> np.ndarray:
    """Per-candidate count of probe states where the candidate's action
    tensor differs from the base program's (clean.py:173-196): each
    candidate runs once over the whole probe batch."""
    a_base = compile_program(env, base)(states, seats, noise)
    out = []
    for p in candidates:
        a = compile_program(env, p)(states, seats, noise)
        out.append(int((a != a_base).flatten(1).any(1).sum()))
    return np.asarray(out, dtype=np.int64)


@dataclasses.dataclass
class CleanResult:
    program: Program
    removed: List[str]          # accepted edit labels, in order
    nodes_before: int
    nodes_after: int


def clean_program(env: GridnetEnv, program: Program,
                  opponents: Sequence[Opponent], n_snaps: int = 24,
                  stride: int = 17, seed: int = 0,
                  max_rounds: int = 32) -> CleanResult:
    """PerformCleanerAST analog: greedily delete structure while the
    program's actions stay bit-identical on every probe state.

    Each round scores the whole single-edit neighborhood on the probe
    batch and accepts the equivalent edit that sheds the most nodes;
    terminates at a fixpoint (no equivalent edit remains)."""
    states, seats, noise = probe_states(env, program, opponents,
                                        n_snaps, stride, seed)
    cur = program
    removed: List[str] = []
    for _ in range(max_rounds):
        cands = edit_candidates(cur)
        if not cands:
            break
        counts = mismatch_counts(env, cur, [p for _, p in cands],
                                 states, seats, noise)
        ok = [(node_count(p), label, p)
              for (label, p), c in zip(cands, counts)
              if c == 0 and node_count(p) < node_count(cur)]
        if not ok:
            break
        _, label, cur = min(ok, key=lambda t: t[0])
        removed.append(label)
    return CleanResult(cur, removed, node_count(program), node_count(cur))


def shrink_program(env: GridnetEnv, program: Program,
                   opponents: Sequence[Opponent], tol: float = 0.0,
                   games_per_pair: int = 2, max_cycles: int = 1200,
                   seed: int = 0, max_rounds: int = 16) -> CleanResult:
    """PerformCleanerASTOptim analog: greedily delete structure while
    tournament fitness stays within ``tol`` of the incumbent's.

    Each round scores incumbent + every single-edit candidate as one
    batched tournament; accepts the smallest candidate still within
    tolerance of the incumbent's CURRENT score (re-measured each round,
    same seed, so drift cannot accumulate past ``tol``)."""
    cur = program
    removed: List[str] = []
    for r in range(max_rounds):
        cands = edit_candidates(cur)
        if not cands:
            break
        fits = evaluate_population(env, [cur] + [p for _, p in cands],
                                   opponents, games_per_pair, max_cycles,
                                   seed=seed)
        ok = [(node_count(p), label, p)
              for (label, p), f in zip(cands, fits[1:])
              if f >= fits[0] - tol and node_count(p) < node_count(cur)]
        if not ok:
            break
        _, label, cur = min(ok, key=lambda t: t[0])
        removed.append(label)
    return CleanResult(cur, removed, node_count(program), node_count(cur))
