"""Scripted bots on batched planes (port of ``microrts_tpu.bots.scripted``:
``passive_bot`` and ``random_bot``).

A bot is ``bot(state, player, u) -> int32 [B, H, W, 7]`` gridnet actions.
Its randomness comes in as ``u``, float32 uniforms in [0, 1) of shape
``[B, H, W, 2]`` made by the caller (e.g. with a ``torch.Generator``), so
the same draws can be fed to the JAX package in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import kernels as KN
from ..engine.types import State
from ..env.gridnet import GridnetEnv

I32 = torch.int32


def passive_bot(env: GridnetEnv):
    """PassiveAI (ai/PassiveAI.java:28-55): never acts."""
    def bot(state: State, player: int, u=None) -> torch.Tensor:
        return torch.zeros((state.batch, env.h, env.w, 7), dtype=I32,
                           device=state.device)
    return bot


def random_bot(env: GridnetEnv, bias: float = 1.0):
    """RandomAI (bias=1) / RandomBiasedAI (bias=5: harvest, return and
    attack weighted 5x, RandomBiasedAI.java:25-60), as scripted.py:38-103
    samples it: a float32 threshold walk over the 6 action classes with
    ``u[..., 0]``, then the ``min(int(u1*n), n-1)``-th legal parameter of
    the chosen class with ``u[..., 1]``.  On CUDA tensors this is the
    fused ``actor`` kernel (legal masks + sampling)."""
    weights = (1.0, 1.0, float(bias), float(bias), 1.0, float(bias))

    def bot(state: State, player: int, u: torch.Tensor) -> torch.Tensor:
        if env.engine._use_kernel(u):
            return KN.ACTOR(env.cfg.engine, state, player, u=u,
                            weights=weights)[0]
        return random_bot_plain(env, state, player, u, weights)

    return bot


@dataclasses.dataclass(frozen=True)
class Opponent:
    """A bot as the PPO trainer's opponent: ``bot(state, player, u)`` with
    ``draws`` uniforms per cell (``u`` float32 ``[B, H, W, draws]``, which
    the trainer draws or takes from its noise source; JAX's bots draw
    them from a key instead)."""
    bot: Callable
    draws: int

    def __call__(self, state: State, player: int, u) -> torch.Tensor:
        return self.bot(state, player, u)


def random_opponent(env: GridnetEnv, bias: float = 5.0) -> Opponent:
    """``random_bot(env, bias)`` as an opponent: two uniforms per cell,
    ``uniform(key, (H, W, 2))`` in the JAX package (scripted.py:71)."""
    return Opponent(random_bot(env, bias), 2)


def kth_legal(L: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Index of the (j+1)-th True along the last axis of bool ``L``
    (``j`` int32); 0 when out of range."""
    hit = L & (torch.cumsum(L.to(I32), -1) == (j + 1)[..., None])
    return hit.to(torch.uint8).argmax(-1).to(I32)


def random_bot_plain(env: GridnetEnv, state: State, player: int,
                     u: torch.Tensor, weights) -> torch.Tensor:
    T = env.cfg.engine.num_types
    B, H, W = state.utype.shape
    m = env.engine.legal_masks(state, player)
    tm = m["type"]
    f32 = torch.float32

    # weighted type draw: a threshold walk over the 6 classes, in float32
    w = [torch.where(tm[..., i], weights[i], 0.0).to(f32) for i in range(6)]
    tot = w[0]
    for i in range(1, 6):
        tot = tot + w[i]
    x = u[..., 0] * tot
    acc = torch.zeros_like(x)
    at = torch.zeros((B, H, W), dtype=I32, device=u.device)
    chosen = torch.zeros_like(tm[..., 0])
    for i in range(6):
        acc = acc + w[i]
        hit = ~chosen & (x < acc)
        at = torch.where(hit, i, at)
        chosen = chosen | hit

    def pick(L):
        n = L.sum(-1, dtype=I32)
        j = torch.minimum((u[..., 1] * n).to(I32), (n - 1).clamp(min=0))
        return kth_legal(L, j)

    mv = pick(m["move"])
    hv = pick(m["harvest"])
    rt = pick(m["ret"])
    pj = pick(m["produce_pair"].reshape(B, H, W, -1))
    ak = pick(m["attack"])
    out = torch.stack([at, mv, hv, rt, pj // T, pj % T, ak], -1)
    return torch.where(m["can_act"][..., None], out, 0).to(I32)
