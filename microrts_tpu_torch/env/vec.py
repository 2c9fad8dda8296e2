"""Vectorized, auto-resetting gridnet env (port of ``microrts_tpu.env.vec``).

The batch is the leading axis of every plane.  When an env reports done
(or reaches ``max_steps``) the returned rewards and dones are the terminal
ones while the returned state and observation are the fresh reset ones
(JNIGridnetVecClient.java:224-236, :253-272).  ``quarantine`` and
``env_health`` are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import kernels as KN
from ..engine.types import State
from .gridnet import GridnetEnv


class VecGridnetEnv:
    """Batched self-play env over one map."""

    def __init__(self, env: GridnetEnv, num_envs: int, max_steps: int = 5000):
        self.env = env
        self.num_envs = num_envs
        self.max_steps = max_steps

    def reset(self) -> Tuple[State, torch.Tensor]:
        steps = torch.zeros(self.num_envs, dtype=torch.int32,
                            device=self.env.device)
        return self.env.reset(self.num_envs), steps

    def step(self, states: State, steps: torch.Tensor, a0: torch.Tensor,
             a1: torch.Tensor, onehot: Sequence[int] = ()):
        """Step all envs; auto-reset finished ones.

        Returns (states', steps', obs int32 [2, N, 6, H, W], rewards
        float32 [N, 2, NR], dones bool [2, N, NR], reset_mask bool [N]),
        and with ``onehot`` (players) also the one-hot observation float32
        [len(onehot), N, H, W, C] of states' for those players.  On CUDA
        tensors the epilogue is two kernels: ``epilogue`` (rewards, dones,
        reset arithmetic) and ``splice_obs`` (reset splice, observations).
        """
        env = self.env
        c0, c1, nstates, _ = env.advance(states, a0, a1)
        if env.engine._use_kernel(nstates.utype):
            rewards, dones, reset_mask, out_steps = KN.EPILOGUE(
                env.cfg, nstates, states, c0, c1, steps, self.max_steps,
                done_copies=2)
            out_states, obs, oh = KN.SPLICE_OBS(
                env.cfg.engine, nstates, reset_mask, env.init_state,
                obs=(0, 1), onehot=tuple(onehot))
        else:
            rewards = env.rewards_plain(states, c0, c1, nstates)
            done_vec = env.dones_plain(nstates)
            steps1 = steps + 1
            reset_mask = done_vec[:, 0] | (steps1 >= self.max_steps)
            out_states = nstates.select(reset_mask, env.init_state)
            out_steps = torch.where(reset_mask, 0, steps1).to(torch.int32)
            obs = torch.stack([env.observation_plain(out_states, p)
                               for p in (0, 1)])
            dones = torch.stack([done_vec, done_vec])
            oh = (torch.stack([env.observation_onehot_plain(out_states, p)
                               for p in onehot]) if onehot else None)
        out = (out_states, out_steps, obs, rewards, dones, reset_mask)
        return out + (oh,) if onehot else out

    def masks(self, states: State) -> torch.Tensor:
        """int32 [2, N, H, W, M]."""
        return torch.stack([self.env.masks(states, p) for p in (0, 1)])
