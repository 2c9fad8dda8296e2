"""Vectorized, auto-resetting gridnet env (port of ``microrts_tpu.env.vec``).

The batch is the leading axis of every plane.  When an env reports done
(or reaches ``max_steps``) the returned rewards and dones are the terminal
ones while the returned state and observation are the fresh reset ones
(JNIGridnetVecClient.java:224-236, :253-272).  ``quarantine`` and
``env_health`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import kernels as KN
from ..engine.types import State
from .gridnet import GridnetEnv


class VecGridnetEnv:
    """Batched self-play env over one map.  ``init`` (a State of batch 1
    or ``num_envs``) is what a finished env resets to: by default the
    map's initial state (``env/pool.py`` gives each env its own map)."""

    def __init__(self, env: GridnetEnv, num_envs: int, max_steps: int = 5000,
                 init: Optional[State] = None):
        self.env = env
        self.num_envs = num_envs
        self.max_steps = max_steps
        self.init = init if init is not None else env.init_state

    def reset(self) -> Tuple[State, torch.Tensor]:
        steps = torch.zeros(self.num_envs, dtype=torch.int32,
                            device=self.env.device)
        return State(**{f: v.expand((self.num_envs,) + tuple(v.shape[1:]))
                        .clone() for f, v in vars(self.init).items()}), steps

    def step(self, states: State, steps: torch.Tensor, a0: torch.Tensor,
             a1: torch.Tensor, onehot: Sequence[int] = (), coins=None):
        """Step all envs; auto-reset finished ones.

        Returns (states', steps', obs int32 [2, N, C, H, W] (C = 6, or 8
        under partial observability), rewards float32 [N, 2, NR], dones
        bool [2, N, NR], reset_mask bool [N]), and with ``onehot``
        (players) also the one-hot observation float32
        [len(onehot), N, H, W, 20+T] of states' for those players (of
        their views under partial observability).  ``coins``: the step's
        CANCEL_RANDOM coins (``GridnetEnv.advance``).  On CUDA tensors the
        epilogue is ``epilogue`` (rewards, dones, reset arithmetic) and
        ``splice_obs`` (reset splice and observations; under partial
        observability the splice only, then ``obs_po``).
        """
        env = self.env
        po = env.partial_obs
        c0, c1, nstates, _ = env.advance(states, a0, a1, coins)
        if env.engine._use_kernel(nstates.utype):
            rewards, dones, reset_mask, out_steps = KN.EPILOGUE(
                env.cfg, nstates, states, c0, c1, steps, self.max_steps,
                done_copies=2)
            out_states, obs, oh = KN.SPLICE_OBS(
                env.cfg.engine, nstates, reset_mask, self.init,
                obs=() if po else (0, 1), onehot=() if po else tuple(onehot))
            if po:
                obs, oh = KN.OBS_PO(env.cfg.engine, out_states, (0, 1),
                                    onehot=tuple(onehot))
        else:
            rewards = env.rewards_plain(states, c0, c1, nstates)
            done_vec = env.dones_plain(nstates)
            steps1 = steps + 1
            reset_mask = done_vec[:, 0] | (steps1 >= self.max_steps)
            out_states = nstates.select(reset_mask, self.init)
            out_steps = torch.where(reset_mask, 0, steps1).to(torch.int32)
            obs = torch.stack([env.observation_plain(out_states, p)
                               for p in (0, 1)])
            dones = torch.stack([done_vec, done_vec])
            oh = (torch.stack([env.observation_onehot_plain(out_states, p)
                               for p in onehot]) if onehot else None)
        out = (out_states, out_steps, obs, rewards, dones, reset_mask)
        return out + (oh,) if onehot else out

    def masks(self, states: State) -> torch.Tensor:
        """int32 [2, N, H, W, M] (of the full state, also under partial
        observability, as in the JAX package)."""
        return torch.stack([self.env.masks(states, p) for p in (0, 1)])
