"""Vectorized, auto-resetting gridnet env (port of ``microrts_tpu.env.vec``).

The batch is the leading axis of every plane.  When an env reports done
(or reaches ``max_steps``) the returned rewards and dones are the terminal
ones while the returned state and observation are the fresh reset ones
(JNIGridnetVecClient.java:224-236, :253-272).  ``quarantine=True`` adds
the per-env failure detector ``env_health`` (vec.py:23-48): a failed env
is reset in the same step, its rewards read 0 and every other env's are
``nan_to_num``'d (vec.py:86-91).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import kernels as KN
from ..engine.types import State
from .gridnet import GridnetEnv


def env_health(state: State, rewards: torch.Tensor, cfg,
               plain: bool = False) -> torch.Tensor:
    """Per-env failure flags bool ``[B]`` (vec.py:23-48): a non-finite
    reward (``rewards`` float32 ``[B, NR']``), an occupied cell's hp
    outside [1, max hp of the UTT], a type past the UTT, a busy cell's
    negative ticks, a stockpile below 0 or above 10^6.  ``cfg`` is the
    ``EngineConfig``; CUDA tensors launch the ``env_health`` kernel
    unless ``plain``."""
    if not plain and state.device.type != "cpu":
        return KN.ENV_HEALTH(cfg, state, rewards)
    return env_health_plain(state, rewards, cfg)


def env_health_plain(state: State, rewards: torch.Tensor,
                     cfg) -> torch.Tensor:
    occ = state.utype > 0
    hp = state.hp
    bad_hp = (occ & ((hp <= 0) | (hp > max(cfg.hp)))).any((1, 2))
    bad_type = (state.utype > cfg.num_types).any((1, 2))
    bad_ticks = (state.busy & (state.aticks < 0)).any((1, 2))
    bad_res = ((state.resources < 0)
               | (state.resources > 1_000_000)).any(-1)
    bad_rew = ~torch.isfinite(rewards).all(-1)
    return bad_hp | bad_type | bad_ticks | bad_res | bad_rew


class VecGridnetEnv:
    """Batched self-play env over one map.  ``init`` (a State of batch 1
    or ``num_envs``) is what a finished env resets to: by default the
    map's initial state (``env/pool.py`` gives each env its own map).

    ``quarantine=True`` adds the per-env failure detector: envs whose
    state corrupts or whose rewards go non-finite are reset in the same
    step (their lane goes on with a fresh episode instead of poisoning
    the batch) and reported in the step's ``reset_mask``."""

    def __init__(self, env: GridnetEnv, num_envs: int, max_steps: int = 5000,
                 init: Optional[State] = None, quarantine: bool = False):
        self.env = env
        self.num_envs = num_envs
        self.max_steps = max_steps
        self.init = init if init is not None else env.init_state
        self.quarantine = quarantine

    def reset(self) -> Tuple[State, torch.Tensor]:
        steps = torch.zeros(self.num_envs, dtype=torch.int32,
                            device=self.env.device)
        return State(**{f: v.expand((self.num_envs,) + tuple(v.shape[1:]))
                        .clone() for f, v in vars(self.init).items()}), steps

    def step(self, states: State, steps: torch.Tensor, a0: torch.Tensor,
             a1: torch.Tensor, onehot: Sequence[int] = (), coins=None,
             u01=None, gen: Optional[torch.Generator] = None):
        """Step all envs; auto-reset finished ones.

        Returns (states', steps', obs int32 [2, N, C, H, W] (C = 6, or 8
        under partial observability), rewards float32 [N, 2, NR], dones
        bool [2, N, NR], reset_mask bool [N]), and with ``onehot``
        (players) also the one-hot observation float32
        [len(onehot), N, H, W, 20+T] of states' for those players (of
        their views under partial observability).  ``coins``, ``u01`` and
        ``gen``: the engine's draws (``GridnetEnv.advance``).  With
        ``quarantine``, ``reset_mask`` also covers the failed envs.  On
        CUDA tensors the epilogue is ``epilogue`` (rewards, dones, reset
        arithmetic), ``env_health`` when quarantined, and ``splice_obs``
        (reset splice and observations; under partial observability the
        splice only, then ``obs_po``).
        """
        env = self.env
        po = env.partial_obs
        c0, c1, nstates, _ = env.advance(states, a0, a1, coins, u01, gen)
        if env.engine._use_kernel(nstates.utype):
            rewards, dones, reset_mask, out_steps = KN.EPILOGUE(
                env.cfg, nstates, states, c0, c1, steps, self.max_steps,
                done_copies=2)
            if self.quarantine:
                rewards, reset_mask, out_steps = self._quarantine(
                    nstates, rewards, reset_mask, out_steps)
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
            out_steps = torch.where(reset_mask, 0, steps1).to(torch.int32)
            if self.quarantine:
                rewards, reset_mask, out_steps = self._quarantine(
                    nstates, rewards, reset_mask, out_steps)
            out_states = nstates.select(reset_mask, self.init)
            obs = torch.stack([env.observation_plain(out_states, p)
                               for p in (0, 1)])
            dones = torch.stack([done_vec, done_vec])
            oh = (torch.stack([env.observation_onehot_plain(out_states, p)
                               for p in onehot]) if onehot else None)
        out = (out_states, out_steps, obs, rewards, dones, reset_mask)
        return out + (oh,) if onehot else out

    def _quarantine(self, nstates: State, rewards, reset_mask, out_steps):
        """The failed envs join ``reset_mask`` (their steps restart at 0)
        and read rewards 0; the others' rewards are ``nan_to_num``'d
        (vec.py:86-91)."""
        failed = env_health(nstates, rewards.reshape(rewards.shape[0], -1),
                            self.env.cfg.engine, plain=self.env.engine.plain)
        rewards = torch.where(failed[:, None, None], 0.0,
                              torch.nan_to_num(rewards))
        return (rewards, reset_mask | failed,
                torch.where(failed, 0, out_steps).to(torch.int32))

    def masks(self, states: State) -> torch.Tensor:
        """int32 [2, N, H, W, M] (of the full state, also under partial
        observability, as in the JAX package)."""
        return torch.stack([self.env.masks(states, p) for p in (0, 1)])
