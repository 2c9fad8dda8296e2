"""PPO trainer for the gridnet env: the policy-driven rollout.

A port of the rollout half of ``microrts_tpu.train.ppo``: per step the
gridnet policy reads player 0's one-hot observation and masks and samples
a factored action under invalid-action masking, the opponent (a scripted
bot, or the same policy with ``selfplay``) acts on the same pre-step
state, and ``VecGridnetEnv`` steps and auto-resets, handing back the next
one-hot observation from its epilogue.  On CUDA tensors every step runs
the ``actor``, ``policy_sample``, ``decode``, ``issue_env``, ``cycle``,
``epilogue`` and ``splice_obs`` kernels around the cuDNN convolutions of
the policy; an env built with ``plain=True`` runs every plain version.

Randomness: JAX keys the rollout per env (``fold_in`` of the global env
index) and splits per step; the port draws the same kinds of noise from a
``torch.Generator`` (the policy's gumbels, the opponent's uniforms), or
takes them from ``noise(t)``, so that a test can hand both packages the
same draws.  ``_gae``, ``_loss``, ``update`` and ``train/run.py`` belong
to the training slice and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..engine.types import State
from ..env.gridnet import GridnetEnv
from ..env.vec import VecGridnetEnv
from ..models.gridnet_policy import (ActionSpace, GridnetPolicy,
                                     gumbel_noise, sample_action)

DEFAULT_REWARD_WEIGHTS = (10.0, 1.0, 1.0, 0.2, 4.0, 1.0)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 64
    rollout_len: int = 128
    max_steps: int = 2000
    lr: float = 2.5e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    epochs: int = 4
    minibatches: int = 4
    max_grad_norm: float = 0.5
    reward_weights: Tuple[float, ...] = DEFAULT_REWARD_WEIGHTS


@dataclasses.dataclass
class TrainState:
    """The rollout's carry (the policy's parameters live in
    ``PPOTrainer.model``)."""
    env_states: State
    env_steps: torch.Tensor


class Transition(NamedTuple):
    obs: torch.Tensor      # float32 [N, H, W, C]
    mask: torch.Tensor     # int32 [N, H, W, 1+A], the env's layout (JAX
    #                        keeps bool [..., 1:])
    action: torch.Tensor   # int32 [N, H, W, 7]
    logprob: torch.Tensor  # float32 [N]
    value: torch.Tensor    # float32 [N]
    reward: torch.Tensor   # float32 [N]
    done: torch.Tensor     # bool [N]


class StepNoise(NamedTuple):
    """One rollout step's randomness: player 0's gumbels float32 ``[N, H,
    W, A]`` and the opponent's draws (uniforms ``[N, H, W, draws]`` for a
    scripted bot, gumbels for self-play, None for no opponent)."""
    gumbel: torch.Tensor
    opp: Optional[torch.Tensor]


class PPOTrainer:
    def __init__(self, env: GridnetEnv, cfg: PPOConfig = PPOConfig(),
                 opponent=None, selfplay: bool = False,
                 model: Optional[GridnetPolicy] = None):
        """``opponent``: a ``bots.scripted.Opponent`` (a bot and its
        uniforms per cell), or None for an opponent that never acts."""
        self.env = env
        self.cfg = cfg
        self.selfplay = selfplay
        self.plain = env.engine.plain
        self.vec = VecGridnetEnv(env, cfg.num_envs, cfg.max_steps)
        ecfg = env.cfg.engine
        self.space = ActionSpace(ecfg.num_types, 2 * ecfg.max_range + 1)
        self.model = model if model is not None else GridnetPolicy(
            self.space, 20 + ecfg.num_types)
        self.model.to(env.device)
        self.opponent = opponent
        nr = env.num_rewards
        w = [0.0] * nr
        for i, wv in enumerate(cfg.reward_weights[:nr]):
            w[i] = wv
        self.reward_w = torch.tensor(w, dtype=torch.float32,
                                     device=env.device)
        self._winloss_idx = env.cfg.reward_fns.index("winloss")

    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = 0) -> TrainState:
        """Fresh envs; with ``seed``, the policy's parameters are drawn
        anew from a generator seeded with it (else they are kept)."""
        if seed is not None:
            gen = torch.Generator()
            gen.manual_seed(seed)
            self.model.to("cpu").init_params(gen).to(self.env.device)
        states, steps = self.vec.reset()
        return TrainState(env_states=states, env_steps=steps)

    def _obs(self, state: State) -> torch.Tensor:
        return self.env.observation_onehot(state, 0)

    def _mask(self, state: State) -> torch.Tensor:
        return self.env.masks(state, 0)

    def _opp_action(self, state: State, u: Optional[torch.Tensor]
                    ) -> torch.Tensor:
        if self.opponent is None:
            return torch.zeros((state.batch, self.env.h, self.env.w, 7),
                               dtype=torch.int32, device=state.device)
        return self.opponent(state, 1, u)

    def _selfplay_opp(self, state: State, gumbel: torch.Tensor
                      ) -> torch.Tensor:
        """Mirror self-play: player 1 acts with the same policy on its own
        observation and masks."""
        logits, _ = self.model(self.env.observation_onehot(state, 1))
        return sample_action(logits, self.env.masks(state, 1), self.space,
                             gumbel, plain=self.plain)[0]

    def draw_noise(self, gen: torch.Generator) -> StepNoise:
        """One step's randomness from ``gen`` (on the env's device)."""
        B, H, W = self.cfg.num_envs, self.env.h, self.env.w
        dev = self.env.device
        g = gumbel_noise((B, H, W, self.space.total), gen, dev)
        if self.selfplay:
            opp = gumbel_noise((B, H, W, self.space.total), gen, dev)
        elif self.opponent is not None and self.opponent.draws:
            opp = torch.rand((B, H, W, self.opponent.draws), generator=gen,
                             device=dev)
        else:
            opp = None
        return StepNoise(g, opp)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _rollout(self, ts: TrainState, gen: Optional[torch.Generator] = None,
                 noise: Optional[Callable[[int], StepNoise]] = None):
        """``cfg.rollout_len`` steps from ``ts``.  Each step's noise is
        ``noise(t)`` if given, else drawn from ``gen``.  Returns (the next
        TrainState, the stacked Transitions ``[T, N, ...]``, the value of
        the last observation ``[N]``, the number of player-0 wins)."""
        cfg = self.cfg
        states, steps = ts.env_states, ts.env_steps
        obs = self._obs(states)
        trs = []
        wins = torch.zeros((), dtype=torch.int64, device=steps.device)
        for t in range(cfg.rollout_len):
            nz = noise(t) if noise is not None else self.draw_noise(gen)
            mask = self._mask(states)
            logits, value = self.model(obs)
            action, _, _, logprob = sample_action(
                logits, mask, self.space, nz.gumbel, plain=self.plain)
            if self.selfplay:
                a1 = self._selfplay_opp(states, nz.opp)
            else:
                a1 = self._opp_action(states, nz.opp)
            states, steps, _, rewards, _, reset, oh = self.vec.step(
                states, steps, action, a1, onehot=(0,))
            r = (rewards[:, 0, :] * self.reward_w).sum(-1)
            trs.append(Transition(obs=obs, mask=mask, action=action,
                                  logprob=logprob, value=value, reward=r,
                                  done=reset))
            # terminal winloss: +1 only on a player-0 win reset
            wins += (reset & (rewards[:, 0, self._winloss_idx] > 0)).sum()
            obs = oh[0]
        _, last_value = self.model(obs)
        traj = Transition(*[torch.stack(f) for f in zip(*trs)])
        return TrainState(states, steps), traj, last_value, wins
