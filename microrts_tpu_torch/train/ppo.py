"""PPO trainer for the gridnet env: rollout, GAE and clipped-PPO updates.

A port of ``microrts_tpu.train.ppo``: per step the gridnet policy reads
player 0's one-hot observation and masks and samples a factored action
under invalid-action masking, the opponent (a scripted bot, or the same
policy with ``selfplay``) acts on the same pre-step state, and
``VecGridnetEnv`` steps and auto-resets, handing back the next one-hot
observation from its epilogue.  ``update`` then runs GAE over the
trajectory and ``epochs`` x ``minibatches`` steps of the clipped-PPO loss
with the optimizer ``tx`` (by default optax's ``chain(clip_by_global_norm,
adam)``, repeated in ``train/optim.py``).  On CUDA tensors every rollout
step runs the ``actor``, ``policy_sample``, ``decode``, ``issue_env``,
``cycle``, ``epilogue`` and ``splice_obs`` kernels (and ``rush`` for a
rush opponent) around the cuDNN convolutions of the policy, and every
loss step runs ``policy_logprob_fwd`` and, in its backward,
``policy_logprob_bwd``; an env built with ``plain=True`` runs every plain
version.

Randomness: JAX keys update ``u``'s rollout with ``fold_in(key, u)`` and
then per env (``fold_in`` of the global env index) and per step; the port
draws the same kinds of noise from a ``torch.Generator`` (the policy's
gumbels, the opponent's uniforms, and where the env needs them the
engine's: UTT v3's damage uniforms, CANCEL_RANDOM's coins under fog),
by default one seeded from the
trainer's seed and the update count, or takes them from ``noise(t)``, so
that a test can hand both packages the same draws.  ``update_sharded``
(data parallel over cards) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..engine.types import State
from ..env.gridnet import GridnetEnv
from ..env.vec import VecGridnetEnv
from ..models.gridnet_policy import (ActionSpace, GridnetPolicy,
                                     action_logprob, flax_order,
                                     gumbel_noise, sample_action)
from . import optim

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
    """The training carry.  The policy's parameters live in
    ``PPOTrainer.model`` (updated in place); ``opt_state`` is the
    optimizer's state over them, ``seed`` keys the default rollout noise
    and ``update_count`` counts the updates done."""
    env_states: State
    env_steps: torch.Tensor
    opt_state: object = None
    update_count: int = 0
    seed: int = 0


class Transition(NamedTuple):
    obs: torch.Tensor      # float32 [N, H, W, C]
    mask: torch.Tensor     # bool [N, H, W, A]: the env's mask without its
    #                        can-act channel, as JAX's Transition keeps it
    action: torch.Tensor   # int32 [N, H, W, 7]
    logprob: torch.Tensor  # float32 [N]
    value: torch.Tensor    # float32 [N]
    reward: torch.Tensor   # float32 [N]
    done: torch.Tensor     # bool [N]


class StepNoise(NamedTuple):
    """One rollout step's randomness: player 0's gumbels float32 ``[N, H,
    W, A]`` and the opponent's draws (what its ``draw`` makes: uniforms
    ``[N, H, W, 2]`` for a random bot, None for a deterministic one;
    gumbels for self-play; None for no opponent), and the env step's
    draws where the env needs them (``GridnetEnv.advance``): damage
    uniforms float32 ``[step_cycles, N, H, W]`` and coins bool ``[2, N,
    H, W, 4]``, else None."""
    gumbel: torch.Tensor
    opp: Optional[torch.Tensor]
    u01: Optional[torch.Tensor] = None
    coins: Optional[torch.Tensor] = None


class PPOTrainer:
    def __init__(self, env: GridnetEnv, cfg: PPOConfig = PPOConfig(),
                 opponent=None, selfplay: bool = False,
                 model: Optional[GridnetPolicy] = None,
                 tx: Optional[optim.Transform] = None):
        """``opponent``: a ``bots.scripted.Opponent`` (a bot and the draw
        of its noise), or None for an opponent that never acts.
        ``tx``: the optimizer (``train.optim``), by default
        ``chain(clip_by_global_norm(max_grad_norm), adam(lr))``."""
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
        self.tx = tx if tx is not None else optim.chain(
            optim.clip_by_global_norm(cfg.max_grad_norm), optim.adam(cfg.lr))
        # the parameters in the flax tree's order (optax's leaf order)
        self.param_names = flax_order(
            [n for n, _ in self.model.named_parameters()])
        nr = env.num_rewards
        w = [0.0] * nr
        for i, wv in enumerate(cfg.reward_weights[:nr]):
            w[i] = wv
        self.reward_w = torch.tensor(w, dtype=torch.float32,
                                     device=env.device)
        self._winloss_idx = env.cfg.reward_fns.index("winloss")

    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = 0) -> TrainState:
        """Fresh envs and optimizer state; with ``seed``, the policy's
        parameters are drawn anew from a generator seeded with it (else
        they are kept)."""
        if seed is not None:
            gen = torch.Generator()
            gen.manual_seed(seed)
            self.model.to("cpu").init_params(gen).to(self.env.device)
        states, steps = self.vec.reset()
        return TrainState(env_states=states, env_steps=steps,
                          opt_state=self.tx.init(self.params()),
                          seed=0 if seed is None else seed)

    def params(self) -> List[torch.Tensor]:
        """The policy's parameters in the flax tree's order."""
        named = dict(self.model.named_parameters())
        return [named[n] for n in self.param_names]

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
        elif self.opponent is not None:
            opp = self.opponent.draw(gen, B)
        else:
            opp = None
        return StepNoise(g, opp, self.env.draw_u01(gen, self.env.step_cycles,
                                                   B),
                         self.env.draw_coins(gen, B))

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
                states, steps, action, a1, onehot=(0,), coins=nz.coins,
                u01=nz.u01)
            r = (rewards[:, 0, :] * self.reward_w).sum(-1)
            trs.append(Transition(obs=obs, mask=mask[..., 1:] != 0,
                                  action=action,
                                  logprob=logprob, value=value,
                                  reward=r, done=reset))
            # terminal winloss: +1 only on a player-0 win reset
            wins += (reset & (rewards[:, 0, self._winloss_idx] > 0)).sum()
            obs = oh[0]
        _, last_value = self.model(obs)
        traj = Transition(*[torch.stack(f) for f in zip(*trs)])
        return (dataclasses.replace(ts, env_states=states, env_steps=steps),
                traj, last_value, wins)

    # ------------------------------------------------------------------
    def _gae(self, traj: Transition, last_value: torch.Tensor):
        """Generalised advantages, scanned backwards over the steps
        (ppo.py:175-188).  Returns (advantages, returns) ``[T, N]``."""
        cfg = self.cfg
        adv_next = torch.zeros_like(last_value)
        v_next = last_value
        advs = [None] * traj.reward.shape[0]
        for t in range(traj.reward.shape[0] - 1, -1, -1):
            nonterm = 1.0 - traj.done[t].to(torch.float32)
            delta = traj.reward[t] + cfg.gamma * v_next * nonterm \
                - traj.value[t]
            adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
            v_next = traj.value[t]
            advs[t] = adv_next
        advs = torch.stack(advs)
        return advs, advs + traj.value

    def _loss(self, batch: Transition, adv_n: torch.Tensor,
              ret: torch.Tensor, ev: Callable[[str], None] = lambda n: None):
        """Clipped-PPO loss over one minibatch (ppo.py:190-210); ``adv_n``
        arrives normalised.  Returns (loss, metrics of 0-d tensors).
        ``ev(name)`` is called after each phase (a profiler's marks)."""
        cfg = self.cfg
        logits, value = self.model(batch.obs)
        ev("forward")
        lp_map, ent_map = action_logprob(logits, batch.mask, batch.action,
                                         self.space, plain=self.plain)
        ev("logprob")
        can_act = batch.mask[..., :6].any(-1)
        logprob = torch.where(can_act, lp_map, 0.0).sum((-2, -1))
        entropy = torch.where(can_act, ent_map, 0.0).sum((-2, -1)).mean()
        ratio = torch.exp(logprob - batch.logprob)
        pg1 = ratio * adv_n
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_loss = 0.5 * ((value - ret) ** 2).mean()
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        return loss, dict(pg_loss=pg_loss, v_loss=v_loss, entropy=entropy,
                          ratio=ratio.mean())

    def minibatch(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """Minibatch ``m`` of a ``[T, N, ...]`` tensor: the envs whose
        index is ``m`` modulo ``minibatches``, ``[T * N/M, ...]`` in
        (step, env) order (ppo.py:250-253)."""
        T, N = x.shape[:2]
        return x[:, m::self.cfg.minibatches].reshape(
            (T * (N // self.cfg.minibatches),) + tuple(x.shape[2:]))

    @torch.no_grad()
    def advantages(self, traj: Transition, last_value: torch.Tensor):
        """GAE with the advantages normalised over the whole rollout
        (ppo.py:233-240).  Returns (normalised advantages, returns)."""
        adv, ret = self._gae(traj, last_value)
        m1 = adv.mean()
        m2 = (adv * adv).mean()
        adv_n = (adv - m1) * torch.rsqrt(
            torch.clamp(m2 - m1 * m1, min=0.0) + 1e-8)
        return adv_n, ret

    def step(self, traj: Transition, adv_n: torch.Tensor, ret: torch.Tensor,
             m: int, opt_state, ev: Callable[[str], None] = lambda n: None):
        """One optimizer step on minibatch ``m``: the loss, its gradients
        and the update of the model's parameters (in place).  Returns
        (the loss terms, the next optimizer state, the gradients)."""
        params = self.params()
        batch = Transition(*[self.minibatch(x, m) for x in traj])
        loss, aux = self._loss(batch, self.minibatch(adv_n, m),
                               self.minibatch(ret, m), ev)
        grads = torch.autograd.grad(loss, params)
        ev("backward")
        with torch.no_grad():
            updates, opt_state = self.tx.update(list(grads), opt_state)
            optim.apply_updates(params, updates)
        ev("optimizer")
        return aux, opt_state, grads

    def update(self, ts: TrainState, gen: Optional[torch.Generator] = None,
               noise: Optional[Callable[[int], StepNoise]] = None,
               ev: Callable[[str], None] = lambda n: None):
        """One PPO update (ppo.py:212-290): a rollout, GAE, global
        advantage normalisation, then ``epochs`` x ``minibatches`` steps of
        the loss and the optimizer on the model's parameters (in place).
        The rollout's noise is ``noise(t)`` if given, else drawn from
        ``gen``, else from a generator seeded with (seed, update count).
        Returns (the next TrainState, metrics: the last epoch's last
        minibatch's loss terms, ``mean_reward``, ``episodes``, ``wins``).
        ``ev(name)`` is called after each phase (a profiler's marks)."""
        cfg = self.cfg
        M, N, T = cfg.minibatches, cfg.num_envs, cfg.rollout_len
        if N % M:
            raise ValueError("num_envs must divide by minibatches")
        if noise is None and gen is None:
            gen = torch.Generator(device=self.env.device)
            gen.manual_seed((ts.seed * 1_000_003 + ts.update_count)
                            % (1 << 63))
        nts, traj, last_value, wins = self._rollout(ts, gen=gen, noise=noise)
        ev("rollout")
        adv_n, ret = self.advantages(traj, last_value)
        ev("gae")
        opt_state = ts.opt_state
        aux: Dict[str, torch.Tensor] = {}
        for _ in range(cfg.epochs):
            for m in range(M):
                aux, opt_state, _ = self.step(traj, adv_n, ret, m,
                                              opt_state, ev)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["mean_reward"] = traj.reward.mean()
        metrics["episodes"] = traj.done.sum()
        metrics["wins"] = wins
        return dataclasses.replace(
            nts, opt_state=opt_state, update_count=ts.update_count + 1,
            seed=ts.seed), metrics

    def update_sharded(self, ts: TrainState):
        raise NotImplementedError(
            "update_sharded (data parallel over cards) is not ported yet: "
            "ROADMAP.md queue 1 item 14")
