"""Training CLI: PPO against scripted opponents, with checkpoints.

    python -m microrts_tpu_torch.train.run [--map maps/16x16/basesWorkers16x16.xml]
        [--opponent WorkerRush] [--updates 50] [--num-envs 64]
        [--rollout-len 128] [--lr 2.5e-4] [--seed 0] [--ckpt out.npz]
        [--ckpt-every N] [--resume in.npz] [--eval-every N]
        [--eval-games 8] [--selfplay] [--cpu]

The port of ``python -m microrts_tpu.train.run``, with its flags and its
per-update line.  It trains the bf16 ``GridnetPolicy`` (width 64, 4
blocks) on the CUDA card, through the port's kernels; without a card it
raises, and ``--cpu`` runs the plain PyTorch path on the CPU instead (it
never falls back on its own).  The default map is basesWorkers16x16 (the
JAX CLI's is basesWorkers8x8).  Checkpoints are npz files in the JAX
package's layout, so either package resumes the other's.
``--eval-every N`` plays ``--eval-games`` games of the sampled policy
against the opponent every N updates (``evaluate``, through
``eval/tournament.play_matches``) and prints the win-rate.

Not ported yet: ``--sharded`` (ROADMAP.md queue 1 item 14); it raises
``NotImplementedError``.  A stateful ``--opponent`` (BS1/BS2/BS3_NaiveMCTS,
ContinuingNaiveMCTS) raises ``ValueError``: the trainer calls its
opponent as ``opponent(state, 1, noise)``, without the memory such a bot
carries from frame to frame (so does the JAX package's).
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--map", default="maps/16x16/basesWorkers16x16.xml")
    p.add_argument("--opponent", default="WorkerRush")
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--rollout-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", help="save final params here (npz)")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", help="load params from npz")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-games", type=int, default=8)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--selfplay", action="store_true",
                   help="mirror self-play: player 1 uses the same policy")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU")
    args = p.parse_args(argv)
    if args.sharded:
        raise NotImplementedError(
            "--sharded is not ported yet: ROADMAP.md queue 1 item 14")

    from ..config import STATEFUL_BOTS, JAVA_AI_ALIASES, make_bot
    from ..env.gridnet import GridnetEnv
    from ..utils.assets import asset_path
    from ..utils.checkpoint import load_params, save_params
    from .ppo import PPOConfig, PPOTrainer

    if JAVA_AI_ALIASES.get(args.opponent, args.opponent) in STATEFUL_BOTS:
        raise ValueError(
            f"--opponent {args.opponent} is a stateful bot: PPOTrainer calls "
            "its opponent as opponent(state, 1, noise) and keeps no memory "
            "for it between steps, so it cannot train against one")
    env = GridnetEnv(asset_path(args.map),
                     device="cpu" if args.cpu else "cuda")
    opponent = make_bot(args.opponent, env)
    cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout_len,
                    lr=args.lr)
    trainer = PPOTrainer(env, cfg, opponent=opponent,
                         selfplay=args.selfplay)
    ts = trainer.init(seed=args.seed)
    if args.resume:
        load_params(args.resume, trainer.model)
        print(f"resumed params from {args.resume}")

    def sync():
        if env.device.type == "cuda":
            torch.cuda.synchronize(env.device)

    steps_per_update = cfg.num_envs * cfg.rollout_len
    t0 = time.time()
    for u in range(1, args.updates + 1):
        ts, m = trainer.update(ts)
        if u == 1:
            sync()
            t0 = time.time()  # exclude the first update (kernel builds)
        sps = steps_per_update * max(u - 1, 1) / max(time.time() - t0, 1e-9)
        print(f"update {u:4d}  reward/step {float(m['mean_reward']):+.4f}  "
              f"episodes {int(m['episodes'])}  "
              f"wins {int(m['wins'])}  "
              f"entropy {float(m['entropy']):.2f}  "
              f"ratio {float(m['ratio']):.3f}  "
              f"env-steps/s {sps:,.0f}", flush=True)
        if args.ckpt and args.ckpt_every and u % args.ckpt_every == 0:
            save_params(args.ckpt, trainer.model)
        if args.eval_every and u % args.eval_every == 0:
            wr = evaluate(trainer, opponent, args.eval_games)
            print(f"  eval: win-rate {wr:.2f} vs {args.opponent}",
                  flush=True)
    if args.ckpt:
        save_params(args.ckpt, trainer.model)
        print(f"params saved to {args.ckpt}")
    return trainer, ts


def policy_opponent(trainer, sample: bool = True):
    """The trainer's policy as player 0's bot (``bots.scripted.Opponent``):
    player 0's one-hot observation and masks through the model, then
    ``sample_action`` (K7) with the gumbels its ``draw`` makes, or
    ``greedy_action``."""
    from ..bots.scripted import Opponent
    from ..models.gridnet_policy import (greedy_action, gumbel_noise,
                                         sample_action)

    env, space = trainer.env, trainer.space

    @torch.no_grad()
    def bot(state, player, gumbel):
        logits, _ = trainer.model(trainer._obs(state))
        mask = trainer._mask(state)
        if sample:
            return sample_action(logits, mask, space, gumbel,
                                 plain=trainer.plain)[0]
        return greedy_action(logits, mask, space, plain=trainer.plain)

    def draw(gen, batch):
        if not sample:
            return None
        return gumbel_noise((batch, env.h, env.w, space.total), gen,
                            env.device)

    return Opponent(bot, draw)


def evaluate(trainer, opponent, n_games: int, max_cycles: int = 2000,
             sample: bool = True, noise=None) -> float:
    """Policy win-rate vs ``opponent`` (a ``bots.scripted.Opponent``) over
    ``n_games`` lockstep games (JAX train/run.py:95-120).

    ``sample=True`` plays the trained object itself, PPO's stochastic
    policy; ``sample=False`` the argmax policy.  The noise comes from
    ``play_matches``' generator (seed 0), or from ``noise`` (see
    ``eval/tournament.play_matches``)."""
    from ..eval.tournament import play_matches

    w = play_matches(trainer.env, policy_opponent(trainer, sample), opponent,
                     n_games, max_cycles, noise=noise)
    return float((w == 0).mean())


if __name__ == "__main__":
    main()
