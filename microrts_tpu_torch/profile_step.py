"""Where the time of one env step, one rollout step or one PPO update goes,
on a CUDA card.

    python -m microrts_tpu_torch.profile_step [--mode step|rollout|update]
        [--batch 1024] [--steps 50] [--rollout-len 128] [--updates 2]

Runs the kernel path on basesWorkers16x16 from a mid-game state:

* ``step``: ``VecGridnetEnv.step`` with RandomBiasedAI (bias 5) actors for
  both players (slice 1's main path);
* ``rollout``: one step of ``PPOTrainer._rollout``: the gumbel and
  opponent draws, player 0's masks (``actor``), the bf16 ``GridnetPolicy``
  forward (width 64, 4 blocks, cuDNN), the ``policy_sample`` kernel, the
  RandomBiasedAI opponent (``actor``), then the vec step;
* ``update``: ``PPOTrainer.update`` at ``PPOConfig``'s defaults (4 epochs
  x 4 minibatches) against WorkerRush from a fresh start, split into the
  rollout, GAE and normalisation, and per minibatch the policy forward
  (cuDNN), K7b's forward (``policy_logprob_fwd``), the loss and backward
  (cuDNN and ``policy_logprob_bwd``) and the optimizer; one warm-up
  update, then ``--updates`` measured ones;

and reports:

* per phase of the step, the span between CUDA events recorded around it
  on the card's timeline (it includes time the card waits for the host to
  launch);
* the step's wall time and env-steps/s;
* a ``torch.profiler`` window: device time by kernel name and the share
  of the window the device was busy (the union of the kernels' intervals
  on the card's timeline over the host clock's window).

Prints the tables and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import kernels as KN
from .bots.scripted import random_bot, random_opponent
from .config import make_bot
from .env.gridnet import GridnetEnv
from .env.vec import VecGridnetEnv
from .models.gridnet_policy import gumbel_noise, sample_action
from .train.ppo import PPOConfig, PPOTrainer
from .utils.assets import asset_path

MAP = "maps/16x16/basesWorkers16x16.xml"


def vec_phases(env, vec, s, steps, a0, a1, ev, onehot=()):
    """``VecGridnetEnv.step`` on CUDA tensors, split into phases."""
    eng = env.engine
    c0 = env.decode(s, a0, 0)
    ev("decode p0")
    s1 = eng.issue_env(s, c0)
    ev("issue_env p0")
    c1 = env.decode(s1, a1, 1)
    ev("decode p1")
    s2 = eng.issue_env(s1, c1)
    ev("issue_env p1")
    s3, _ = eng.cycle(s2)
    ev("cycle")
    rew, _, reset, steps = KN.EPILOGUE(env.cfg, s3, s, c0, c1, steps,
                                       vec.max_steps, done_copies=2)
    ev("epilogue")
    out, _, oh = KN.SPLICE_OBS(env.cfg.engine, s3, reset, env.init_state,
                               obs=(0, 1), onehot=onehot)
    ev("splice_obs")
    return out, steps, rew, reset, oh


def step_phases(env, vec, bot, s, steps, gen, ev):
    """Slice 1's step: random actors for both players, then the vec step."""
    B, H, W = s.utype.shape
    u0 = torch.rand((B, H, W, 2), generator=gen, device=s.device)
    u1 = torch.rand((B, H, W, 2), generator=gen, device=s.device)
    ev("uniforms")
    a0, a1 = bot(s, 0, u0), bot(s, 1, u1)
    ev("actor x2")
    out, steps, *_ = vec_phases(env, vec, s, steps, a0, a1, ev)
    return out, steps


def rollout_phases(tr, s, steps, obs, gen, ev):
    """One step of ``PPOTrainer._rollout`` (RandomBiasedAI opponent)."""
    env, space = tr.env, tr.space
    B, H, W = s.utype.shape
    g = gumbel_noise((B, H, W, space.total), gen, s.device)
    u1 = torch.rand((B, H, W, 2), generator=gen, device=s.device)
    ev("gumbel + opponent draws")
    mask = tr._mask(s)
    ev("actor p0 masks")
    with torch.no_grad():
        logits, value = tr.model(obs)
    ev("policy forward (cuDNN)")
    action, _, _, logprob = sample_action(logits, mask, space, g)
    ev("policy_sample")
    a1 = tr._opp_action(s, u1)
    ev("opponent actor")
    out, steps, rew, reset, oh = vec_phases(env, tr.vec, s, steps, action,
                                            a1, ev, onehot=(0,))
    return out, steps, oh[0]


# the update's phases, named by the mark that ends each (PPOTrainer.update)
UPDATE_PHASES = dict(rollout="rollout", gae="GAE + normalisation",
                     forward="policy forward (cuDNN)",
                     logprob="K7b forward (policy_logprob_fwd)",
                     backward="loss + backward (cuDNN + policy_logprob_bwd)",
                     optimizer="optimizer (clip + Adam)")


def device_busy(prof):
    """(busy us, the device kernels by name) of a torch.profiler run: the
    union of the kernels' intervals on the card's timeline."""
    cuda = torch.autograd.DeviceType.CUDA
    spans_dev = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.device_type == cuda)
    busy, end = 0.0, float("-inf")
    for a, b in spans_dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kern = [a for a in prof.key_averages() if a.device_type == cuda]
    kern.sort(key=lambda a: -a.self_device_time_total)
    return busy, kern


def profile_update(args, dev) -> int:
    B = args.batch
    env = GridnetEnv(asset_path(MAP), device=dev)
    tr = PPOTrainer(env, PPOConfig(num_envs=B, rollout_len=args.rollout_len),
                    opponent=make_bot("WorkerRush", env))
    ts = tr.init(seed=0)
    ts, _ = tr.update(ts)                       # warm-up
    torch.cuda.synchronize()
    spans = {k: 0.0 for k in UPDATE_PHASES}
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.updates):
        marks = []

        def ev(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev("start")
        ts, m = tr.update(ts, ev=ev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for (_, a), (name, b) in zip(marks, marks[1:]):
            spans[name] += a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated()
    n = args.updates
    wall = sum(walls) / n
    total = sum(spans.values())
    name = torch.cuda.get_device_name(0)
    steps = B * args.rollout_len
    print(f"update phases at B={B}, rollout_len {args.rollout_len} ({n} "
          f"updates after a warm-up, card timeline, ms/update; {name}):")
    for k, v in spans.items():
        print(f"  {UPDATE_PHASES[k]:46s} {v / n:10.2f}  "
              f"{100 * v / total:5.1f}%")
    print(f"  wall per update {wall:.3f} s; {steps / wall:.1f} env-steps/s; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        ts, _ = tr.update(ts)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e6
    busy, kern = device_busy(prof)
    print("device time by kernel (top 16, ms per update):")
    for a in kern[:16]:
        print(f"  {a.self_device_time_total / 1e3:9.2f}  {a.count:6d}x  "
              f"{a.key[:70]}")
    print(f"device busy {busy / 1e6:.3f} s of {window / 1e6:.3f} s per "
          f"update ({100 * busy / window:.1f}%)")
    print(json.dumps(dict(
        mode="update", batch=B, rollout_len=args.rollout_len,
        wall_s_per_update=wall, env_steps_per_s=steps / wall,
        phases_ms={k: v / n for k, v in spans.items()},
        peak_bytes=peak, device_busy_share=busy / window, device=name)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("step", "rollout", "update"),
                    default="step")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--rollout-len", type=int, default=128)
    ap.add_argument("--updates", type=int, default=2)
    ap.add_argument("--warm", type=int, default=400,
                    help="ticks played before measuring (mid-game state)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is available")
    dev = torch.device("cuda", 0)
    if args.mode == "update":
        return profile_update(args, dev)
    B = args.batch
    env = GridnetEnv(asset_path(MAP), device=dev)
    vec = VecGridnetEnv(env, B, max_steps=5000)
    bot = random_bot(env, 5.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s, steps = vec.reset()
    for _ in range(args.warm):
        s, steps = step_phases(env, vec, bot, s, steps, gen, lambda n: None)
    if args.mode == "rollout":
        tr = PPOTrainer(env, PPOConfig(num_envs=B, max_steps=5000),
                        opponent=random_opponent(env, 5.0))
        tr.init(seed=0)
        obs = tr._obs(s)

        def one(ev):
            nonlocal s, steps, obs
            s, steps, obs = rollout_phases(tr, s, steps, obs, gen, ev)
    else:
        def one(ev):
            nonlocal s, steps
            s, steps = step_phases(env, vec, bot, s, steps, gen, ev)
    for _ in range(3):
        one(lambda n: None)
    torch.cuda.synchronize()

    marks = []

    def ev(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    spans = {}
    t0 = time.perf_counter()
    for _ in range(args.steps):
        marks.clear()
        ev("start")
        one(ev)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    total = sum(spans.values())
    name = torch.cuda.get_device_name(0)
    print(f"{args.mode} phases at B={B} ({args.steps} steps, card timeline, "
          f"ms/step; {name}):")
    for k, v in spans.items():
        print(f"  {k:24s} {v / args.steps:8.3f}  {100 * v / total:5.1f}%")
    print(f"  wall per step {wall:.3f} ms (synchronised each step); "
          f"{B / wall * 1e3:.1f} env-steps/s")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_prof = 10
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(n_prof):
            one(lambda n: None)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e6
    busy, kern = device_busy(prof)
    print("device time by kernel (top 14, us per step):")
    for a in kern[:14]:
        print(f"  {a.self_device_time_total / n_prof:9.1f}  "
              f"{a.count // n_prof:5d}x  {a.key[:70]}")
    print(f"device busy {busy / n_prof / 1e3:.3f} ms of "
          f"{window / n_prof / 1e3:.3f} ms per step "
          f"({100 * busy / window:.1f}%)")
    print(json.dumps(dict(
        mode=args.mode, batch=B, wall_ms_per_step=wall,
        env_steps_per_s=B / wall * 1e3,
        phases_ms={k: v / args.steps for k, v in spans.items()},
        device_busy_share=busy / window, device=name)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
