"""Where the time of one env step goes, on a CUDA card.

    python -m microrts_tpu_torch.profile_step [--batch 1024] [--steps 50]

Runs the kernel path (``VecGridnetEnv`` + ``random_bot``, bias 5) on
basesWorkers16x16 from a mid-game state and reports:

* per phase of the step (uniforms, actors, decode/issue per player,
  cycle, rewards, dones, reset splice, observation), the span between
  CUDA events recorded around it on the card's timeline (it includes time
  the card waits for the host to launch);
* the step's wall time and env-steps/s;
* a ``torch.profiler`` window: device time by kernel name and the share
  of the window the device was busy.

Prints the tables and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bots.scripted import random_bot
from .env.gridnet import GridnetEnv
from .env.vec import VecGridnetEnv
from .utils.assets import asset_path

MAP = "maps/16x16/basesWorkers16x16.xml"


def step_phases(env, vec, bot, s, steps, gen, ev):
    """``VecGridnetEnv.step`` with the random actors, split into phases;
    ``ev(name)`` records a CUDA event after each phase."""
    B, H, W = s.utype.shape
    eng = env.engine
    u0 = torch.rand((B, H, W, 2), generator=gen, device=s.device)
    u1 = torch.rand((B, H, W, 2), generator=gen, device=s.device)
    ev("uniforms")
    a0, a1 = bot(s, 0, u0), bot(s, 1, u1)
    ev("actor x2")
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
    rew = torch.stack([env._rewards(s, c0, 0, s3), env._rewards(s, c1, 1, s3)], 1)
    ev("rewards")
    done = env.dones(s3)
    ev("dones")
    steps1 = steps + 1
    reset = done[:, 0] | (steps1 >= vec.max_steps)
    out = s3.select(reset, env.init_state)
    steps = torch.where(reset, 0, steps1).to(torch.int32)
    ev("reset splice")
    obs = torch.stack([env.observation(out, p) for p in (0, 1)])
    ev("observation")
    return out, steps, obs, rew


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warm", type=int, default=400,
                    help="ticks played before measuring (mid-game state)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is available")
    dev = torch.device("cuda", 0)
    B = args.batch
    env = GridnetEnv(asset_path(MAP), device=dev)
    vec = VecGridnetEnv(env, B, max_steps=5000)
    bot = random_bot(env, 5.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s, steps = vec.reset()
    for _ in range(args.warm):
        s, steps, *_ = step_phases(env, vec, bot, s, steps, gen, lambda n: None)
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
        s, steps, *_ = step_phases(env, vec, bot, s, steps, gen, ev)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            spans[name] = spans.get(name, 0.0) + a.elapsed_time(b)
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    total = sum(spans.values())
    print(f"step phases at B={B} ({args.steps} steps, card timeline, ms/step):")
    for name, v in spans.items():
        print(f"  {name:14s} {v / args.steps:8.3f}  {100 * v / total:5.1f}%")
    print(f"  wall per step {wall:.3f} ms (synchronised each step); "
          f"{B / wall * 1e3:.1f} env-steps/s")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_prof = 10
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(n_prof):
            s, steps, *_ = step_phases(env, vec, bot, s, steps, gen,
                                       lambda n: None)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e6
    avgs = prof.key_averages()
    dev_us = sum(getattr(a, "self_device_time_total", 0.0) for a in avgs)
    top = sorted(avgs, key=lambda a: -getattr(a, "self_device_time_total", 0))
    print("device time by kernel (top 12, us per step):")
    for a in top[:12]:
        print(f"  {a.self_device_time_total / n_prof:9.1f}  {a.count // n_prof:5d}x"
              f"  {a.key[:70]}")
    print(f"device busy {dev_us / n_prof / 1e3:.3f} ms of {window / n_prof / 1e3:.3f} "
          f"ms per step ({100 * dev_us / window:.1f}%)")
    print(json.dumps(dict(
        batch=B, wall_ms_per_step=wall, env_steps_per_s=B / wall * 1e3,
        phases_ms={k: v / args.steps for k, v in spans.items()},
        device_busy_share=dev_us / window,
        device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
