"""Synthesis runner CLI: search the DSL grammar, clean the winner, ship
the artifact (a port of ``python -m microrts_tpu.synth``, the same flags).

    python -m microrts_tpu_torch.synth --map maps/8x8/basesWorkers8x8.xml \\
        --opponents LightRush --generations 16 --population 8 \\
        --clean behavior -o winner.dslprog

synthesize (batched-game grammar search, synth/search.py) -> clean
(behavioral or fitness-preserving AST shrink, synth/clean.py) -> export
(synth/export.py text artifact + optional standalone module).  Runs on
the card; ``--cpu`` runs the plain path on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="microrts_tpu_torch.synth")
    ap.add_argument("--map", required=True)
    ap.add_argument("--opponents", nargs="+", default=["WorkerRush"],
                    help="registry bot names forming the fitness pool")
    ap.add_argument("--generations", type=int, default=8)
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--games-per-pair", type=int, default=2)
    ap.add_argument("--max-cycles", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--from-scratch", action="store_true",
                    help="start from a random program, not SEED_PROGRAM")
    ap.add_argument("--clean", choices=["none", "behavior", "fitness"],
                    default="behavior",
                    help="post-search shrink: behavior=PerformCleanerAST"
                         " analog, fitness=PerformCleanerASTOptim analog")
    ap.add_argument("--module", action="store_true",
                    help="emit a standalone importable module instead of"
                         " the program text form")
    ap.add_argument("-o", "--out", default=None,
                    help="write the winning program artifact here")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    import random

    from ..config import make_bot
    from ..env.gridnet import GridnetEnv
    from ..utils.assets import asset_path
    from . import export
    from .clean import clean_program, node_count, shrink_program
    from .search import random_program, synthesize

    env = GridnetEnv(asset_path(args.map),
                     device="cpu" if args.cpu else "cuda")
    opponents = [make_bot(n, env) for n in args.opponents]

    seed_prog = (random_program(random.Random(args.seed))
                 if args.from_scratch else None)
    t0 = time.time()
    res = synthesize(env, opponents, generations=args.generations,
                     population=args.population,
                     games_per_pair=args.games_per_pair,
                     max_cycles=args.max_cycles, seed=args.seed,
                     seed_program=seed_prog)
    print(f"search: fitness {res.fitness:.3f} in {time.time() - t0:.0f}s; "
          f"history {[(g, round(f, 3)) for g, f in res.history]}")

    prog = res.program
    if args.clean == "behavior":
        cr = clean_program(env, prog, opponents, seed=args.seed)
    elif args.clean == "fitness":
        cr = shrink_program(env, prog, opponents,
                            games_per_pair=args.games_per_pair,
                            max_cycles=args.max_cycles, seed=args.seed)
    else:
        cr = None
    if cr is not None:
        prog = cr.program
        print(f"clean({args.clean}): {cr.nodes_before} -> "
              f"{cr.nodes_after} nodes; removed {cr.removed or 'nothing'}")

    text = (export.to_module(prog) if args.module else export.dumps(prog))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({node_count(prog)} nodes)")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
