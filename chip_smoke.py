#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives ``microrts_tpu_torch`` (never JAX) on basesWorkers16x16 at 1024
envs:

1. device: the card's name, count, power limit;
2. build: compiles the thirty-five CUDA kernels (twenty-three sources) from
   ``microrts_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel; ``-Xptxas -v`` report printed);
3. realistic states: runs RandomBiasedAI (bias 5, both players) on the
   card until the recorded kernel inputs hold busy units, kept produces
   and completing attacks (at least 20), harvests and returns, each tick
   on the kernels and each recorded tick again on the plain PyTorch path,
   whose outputs are kept; one more record has terminal envs (a player's
   units removed) for the winloss reward; then a WorkerRush-vs-LightRush
   run on the kernels (each env opens with a few random ticks, so that
   the envs differ) records rush states, plus a copy with the bases
   removed (rebuilds); then the partially observable (PO) path
   (RandomBiasedAI, both players, fog-of-war decode and the full
   ``issue``) for 128 ticks from the end of the rush run (units in
   contact), every 16th tick on the plain path, which counts at its
   issues the conflicts of each kind (cross-cycle position and resource
   cancels, chain cancels of a new and of an earlier same-tick claim),
   keeping that step's inputs and outputs;
4. kernel vs plain: every kernel output equals its plain version on those
   inputs (tolerance: exact; the policy sampler's and K7b's logprob and
   entropy within 1e-5 relative + 1e-4 absolute, K7b's gradient of the
   logits within 1e-4 relative + 1e-5 absolute of autograd through the
   plain version, under upstream weights drawn from a normal; the logits
   are the seeded bf16 ``GridnetPolicy``'s at full width, over four
   recorded ticks: a 4096-sample minibatch); ``rush`` for every ported
   ``RushSpec`` (and the expansion branch), both players, with the
   decision counts of the plain version printed; ``event_jump`` (K8) in
   both of its modes with and without a per-lane cap, and the cycle
   kernel's ``active`` lanes after it, on the post-issue, pre-step,
   terminal, rush and initial records; ``evaluate`` (K12a), all seven
   functions from both players' view and a per-lane player vector (the
   Sqrt family and the upper bound exact, Simple, Opt and Lanchester
   within 1e-5 of the larger of the value and 1); the actor's masks and
   decode with a per-env player vector; ``arm_sample`` (K12b) in its four
   modes on random visit tables and ``arms_to_action``; ``mcts_descend``
   (K12c) and ``mcts_backprop`` (K12d) on every 5th node-array update of
   NaiveMCTS and UCT searches of 16 rush records (6-node trees, so
   that they fill; exact); ``enum_next`` (K12e), eight successive draws
   of both players' odometers from ``init`` (four with every lane
   drawing, four with every other lane) on every 6th recorded tick, every
   4th rush record, a record where no unit can act and a resource-tight
   one (balance at most 2), arms, valid flags, trip counts and the
   odometers in place exact, the largest trip count printed;
   ``minimax_step`` (K12f) on every 5th trip, and every trip that pops a
   root child, of ABCD and RTMinimax searches of 16 rush records
   for both players at small budgets (budget 64 and the reduced shapes
   of [12]), and on the same trips
   with their pushes turned into exhausted draws (a search never draws
   past its node's last joint action, all NONE), whole stacks, row S
   too, exact, the pops, prunes, pushes, root updates and exhausted
   draws among them printed; ``issue`` (K11a) on both issues of every PO
   record under the three move-conflict policies (random coins for
   CANCEL_RANDOM, a drawn cancelation counter for CANCEL_ALTERNATING),
   and on two-issue random candidate tables (half the units, then the
   other half, stockpiles drawn) over PO and rush records, where every
   conflict kind occurs (counts printed), whole states exact; ``issue``
   against ``issue_env`` on slice 1's full-observation records (the
   shortcut of the playouts and searches); ``po_state`` (K11b) and
   ``obs_po`` (K11c, with the one-hot) for both players and a per-lane
   player vector on the PO, rush and terminal records; ``decode`` with a
   view on the PO records; ``believe_update`` (K13: init, update and the
   sampled world) of the three levels for both observers along the PO
   records, memories made at the first with the seen types cleared in
   half the lanes, whole memories and worlds exact, the rules' cells
   counted; ``mcts_reroot`` (K12g) on the trees of a reduced
   ContinuingNaiveMCTS decision of 16 rush records, at the state after
   the real step (WorkerRush's reply, the fast-forward), at a child's and
   a grandchild's node state, at a state no node holds and with a third
   of the lanes left out, whole trees exact; slice 9: ``cycle`` under UTT
   v3 with a uniform a cell (with and without ``active`` lanes) on every
   record, completing attacks drawn above their minimum counted, the
   ``epilogue`` with all eight rewards (the closer rewards non-zero) and
   ``env_health`` on every record's post-step state with a fault planted
   in lanes 1-6 of every 8 (hp 0, a type past the UTT, negative ticks on
   a busy cell, a negative stockpile, a NaN reward, a stockpile above
   10^6) and healthy lanes, exact; slice 10: ``distance_fields`` (the
   enemy, resource and own-base fields of both players), each field's
   ``descend_direction``, ``distance_field2`` of the own units and
   ``descend_direction_excluding`` of the cells' own ids, ``range_cover``
   and ``dsl_target`` under the seven target policies (Random's uniforms
   drawn) on every 2nd rush record, every 4th PO record and a planted
   serpentine maze whose far end lies beyond H+W sweeps;
   ``expert_macro`` for every macro 0-12 and both players on every 3rd
   rush record with role tables carried along the records by a plain run,
   and
   ``expert_detailed`` on seeded logits, exact; slice 11 on every 2nd
   rush record, both players and a per-lane player vector:
   ``aim_predict`` (K14a, the shipped AIM-WR model) in its four modes
   (logits, prior, sample, greedy), ``nb_predict`` (K14b, a model of
   seeded counts) in its three, ``cooperative_act`` (K14c) on the nets of
   seeded genomes whose units act, and ``arm_sample``'s informed mode on
   random visit tables with the model's prior, exact; each kernel and its
   plain version are timed with CUDA events (200 calls of the kernel, 4
   of the plain version; ``mcts_reroot`` in [14]; ``cycle`` under v3 and
   the eight-reward ``epilogue`` beside their v2 figures, the other modes
   of ``aim_predict``, ``nb_predict`` and ``arm_sample`` beside their
   main path's);
5. slice 1's main path: ``VecGridnetEnv`` + ``random_bot`` through the
   kernels next to the plain path, same start and uniforms, 32 ticks
   with auto-resets; state, obs, rewards and dones equal at every tick;
   launches per step actor 2, decode 2, issue_env 2, cycle 1, epilogue 1,
   splice_obs 1, no other; then a steady window gives env-steps/s;
6. the rollout: ``PPOTrainer._rollout`` (bf16 ``GridnetPolicy`` at width
   64 / 4 blocks, RandomBiasedAI opponent, cuDNN deterministic) through
   the kernels next to the plain path, 16 steps from the same states with
   the same noise; states, obs, masks, actions, values, rewards and dones
   identical at every step; the seven rollout kernels launched, the
   learner's and the rush bot's not; then a timed rollout gives
   env-steps/s;
7. training: ``PPOTrainer.update`` (WorkerRush opponent, rollout_len 16,
   4 epochs x 4 minibatches) through the kernels next to the plain path
   from the same start with the same noise, once with SGD and once with
   Adam: the rollout identical; SGD: the loss terms within 1e-3 relative
   (``pg_loss``, a mean of terms of RMS about 1 that cancel to near 0,
   within 1e-3 absolute) and every parameter within 1e-5 absolute of the
   plain path's; Adam (whose steps are about lr whatever the gradient's
   size, so a sign flip of a near-zero gradient moves a weight by up to
   2 lr, and the bf16 forward carries that into every later step): the
   loss terms within 1e-2 (relative; ``pg_loss`` absolute), and the
   parameters' displacement no further from the plain path's than twice
   the witness's, the witness being the plain path with the logits'
   gradient multiplied by 1 +- 1e-6 (random signs); then one clip + Adam
   step on one minibatch with an fp32 policy: every parameter whose
   plain gradient exceeds 1e-6 within 1e-2 lr of the plain path's (the
   witness's reading printed beside); every one of the ten training
   kernels launched, the decision-frame path's two not; then training
   env-steps/s at ``PPOConfig(num_envs=1024)``'s defaults (rollout_len
   128, or the largest that fits), one warm-up update and the median of
   two, with the rollout/learn split and the peak memory;
8. the round robin: PassiveAI, RandomBiasedAI and the four rushes, 30
   ordered pairs x 34 games = 1020 lanes of one pool batch
   (``eval/tournament.round_robin``), through the kernels next to the
   plain path with the same seed to 12 cycles (tables, winners and
   final states equal; ``event_jump``, ``cycle``, the actor's, the
   step's and the rush kernels launched, ``evaluate`` not), and 64
   RandomBiasedAI vs WorkerRush games (``play_matches``) on basesWorkers8x8
   next to the plain path to 240 cycles, in which games end (winners and
   frozen final states equal), then ``round_robin`` timed on the kernels
   to 1000 cycles: game-ticks/s (the lanes' ticks over the wall
   seconds), frames, the table, and the device busy share of a profiled
   32-cycle run;
9. MonteCarlo (K=12, playout_len 48): one decision of 64 recorded rush
   games (768 playout lanes) and 8-cycle games against WorkerRush
   (``play_matches``), through the kernels next to the plain path with
   the same draws (actions, winners and final states equal;
   ``event_jump`` and ``evaluate`` launched); then eight timed
   decisions: game-decisions/s and playout ticks/s;
10. ``train.run.evaluate``: the seeded bf16 policy against WorkerRush,
   64 games to 16 cycles through the kernels next to the plain path
   (win-rate, winners and final states equal), then 1024 games to 2000
   cycles, timed, with its win-rate;
11. tree search: one NaiveMCTS and one UCT decision of 16 rush records
   at a reduced budget (4 playouts, 16 nodes, 8 children or candidates,
   depth 4, playout_len 24) and 16 NaiveMCTS (2 playouts, depth 2,
   playout_len 4) vs WorkerRush games to 4 cycles (``play_matches``),
   through the kernels next to the plain path with the same draws (whole
   trees, actions, winners and final states equal); on 64 recorded rush
   games at a decision frame of player 0, one decision of each at the
   defaults' nodes, children and depth with short playouts (3 playouts
   of 4 ticks), kernel next to plain (whole trees and actions
   equal), then one decision of each (``make_bot``: the JAX defaults),
   timed:
   game-decisions/s, tree iterations/s, launches by kernel, peak memory;
12. minimax: on 16 recorded rush games, one decision each of ABCD,
   IDABCD, RTMinimax, IDRTMinimax, IDRTMinimaxRandomized and SampledABCD
   at reduced budgets, through the kernels next to the plain path with
   the same draws (whole stacks, row S too, root values or scores, and
   actions equal; each bot launches ``enum_next`` and ``minimax_step``,
   SampledABCD neither, and no kernel outside its path), 16 ABCD-vs-
   WorkerRush games to 4 cycles (``play_matches``) kernel vs plain
   (winners and final states equal), then one decision of each of
   ABCD, RTMinimax, IDRTMinimaxRandomized and SampledABCD on the 64 timed
   games at the defaults' stack and candidate shapes (ABCD depth 4,
   RTMinimax stack 12, the randomized bot's 8 x 8 DFS lanes a game at
   stack 10, 8 x 8 SampledABCD candidates) with budgets of 16 trips and
   8-tick playouts, kernel vs plain (whole stacks, values and actions
   equal; the deepest stack row used printed), then one decision of the
   64 games at the JAX defaults (``make_bot``) of each of the four, timed:
   game-decisions/s/card, launches by kernel, peak memory, and the
   device's busy share of a profiled decision (ABCD's and RTMinimax's at
   a budget of 64);
13. the PO main path: ``VecGridnetEnv(GridnetEnv(partial_obs=True))`` +
   ``random_bot`` through the kernels next to the plain path, same start
   (the end of [3]'s PO run) and uniforms, 32 ticks with auto-resets;
   state, 8-plane observations, the one-hot of each player's view,
   rewards and dones equal at every tick; launches per step actor 2,
   po_state 2, decode 2, issue 2, cycle 1, epilogue 1, splice_obs 1,
   obs_po 1, no other; a steady window gives PO env-steps/s and a
   profiled one the card's busy share; ``MapPoolVecEnv(partial_obs=True)``
   over basesWorkers16x16, TwoBasesBarracks16x16 and the padded
   basesWorkers8x8 and NoWhereToRun9x8, 32 ticks kernel vs plain (resets
   to each env's own map); a ``round_robin`` of the four PO rushes and
   WorkerRush on the PO env (20 ordered pairs x 8 games) kernel vs plain
   to 8 cycles (winners, tables, states equal), then timed to 2000
   cycles: game-ticks/s;
14. the stateful bots: 1024 WorkerRush-vs-LightRush games on the PO
   env (2 (k % 32) random opening ticks in env k) played 240 ticks
   through the kernels, then believe memories of levels 1-3 for both
   observers, the seen types cleared in half the lanes, kernel vs plain
   for 150 ticks (whole memories and sampled worlds exact; every rule of
   each level fired for one observer or the other, the cells counted);
   on the 64 timed games of [11], a
   warm BS3_NaiveMCTS decision at the JAX defaults (``make_bot``),
   followed by a NaiveMCTS decision on the same games and noise, timed
   (and their ratio), with BS3's launches, peak memory and the busy
   share of a profiled decision of 16 iterations; ContinuingNaiveMCTS at
   the JAX
   defaults against WorkerRush for 2 consecutive decisions (the first on
   fresh trees), each timed with its launches, the re-root hit share and
   the nodes carried, the peak memory, then ``mcts_reroot`` of the last
   trees kernel vs plain (whole trees, row N included; some game keeps
   more than 16 rows), each timed on copies, and the busy share of a
   profiled decision of 16 iterations; and
   ``play_matches_stateful`` of BS3 (the [11] games' budget) against
   POWorkerRush and of ContinuingNaiveMCTS against WorkerRush, 16 games
   to 2 cycles, kernel vs plain (winners and final states equal);
15. slice 9 at full width: ``VecGridnetEnv(quarantine=True)`` over
   ``GridnetEnv(UnitTypeTable(3), reward_fns=REWARD_NAMES)``, WorkerRush
   vs LightRush from the end of [3]'s rush run (units in contact), the
   kernel path next to the plain path with the same damage uniforms for
   48 ticks, a negative stockpile planted in one lane every 8th tick:
   states, observations, rewards, dones, steps and reset mask identical;
   fails unless some completing attack drew damage above its minimum,
   some closer reward is non-zero and every planted lane was quarantined
   and reset; launches per step rush 2, decode 2, issue_env 2, cycle 1,
   epilogue 1, env_health 1, splice_obs 1; the v3 step's env-steps/s
   (RandomBiasedAI both sides, uniforms drawn) timed in turn with slice
   1's v2 step (v2, v3, v3, v2); two ``PPOTrainer.update``s on the v3
   env (``PPOConfig(num_envs=1024)``, phase 7's rollout_len, WorkerRush),
   the last timed; a round robin of POWorkerRush, POLightRush and
   WorkerRush on the PO env under ``UnitTypeTable(2, CANCEL_RANDOM)``
   (coins drawn each frame) kernel next to plain to 12 cycles (states,
   winners, tables equal); one MonteCarlo decision at the JAX defaults
   under v3 on [9]'s 64 games kernel next to plain (actions equal), then
   a warm one timed;
16. slice 10 at full width: ``ExpertEnv.step_vs`` of 1024 envs from
   the start, macros drawn from the action mask, against WorkerRush
   kernel next to plain for 32 ticks (states, the four role tables,
   rewards and dones equal; launches per step expert_macro 1, rush 1,
   decode 2, issue_env 2, cycle 1, epilogue 1), then timed (env-steps/s,
   busy share, peak memory); the detailed mode (player 0, seeded logits
   per env, against WorkerRush) kernel next to plain for 12 ticks, then
   timed, with the size of its Gumbel noise; the self-play macro step
   kernel next to plain for 16 ticks, then timed;
   ``evaluate_population`` of SEED_PROGRAM and 7 mutations of
   ``random.Random(0)`` against WorkerRush and LightRush, 32 games a side
   (1024 lanes), kernel next to plain for 8 ticks (states, winners,
   fitness), then timed to 336 cycles (lane-ticks/s);
   from the timed run's state (kept every 32 ticks) with the most lanes
   in contact both ways, its programs and two programs that reach every
   DSL kernel for 8 ticks each, kernel next to plain on 1024 lanes,
   each window failing unless the programs issue ATTACKs and lanes are in
   contact both ways; ``python -m microrts_tpu_torch.synth`` through
   ``main`` on basesWorkers8x8 with small settings and ``--clean
   behavior``, its program text printed;
17. slice 11, the learned models at full width: the four new kernels
   held against their plain versions on [16]'s kept in-contact state
   (1024 lanes); one InformedNaiveMCTS decision of the 64 timed games at
   the defaults' tree shapes with short playouts (3 of 4 ticks), kernel
   next to plain (whole trees and actions), then a warm one at the JAX
   defaults (``make_bot``: 64 playouts of 100 ticks, the AIM-WR prior and
   model playouts), timed: s/decision, launches, peak memory; a
   ``round_robin`` of UnitActionProbabilityDistributionAI, CooperativeAI
   (seed 1's genomes, whose units act), WorkerRush and RandomBiasedAI (12
   ordered pairs x 32 games) kernel next to plain to 12 cycles (tables,
   winners, states; CooperativeAI must issue actions), then timed to 1000
   cycles (game-ticks/s, the busy share of a profiled 32-cycle run; some
   game must end); a ``bayes_bot`` self-play of 1024 envs (a model of
   seeded counts) kernel next to plain for 8 ticks, then timed
   (env-steps/s);
18. one JSON line of every kernel (launches: phase 7's for the training
   kernels, one MonteCarlo decision's for ``event_jump`` and
   ``evaluate``, one NaiveMCTS decision's at the defaults for K12b-d, one
   ABCD decision's at the defaults for K12e-f, the PO main path's for
   K11a-c, a ContinuingNaiveMCTS decision's for K12g, a BS3_NaiveMCTS
   decision's for K13, [15]'s v3 step for ``env_health``, [16]'s
   checked step_vs, detailed steps and populations for the slice-10
   kernels, [17]'s InformedNaiveMCTS decision for ``aim_predict``, its
   round robin for ``cooperative_act``, its bayes self-play for
   ``nb_predict``; ``cycle``'s
   entry also holds its UTT v3 figures under ``utt_v3`` and the
   epilogue's its eight-reward ones under ``eight_rewards``, and the
   other modes of ``aim_predict``, ``nb_predict`` and ``arm_sample``
   under theirs; every
   phase's under
   ``launches_by_phase``, [12] one entry a bot: the timed decision's, or
   for IDABCD and IDRTMinimax the reduced one's), the ``nvidia-smi``
   line, and as the last line ``{"ok": true, "device": {...}}``.

No single PyTorch call computes any kernel's function (the engine, the
fog, the bots and the masked factored categorical are the JAX package's
own code), so every ``library_ms`` is null.  Any failure raises and the exit
code is not 0.  Without a CUDA device it exits with code 2 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

B = 1024
MAP = "maps/16x16/basesWorkers16x16.xml"
BIAS = 5.0
MIN_TICKS = 300          # phase 3: at least this many plain ticks
MAX_TICKS = 1500         # ... and at most this many while events are missing
MIN_ATTACKS = 20         # completing attacks wanted in the recorded inputs
MAIN_TICKS = 32          # phase 5: compared ticks
MAX_STEPS = 96           # phase 5: episode cap, so that resets happen
TIME_TICKS = 200         # phase 5: timed window
ROLL_STEPS = 16          # phase 6: compared rollout steps
ROLL_TIME_STEPS = 32     # phase 6: timed rollout
RUSH_TICKS = 480         # phase 3: plain WorkerRush-vs-LightRush ticks
RUSH_EVERY = 40          # ... recorded every this many ticks
RUSH_OPEN = 2            # env k opens with 2 (k % 32) random ticks
LOGPROB_RECORDS = 4      # phase 4: K7b over 4 x 1024 envs (a minibatch)
PLAIN_REPS = 4           # phase 4: timed calls of each plain version
UPDATE_LEN = 16          # phase 7: compared updates' rollout_len
TRAIN_LEN = 128          # phase 7: timed updates' rollout_len (default)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# H100 SXM int32: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (NVIDIA H100
# Tensor Core GPU Architecture whitepaper), one operation per lane a clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The least int32 operations of the stencils' functions (what the function
# needs, not what a kernel spends on bounds or indices).  A distance-field
# sweep, per cell: the min of the four neighbours (3), the +1, the min
# with the cell's own value, the source and the walkable selects.
FIELD_OPS = 7
# distance_field2's sweep merges 8 candidates a cell, each: the +1, three
# compares (same first id, below the first, below the second) and six
# selects or mins of the two (distance, id) entries.
FIELD2_OPS = 8 * 10
# range_cover, per cell and offset: the source's range squared against
# the offset's d2, the AND with the source flag, the OR into the cover.
COVER_OPS = 3
# dsl_target (Weakest), per cell and offset: the offset's d2 against the
# cell's range squared, the AND with the enemy flag, the score against
# the best, the AND of the two, the two selects (the score plane is made
# once a cell).
TARGET_OPS = 6
LP_TOL = dict(rtol=1e-5, atol=1e-4)  # sampler / K7b logprob, entropy
DLOGITS_TOL = dict(rtol=1e-4, atol=1e-5)  # K7b gradient vs autograd
SGD_TOL = dict(metrics_rtol=1e-3, params_atol=1e-5)
# Adam turns a rounding-level change of a near-zero gradient into a step of
# lr, so its whole update is held against the witness (the plain path with
# the logits' gradient perturbed by WITNESS_REL, relative, with random
# signs): the displacement's gap to the plain path's at most twice the
# witness's.  One Adam step on an fp32 policy (no bf16 rounding between
# the gradient of the logits and those of the weights) is held as the CPU
# test holds it against optax: within 1e-2 x lr where |g| > 1e-6.
WITNESS_REL = 1e-6
ADAM_TOL = dict(metrics_rtol=1e-2, gap_vs_witness=2.0, step_grad_min=1e-6,
                step_atol_lr=1e-2)
ROLLOUT_KERNELS = ("actor", "decode", "issue_env", "cycle", "epilogue",
                   "splice_obs", "policy_sample")
TRAIN_KERNELS = ROLLOUT_KERNELS + ("policy_logprob_fwd", "policy_logprob_bwd",
                                   "rush")
# the decision-frame path: tournaments and MonteCarlo search
RR_BOTS = ("PassiveAI", "RandomBiasedAI", "WorkerRush", "LightRush",
           "HeavyRush", "RangedRush")
RR_GAMES = 34            # per ordered pair: 30 pairs x 34 = 1020 lanes
RR_CHECK_CYCLES = 12     # phase 8: the kernel run next to the plain path
WIN_CHECK_GAMES = 64     # phase 8: RandomBiasedAI vs WorkerRush next to the
WIN_CHECK_MAP = "maps/8x8/basesWorkers8x8.xml"  # ... plain path on 8x8,
WIN_CHECK_CYCLES = 240   # ... where WorkerRush wins from about tick 195
RR_CYCLES = 1000         # phase 8: timed (the JAX default, 2000, cut for
                         # the time limit)
RR_PROFILE_CYCLES = 32   # phase 8: the profiled window
RR_KERNELS = ("actor", "decode", "issue_env", "cycle", "rush", "event_jump")
MC_GAMES = 64            # phase 9: MonteCarlo (K=12, L=48) vs WorkerRush
MC_CHECK_CYCLES = 8      # phase 9: the games next to the plain path
MC_TIME_DECISIONS = 8    # phase 9: timed decisions (64 games each)
MC_KERNELS = ("actor", "decode", "issue_env", "cycle", "event_jump",
              "evaluate")
EVAL_CHECK_GAMES = 64    # phase 10: evaluate next to the plain path ...
EVAL_CHECK_CYCLES = 16   # ... over short games
EVAL_GAMES = 1024        # phase 10: evaluate of the policy vs WorkerRush
# K12a: the Sqrt family and the upper bound sum small integers (exact);
# Simple, Opt and Lanchester sum float32 terms in another order than the
# plain version: within 1e-5 of the larger of the value and 1
EVAL_EXACT = ("simple_sqrt_eval", "simple_sqrt_eval2", "simple_sqrt_eval3",
              "simple_opt_upper_bound")
EVAL_FLOAT = ("simple_eval", "simple_opt_eval", "lanchester_eval")
EVAL_RTOL = 1e-5
# the tree search (K12b-d): NaiveMCTS and UCT
ARM_ROWS = 3             # phase 4: rows of the random visit tables (B=1024)
TREE_GAMES = 16          # phases 4, 11: games of the checked searches
TREE_CHECK = dict(n_playouts=8, max_nodes=16, max_children=8, max_depth=4,
                  playout_len=24)
UCT_CHECK = dict(n_playouts=8, max_nodes=16, n_candidates=8, max_depth=4,
                 playout_len=24)
TREE_PLAYOUTS_11 = 4     # phase 11: TREE_CHECK's and UCT_CHECK's playouts
TREE_GAME = dict(n_playouts=2, max_depth=2, playout_len=4)
TREE_GAME_CYCLES = 4     # phase 11: NaiveMCTS vs WorkerRush, 16 games
TREE_TIME_GAMES = 64     # phase 11: one decision at the JAX defaults
# phase 11: kernel vs plain at the defaults' tree shapes (N, C, D) on the
# 64 timed games, with short playouts so that the plain path stays cheap
TREE_DEEP = {"NaiveMCTS": dict(n_playouts=3, playout_len=4),
             "UCT": dict(n_playouts=3, playout_len=4)}
TREE_ITERS = 64          # ... whose n_playouts (treesearch.py:137, :620)
TREE_SNAPSHOT_EVERY = 5  # phase 4: every 5th node-array update kept
SNAP_NODES = 6           # ... of searches whose trees fill (nnodes == N)
TREE_KERNELS = ("actor", "decode", "issue_env", "cycle", "event_jump",
                "evaluate", "arm_sample", "arms_to_action", "mcts_descend",
                "mcts_backprop")
# the minimax family (K12e-f)
MM_SNAPSHOT_EVERY = 5    # phase 4: every 5th minimax_step call kept ...
MM_SNAPSHOT_BUDGET = 64  # ... of searches of both players at this budget
MM_REDUCED = {           # phase 12 (and 4): kernel vs plain, 16 games
    "ABCD": dict(max_depth=2, playout_len=8, node_budget=16),
    "IDABCD": dict(depths=(1, 2), playout_len=8, node_budget=16),
    "RTMinimax": dict(lookahead=12, stack_cap=6, node_budget=16),
    "IDRTMinimax": dict(lookaheads=(6, 12), stack_cap=6, node_budget=16),
    "IDRTMinimaxRandomized": dict(k_moves=4, repeats=4, lookahead=12,
                                  stack_cap=6, node_budget=16),
    "SampledABCD": dict(k_moves=4, playout_len=8)}
MM_GAME_CYCLES = 4       # phase 12: ABCD (reduced) vs WorkerRush, 16 games
# phase 12: kernel vs plain on the 64 timed games at the defaults' stack
# shapes (ABCD S=5, RTMinimax S=12, IDRTMinimaxRandomized 4096 lanes S=11,
# SampledABCD 8 x 8 candidates), with short budgets and playouts so that
# the plain path stays cheap
MM_DEEP = {"ABCD": dict(max_depth=4, playout_len=8, node_budget=16),
           "RTMinimax": dict(lookahead=50, stack_cap=12, node_budget=16),
           "IDRTMinimaxRandomized": dict(k_moves=8, repeats=8, lookahead=25,
                                         stack_cap=10, node_budget=16),
           "SampledABCD": dict(k_moves=8, playout_len=8)}
# phase 12: the profiled decision (device busy share) is the timed one,
# but ABCD's and RTMinimax's at this budget (their trips are alike; 512
# would trace ~40,000 launches, and the profile's host readback grows with
# them)
MM_PROFILE_ABCD_BUDGET = 64
MM_TIMED = ("ABCD", "RTMinimax", "IDRTMinimaxRandomized", "SampledABCD")
DFS_KERNELS = ("actor", "decode", "issue_env", "cycle", "event_jump",
               "evaluate", "arms_to_action", "enum_next", "minimax_step")
MM_KERNELS = {"ABCD": DFS_KERNELS + ("rush",),
              "IDABCD": DFS_KERNELS + ("rush",),
              "RTMinimax": DFS_KERNELS, "IDRTMinimax": DFS_KERNELS,
              "IDRTMinimaxRandomized": DFS_KERNELS,
              "SampledABCD": ("actor", "decode", "issue_env", "cycle",
                              "event_jump", "evaluate", "rush")}


# the partially observable path (K11a-c)
PO_TICKS = 128           # phase 3: plain PO ticks (1024 envs)
PO_RECORD_EVERY = 16     # ... whose inputs are kept every 16th tick
PO_MAIN_TICKS = 32       # phase 13: compared PO ticks
PO_TIME_TICKS = 200      # phase 13: timed window
PO_PROFILE_TICKS = 20    # phase 13: profiled window
# phase 13: launches per PO step (random_bot's actor for both players)
PO_STEP_LAUNCHES = dict(actor=2, po_state=2, decode=2, issue=2, cycle=1,
                        epilogue=1, splice_obs=1, obs_po=1)
POOL_MAPS = ("maps/16x16/basesWorkers16x16.xml",
             "maps/16x16/TwoBasesBarracks16x16.xml",
             "maps/8x8/basesWorkers8x8.xml", "maps/NoWhereToRun9x8.xml")
POOL_TICKS = 32          # phase 13: the PO pool next to the plain path
PO_RR_BOTS = ("POWorkerRush", "POLightRush", "POHeavyRush", "PORangedRush",
              "WorkerRush")
PO_RR_GAMES = 8          # per ordered pair: 20 pairs x 8 = 160 lanes
# phase 13: kernel next to plain; the plain PO rushes' pool takes ~0.66 s
# a frame on the card's host, so the check stops at 8 cycles
PO_RR_CHECK_CYCLES = 8
PO_RR_CYCLES = 2000      # phase 13: timed (WorkerRush wins only late)
PO_RR_KERNELS = ("decode", "issue", "po_state", "cycle", "rush",
                 "event_jump")
# the stateful bots (K13, K12g)
BEL_OPEN = 240           # phase 14: PO rush ticks before the memories
BEL_TICKS = 150          # ... then memories kernel vs plain for 150 ticks
BS3_PAIRS = 1            # phase 14: BS3_NaiveMCTS, NaiveMCTS decisions in turn
CONT_FRAMES = 2          # phase 14: consecutive ContinuingNaiveMCTS frames
REROOT_N = 4             # ... mcts_reroot timed on copies of 64 trees
STATEFUL_GAME_CYCLES = 2  # phase 14: the stateful loop kernel vs plain
# slice 9: UTT v3's damage draw, the eight rewards, the quarantine
FAULT_LANES = 8          # phase 4: lane b % 8 in 1..6 holds a planted fault
V3_CHECK_TICKS = 48      # phase 15: the v3 quarantined step kernel vs plain
V3_FAULT_EVERY = 8       # ... a negative stockpile planted every 8th tick
V3_TIME_TICKS = 200      # phase 15: timed window (phase 5's)
V3_UPDATES = 2           # phase 15: PPO updates on the v3 env (1 timed)
RANDOM_RR_BOTS = ("POWorkerRush", "POLightRush", "WorkerRush")
RANDOM_RR_GAMES = 8      # phase 15: per ordered pair, 6 pairs x 8 lanes
RANDOM_RR_CYCLES = 12    # ... CANCEL_RANDOM PO round robin kernel vs plain
# slice 10: the expert macro env and the DSL synthesis at full width
EXPERT_CHECK_TICKS = 32  # phase 16: step_vs vs WorkerRush kernel vs plain
EXPERT_TIME_TICKS = 100  # ... then timed
EXPERT_PROFILE_TICKS = 20  # ... and a profiled window
DETAILED_CHECK_TICKS = 12  # phase 16: the detailed mode kernel vs plain
DETAILED_TIME_TICKS = 40   # ... then timed
SELFPLAY_CHECK_TICKS = 16  # phase 16: the self-play step kernel vs plain
SELFPLAY_TIME_TICKS = 100  # ... then timed
SYN_GAMES = 32           # phase 16: games a side: 8 x 2 x 2 x 32 = 1024
SYN_CHECK_TICKS = 8      # ... evaluate_population kernel vs plain
SYN_CYCLES = 336         # ... then timed (the JAX default max_cycles, 1200, is cut
                         # for the time limit)
SYN_SNAP_EVERY = 32      # ... keeping its state every 32 ticks
SYN_CONTACT_TICKS = 8    # phase 16: its programs kernel vs plain from the
COVER_CONTACT_TICKS = 8  # kept state most in contact, and the programs of
                         # every DSL kernel
SYN_OPPONENTS = ("WorkerRush", "LightRush")
# slice 11: the learned models
PROFILE_PLAYOUTS = 16    # phase 14: the profiled decisions' iterations (a
                         # quarter of the timed ones': the profile's host
                         # readback grows with its launches)
INF_CHECK = dict(n_playouts=3, playout_len=4)  # phase 17: the informed
                         # decision kernel vs plain at the defaults' N, C, D
LRR_BOTS = ("UnitActionProbabilityDistributionAI", "CooperativeAI",
            "WorkerRush", "RandomBiasedAI")
LRR_GAMES = 32           # phase 17: per ordered pair, 12 pairs x 32 lanes
LRR_CHECK_CYCLES = 12    # ... kernel vs plain
LRR_CYCLES = 1000        # ... then timed
LRR_PROFILE_CYCLES = 32  # ... and a profiled window
NB_CHECK_TICKS = 8       # phase 17: bayes_bot self-play kernel vs plain
NB_TIME_TICKS = 100      # ... then timed
LEARNED_KERNELS = ("aim_predict", "nb_predict", "cooperative_act")


def plant_faults(post, rew, num_types):
    """Copies of the State ``post`` and of its rewards float32 ``[B, NR']``
    with one fault in each lane b % FAULT_LANES of 1..6: every unit's hp
    0, a type past the UTT, a busy cell with negative ticks, a negative
    stockpile, a NaN reward, a stockpile above 10^6.  Returns (state,
    rewards, the flags ``env_health`` must raise)."""
    import torch
    s, r = post.clone(), rew.clone()
    lane = torch.arange(s.batch, device=s.device) % FAULT_LANES
    s.hp[lane == 1] = torch.where(s.utype[lane == 1] > 0, 0,
                                  s.hp[lane == 1])
    s.utype[lane == 2, 0, 0] = num_types + 1
    s.busy[lane == 3, 0, 0] = True
    s.aticks[lane == 3, 0, 0] = -1
    s.resources[lane == 4, 0] = -1
    r[lane == 5, 0] = float("nan")
    s.resources[lane == 6, 1] = 1_000_001
    return s, r, (lane >= 1) & (lane <= 6)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 50, warm: int = 3):
    """(device ms per call, host-paced ms per call) of ``fn``, between
    CUDA events around ``n`` calls.  For the device time the calls are
    queued behind a sleep of the card long enough for the host to enqueue
    them all, so that the host's launch overhead does not starve the card;
    the host-paced time is the same run without the sleep."""
    import torch
    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    paced = a.elapsed_time(b) / n
    host_ms = (time.perf_counter() - t0) * 1e3
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / a.elapsed_time(b)
    torch.cuda._sleep(int(cycles_per_ms * (1.5 * host_ms + 5.0)))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, paced


def max_abs(x, y) -> int:
    return int((x.long() - y.long()).abs().max().item()) if x.numel() else 0


def expect_equal(name, pairs):
    """pairs: [(label, kernel tensor, plain tensor)]; returns max |diff|."""
    import torch
    err = 0
    for label, k, p in pairs:
        if k.shape != p.shape or k.dtype != p.dtype:
            raise AssertionError(f"{name}: {label} is {k.dtype}{tuple(k.shape)}"
                                 f", plain {p.dtype}{tuple(p.shape)}")
        e = max_abs(k, p)
        err = max(err, e)
        if not torch.equal(k, p):
            idx = (k != p).nonzero()[0].tolist()
            raise AssertionError(
                f"{name}: {label} differs from the plain version at {idx}: "
                f"kernel {k[tuple(idx)].item()} plain {p[tuple(idx)].item()}")
    return err


def expect_close(name, pairs):
    """pairs: [(label, kernel tensor, plain tensor)] of float32 tensors,
    held to LP_TOL; returns max |diff|."""
    import torch
    err = 0.0
    for label, k, p in pairs:
        try:
            torch.testing.assert_close(k, p, **LP_TOL)
        except AssertionError as e:
            raise AssertionError(f"{name}: {label}: {e}") from None
        err = max(err, float((k - p).abs().max()))
    return err


def state_pairs(k, p):
    from microrts_tpu_torch.engine.types import FIELD_DTYPES
    return [(f, getattr(k, f), getattr(p, f)) for f in FIELD_DTYPES]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _no_grad(fn, *args):
    import torch
    with torch.no_grad():
        return fn(*args)


def eval_call(name, state, player, cfg, type_ids, plain):
    """Evaluation function ``name`` of ops/evaluation.py on ``state``."""
    from microrts_tpu_torch.ops import evaluation as EV
    fn = getattr(EV, name)
    if name == "simple_opt_upper_bound":
        return fn(state, cfg, plain=plain)
    if name == "lanchester_eval":
        return fn(state, player, cfg, type_ids, plain=plain)
    return fn(state, player, cfg, plain=plain)


def lane_ticks(state) -> int:
    return int(state.time.sum())


def clone_tree(tree):
    import dataclasses
    return dataclasses.replace(tree, states=tree.states.clone(), **{
        f: getattr(tree, f).clone() for f in type(tree).FIELDS})


def clone_walk(w):
    import dataclasses
    from microrts_tpu_torch.kernels import WALK_FIELDS
    return dataclasses.replace(w, st=w.st.clone(), leaf_st=w.leaf_st.clone(),
                               **{f: getattr(w, f).clone()
                                  for f in WALK_FIELDS})


def tree_pairs(kt, pt, kw=None, pw=None):
    """[(label, kernel tensor, plain tensor)] of two trees (and walks)."""
    from microrts_tpu_torch.kernels import WALK_FIELDS
    pairs = [(f, getattr(kt, f), getattr(pt, f)) for f in type(kt).FIELDS]
    pairs += [(f"states.{f}", a, b) for f, a, b in state_pairs(kt.states,
                                                               pt.states)]
    if kw is not None:
        pairs += [(f"walk.{f}", getattr(kw, f), getattr(pw, f))
                  for f in WALK_FIELDS]
        for name in ("st", "leaf_st"):
            pairs += [(f"walk.{name}.{f}", a, b) for f, a, b in state_pairs(
                getattr(kw, name), getattr(pw, name))]
    return pairs


def record_tree_calls(TS, run, every):
    """Run ``run()`` (a search) with the node-array updates of
    ``bots.treesearch`` wrapped: copies of the tree, the walk and the other
    arguments of every ``every``-th call of each, before the call."""
    names = ("mcts_descend", "uct_select", "uct_descend", "mcts_backprop")
    real = {n: getattr(TS, n) for n in names}
    snaps = {n: [] for n in names}
    calls = {n: 0 for n in names}

    def wrap(n):
        def f(env, tree, w, *a):
            if calls[n] % every == 0:
                snaps[n].append((clone_tree(tree), clone_walk(w), a))
            calls[n] += 1
            return real[n](env, tree, w, *a)
        return f
    for n in names:
        setattr(TS, n, wrap(n))
    try:
        run()
    finally:
        for n in names:
            setattr(TS, n, real[n])
    return snaps


def tree_decision(env, make, kw, state, seed, player=0):
    """One decision of ``make(env, **kw)``'s bot for ``state``, the bot's
    noise drawn from a generator seeded with ``seed``: (tree, action)."""
    import torch
    bot = make(env, **kw)
    g = torch.Generator(device=env.device)
    g.manual_seed(seed)
    nz = bot.draw(g, state.batch)
    b = bot.bot
    tree = (b.init_tree(state, player, nz.root()) if hasattr(nz, "root")
            else b.init_tree(state, player))
    b.search(tree, player, state.time, nz)
    return tree, b.best_action(tree)


def stack_pairs(k, p):
    """[(label, kernel tensor, plain tensor)] of two minimax stacks: every
    table (row S too), the stacked states and the per-lane state."""
    pt = p.tensors()
    pairs = [(f, t, pt[f]) for f, t in k.tensors().items()]
    pairs += [(f"states.{f}", a, b) for f, a, b in state_pairs(k.states,
                                                               p.states)]
    return pairs + [(f"cur.{f}", a, b) for f, a, b in state_pairs(k.cur,
                                                                  p.cur)]


def clone_trip(trip):
    return trip._replace(**{f: (v.clone() if v is not None else None)
                            for f, v in trip._asdict().items()})


def record_minimax_calls(MM, run, every):
    """Run ``run()`` (a search) with ``bots.minimax.minimax_step``
    wrapped: copies of the stack and the trip of every ``every``-th call
    and of every call that pops a root child (the rare root updates),
    before the call."""
    real, snaps, n = MM.minimax_step, [], [0]

    def f(env, stk, trip, maxp):
        if n[0] % every == 0 or bool((trip.live & trip.finish
                                      & (stk.sp == 1)).any()):
            snaps.append((stk.clone(), clone_trip(trip), maxp))
        n[0] += 1
        return real(env, stk, trip, maxp)
    MM.minimax_step = f
    try:
        run()
    finally:
        MM.minimax_step = real
    return snaps


def deepest_rows(MM, run):
    """(run(), the largest ``sp`` (top row) of any stack after any
    ``bots.minimax.minimax_step`` call of the run)."""
    real, top = MM.minimax_step, [0]

    def f(env, stk, trip, maxp):
        real(env, stk, trip, maxp)
        top[0] = max(top[0], int(stk.sp.max()))
    MM.minimax_step = f
    try:
        return run(), top[0]
    finally:
        MM.minimax_step = real


def minimax_decision(env, MM, name, kw, state, seed, player=0):
    """One decision of bot ``name`` (``bots.minimax``, built with ``kw``)
    for ``state``, its noise from a generator seeded with ``seed``:
    (action, the searches' stacks, their root values or the scores)."""
    import torch
    make = dict(ABCD=MM.abcd_bot, IDABCD=MM.id_abcd_bot,
                RTMinimax=MM.rt_minimax_bot, IDRTMinimax=MM.idrt_minimax_bot,
                IDRTMinimaxRandomized=MM.idrt_minimax_randomized_bot,
                SampledABCD=MM.sampled_abcd_bot)[name]
    bot = make(env, **kw)
    g = torch.Generator(device=env.device)
    g.manual_seed(seed)
    nz = bot.draw(g, state.batch)
    b = bot.bot
    if name == "IDRTMinimaxRandomized":
        arms, valid, score, stk = b.scores(state, player, nz)
        return bot(state, player, nz), [stk], [arms, valid, score]
    if name == "SampledABCD":
        mine, V = b.values(state, player, nz)
        return bot(state, player, nz), [], [mine, V]
    out = [run(state, player) for run in (b.runs if hasattr(b, "runs")
                                          else [b.run])]
    return out[-1][0], [o[2] for o in out], [o[1] for o in out]


def mem_tensors(m):
    """A believe memory's planes and seen types."""
    return [m.b_utype, m.b_hp, m.b_uid, m.seen_type]


def mem_pairs(k, p):
    """[(label, kernel tensor, plain tensor)] of two believe memories."""
    from microrts_tpu_torch.bots.believestate import BelieveMem
    return ([(f, getattr(k, f), getattr(p, f)) for f in BelieveMem.PLANES]
            + [(f"prev.{f}", a, b) for f, a, b in state_pairs(k.prev,
                                                               p.prev)])


def reroot_bytes(before, after, HW):
    """The bytes a re-root of ``before`` into ``after`` must move: the 13
    match fields of every valid row read, each row a game keeps read once,
    and the whole re-rooted tree (every row, the fresh ones with the real
    state) written once."""
    import torch
    from microrts_tpu_torch.engine.types import FIELD_DTYPES
    B, n1 = before.nplayer.shape
    st = before.states
    match_b = HW * sum(getattr(st, f).element_size() for f in (
        "utype", "owner", "hp", "carried", "busy", "atype", "aparam", "atx",
        "aty", "aptype", "aticks")) + 12
    row_b = sum(getattr(st, f)[0].numel() * getattr(st, f).element_size()
                for f in FIELD_DTYPES) + sum(
        getattr(before, f)[0, 0].numel() * getattr(before, f).element_size()
        for f in ("nplayer", "nterm", "ndepth", "nacc", "nvis", "tacc",
                  "tvis", "children", "carms", "nchild"))
    kept = torch.where(after.nvis[:, 0] > 0, after.nnodes, 0)
    return (int(before.nnodes.sum()) * match_b + int(kept.sum()) * row_b
            + B * n1 * row_b)


def seeded_nb_model(n_arms, sizes, seed):
    """A naive-Bayes model (``ml.bayes.NaiveBayesModel``) of seeded counts:
    prior [A] and one [A, Xj] table a feature, calibration 0.35."""
    import numpy as np
    from microrts_tpu_torch.ml.bayes import NaiveBayesModel
    rng = np.random.default_rng(seed)
    return NaiveBayesModel(
        prior=rng.integers(0, 60, n_arms).astype(np.float64),
        cpds=[rng.integers(0, 25, (n_arms, x)).astype(np.float64)
              for x in sizes], calibration=0.35)


def random_claims(gen, s, cfg, cells):
    """Candidates for the units of ``s`` in ``cells`` (bool [B, H, W]):
    most of them claims (a move, or a produce of a type the unit makes)
    toward a free neighbour where one is free, some other actions and
    parameters out of range; ranks a random permutation of the cells per
    env.  Units next to the same free cell then claim it together."""
    import torch
    from microrts_tpu_torch.engine.kernel import pull
    from microrts_tpu_torch.engine.types import Candidates
    B, H, W = s.utype.shape
    T, dev = cfg.num_types, s.utype.device

    def rand(*shape):
        return torch.rand((B, H, W) + shape, generator=gen, device=dev)

    def ri(lo, hi):
        return torch.randint(lo, hi, (B, H, W), generator=gen, device=dev,
                             dtype=torch.int32)
    free = (s.terrain == 0) & (s.utype == 0)
    fd = torch.stack([pull(free, d, False) for d in range(4)], -1)
    pick = torch.where(fd, rand(4), -1.0).argmax(-1).int()
    param = torch.where(fd.any(-1) & (rand() < 0.9), pick, ri(-1, 5))
    t = (s.utype.long() - 1).clamp(0, T - 1)
    makes = torch.tensor(cfg.produces, dtype=torch.bool, device=dev)[t]
    ptype = torch.where(makes, rand(T), -1.0).argmax(-1).int()
    mover = torch.tensor(cfg.can_move, dtype=torch.bool, device=dev)[t]
    at = torch.where(makes.any(-1) & (rand() < 0.6), 4,
                     torch.where(mover, 1, 0)).int()
    at = torch.where(rand() < 0.15, ri(-1, 6), at)
    at = torch.where(cells & (s.utype > 0), at, -1).int()
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    rank = torch.argsort(torch.rand((B, H * W), generator=gen, device=dev),
                         1).int().reshape(B, H, W)
    return Candidates(atype=at, aparam=param.int(),
                      atx=(xs + ri(-3, 4)).int(), aty=(ys + ri(-3, 4)).int(),
                      aptype=torch.where(rand() < 0.9, ptype, ri(0, T)),
                      rank=rank)


def main() -> int:
    t_main = time.perf_counter()
    t_lap = [t_main]

    def lap(part: str) -> None:
        """Print the seconds since the last lap: where the script's time
        goes, against its limit."""
        now = time.perf_counter()
        print(f"    ({part} took {now - t_lap[0]:.1f} s; the script "
              f"{now - t_main:.1f} s so far)", flush=True)
        t_lap[0] = now
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import scripted as S
    from microrts_tpu_torch.bots.scripted import (random_bot,
                                                  random_bot_plain,
                                                  random_opponent)
    from microrts_tpu_torch.config import RUSH_BOTS, make_bot, pretrained_wr
    from microrts_tpu_torch.engine import fog
    from microrts_tpu_torch.engine.kernel import make_engine
    from microrts_tpu_torch.engine.types import (ATTACK, FIELD_DTYPES,
                                                 HARVEST, PRODUCE, RETURN,
                                                 Candidates, State)
    from microrts_tpu_torch.engine.utt import UnitTypeTable
    from microrts_tpu_torch.env.gridnet import REWARD_NAMES, GridnetEnv
    from microrts_tpu_torch.env.pool import MapPoolVecEnv
    from microrts_tpu_torch.env.vec import VecGridnetEnv, env_health_plain
    from microrts_tpu_torch.models.gridnet_policy import (
        ActionSpace, GridnetPolicy, action_logprob_plain, greedy_action_plain,
        gumbel_noise, sample_action_plain)
    from microrts_tpu_torch.bots import believestate as BS
    from microrts_tpu_torch.bots import minimax as MM
    from microrts_tpu_torch.bots import treesearch as TS
    from microrts_tpu_torch.bots.search import monte_carlo_bot
    from microrts_tpu_torch.eval import tournament as TN
    from microrts_tpu_torch.ops import arms as AR
    from microrts_tpu_torch.ops import enumerate as EN
    from microrts_tpu_torch.ops import evaluation as EV
    from microrts_tpu_torch.ops import playout as PO
    from microrts_tpu_torch.profile_step import device_busy
    from microrts_tpu_torch.train import optim
    from microrts_tpu_torch.train.ppo import PPOConfig, PPOTrainer
    from microrts_tpu_torch.train.run import evaluate
    from microrts_tpu_torch.utils.assets import asset_path
    from microrts_tpu_torch.engine.kernel import pull
    from microrts_tpu_torch.env.expert import (
        NUM_MACROS, DetailedNoise, ExpertEnv, ExpertNoise, ExpertRoles,
        detailed_to_gridnet, detailed_to_gridnet_plain, scan_offsets)
    from microrts_tpu_torch.ops import fields as FLD
    from microrts_tpu_torch.synth import dsl as DSL
    from microrts_tpu_torch.synth import search as SYN
    from microrts_tpu_torch.bots import cooperative as CO
    from microrts_tpu_torch.ml import bayes as NB
    from microrts_tpu_torch.ml import pretrained as PT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the same cuDNN algorithms on the kernel and the plain path: same logits
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    print(f"[1] device: {kind} x{count}; nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    secs = KN.build()
    print(f"[2] build: {secs:.1f} s for {len(KN.KERNELS)} kernels in "
          f"{len(KN.NAMES)} sources (wall {time.perf_counter() - t0:.1f} s)",
          flush=True)
    for name in KN.NAMES:
        for line in KN.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {name}: {line.strip()}")

    path = asset_path(MAP)
    kenv = GridnetEnv(path, device=dev)
    penv = GridnetEnv(path, device=dev, plain=True)
    cfg = kenv.cfg.engine
    H, W = kenv.h, kenv.w
    weights = (1.0, 1.0, BIAS, BIAS, 1.0, BIAS)
    pbot = random_bot(penv, BIAS)
    kbot = random_bot(kenv, BIAS)
    peng = penv.engine
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def uniforms():
        return (torch.rand((B, H, W, 2), generator=gen, device=dev),
                torch.rand((B, H, W, 2), generator=gen, device=dev))

    lap("[1]-[2]")
    # ---- [3] realistic states: RandomBiasedAI on the kernel path, each
    # recorded tick run again on the plain path, whose outputs are [4]'s
    # references
    t0 = time.perf_counter()
    keng = kenv.engine
    s = penv.reset(B)
    records = []
    seen = dict(busy=0, produce_kept=0, attack=0, harvest=0, ret=0)
    tick = 0

    def wanting():
        return min(seen.values()) == 0 or seen["attack"] < MIN_ATTACKS

    while tick < MIN_TICKS or (wanting() and tick < MAX_TICKS):
        u0, u1 = uniforms()
        a0 = kbot(s, 0, u0)
        a1 = kbot(s, 1, u1)
        c0 = kenv.decode(s, a0, 0)
        s1 = keng.issue_env(s, c0)
        c1 = kenv.decode(s1, a1, 1)
        s2 = keng.issue_env(s1, c1)
        comp = s2.busy & (s2.aticks <= 1)
        ev = dict(busy=int(s.busy.sum()),
                  produce_kept=int((c0.atype == PRODUCE).sum()
                                   + (c1.atype == PRODUCE).sum()),
                  attack=int((comp & (s2.atype == ATTACK)).sum()),
                  harvest=int((comp & (s2.atype == HARVEST)).sum()),
                  ret=int((comp & (s2.atype == RETURN)).sum()))
        new_kind = any(ev[k] and not seen[k] for k in ev)
        more_attacks = ev["attack"] and seen["attack"] < MIN_ATTACKS
        keep = (new_kind or more_attacks
                or tick in (MIN_TICKS // 2, MIN_TICKS - 1))
        if keep:
            a0 = pbot(s, 0, u0)
            a1 = pbot(s, 1, u1)
            c0 = penv.decode(s, a0, 0)
            s1 = peng.issue_env(s, c0)
            c1 = penv.decode(s1, a1, 1)
            s2 = peng.issue_env(s1, c1)
            records.append(dict(tick=tick, s=s, u0=u0, u1=u1, a0=a0, a1=a1,
                                s1=s1, c0=c0, c1=c1, s2=s2, ev=ev))
            for k in ev:
                seen[k] += ev[k]
        s, _ = (peng if keep else keng).cycle(s2)
        if keep:
            records[-1]["post"] = s
        tick += 1
    torch.cuda.synchronize()
    print(f"[3] {tick} ticks ({len(records)} of them also on the plain "
          f"path) in {time.perf_counter() - t0:.1f} s; "
          f"{len(records)} recorded ticks {[r['tick'] for r in records]}; "
          f"events in them {seen}", flush=True)
    missing = [k for k, v in seen.items() if v == 0]
    if missing:
        raise AssertionError(f"recorded inputs hold no {missing}")
    realistic = s
    # terminal envs: player 0's units gone in every 4th env, player 1's in
    # the next ones (the winloss reward and done, and resets)
    r = dict(records[-1])
    post = r["post"]
    k = torch.arange(B, device=dev) % 4
    gone = (((post.owner == 0) & (k == 0)[:, None, None])
            | ((post.owner == 1) & (k == 1)[:, None, None]))
    r["post"] = post.replace(utype=torch.where(gone, 0, post.utype),
                             owner=torch.where(gone, -1, post.owner))
    r["tick"] = f"{r['tick']} (terminal)"
    records.append(r)

    # rush states: WorkerRush (player 0) against LightRush (player 1) on
    # the kernel path (they are inputs only: [4] holds every kernel against
    # its plain version on them); env k opens with RUSH_OPEN * (k % 32)
    # ticks of RandomBiasedAI
    t0 = time.perf_counter()
    rushers = (S.worker_rush(kenv), S.light_rush(kenv))
    s = kenv.reset(B)
    opening = (RUSH_OPEN * (torch.arange(B, device=dev) % 32))[
        :, None, None, None]
    rush_records = []
    for tick in range(RUSH_TICKS):
        if tick % RUSH_EVERY == RUSH_EVERY - 1:
            rush_records.append(s)
        a0, a1 = rushers[0](s, 0), rushers[1](s, 1)
        if tick < RUSH_OPEN * 31:
            u0, u1 = uniforms()
            a0 = torch.where(tick < opening, kbot(s, 0, u0), a0)
            a1 = torch.where(tick < opening, kbot(s, 1, u1), a1)
        s, _, _ = kenv.step(s, a0, a1)
    rush_start = s
    # every base removed, resources raised, in half the envs (rebuilds)
    base = ((s.utype == kenv.cfg.base_id + 1)
            & (torch.arange(B, device=dev) % 2 == 0)[:, None, None])
    rush_records.append(s.replace(utype=torch.where(base, 0, s.utype),
                                  owner=torch.where(base, -1, s.owner),
                                  resources=s.resources.clamp(min=20)))
    torch.cuda.synchronize()
    print(f"    {RUSH_TICKS} WorkerRush-vs-LightRush ticks in "
          f"{time.perf_counter() - t0:.1f} s; {len(rush_records)} recorded "
          f"(the last with bases removed)", flush=True)

    # PO step inputs: the PO path from the end of the rush run (units in
    # contact, so that hidden units' claims meet visible ones) on the
    # kernels, every PO_RECORD_EVERY-th tick on the plain path, which
    # counts the conflicts of each kind at its issues; those ticks' inputs
    # and outputs are kept
    t0 = time.perf_counter()
    kpo = GridnetEnv(path, partial_obs=True, device=dev)
    ppo = GridnetEnv(path, partial_obs=True, device=dev, plain=True)
    ppbot = random_bot(ppo, BIAS)
    kppbot = random_bot(kpo, BIAS)
    s = rush_start
    po_records = []
    po_seen = {k: 0 for k in peng.ISSUE_CONFLICTS}
    for tick in range(PO_TICKS):
        u0, u1 = uniforms()
        if tick % PO_RECORD_EVERY:
            a0, a1 = kppbot(s, 0, u0), kppbot(s, 1, u1)
            c0 = kpo.decode(s, a0, 0, view=kpo.po_view(s, 0))
            s1 = kpo.engine.issue(s, c0)
            c1 = kpo.decode(s1, a1, 1, view=kpo.po_view(s1, 1))
            s, _ = kpo.engine.cycle(kpo.engine.issue(s1, c1))
            continue
        a0, a1 = ppbot(s, 0, u0), ppbot(s, 1, u1)
        cnt = {}
        v0 = ppo.po_view(s, 0)
        c0 = ppo.decode(s, a0, 0, view=v0)
        s1 = ppo.engine.issue_plain(s, c0, counts=cnt)
        v1 = ppo.po_view(s1, 1)
        c1 = ppo.decode(s1, a1, 1, view=v1)
        s2 = ppo.engine.issue_plain(s1, c1, counts=cnt)
        po_records.append(dict(tick=tick, s=s, a0=a0, a1=a1, v0=v0,
                               c0=c0, s1=s1, v1=v1, c1=c1, cnt=cnt))
        for k in cnt:
            po_seen[k] += cnt[k]
        s, _ = ppo.engine.cycle(s2)
    po_start = s
    torch.cuda.synchronize()
    print(f"    {PO_TICKS} PO ticks in {time.perf_counter() - t0:.1f} "
          f"s; {len(po_records)} recorded {[r['tick'] for r in po_records]}; "
          f"conflicts at their plain issues {po_seen}", flush=True)

    # the policy: seeded, full width, bf16 activations
    space = ActionSpace(cfg.num_types, 2 * cfg.max_range + 1)
    net = GridnetPolicy(space, 20 + cfg.num_types).init_params(
        torch.Generator().manual_seed(0)).to(dev)

    lap("[3]")
    # ---- [4] every kernel against its plain version, on every record
    errs = {k.name: 0 for k in KN.KERNELS}
    terminal = 0
    lane_player = (torch.arange(B, device=dev) % 2).int()
    for r in records:
        for p, st, u, a in ((0, r["s"], r["u0"], r["a0"]),
                            (1, r["s"], r["u1"], r["a1"])):
            act, mask = KN.ACTOR(cfg, st, p, u=u, weights=weights, masks=True)
            errs["actor"] = max(errs["actor"], expect_equal("actor", [
                ("actions", act, random_bot_plain(penv, st, p, u, weights)),
                ("actions vs recorded", act, a),
                ("mask", mask, penv.masks_plain(st, p))]))
        for p, st, a, c in ((0, r["s"], r["a0"], r["c0"]),
                            (1, r["s1"], r["a1"], r["c1"])):
            kc = KN.DECODE(kenv.cfg, st, a, p)
            errs["decode"] = max(errs["decode"], expect_equal("decode", [
                (f, getattr(kc, f), getattr(c, f)) for f in Candidates.FIELDS]))
        for st, c in ((r["s"], r["c0"]), (r["s1"], r["c1"])):
            ks = KN.ISSUE_ENV(cfg, st, c)
            errs["issue_env"] = max(errs["issue_env"], expect_equal(
                "issue_env", state_pairs(ks, peng.issue_env_plain(st, c))))
        ks, kd = KN.CYCLE(cfg, r["s2"])
        ps, pd = peng.cycle_plain(r["s2"])
        errs["cycle"] = max(errs["cycle"], expect_equal(
            "cycle", state_pairs(ks, ps) + [("done", kd, pd)]))

        pre, post, c0, c1 = r["s"], r["post"], r["c0"], r["c1"]
        steps = torch.randint(0, MAX_STEPS, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        r["steps"] = steps
        rew, dn, rm, nst = KN.EPILOGUE(kenv.cfg, post, pre, c0, c1, steps,
                                       MAX_STEPS, done_copies=2)
        pdn = penv.dones_plain(post)
        prm = pdn[:, 0] | (steps + 1 >= MAX_STEPS)
        prew = penv.rewards_plain(pre, c0, c1, post)
        errs["epilogue"] = max(errs["epilogue"], expect_equal("epilogue", [
            ("rewards", rew, prew), ("dones", dn, torch.stack([pdn, pdn])),
            ("reset", rm, prm),
            ("steps", nst, torch.where(prm, 0, steps + 1).int()),
            ("dones alone", KN.EPILOGUE(kenv.cfg, post)[1], pdn)]))
        terminal += int(pdn[:, 0].sum())
        sp, obs, oh = KN.SPLICE_OBS(cfg, post, rm, kenv.init_state,
                                    obs=(0, 1), onehot=(0,))
        psp = post.select(prm, penv.init_state)
        errs["splice_obs"] = max(errs["splice_obs"], expect_equal(
            "splice_obs", state_pairs(sp, psp) + [
                ("obs", obs, torch.stack([penv.observation_plain(psp, p)
                                          for p in (0, 1)])),
                ("onehot", oh[0], penv.observation_onehot_plain(psp, 0))]))
        with torch.no_grad():
            logits, _ = net(penv.observation_onehot_plain(pre, 0))
        mask = penv.masks_plain(pre, 0)
        gum = gumbel_noise(logits.shape, gen, dev)
        ka, klp, kent, kenv_lp = KN.SAMPLE(space.sizes, logits, mask, gum)
        pa, plp, pent, penv_lp = sample_action_plain(logits, mask, space, gum)
        expect_equal("policy_sample", [("actions", ka, pa)])
        expect_equal("policy_sample", [
            ("greedy", KN.SAMPLE(space.sizes, logits, mask)[0],
             greedy_action_plain(logits, mask, space))])
        errs["policy_sample"] = max(errs["policy_sample"], expect_close(
            "policy_sample", [("logprob", klp, plp), ("entropy", kent, pent),
                              ("env logprob", kenv_lp, penv_lp)]))
        r.update(logits=logits, mask=mask, gum=gum, reset=rm)
    torch.cuda.synchronize()
    if terminal == 0:
        raise AssertionError("no terminal env in the recorded inputs")

    # rush: every ported spec and the expansion branch, both players
    rush_plans = {n: make_bot(n, kenv).bot.plan for n in RUSH_BOTS}
    rush_plans["expand (Light)"] = S.rush_plan(
        kenv, S.RushSpec("Light", expand=True))
    branches = {}
    # every 3rd record (the last, with bases removed, among them), then the
    # others only while a decision of the plain version is still missing
    first = rush_records[::3]
    order = first + [rs for i, rs in enumerate(rush_records) if i % 3]
    n_rush = 0
    for i, rs in enumerate(order):
        if i >= len(first) and not [
                b for b in S.RUSH_BRANCHES if not branches.get(b)
                and not b.startswith("expand")]:
            break
        n_rush += 1
        for name, plan in rush_plans.items():
            for p in (0, 1):
                errs["rush"] = max(errs["rush"], expect_equal(
                    f"rush {name} p{p}", [("actions", KN.RUSH(cfg, plan, rs, p),
                                           S.rush_bot_plain(penv, plan, rs, p,
                                                            branches))]))
    torch.cuda.synchronize()
    print(f"    rush: {len(rush_plans)} specs x {n_rush} of "
          f"{len(rush_records)} records x 2 players equal to plain; "
          f"decisions of the plain version "
          f"{branches}", flush=True)
    missing = [b for b in S.RUSH_BRANCHES if not branches.get(b)
               and not b.startswith("expand")]
    if missing:
        raise AssertionError(f"the rush records exercise no {missing}")

    lap("[4] rush")
    # K8: the jump in both modes (playout_step's, and fast_forward's gated
    # step with done lanes), with and without a per-lane cap, on the
    # post-issue states (every unit busy), the pre-step states, the
    # terminal record and the rush records (busy and idle lanes); the
    # cycle kernel's active flag on the lanes that take the cycle
    k8_inputs = ([r["s2"] for r in records] + [records[-1]["post"]]
                 + [r["s"] for r in records[::4]] + rush_records
                 + [penv.reset(B)])
    k8_seen = dict(jumped=0, capped=0, no_busy=0, cycled=0, frozen=0,
                   over=0)
    for st in k8_inputs:
        te = st.time + torch.randint(-2, 40, (B,), generator=gen, device=dev,
                                     dtype=torch.int32)
        dn = torch.rand(B, generator=gen, device=dev) < 0.1
        for d, t in ((None, None), (None, te), (dn, None), (dn, te)):
            kj, kt, ko = KN.EVENT_JUMP(st, t, 512, d)
            pj, pt, po = PO.event_jump_plain(penv, st, t, 512, d)
            if (ko is None) != (d is not None) or (po is None) != (
                    d is not None):
                raise AssertionError("event_jump: gameover returned in the "
                                     "gated mode or missing in the other")
            over = [("over", ko, po)] if d is None else []
            errs["event_jump"] = max(errs["event_jump"], expect_equal(
                "event_jump", state_pairs(kj, pj) + [("take", kt, pt)]
                + over))
            kc, kd = KN.CYCLE(cfg, kj, kt)
            pc, pd = peng.cycle_plain(pj, pt)
            errs["cycle"] = max(errs["cycle"], expect_equal(
                "cycle (active)", state_pairs(kc, pc) + [("done", kd, pd)]))
            k8_seen["jumped"] += int((kj.time > st.time + 1).sum())
            k8_seen["capped"] += int(((kj.time == t) & ~kt).sum()) \
                if t is not None else 0
            k8_seen["no_busy"] += int((~st.busy.any((1, 2))).sum())
            k8_seen["cycled"] += int(kt.sum())
            k8_seen["frozen"] += int((~kt).sum())
            k8_seen["over"] += int(ko.sum()) if ko is not None else 0
    if min(k8_seen.values()) == 0:
        raise AssertionError(f"the K8 inputs miss a case: {k8_seen}")
    # K12a: the seven functions from both players' view and a per-lane
    # player vector
    type_ids = {n: kenv.utt.get_unit_type(n).ID for n in (
        "Base", "Barracks", "Worker", "Light", "Heavy", "Ranged")}
    for st in [r["s"] for r in records] + [records[-1]["post"]] \
            + rush_records:
        for name in EVAL_EXACT + EVAL_FLOAT:
            for p in (0, 1, lane_player):
                kv = eval_call(name, st, p, cfg, type_ids, False)
                pv = eval_call(name, st, p, cfg, type_ids, True)
                if name in EVAL_EXACT:
                    expect_equal(name, [("value", kv, pv)])
                    continue
                rel = float(((kv - pv).abs() / pv.abs().clamp(min=1)).max())
                if not rel <= EVAL_RTOL:
                    raise AssertionError(f"evaluate {name}: {rel} relative")
                errs["evaluate"] = max(errs["evaluate"],
                                       float((kv - pv).abs().max()))
    torch.cuda.synchronize()
    print(f"    event_jump + cycle(active): {len(k8_inputs)} records x 4 "
          f"modes equal to plain, cases {k8_seen}; evaluate: 7 functions "
          f"x {len(records) + 1 + len(rush_records)} records x 3 player "
          f"views (Sqrt family exact, the others within {EVAL_RTOL} "
          f"relative)", flush=True)

    lap("[4] event_jump, cycle, evaluate")
    # K7b on the policy's logits over four recorded ticks (a minibatch of
    # 4096 samples, as phase 7's updates have), upstream weights normal
    lp_recs = records[::5][:LOGPROB_RECORDS]
    with torch.no_grad():
        lg = torch.cat([net(penv.observation_onehot_plain(r["s"], 0))[0]
                        for r in lp_recs])
    emask = torch.cat([penv.masks_plain(r["s"], 0) for r in lp_recs])
    lmask = emask[..., 1:] != 0
    lact = sample_action_plain(lg, emask, space,
                               gumbel_noise(lg.shape, gen, dev))[0]
    del emask
    w1 = torch.randn(lg.shape[:-1], generator=gen, device=dev)
    w2 = torch.randn(lg.shape[:-1], generator=gen, device=dev)
    klp, kent = KN.LOGPROB(space.sizes, lg, lmask, lact)
    with torch.no_grad():
        plp, pent = action_logprob_plain(lg, lmask, lact, space)
    errs["policy_logprob_fwd"] = expect_close("policy_logprob_fwd", [
        ("logprob", klp, plp), ("entropy", kent, pent)])
    kd = KN.LOGPROB_BWD(space.sizes, lg, lmask, lact, w1, w2)
    plg = lg.clone().requires_grad_(True)
    plp, pent = action_logprob_plain(plg, lmask, lact, space)
    pobj = (w1 * plp + w2 * pent).sum()
    pd, = torch.autograd.grad(pobj, plg, retain_graph=True)
    try:
        torch.testing.assert_close(kd, pd, **DLOGITS_TOL)
    except AssertionError as e:
        raise AssertionError(f"policy_logprob_bwd: {e}") from None
    errs["policy_logprob_bwd"] = float((kd - pd).abs().max())
    del kd, pd, klp, kent

    # K12b: arm_sample in its four modes on recorded states with random
    # visit tables (about 85% of the legal arms visited, so that both the
    # unvisited-first and the visited rules are taken), arms_to_action; the
    # per-lane player of the actor's masks and of decode
    asp = AR.arm_space(kenv)
    NA = asp.n_arms
    lane_pl = ((torch.arange(B, device=dev) // 3) % 2).int()
    to_max = (lane_pl == 1)[:, None, None, None]
    arm_cases = dict(visited=0, unvisited=0)
    for r in records[::3]:
        st = r["s"]
        errs["actor"] = max(errs["actor"], expect_equal(
            "actor (per-lane player)", [(
                "mask", KN.ACTOR(cfg, st, lane_pl, masks=True)[1],
                penv.masks_plain(st, lane_pl))]))
        a = torch.where(to_max, r["a1"], r["a0"])
        kc = KN.DECODE(kenv.cfg, st, a, lane_pl)
        pc = penv.decode_plain(st, a, lane_pl)
        errs["decode"] = max(errs["decode"], expect_equal(
            "decode (per-lane player)",
            [(f, getattr(kc, f), getattr(pc, f)) for f in Candidates.FIELDS]))
        mask = penv.masks_plain(st, lane_pl)
        shape = (B, ARM_ROWS, H, W, NA)
        tvis = torch.where(
            torch.rand(shape, generator=gen, device=dev) < 0.85,
            torch.randint(1, 4, shape, generator=gen, device=dev,
                          dtype=torch.int32), 0).int()
        tacc = torch.randn(shape, generator=gen, device=dev) * tvis
        nvis = torch.randint(1, 50, (B, ARM_ROWS), generator=gen,
                             device=dev, dtype=torch.int32)
        cur = torch.randint(0, ARM_ROWS, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        gum = gumbel_noise((B, H, W, NA), gen, dev)
        tables = (tvis, tacc, nvis)
        la = AR.arm_masks_packed(asp, mask)
        unv = (la & (tvis[torch.arange(B, device=dev), cur] == 0)).any(-1)
        arm_cases["unvisited"] += int((unv & la.any(-1)).sum())
        arm_cases["visited"] += int((~unv & la.any(-1)).sum())
        for mode in ("egreedy", "ucb", "unit_uct"):
            args = (asp, mask, gum, mode, tables, cur, lane_pl, 0, 0.3,
                    TS._f32(1.0 - 0.3), 0.05)
            ka, kact = AR.arm_sample(*args)
            pa, pact = AR.arm_sample(*args, plain=True)
            errs["arm_sample"] = max(errs["arm_sample"], expect_equal(
                f"arm_sample {mode}", [("arms", ka, pa),
                                       ("action", kact, pact)]))
        errs["arms_to_action"] = max(errs["arms_to_action"], expect_equal(
            "arms_to_action", [("action", AR.arms_to_action(asp, ka),
                                AR.arms_to_action_plain(asp, ka))]))
        gk = gumbel_noise((B, 2, H, W, NA), gen, dev)
        errs["arm_sample"] = max(errs["arm_sample"], expect_equal(
            "arm_sample uniform", [
                ("arms", AR.arm_sample(asp, mask, gk, "uniform")[0],
                 AR.arm_sample(asp, mask, gk, "uniform", plain=True)[0])]))
        del tvis, tacc, gk
    arm_rec = dict(mask=mask, gum=gum, tables=tables, cur=cur, arms=ka)
    if min(arm_cases.values()) == 0:
        raise AssertionError(f"the arm_sample inputs miss a case: "
                             f"{arm_cases}")
    # K12c/d: every 5th mcts_descend / uct_select / uct_descend /
    # mcts_backprop call of two searches on the kernel path (NaiveMCTS with eps_g 0.3,
    # so that the global bandit's random slot is read, and UCT; 6 nodes,
    # so that the trees fill) on 16 rush records, each held kernel vs
    # plain from the same copies
    tree_state = State(**{f: getattr(rush_records[3], f)[:TREE_GAMES]
                          for f in FIELD_DTYPES})
    snaps = record_tree_calls(TS, lambda: tree_decision(
        kenv, TS.naive_mcts_bot, dict(TREE_CHECK, eps_g=0.3,
                                      max_nodes=SNAP_NODES), tree_state,
        31), TREE_SNAPSHOT_EVERY)
    usnaps = record_tree_calls(TS, lambda: tree_decision(
        kenv, TS.uct_tree_bot, dict(UCT_CHECK, max_nodes=SNAP_NODES),
        tree_state, 32), TREE_SNAPSHOT_EVERY)
    tree_cases = dict(expanded=0, matched_or_global=0, leaf=0, full=0)
    for which, snap in (("naive", snaps), ("uct", usnaps)):
        for name in ("mcts_descend", "uct_select", "uct_descend",
                     "mcts_backprop"):
            for tree, w, a in snap[name]:
                kt, kw_, pt, pw = (clone_tree(tree), clone_walk(w),
                                   clone_tree(tree), clone_walk(w))
                ko = getattr(TS, name)(kenv, kt, kw_, *a)
                po = getattr(TS, name)(penv, pt, pw, *a)
                extra = [] if ko is None else [("slot", ko[0], po[0]),
                                               ("action", ko[1], po[1])]
                key = "mcts_backprop" if name == "mcts_backprop" \
                    else "mcts_descend"
                errs[key] = max(errs[key], expect_equal(
                    f"{name} ({which})", tree_pairs(kt, pt, kw_, pw) + extra))
                if name in ("mcts_descend", "uct_descend"):
                    grew = pt.nnodes > tree.nnodes
                    tree_cases["expanded"] += int(grew.sum())
                    tree_cases["matched_or_global"] += int(
                        (~grew & ~pw.found & ~w.found).sum())
                    tree_cases["leaf"] += int((pw.found & ~w.found).sum())
                    tree_cases["full"] += int(
                        (tree.nnodes == tree.nplayer.shape[1] - 1).sum())
    if min(tree_cases.values()) == 0:
        raise AssertionError(f"the tree snapshots miss a case: "
                             f"{tree_cases}")
    torch.cuda.synchronize()
    print(f"    arm_sample (4 modes, per-lane players, {ARM_ROWS}-row "
          f"random visit tables; cells {arm_cases}) and arms_to_action on "
          f"{len(records[::3])} records, the per-lane player of actor and "
          f"decode, and {sum(map(len, snaps.values()))} + "
          f"{sum(map(len, usnaps.values()))} node-array updates of "
          f"NaiveMCTS and UCT searches ({TREE_GAMES} games; steps "
          f"{tree_cases}) equal to plain", flush=True)
    lap("[4] policy, arms, tree nodes")
    # K12e: enum_next, eight successive draws of both players' odometers
    # from init (four with every lane drawing, four with every other
    # lane), on every 6th recorded tick, every 4th rush record, a record
    # where no unit can act and a resource-tight one
    t1 = time.perf_counter()
    rs3 = rush_records[3]
    ens = ([r["s"] for r in records[::6]] + rush_records[1::4]
           + [rs3.replace(busy=rs3.utype > 0),
              rs3.replace(resources=rs3.resources.clamp(max=2))])
    enum_stats = dict(draws=0, valid=0, empty=0, exhausted=0, max_trips=0)
    for st in ens:
        for p in (0, 1):
            (ki, kn), (pi, pn) = (EN.make_enumerator(e) for e in (kenv, penv))
            kod, kctx = ki(st, p)
            pod, pctx = pi(st, p)
            for i in range(8):
                act = (None if i < 4 else
                       torch.arange(B, device=dev) % 2 == i % 2)
                ko, po = kn(kod, kctx, active=act), pn(pod, pctx, active=act)
                errs["enum_next"] = max(errs["enum_next"], expect_equal(
                    "enum_next", [("arms", ko[0], po[0]),
                                  ("valid", ko[1], po[1]),
                                  ("trips", ko[2], po[2]),
                                  ("choice", kod.choice, pod.choice),
                                  ("more", kod.more, pod.more)]))
                live = torch.ones(B, dtype=torch.bool, device=dev) \
                    if act is None else act
                enum_stats["draws"] += int(live.sum())
                enum_stats["valid"] += int(ko[1].sum())
                enum_stats["empty"] += int((ko[1] & (ko[0] < 0).flatten(
                    1).all(1)).sum())
                enum_stats["exhausted"] += int((live & ~ko[1]).sum())
                enum_stats["max_trips"] = max(enum_stats["max_trips"],
                                              int(ko[2].max()))
    if min(enum_stats.values()) == 0:
        raise AssertionError(f"the enum_next inputs miss a case: "
                             f"{enum_stats}")
    # K12f: every 5th minimax_step call (and every one that pops a root
    # child) of ABCD and RTMinimax searches on the kernel path of 16 rush records, each
    # held kernel vs plain from the same copies
    msnaps = []
    for name in ("ABCD", "RTMinimax"):
        for p in (0, 1):
            msnaps += record_minimax_calls(MM, lambda: minimax_decision(
                kenv, MM, name, dict(MM_REDUCED[name],
                                     node_budget=MM_SNAPSHOT_BUDGET),
                tree_state, 33, p), MM_SNAPSHOT_EVERY)
    # A search never draws past its node's last joint action (all NONE,
    # always consistent, ends every odometer), so its exhausted draws are
    # held on each snapshot's trip with the pushes turned into exhausted
    # draws
    mm_cases = dict(pops=0, prunes=0, pushes=0, root_updates=0,
                    exhausted_draws=0)
    for stk, trip, maxp in msnaps:
        for variant in (trip, trip._replace(push=torch.zeros_like(
                trip.push))):
            kst, pst = stk.clone(), stk.clone()
            MM.minimax_step(kenv, kst, variant, maxp)
            MM.minimax_step(penv, pst, variant, maxp)
            errs["minimax_step"] = max(errs["minimax_step"], expect_equal(
                "minimax_step", stack_pairs(kst, pst)))
        mm_cases["exhausted_draws"] += int((trip.live & ~trip.finish).sum())
        rows = torch.arange(stk.sp.shape[0], device=dev)
        top = stk.sp.long()
        pop = trip.live & trip.finish
        kst = stk.clone()
        MM.minimax_step(penv, kst, trip, maxp)
        mm_cases["pops"] += int(pop.sum())
        mm_cases["prunes"] += int((pop & stk.od.more[rows, top]).sum())
        mm_cases["pushes"] += int(trip.push.sum())
        mm_cases["root_updates"] += int((pop & (top == 1) & (
            kst.best[:, 0] != stk.best[:, 0])).sum())
    if min(mm_cases.values()) == 0:
        raise AssertionError(f"the minimax_step snapshots miss a case: "
                             f"{mm_cases}")
    torch.cuda.synchronize()
    print(f"    enum_next on {len(ens)} records x {B} lanes (the last two "
          f"with no unit able to act and with the balance at most 2), both "
          f"players, 8 draws each ({enum_stats}), and {len(msnaps)} "
          f"minimax_step calls of ABCD and RTMinimax searches "
          f"({TREE_GAMES} games; lanes {mm_cases}, the exhausted draws "
          f"on the trips with the pushes cleared) equal to plain "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    lap("[4] enum_next, minimax_step")
    # K11a: issue on both issues of every PO record under the three
    # policies, and on two-issue random candidate tables (half the units,
    # then the others on the result) over PO and rush records with the
    # stockpiles drawn; CANCEL_RANDOM's coins random, CANCEL_ALTERNATING's
    # counter drawn; issue against issue_env on slice 1's records
    t1 = time.perf_counter()
    pcfg = {p: dataclasses.replace(cfg, move_conflict_policy=p)
            for p in (1, 2, 3)}
    peng_p = {p: make_engine(c, plain=True) for p, c in pcfg.items()}

    def drawn(hi, shape=()):
        return torch.randint(0, hi, (B,) + shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def issue_check(label, st, c, policy, counts=None):
        coins = (torch.rand((B, H, W, 4), generator=gen, device=dev) < 0.5
                 if policy == 2 else None)
        if policy == 3:
            st = st.replace(cancel_ctr=drawn(6))
        ps = peng_p[policy].issue_plain(st, c, coins, counts)
        errs["issue"] = max(errs["issue"], expect_equal(
            label, state_pairs(KN.ISSUE(pcfg[policy], st, c, coins), ps)))
        return ps

    for r in po_records:
        for policy in (1, 2, 3):
            for st, c in ((r["s"], r["c0"]), (r["s1"], r["c1"])):
                issue_check(f"issue policy {policy} (PO tick {r['tick']})",
                            st, c, policy)
    syn = {}
    syn_inputs = [r["s"] for r in po_records[::3]] + rush_records[::3]
    for st0 in syn_inputs:
        for policy in (1, 2, 3):
            st = st0.replace(resources=drawn(12, (2,)))
            half = torch.rand((B, H, W), generator=gen, device=dev) < 0.5
            for cells in (half, ~half):
                st = issue_check(f"issue policy {policy} (random tables)",
                                 st, random_claims(gen, st, cfg, cells),
                                 policy, syn)
    both = {k: po_seen[k] + syn.get(k, 0) for k in po_seen}
    if min(both.values()) == 0:
        raise AssertionError(f"the issue inputs miss a conflict kind: PO "
                             f"path {po_seen}, random tables {syn}")
    for r in records:
        for st, c in ((r["s"], r["c0"]), (r["s1"], r["c1"])):
            expect_equal("issue vs issue_env (full observation)",
                         state_pairs(KN.ISSUE(cfg, st, c),
                                     KN.ISSUE_ENV(cfg, st, c)))
    # K11b/c: the fog of both players and a per-lane player vector on the
    # PO, rush and terminal records; decode with a view on the PO records
    fog_inputs = ([r["s"] for r in po_records] + rush_records
                  + [records[-1]["post"]])
    fog_seen = dict(hidden=0, seen=0)
    for st in fog_inputs:
        for p in (0, 1, lane_player):
            kv, kvis = KN.PO_STATE(cfg, st, p)
            pvis = fog.visibility_plain(st, p, cfg)
            errs["po_state"] = max(errs["po_state"], expect_equal(
                "po_state", state_pairs(kv, fog.po_state_plain(st, p, cfg))
                + [("visibility", kvis, pvis)]))
            me = p[:, None, None] if isinstance(p, torch.Tensor) else p
            enemy = (st.utype > 0) & (st.owner >= 0) & (st.owner != me)
            fog_seen["hidden"] += int((enemy & ~pvis).sum())
            fog_seen["seen"] += int((enemy & pvis).sum())
            ko = KN.OBS_PO(cfg, st, (p,))[0]
            errs["obs_po"] = max(errs["obs_po"], expect_equal("obs_po", [
                ("obs", ko[0], fog.observation_po_plain(st, p, cfg))]))
        ko, koh = KN.OBS_PO(cfg, st, (0, 1), onehot=(0, 1))
        errs["obs_po"] = max(errs["obs_po"], expect_equal(
            "obs_po (both players, one-hot)", [
                ("obs", ko, torch.stack([ppo.observation_plain(st, p)
                                         for p in (0, 1)])),
                ("onehot", koh, torch.stack([
                    ppo.observation_onehot_plain(st, p) for p in (0, 1)]))]))
    if min(fog_seen.values()) == 0:
        raise AssertionError(f"the fog inputs miss a case: {fog_seen}")
    for r in po_records:
        for p, st, a, v, c in ((0, r["s"], r["a0"], r["v0"], r["c0"]),
                               (1, r["s1"], r["a1"], r["v1"], r["c1"])):
            kc = KN.DECODE(kenv.cfg, st, a, p, view=v)
            errs["decode"] = max(errs["decode"], expect_equal(
                "decode (view)", [(f, getattr(kc, f), getattr(c, f))
                                  for f in Candidates.FIELDS]))
    torch.cuda.synchronize()
    print(f"    issue under 3 policies on {len(po_records)} PO records x 2 "
          f"issues and two-issue random tables on {len(syn_inputs)} PO and "
          f"rush records (conflicts: PO path {po_seen}, random tables "
          f"{syn}), issue = issue_env on {len(records)} full-observation "
          f"records x 2, po_state and obs_po (one-hot too) on "
          f"{len(fog_inputs)} records x 3 player views (enemy units "
          f"{fog_seen}), decode with a view on {len(po_records)} x 2, equal "
          f"to plain ({time.perf_counter() - t1:.1f} s)", flush=True)
    lap("[4] issue, fog")
    # K13: believe_update (init, update and the sampled world) of the
    # three levels for both observers along the PO records (memories made
    # at the first, the seen types cleared in half the lanes so that
    # producers are inferred), kernel vs plain
    t1 = time.perf_counter()
    echo = S.Opponent(lambda w, q, n: w)
    bel_rules = dict.fromkeys(BS.RULES, 0)
    for level in (1, 2, 3):
        for p in (0, 1):
            kb = BS.believe_state_bot(kenv, echo, level=level)
            pb = BS.believe_state_bot(penv, echo, level=level)
            km, pm = kb.init(po_records[0]["s"], p), pb.init(
                po_records[0]["s"], p)
            errs["believe_update"] = max(errs["believe_update"],
                                         expect_equal("believe init",
                                                      mem_pairs(km, pm)))
            km.seen_type[B // 2:] = False
            pm.seen_type[B // 2:] = False
            for r in po_records[1:]:
                km, kwld = kb.update(r["s"], km, p)
                pm, pwld = pb.update(r["s"], pm, p, bel_rules)
                errs["believe_update"] = max(
                    errs["believe_update"], expect_equal(
                        f"believe_update level {level} p{p}",
                        mem_pairs(km, pm) + state_pairs(kwld, pwld)))
    if min(bel_rules[n] for n in ("remembered", "forgotten_by_uid",
                                  "inferred", "relocated",
                                  "forgotten")) == 0:
        raise AssertionError(f"the believe inputs miss a rule: {bel_rules}")
    # K12g: mcts_reroot on the trees of a reduced ContinuingNaiveMCTS (the
    # checks' budget) of the 16 rush games after one decision, at the
    # state after the real step (WorkerRush's reply, the fast-forward),
    # at a child's and a grandchild's node state (hits), at a state no
    # node holds, and with a third of the lanes left out
    cb = TS.naive_mcts_continuing(penv, **TREE_CHECK)
    g = torch.Generator(device=dev)
    g.manual_seed(33)
    ctree = cb.init(tree_state, 0)
    cact, ctree = cb.step(tree_state, ctree, 0, cb.draw(g, TREE_GAMES))
    s_real = penv.step(tree_state, cact,
                       make_bot("WorkerRush", penv)(tree_state, 1))[0]
    s_real = PO.fast_forward(penv, s_real, peng.gameover(s_real))[0]
    tb = torch.arange(TREE_GAMES, device=dev)
    child = ctree.children[tb, 0, 0].clamp(min=0)
    grand = ctree.children[tb, child, 0]
    grand = torch.where(grand >= 0, grand, child)
    s_miss = s_real.clone()
    s_miss.resources[:, 0] += 37
    reroot_cases = dict(hit=0, miss=0, left_out=0)
    D_CHECK = TREE_CHECK["max_depth"]
    for st, lv in ((s_real, None), (TS.node_states(ctree, child), None),
                   (TS.node_states(ctree, grand), tb % 3 != 0),
                   (s_miss, None)):
        kt, pt = clone_tree(ctree), clone_tree(ctree)
        TS.mcts_reroot(kenv, kt, st, 0, D_CHECK, lv)
        TS.mcts_reroot(penv, pt, st, 0, D_CHECK, lv)
        errs["mcts_reroot"] = max(errs["mcts_reroot"], expect_equal(
            "mcts_reroot", tree_pairs(kt, pt)))
        on = torch.ones_like(tb, dtype=torch.bool) if lv is None else lv
        reroot_cases["hit"] += int((on & (pt.nvis[:, 0] > 0)).sum())
        reroot_cases["miss"] += int((on & (pt.nvis[:, 0] == 0)).sum())
        reroot_cases["left_out"] += int((~on).sum())
    if min(reroot_cases.values()) == 0:
        raise AssertionError(f"the re-root inputs miss a case: "
                             f"{reroot_cases}")
    torch.cuda.synchronize()
    print(f"    believe_update (levels 1-3, both observers, init, update and "
          f"the world) along {len(po_records)} PO records (rules "
          f"{bel_rules}), mcts_reroot on {TREE_GAMES} trees after a real "
          f"step (lanes {reroot_cases}), equal to plain "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    lap("[4] believe_update, mcts_reroot")
    # slice 9 (K5 rest, K6 rest): cycle under UTT v3 with the cells'
    # uniforms (and active lanes), the epilogue with all eight rewards,
    # env_health on planted faults and healthy lanes, on every record
    t1 = time.perf_counter()
    k3env = GridnetEnv(path, UnitTypeTable(3), reward_fns=REWARD_NAMES,
                       device=dev)
    p3env = GridnetEnv(path, UnitTypeTable(3), reward_fns=REWARD_NAMES,
                       device=dev, plain=True)
    cfg3, peng3 = k3env.cfg.engine, p3env.engine
    above = closer = flagged = 0
    for r in records:
        u01 = torch.rand((B, H, W), generator=gen, device=dev)
        act = torch.rand(B, generator=gen, device=dev) < 0.75
        for a in (None, act):
            ks, kd = KN.CYCLE(cfg3, r["s2"], a, u01)
            ps, pd = peng3.cycle_plain(r["s2"], a, u01)
            errs["cycle"] = max(errs["cycle"], expect_equal(
                "cycle (UTT v3)", state_pairs(ks, ps) + [("done", kd, pd)]))
        t = (r["s2"].utype.long() - 1).clamp(0, cfg3.num_types - 1)
        lo = peng3.lut("min_damage", dev)[t]
        hi = peng3.lut("max_damage", dev)[t]
        comp = r["s2"].busy & (r["s2"].aticks <= 1) & (r["s2"].atype
                                                       == ATTACK)
        above += int((comp & (hi > lo)
                      & ((u01 * (hi - lo + 1)).int() > 0)).sum())
        pre, post, c0, c1 = r["s"], r["post"], r["c0"], r["c1"]
        rew, dn, rm, nst = KN.EPILOGUE(k3env.cfg, post, pre, c0, c1,
                                       r["steps"], MAX_STEPS, done_copies=2)
        pdn = p3env.dones_plain(post)
        prm = pdn[:, 0] | (r["steps"] + 1 >= MAX_STEPS)
        errs["epilogue"] = max(errs["epilogue"], expect_equal(
            "epilogue (eight rewards)", [
                ("rewards", rew, p3env.rewards_plain(pre, c0, c1, post)),
                ("dones", dn, torch.stack([pdn, pdn])), ("reset", rm, prm),
                ("steps", nst, torch.where(prm, 0, r["steps"] + 1).int())]))
        closer += int((rew[..., 6:] != 0).sum())
        fs, frew, want_bad = plant_faults(post, rew.reshape(B, -1),
                                          cfg.num_types)
        kbad = KN.ENV_HEALTH(cfg, fs, frew)
        errs["env_health"] = max(errs["env_health"], expect_equal(
            "env_health", [("failed", kbad, env_health_plain(fs, frew, cfg)),
                           ("failed vs planted", kbad, want_bad)]))
        flagged += int(kbad.sum())
    if above == 0 or closer == 0:
        raise AssertionError(f"the v3 records: {above} attacks above their "
                             f"minimum, {closer} closer rewards non-zero")
    torch.cuda.synchronize()
    print(f"    cycle under UTT v3 (with and without active lanes; "
          f"{above} completing attacks drawn above their minimum), "
          f"epilogue with the eight rewards ({closer} closer rewards "
          f"non-zero) and env_health ({flagged} lanes flagged, 6 of every "
          f"{FAULT_LANES} planted) equal to plain on {len(records)} "
          f"records ({time.perf_counter() - t1:.1f} s)", flush=True)
    lap("[4] slice 9")
    # slice 10 (K9 rest, the expert and DSL stencils): the standalone
    # fields on every 2nd rush record and every 4th PO record (the enemy, the
    # resources and the own bases of both players, the two nearest
    # distinct own units) and on a planted serpentine maze longer than
    # H+W; expert_macro for every macro and both players with role tables
    # carried along the rush records by a plain run; expert_detailed on
    # seeded logits; range_cover and dsl_target under the seven policies
    t1 = time.perf_counter()
    xk, xp = ExpertEnv(kenv), ExpertEnv(penv)
    scan = scan_offsets(cfg.max_range)
    x_inputs = rush_records[::2] + [r["s"] for r in po_records[::4]]
    maze = penv.reset(B)
    mz = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for row in range(1, H - 1, 2):     # walls with one gap, alternating
        mz[row] = True
        mz[row, (W - 1) if (row // 2) % 2 == 0 else 0] = False
    maze = maze.replace(terrain=torch.where(mz & (maze.utype == 0), 1,
                                            maze.terrain).to(torch.int8))
    x_inputs.append(maze)
    iters = H + W
    far = 0
    for st in x_inputs:
        exists = st.utype > 0
        t_ = (st.utype.long() - 1).clamp(0, cfg.num_types - 1)
        passable = (st.terrain == 0) & ~exists
        free_n = torch.stack([pull(passable, d, False) for d in range(4)],
                             -1)
        res = exists & peng.lut("is_resource", dev)[t_]
        flat = (torch.arange(H * W, device=dev, dtype=torch.int32)
                .reshape(H, W).expand(B, H, W).contiguous())
        for p in (0, 1):
            mine = exists & (st.owner == p)
            enemy = exists & (st.owner >= 0) & (st.owner != p)
            src3 = torch.stack([enemy, res, mine & peng.lut(
                "is_stockpile", dev)[t_]], 1)
            kd = KN.DISTANCE_FIELDS(src3, passable, iters)
            errs["distance_fields"] = max(errs["distance_fields"],
                                          expect_equal("distance_fields", [(
                                              "fields", kd,
                                              FLD.distance_fields_plain(
                                                  src3, passable, iters))]))
            far += int(((kd == (1 << 30)) & passable[:, None]).sum())
            for f in range(3):
                df = kd[:, f].contiguous()
                errs["descend_direction"] = max(
                    errs["descend_direction"], expect_equal(
                        "descend_direction", [("dir", KN.DESCEND(df, free_n),
                                               FLD.descend_direction_plain(
                                                   df, free_n))]))
            kst = KN.DISTANCE_FIELD2(mine, passable, iters)
            errs["distance_field2"] = max(errs["distance_field2"],
                                          expect_equal("distance_field2", [
                                              (n, a, b) for n, a, b in zip(
                                                  ("d1", "i1", "d2", "i2"),
                                                  kst,
                                                  FLD.distance_field2_plain(
                                                      mine, passable,
                                                      iters))]))
            errs["descend_direction_excluding"] = max(
                errs["descend_direction_excluding"], expect_equal(
                    "descend_direction_excluding", [(
                        "dir", KN.DESCEND_EXCLUDING(kst, free_n, flat),
                        FLD.descend_direction_excluding_plain(
                            kst, free_n, flat))]))
            rng_p = peng.lut("attack_range", dev)[t_]
            dmg_p = peng.lut("max_damage", dev)[t_]
            for cov in (mine, enemy):
                errs["range_cover"] = max(errs["range_cover"], expect_equal(
                    "range_cover", [("cover", KN.RANGE_COVER(cfg, st, cov),
                                     DSL.range_cover_plain(
                                         cov, rng_p, cfg.max_range))]))
            u_rel = torch.rand((B, (2 * cfg.max_range + 1) ** 2, H, W),
                               generator=gen, device=dev)
            for pol, mode in DSL.TARGET_MODES.items():
                kt_, kf_ = KN.DSL_TARGET(cfg, st, p, mode, u_rel, scan)
                pt_, pf_ = DSL.dsl_target_plain(mode, enemy, st.hp, dmg_p,
                                                rng_p, cfg.max_range, u_rel)
                errs["dsl_target"] = max(errs["dsl_target"], expect_equal(
                    f"dsl_target {pol}", [("rel", kt_, pt_),
                                          ("found", kf_, pf_)]))
    if far == 0:
        raise AssertionError("no passable cell beyond H+W sweeps")
    # expert_macro: roles carried along the rush records by a plain run of
    # macros drawn from the action mask; every macro on every record
    x_roles = [ExpertRoles.init(B, dev), ExpertRoles.init(B, dev)]
    macro_acts = {}
    for i, st in enumerate(rush_records):
        for p in (0, 1):
            for m in range(NUM_MACROS) if i % 3 == 0 else ():
                nz = ExpertNoise.draw(gen, B, kenv)
                mac = torch.full((B,), m, dtype=torch.int32, device=dev)
                ka, kr = xk.macro_to_gridnet(st, x_roles[p], p, mac, nz)
                pa, pr = xp.macro_to_gridnet(st, x_roles[p], p, mac, nz)
                errs["expert_macro"] = max(errs["expert_macro"], expect_equal(
                    f"expert_macro record {i} p{p} macro {m}",
                    [("actions", ka, pa)] + [
                        (f, getattr(kr, f), getattr(pr, f))
                        for f in ExpertRoles.FIELDS]))
                macro_acts[m] = macro_acts.get(m, 0) + int(
                    ((ka[..., 0] > 0) & (st.owner == p)).sum())
            mac = torch.multinomial(xp.action_mask(st, x_roles[p], p)
                                    .float(), 1, generator=gen)[:, 0].int()
            x_roles[p] = xp.macro_to_gridnet(st, x_roles[p], p, mac,
                                             ExpertNoise.draw(gen, B,
                                                              kenv))[1]
    carried = [int(r.harvester.sum() + r.has_target.sum()) for r in x_roles]
    if min(carried) == 0:
        raise AssertionError(f"expert roles carried {carried}")
    det_acts = 0
    for st in rush_records[::3]:
        for p in (0, 1):
            tl = torch.randn((B, cfg.num_types), generator=gen, device=dev)
            ml = torch.randn((B, H, W), generator=gen, device=dev)
            dn = DetailedNoise.draw(gen, B, kenv)
            ka = KN.EXPERT_DETAILED(cfg, st, p, tl, ml, dn)
            errs["expert_detailed"] = max(errs["expert_detailed"],
                                          expect_equal("expert_detailed", [(
                                              "actions", ka,
                                              detailed_to_gridnet_plain(
                                                  xp, st, p, tl, ml, dn))]))
            det_acts += int((ka[..., 0] > 0).sum())
            del dn
    torch.cuda.synchronize()
    print(f"    slice 10: distance_fields, descend_direction, "
          f"distance_field2, descend_direction_excluding, range_cover and "
          f"dsl_target (seven policies) on {len(x_inputs)} records x 2 "
          f"players (the maze and {far} cells beyond {iters} sweeps), "
          f"expert_macro (13 macros x 2 players on every 3rd of "
          f"{len(rush_records)} rush records, roles carried along all "
          f"{carried}, acting cells by macro "
          f"{macro_acts}) and expert_detailed ({det_acts} acting cells) "
          f"equal to plain ({time.perf_counter() - t1:.1f} s)", flush=True)
    lap("[4] slice 10")
    # slice 11: the learned models (K14a-c, K12b's informed mode) on every
    # 2nd rush record, both players and the per-lane player; the same
    # holds run on [16]'s kept in-contact state in [17]
    t1 = time.perf_counter()
    aim = PT.load_pretrained(pretrained_wr(), kenv)
    nbt = NB.nb_tables(seeded_nb_model(NA, NB.feature_sizes(cfg), 0), dev)
    coop_k = CO.cooperative_bot(kenv, seed=1).bot   # genomes whose units act

    def hold_learned(st, label, acts):
        """aim_predict (4 modes), nb_predict (3), cooperative_act and the
        informed arm_sample on ``st`` kernel vs plain, exact; adds to
        ``acts`` the acting cells each saw."""
        for p in (0, 1, lane_pl):
            mask = penv.masks_plain(st, p)
            can = mask[..., 0].bool()
            gum = gumbel_noise((B, H, W, NA), gen, dev)
            for mode in PT.MODES:
                gg = gum if mode == "sample" else None
                k = PT.aim_predict(aim, st, mask, p, mode, gg)
                q = PT.aim_predict(aim, st, mask, p, mode, gg, plain=True)
                pairs = ([(mode, k, q)] if mode in ("logits", "prior")
                         else [(f"{mode} arms", k[0], q[0]),
                               (f"{mode} action", k[1], q[1])])
                errs["aim_predict"] = max(errs["aim_predict"], expect_equal(
                    f"aim_predict {label}", pairs))
            for mode in NB.MODES:
                gg = gum if mode == "sample" else None
                k = NB.nb_predict(nbt, cfg, asp, st, mask, p, mode, gg)
                q = NB.nb_predict(nbt, cfg, asp, st, mask, p, mode, gg,
                                  plain=True)
                pairs = ([(mode, k, q)] if mode == "logits"
                         else [(f"{mode} arms", k[0], q[0]),
                               (f"{mode} action", k[1], q[1])])
                errs["nb_predict"] = max(errs["nb_predict"], expect_equal(
                    f"nb_predict {label}", pairs))
            nets = CO.cooperative_nets(kenv, st, p, coop_k.genomes,
                                       coop_k.dims, 4)
            ka = KN.COOPERATIVE_ACT(cfg, st, p, nets)
            errs["cooperative_act"] = max(errs["cooperative_act"],
                                          expect_equal(
                f"cooperative_act {label}", [
                    ("actions", ka, CO.cooperative_act_plain(penv, st, p,
                                                             nets))]))
            del nets
            pri = PT.aim_predict(aim, st, mask, p, "prior")
            shape = (B, ARM_ROWS, H, W, NA)
            tvis = torch.where(
                torch.rand(shape, generator=gen, device=dev) < 0.85,
                torch.randint(1, 4, shape, generator=gen, device=dev,
                              dtype=torch.int32), 0).int()
            tvis[:, 0] = 0        # row 0 unvisited: the prior's own draw
            tacc = torch.randn(shape, generator=gen, device=dev) * tvis
            nvis = torch.randint(1, 50, (B, ARM_ROWS), generator=gen,
                                 device=dev, dtype=torch.int32)
            cur = torch.randint(0, ARM_ROWS, (B,), generator=gen,
                                device=dev, dtype=torch.int32)
            pl = p if isinstance(p, torch.Tensor) else torch.full(
                (B,), p, dtype=torch.int32, device=dev)
            args = (asp, mask, gum, "informed", (tvis, tacc, nvis), cur, pl,
                    0, 0.3, TS._f32(1.0 - 0.3), 0.05, pri)
            ka2, kact = AR.arm_sample(*args)
            pa2, pact = AR.arm_sample(*args, plain=True)
            errs["arm_sample"] = max(errs["arm_sample"], expect_equal(
                f"arm_sample informed {label}", [("arms", ka2, pa2),
                                                 ("action", kact, pact)]))
            acts["acting cells"] += int(can.sum())
            acts["cooperative actions"] += int((ka[..., 0] > 0).sum())
            acts["informed draws"] += int((ka2 >= 0).sum())
            del tvis, tacc, gum, pri

    learned_acts = {"acting cells": 0, "cooperative actions": 0,
                    "informed draws": 0}
    for i, rs in enumerate(rush_records[::2]):
        hold_learned(rs, f"rush record {2 * i}", learned_acts)
    torch.cuda.synchronize()
    if min(learned_acts.values()) == 0:
        raise AssertionError(f"slice 11: nothing to hold ({learned_acts})")
    print(f"    slice 11: aim_predict (4 modes), nb_predict (3 modes), "
          f"cooperative_act and arm_sample informed on "
          f"{len(rush_records[::2])} rush records x 3 player settings "
          f"equal to plain ({learned_acts}; "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)
    lap("[4] slice 11")
    print(f"[4] kernels equal to plain on {len(records)} recorded ticks "
          f"(max |diff| {errs})", flush=True)

    r = records[-1]
    st, st1, st2 = r["s"], r["s1"], r["s2"]
    ss = ("utype", "owner", "terrain", "busy", "carried")
    timing = {
        "actor": (lambda: KN.ACTOR(cfg, st, 0, u=r["u0"], weights=weights),
                  lambda: random_bot_plain(penv, st, 0, r["u0"], weights),
                  nbytes(*[getattr(st, f) for f in ss], st.resources,
                         r["u0"], r["a0"])),
        "decode": (lambda: KN.DECODE(kenv.cfg, st1, r["a1"], 1),
                   lambda: penv.decode_plain(st1, r["a1"], 1),
                   nbytes(r["a1"], *[getattr(st1, f) for f in (
                       "utype", "owner", "busy", "atype", "aparam",
                       "aptype")], st1.resources,
                       *[getattr(r["c1"], f) for f in Candidates.FIELDS])),
        "issue_env": (lambda: KN.ISSUE_ENV(cfg, st1, r["c1"]),
                      lambda: peng.issue_env_plain(st1, r["c1"]),
                      nbytes(*[getattr(st1, f) for f in ss],
                             *[getattr(r["c1"], f) for f in Candidates.FIELDS],
                             *[getattr(st1, f) for f in (
                                 "atype", "aparam", "atx", "aty", "aptype",
                                 "aticks", "aorder", "atime")],
                             st1.time, st1.resources, st1.order_ctr,
                             *[getattr(st2, f) for f in (
                                 "busy", "atype", "aparam", "atx", "aty",
                                 "aptype", "aticks", "aorder", "atime",
                                 "order_ctr")])),
        "cycle": (lambda: KN.CYCLE(cfg, st2),
                  lambda: peng.cycle_plain(st2),
                  2 * nbytes(*[getattr(st2, f) for f in (
                      "utype", "owner", "hp", "carried", "uid", "busy",
                      "atype", "aparam", "atx", "aty", "aptype", "aticks",
                      "aorder", "atime", "time", "resources", "next_id")])
                  + B),
    }
    # epilogue: pre utype/owner, both players' atype/atx/aty/aptype, post
    # utype/owner/carried, steps in; rewards, 2 dones copies, reset, steps
    # out
    rm = r["reset"]
    epi_out = KN.EPILOGUE(kenv.cfg, r["post"], st, r["c0"], r["c1"],
                          r["steps"], MAX_STEPS, done_copies=2)
    timing["epilogue"] = (
        lambda: KN.EPILOGUE(kenv.cfg, r["post"], st, r["c0"], r["c1"],
                            r["steps"], MAX_STEPS, done_copies=2),
        lambda: (penv.rewards_plain(st, r["c0"], r["c1"], r["post"]),
                 penv.dones_plain(r["post"])),
        nbytes(st.utype, st.owner, r["post"].utype, r["post"].owner,
               r["post"].carried, r["steps"], *epi_out,
               *[getattr(c, f) for c in (r["c0"], r["c1"])
                 for f in ("atype", "atx", "aty", "aptype")]))
    # env_health: utype, hp, busy, aticks, the stockpiles and the eight
    # rewards of both players in, the flags out, on planted faults
    fs, frew, _ = plant_faults(r["post"], torch.zeros(
        (B, 2 * len(REWARD_NAMES)), device=dev), cfg.num_types)
    timing["env_health"] = (
        lambda: KN.ENV_HEALTH(cfg, fs, frew),
        lambda: env_health_plain(fs, frew, cfg),
        nbytes(fs.utype, fs.hp, fs.busy, fs.aticks, fs.resources, frew) + B)
    # splice_obs: the post planes of the envs that keep playing and the
    # initial state in; the spliced state, both observations and player
    # 0's one-hot out
    sp, obs, oh = KN.SPLICE_OBS(cfg, r["post"], rm, kenv.init_state,
                                obs=(0, 1), onehot=(0,))
    keep = 1.0 - float(rm.float().mean())
    post_b = nbytes(*[getattr(r["post"], f) for f in FIELD_DTYPES])
    timing["splice_obs"] = (
        lambda: KN.SPLICE_OBS(cfg, r["post"], rm, kenv.init_state,
                              obs=(0, 1), onehot=(0,)),
        lambda: (lambda q: (torch.stack([penv.observation_plain(q, p)
                                         for p in (0, 1)]),
                            penv.observation_onehot_plain(q, 0)))(
            r["post"].select(rm, penv.init_state)),
        int(keep * post_b) + nbytes(rm, *[getattr(kenv.init_state, f)
                                          for f in FIELD_DTYPES])
        + post_b + nbytes(obs, oh))
    # policy_sample: logits, mask, gumbels in; actions, logprob, entropy,
    # per-env logprob out
    timing["policy_sample"] = (
        lambda: KN.SAMPLE(space.sizes, r["logits"], r["mask"], r["gum"]),
        lambda: sample_action_plain(r["logits"], r["mask"], space, r["gum"]),
        nbytes(r["logits"], r["mask"], r["gum"],
               *KN.SAMPLE(space.sizes, r["logits"], r["mask"], r["gum"])))
    # policy_logprob_fwd: logits, mask, actions in; lp, ent out (about 20
    # flops per logit); policy_logprob_bwd: the same and the two upstream
    # gradients in, the logits' gradient out (about 40 flops per logit)
    A = space.total
    timing["policy_logprob_fwd"] = (
        lambda: KN.LOGPROB(space.sizes, lg, lmask, lact),
        lambda: _no_grad(action_logprob_plain, lg, lmask, lact, space),
        nbytes(lg, lmask, lact, w1, w2), 20 * lg.numel(), FP32_OPS_PER_S)
    timing["policy_logprob_bwd"] = (
        lambda: KN.LOGPROB_BWD(space.sizes, lg, lmask, lact, w1, w2),
        lambda: torch.autograd.grad(pobj, plg, retain_graph=True),
        nbytes(lg, lmask, lact, w1, w2) + nbytes(lg), 40 * lg.numel(),
        FP32_OPS_PER_S)
    # rush (WorkerRush for player 1 on the last rush record): six state
    # planes and the resources in, the actions out; three fields of
    # iters = H + W sweeps, FIELD_OPS integer operations a cell and sweep
    rs = rush_records[-1]
    wr = rush_plans["WorkerRush"]
    timing["rush"] = (
        lambda: KN.RUSH(cfg, wr, rs, 1),
        lambda: S.rush_bot_plain(penv, wr, rs, 1),
        nbytes(rs.utype, rs.owner, rs.busy, rs.terrain, rs.carried, rs.uid,
               rs.resources) + B * H * W * 7 * 4,
        3 * wr.iters * B * H * W * FIELD_OPS, INT32_OPS_PER_S)
    # event_jump (fast_forward's gated step, capped): utype, owner, busy,
    # aticks, time, done and t_end in; aticks, time and take out
    jd = torch.rand(B, generator=gen, device=dev) < 0.1
    jte = st2.time + 30
    timing["event_jump"] = (
        lambda: KN.EVENT_JUMP(st2, jte, 512, jd),
        lambda: PO.event_jump_plain(penv, st2, jte, 512, jd),
        nbytes(st2.utype, st2.owner, st2.busy, st2.aticks, st2.time, jd, jte,
               st2.aticks, st2.time) + B)
    # evaluate (simple_sqrt_eval3, the search bots' default): utype, owner,
    # hp, carried, the resources and the players in, one float out
    timing["evaluate"] = (
        lambda: KN.EVALUATE(cfg, "sqrt3", st, lane_player),
        lambda: EV.simple_sqrt_eval3(st, lane_player, cfg, plain=True),
        nbytes(st.utype, st.owner, st.hp, st.carried, st.resources,
               lane_player) + 4 * B)
    # arm_sample (egreedy, B=1024): what the function needs of this
    # record: every cell's can-act flag in and its arm and action out;
    # only for the cells that can act, the rest of the mask row that the
    # legality reads (channels 7..), the Gumbels, tvis at the legal arms
    # and tacc at the legal visited ones; per game cur, the player and
    # nvis at cur
    ar = arm_rec
    HW = H * W
    la = AR.arm_masks_packed(asp, ar["mask"])
    trow = ar["tables"][0][torch.arange(B, device=dev), ar["cur"]]
    n_act = int(la.any(-1).sum())
    arm_bytes = (B * 12 + B * HW * (4 + 32)
                 + n_act * 4 * (ar["mask"].shape[-1] - 7 + NA)
                 + 4 * int(la.sum()) + 4 * int((la & (trow != 0)).sum()))
    del la, trow
    timing["arm_sample"] = (
        lambda: AR.arm_sample(asp, ar["mask"], ar["gum"], "egreedy",
                              ar["tables"], ar["cur"], lane_pl, 0, 0.3,
                              TS._f32(0.7), 0.05),
        lambda: AR.arm_sample(asp, ar["mask"], ar["gum"], "egreedy",
                              ar["tables"], ar["cur"], lane_pl, 0, 0.3,
                              TS._f32(0.7), 0.05, plain=True),
        arm_bytes)
    timing["arms_to_action"] = (
        lambda: AR.arms_to_action(asp, ar["arms"]),
        lambda: AR.arms_to_action_plain(asp, ar["arms"]),
        B * HW * (4 + 28))
    # mcts_descend (a NaiveMCTS step of 16 games, repeated on one copy of
    # the tree): the sampled arms, the compared child planes, the expanded
    # state read and written into its row, the edge planes, the next
    # node's and the leaf's state copies where this step's data makes them
    tree, w, a = snaps["mcts_descend"][len(snaps["mcts_descend"]) // 2]
    Bt = w.cur.shape[0]
    rows = torch.arange(Bt, device=dev)
    nch = int(tree.nchild[rows, w.cur].sum())
    pt, pw = clone_tree(tree), clone_walk(w)
    TS.mcts_descend(penv, pt, pw, *a)
    copies = int((pw.cur != w.cur).sum() + (pw.found & ~w.found).sum())
    sbytes = nbytes(*[getattr(a[1], f) for f in FIELD_DTYPES]) // Bt
    descend_bytes = (Bt * HW * (4 + 2) + nch * HW
                     + Bt * 2 * sbytes + copies * 2 * sbytes)
    kt, kw_ = clone_tree(tree), clone_walk(w)
    pt, pw = clone_tree(tree), clone_walk(w)
    timing["mcts_descend"] = (
        lambda kt=kt, kw_=kw_, a=a: TS.mcts_descend(kenv, kt, kw_, *a),
        lambda pt=pt, pw=pw, a=a: TS.mcts_descend(penv, pt, pw, *a),
        descend_bytes)
    # mcts_backprop (NaiveMCTS, 16 games): the path and its edge planes in,
    # tacc and tvis read and written at every edge arm, node statistics
    btree, bw, ba = snaps["mcts_backprop"][-1]
    edges = int((bw.edge >= 0).sum())
    bt, bw2 = clone_tree(btree), clone_walk(bw)
    ptb, pwb = clone_tree(btree), clone_walk(bw)
    timing["mcts_backprop"] = (
        lambda bt=bt, bw2=bw2, ba=ba: TS.mcts_backprop(kenv, bt, bw2, *ba),
        lambda ptb=ptb, pwb=pwb, ba=ba: TS.mcts_backprop(penv, ptb, pwb,
                                                         *ba),
        nbytes(bw.path, bw.edge, bw.plen, bw.leaf, ba[0]) + edges * 16
        + 2 * Bt * (bw.path.shape[1] + 1) * 8)
    # enum_next (the first draw from init of player 0 on a rush record,
    # every lane active; each call on its own copy of the odometer): an
    # active lane reads its digits, every cell's first legal-arm word and
    # the acting cells' other words, the claim flags, spend and balance,
    # and writes its digits, arms, valid flag and trip count; ~30 int32
    # operations a cell and trip, over this input's trips
    eod, ectx = EN.make_enumerator(kenv)[0](rs3, 0)
    NW = ectx.la.shape[-1]
    Lc = H * W + 2 * W
    n_act = int(((ectx.la[..., 0] & 1) != 0).sum())
    etrips = EN.make_enumerator(penv)[1](EN.Odometer(
        eod.choice.clone(), eod.more.clone()), ectx)[2]
    enum_bytes = (B * (H * W * 4 * 4 + Lc + 8 + 2 + 4)
                  + n_act * (NW - 1) * 4)
    enum_ops = int(etrips.sum()) * H * W * 30

    def odometers(n):
        return iter([EN.Odometer(eod.choice.clone(), eod.more.clone())
                     for _ in range(n)])
    kods, pods = odometers(403), odometers(2 * PLAIN_REPS + 1)
    kn_t, pn_t = EN.make_enumerator(kenv)[1], EN.make_enumerator(penv)[1]
    timing["enum_next"] = (lambda: kn_t(next(kods), ectx),
                           lambda: pn_t(next(pods), ectx),
                           enum_bytes, enum_ops, INT32_OPS_PER_S)
    # minimax_step (the snapshot with the most pushes; each call on its
    # own copy of the stack): pops read a few scalars and copy the state
    # of the new top into the lane's state; pushes read the child's state
    # (and its mover's mask: channel 0, the whole row where a cell can
    # act), write it twice and write the packed legal arms, digits, drawn
    # arms, claim flags and ~12 scalars; other live lanes count the trip
    mstk, mtrip, mmaxp = max(msnaps, key=lambda x: int(x[1].push.sum()))
    Bm = mstk.sp.shape[0]
    HW = H * W
    plane_b = sum(getattr(mstk.cur, f)[0].numel()
                  * getattr(mstk.cur, f).element_size()
                  for f in FIELD_DTYPES)
    mpop = mtrip.live & mtrip.finish
    mpush = mtrip.push
    mtop = mstk.sp.long()
    rows = torch.arange(Bm, device=dev)
    hits = int((mpop & (mtop == 1)).sum())
    firsts = int((mpush & (mtop == 0) & ~mstk.root_set).sum())
    n_can = (int(((mtrip.mask2[..., 0] != 0)
                  & mpush[:, None, None]).sum())
             if mtrip.mask2 is not None else 0)
    M = 23 + cfg.num_types + asp.diam ** 2
    mm_bytes = (Bm * 7 + int(mpop.sum()) * (48 + 2 * plane_b)
                + hits * HW * 8
                + int(mpush.sum()) * (3 * plane_b + HW * 4 * (NW + 4) + Lc
                                      + 48)
                + n_can * (M - 1) * 4 + firsts * HW * 4
                + int((mtrip.live & ~mtrip.finish & ~mpush).sum()) * 8)
    kst_pool = iter([mstk.clone() for _ in range(403)])
    pst_pool = iter([mstk.clone() for _ in range(2 * PLAIN_REPS + 1)])
    timing["minimax_step"] = (
        lambda: MM.minimax_step(kenv, next(kst_pool), mtrip, mmaxp),
        lambda: MM.minimax_step(penv, next(pst_pool), mtrip, mmaxp),
        mm_bytes)
    # issue (player 1's issue of the PO record with the most conflicts):
    # the board and assignment planes, the scalars and the candidates in;
    # busy, the assignment planes, order_ctr and cancel_ctr out
    ri = max(po_records, key=lambda r: sum(r["cnt"].values()))
    is1, ic1 = ri["s1"], ri["c1"]
    assign = ("busy", "atype", "aparam", "atx", "aty", "aptype", "aticks",
              "aorder", "atime")
    iout = KN.ISSUE(cfg, is1, ic1)
    timing["issue"] = (
        lambda: KN.ISSUE(cfg, is1, ic1),
        lambda: peng.issue_plain(is1, ic1),
        nbytes(*[getattr(is1, f) for f in ("utype", "owner", "terrain",
                                           "carried", "time", "resources",
                                           "order_ctr", "cancel_ctr")
                 + assign],
               *[getattr(ic1, f) for f in Candidates.FIELDS],
               *[getattr(iout, f) for f in assign + ("order_ctr",
                                                     "cancel_ctr")]))
    # po_state (player 0, that record's state): the 14 unit planes in; the
    # view's 14 planes and the visibility out
    po_s = ri["s"]
    unit_planes = tuple(fog.VIEW_FILL) + ("busy",)
    kview, kvis = KN.PO_STATE(cfg, po_s, 0)
    timing["po_state"] = (
        lambda: KN.PO_STATE(cfg, po_s, 0),
        lambda: fog.po_state_plain(po_s, 0, cfg),
        nbytes(*[getattr(po_s, f) for f in unit_planes],
               *[getattr(kview, f) for f in unit_planes], kvis))
    # obs_po (both players, as the PO step writes them): utype, owner, hp,
    # carried, busy, atype, terrain in; 2 x 8 int32 planes out
    kobs_po = KN.OBS_PO(cfg, po_s, (0, 1))[0]
    timing["obs_po"] = (
        lambda: KN.OBS_PO(cfg, po_s, (0, 1)),
        lambda: [fog.observation_po_plain(po_s, p, cfg) for p in (0, 1)],
        nbytes(*[getattr(po_s, f) for f in ("utype", "owner", "hp",
                                            "carried", "busy", "atype",
                                            "terrain")], kobs_po))
    # believe_update (BS3, player 0, the last PO record, memories of the
    # one before): the view's utype, owner, hp and uid, the terrain and
    # the visibility, the previous view's nine planes the rules read and
    # the memory in; the memory and the world's four planes out
    bb = BS.believe_state_bot(kenv, echo, level=3)
    pbb = BS.believe_state_bot(penv, echo, level=3)
    bs_prev, bs_now = po_records[-2]["s"], po_records[-1]["s"]
    bmem = bb.init(bs_prev, 0)
    bview, bvis = KN.PO_STATE(cfg, bs_now, 0)
    bsp = BS.spiral_offsets(6)
    bprod = BS.producers(cfg)
    bout, bworld = KN.BELIEVE(cfg, 3, bsp, bprod, bs_now, bview, bvis, 0,
                              bmem)
    timing["believe_update"] = (
        lambda: KN.BELIEVE(cfg, 3, bsp, bprod, bs_now, bview, bvis, 0,
                           bmem),
        lambda: (lambda m: (m, BS.sample_world_plain(bs_now, bview, m, 0)))(
            BS.believe_update_plain(bmem, bs_now, bview, bvis, 0, cfg, 3,
                                    bsp)),
        nbytes(bs_now.terrain, bvis, *[getattr(bview, f) for f in (
            "utype", "owner", "hp", "uid")],
            *[getattr(bmem.prev, f) for f in (
                "utype", "owner", "hp", "uid", "busy", "atype", "aparam",
                "atx", "aty")],
            *mem_tensors(bmem), *bout.values(), *bworld.values()))
    # slice 10 (player 1 on the last full rush record): distance_fields
    # (the three fields: the sources and the passable plane in, the int32
    # fields out; 3 x (H+W) sweeps x FIELD_OPS a cell), descend_direction
    # (a field and the free sides in, the directions out), distance_field2
    # (two planes in, four out; FIELD2_OPS a cell and sweep) and its
    # descent (three planes, the free sides and the ids in), expert_macro
    # (six state planes, the pick uniforms, the role tables in and out,
    # the actions out; five fields inside), expert_detailed (five state
    # planes, the logits and the noise in, the actions out), range_cover
    # (the types and the mask in, the cover out; COVER_OPS an offset) and
    # dsl_target (Weakest: three state planes in, the index and the flag
    # out; TARGET_OPS an offset)
    xs_ = rush_records[-2]
    cells = B * H * W
    xt = (xs_.utype.long() - 1).clamp(0, cfg.num_types - 1)
    xpas = (xs_.terrain == 0) & (xs_.utype == 0)
    xfree = torch.stack([pull(xpas, d, False) for d in range(4)], -1)
    xmine = (xs_.utype > 0) & (xs_.owner == 1)
    xen = (xs_.utype > 0) & (xs_.owner == 0)
    xsrc = torch.stack([xen, (xs_.utype > 0) & peng.lut(
        "is_resource", dev)[xt], xmine & peng.lut("is_stockpile", dev)[xt]],
        1)
    xd0 = KN.DISTANCE_FIELDS(xsrc, xpas, H + W)[:, 0].contiguous()
    xst = KN.DISTANCE_FIELD2(xmine, xpas, H + W)
    xflat = (torch.arange(H * W, device=dev, dtype=torch.int32)
             .reshape(H, W).expand(B, H, W).contiguous())
    xroles = x_roles[1]
    xmac = torch.multinomial(xp.action_mask(xs_, xroles, 1).float(), 1,
                             generator=gen)[:, 0].int()
    xnz = ExpertNoise.draw(gen, B, kenv)
    xtl = torch.randn((B, cfg.num_types), generator=gen, device=dev)
    xml = torch.randn((B, H, W), generator=gen, device=dev)
    xdn = DetailedNoise.draw(gen, B, kenv)
    planes6 = [getattr(xs_, f) for f in ("utype", "owner", "busy", "terrain",
                                          "uid", "carried")]
    role_b = nbytes(*[getattr(xroles, f) for f in ExpertRoles.FIELDS])
    timing["distance_fields"] = (
        lambda: KN.DISTANCE_FIELDS(xsrc, xpas, H + W),
        lambda: FLD.distance_fields_plain(xsrc, xpas, H + W),
        nbytes(xsrc, xpas) + 3 * 4 * cells, 3 * (H + W) * FIELD_OPS * cells,
        INT32_OPS_PER_S)
    timing["descend_direction"] = (
        lambda: KN.DESCEND(xd0, xfree),
        lambda: FLD.descend_direction_plain(xd0, xfree),
        nbytes(xd0, xfree) + 4 * cells)
    timing["distance_field2"] = (
        lambda: KN.DISTANCE_FIELD2(xmine, xpas, H + W),
        lambda: FLD.distance_field2_plain(xmine, xpas, H + W),
        nbytes(xmine, xpas) + 4 * 4 * cells, (H + W) * FIELD2_OPS * cells,
        INT32_OPS_PER_S)
    timing["descend_direction_excluding"] = (
        lambda: KN.DESCEND_EXCLUDING(xst, xfree, xflat),
        lambda: FLD.descend_direction_excluding_plain(xst, xfree, xflat),
        nbytes(*xst[:3], xfree, xflat) + 4 * cells)
    timing["expert_macro"] = (
        lambda: KN.EXPERT_MACRO(kenv.cfg, xs_, xroles, 1, xmac, xnz, scan),
        lambda: xp.macro_to_gridnet_plain(xs_, xroles, 1, xmac, xnz),
        nbytes(*planes6, xmac, *xnz) + 2 * role_b + 28 * cells,
        5 * (H + W) * FIELD_OPS * cells, INT32_OPS_PER_S)
    timing["expert_detailed"] = (
        lambda: KN.EXPERT_DETAILED(cfg, xs_, 1, xtl, xml, xdn),
        lambda: detailed_to_gridnet_plain(xp, xs_, 1, xtl, xml, xdn),
        nbytes(*planes6[:4], xs_.carried, xtl, xml, *xdn) + 28 * cells)
    timing["range_cover"] = (
        lambda: KN.RANGE_COVER(cfg, xs_, xmine),
        lambda: DSL.range_cover_plain(xmine, peng.lut("attack_range", dev)[
            xt], cfg.max_range),
        nbytes(xs_.utype, xmine) + cells, len(scan) * COVER_OPS * cells,
        INT32_OPS_PER_S)
    timing["dsl_target"] = (
        lambda: KN.DSL_TARGET(cfg, xs_, 1, 2, None, scan),
        lambda: DSL.dsl_target_plain(
            2, xen, xs_.hp, peng.lut("max_damage", dev)[xt],
            peng.lut("attack_range", dev)[xt], cfg.max_range),
        nbytes(xs_.utype, xs_.owner, xs_.hp) + 5 * cells,
        len(scan) * TARGET_OPS * cells, INT32_OPS_PER_S)
    # slice 11 on the last full rush record, the per-lane players.  What
    # every mode needs: the state planes read, every cell's can-act flag,
    # the acting cells' other mask channels (the legal arms and types) and
    # the model's tables; the logits and the prior write a float a cell and
    # arm, the draws read the acting cells' Gumbels and write the arms and
    # actions (32 B a cell)
    ls_ = rush_records[-2]
    smask = penv.masks_plain(ls_, lane_pl)
    sla = AR.arm_masks_packed(asp, smask)
    l_act = int(sla.any(-1).sum())
    l_rows = 4 * cells + 4 * l_act * (smask.shape[-1] - 1)
    lgum = gumbel_noise((B, H, W, NA), gen, dev)
    aim_in = (nbytes(ls_.utype, ls_.owner, ls_.terrain, ls_.carried,
                     ls_.busy, ls_.atype, ls_.aparam, lane_pl) + l_rows
              + nbytes(aim.log_prior, aim.cpd_cat, aim.log_tf, aim.nf_base,
                       aim.calibration, aim.arm_type))
    nb_in = (nbytes(ls_.utype, ls_.owner, ls_.terrain, ls_.carried, lane_pl)
             + l_rows + nbytes(nbt.log_prior, nbt.logc))
    timing["aim_predict"] = (
        lambda: PT.aim_predict(aim, ls_, smask, lane_pl, "prior"),
        lambda: PT.aim_predict(aim, ls_, smask, lane_pl, "prior",
                               plain=True),
        aim_in + 4 * NA * cells)
    timing["nb_predict"] = (
        lambda: NB.nb_predict(nbt, cfg, asp, ls_, smask, lane_pl, "sample",
                              lgum),
        lambda: NB.nb_predict(nbt, cfg, asp, ls_, smask, lane_pl, "sample",
                              lgum, plain=True),
        nb_in + 4 * NA * l_act + 32 * cells)
    # cooperative_act: the planes, the stocks, the idle own units' rows of
    # the nets (HW + T + 1 floats) in, the actions out; or the base
    # field's H + W sweeps of FIELD_OPS a cell
    lnets = CO.cooperative_nets(kenv, ls_, lane_pl, coop_k.genomes,
                                coop_k.dims, 4)
    l_idle = int(((ls_.utype > 0) & (ls_.owner == lane_pl[:, None, None])
                  & ~ls_.busy).sum())
    timing["cooperative_act"] = (
        lambda: KN.COOPERATIVE_ACT(cfg, ls_, lane_pl, lnets),
        lambda: CO.cooperative_act_plain(penv, ls_, lane_pl, lnets),
        nbytes(ls_.utype, ls_.owner, ls_.terrain, ls_.busy, ls_.carried,
               ls_.resources, lane_pl) + 4 * l_idle * lnets.shape[-1]
        + 28 * cells, (H + W) * FIELD_OPS * cells, INT32_OPS_PER_S)
    del kview, kvis, kobs_po, iout
    assert A == lg.shape[-1]
    times = {}
    print("    device time per call (queued; host-paced in brackets):")
    for name, (kfn, pfn, byts, *ops) in timing.items():
        kms, kpaced = cuda_ms(kfn, n=200)
        pms, ppaced = cuda_ms(pfn, n=PLAIN_REPS, warm=1)
        bound = byts / HBM_BYTES_PER_S * 1e3
        op_bound = ops[0] / ops[1] * 1e3 if ops else 0.0
        by = "operations" if op_bound > bound else "bytes"
        times[name] = (kms, pms, max(bound, op_bound), byts, by)
        print(f"    {name:18s} kernel {kms * 1e3:8.2f} ({kpaced * 1e3:8.2f}) "
              f"us  plain {pms * 1e3:9.2f} ({ppaced * 1e3:9.2f}) us  bound "
              f"{max(bound, op_bound) * 1e3:6.2f} us by {by} "
              f"({byts / 1e6:.2f} MB)", flush=True)
    del lg, lmask, lact, plg, plp, pent, pobj, xdn
    timing.clear()   # the timed copies of odometers and stacks
    # the slice-9 variants of two kernels beside their v2 figures above:
    # cycle under UTT v3 (the uniforms read too), the epilogue with the
    # eight rewards (two more floats a player out)
    u01 = torch.rand((B, H, W), generator=gen, device=dev)
    epi8 = KN.EPILOGUE(k3env.cfg, r["post"], st, r["c0"], r["c1"],
                       r["steps"], MAX_STEPS, done_copies=2)
    variants = {
        ("cycle", "utt_v3"): (
            lambda: KN.CYCLE(cfg3, st2, None, u01),
            lambda: peng3.cycle_plain(st2, None, u01),
            times["cycle"][3] + nbytes(u01)),
        ("epilogue", "eight_rewards"): (
            lambda: KN.EPILOGUE(k3env.cfg, r["post"], st, r["c0"], r["c1"],
                                r["steps"], MAX_STEPS, done_copies=2),
            lambda: (p3env.rewards_plain(st, r["c0"], r["c1"], r["post"]),
                     p3env.dones_plain(r["post"])),
            times["epilogue"][3] + nbytes(epi8[0]) - nbytes(epi_out[0]))}
    # the other modes of the slice-11 kernels
    for mode, out_b in (("logits", 4 * NA * cells),
                        ("sample", 4 * NA * l_act + 32 * cells),
                        ("greedy", 32 * cells)):
        gg = lgum if mode == "sample" else None
        variants[("aim_predict", mode)] = (
            lambda m=mode, g=gg: PT.aim_predict(aim, ls_, smask, lane_pl, m,
                                                g),
            lambda m=mode, g=gg: PT.aim_predict(aim, ls_, smask, lane_pl, m,
                                                g, plain=True),
            aim_in + out_b)
    for mode, out_b in (("logits", 4 * NA * cells), ("greedy", 32 * cells)):
        variants[("nb_predict", mode)] = (
            lambda m=mode: NB.nb_predict(nbt, cfg, asp, ls_, smask, lane_pl,
                                         m),
            lambda m=mode: NB.nb_predict(nbt, cfg, asp, ls_, smask, lane_pl,
                                         m, plain=True),
            nb_in + out_b)
    # arm_sample informed (InformedNaiveMCTS's descent): egreedy's needs
    # of the arm record plus the prior at the acting cells' legal arms
    ar_pri = torch.rand(ar["gum"].shape, generator=gen, device=dev)
    ar_la = int(AR.arm_masks_packed(asp, ar["mask"]).sum())
    variants[("arm_sample", "informed")] = (
        lambda: AR.arm_sample(asp, ar["mask"], ar["gum"], "informed",
                              ar["tables"], ar["cur"], lane_pl, 0, 0.3,
                              TS._f32(0.7), 0.05, ar_pri),
        lambda: AR.arm_sample(asp, ar["mask"], ar["gum"], "informed",
                              ar["tables"], ar["cur"], lane_pl, 0, 0.3,
                              TS._f32(0.7), 0.05, ar_pri, plain=True),
        arm_bytes + 4 * ar_la)
    variant_times = {}
    for (name, var), (kfn, pfn, byts) in variants.items():
        kms, kpaced = cuda_ms(kfn, n=200)
        pms, ppaced = cuda_ms(pfn, n=PLAIN_REPS, warm=1)
        bound = byts / HBM_BYTES_PER_S * 1e3
        variant_times.setdefault(name, {})[var] = dict(
            ms=kms, plain_ms=pms, bound_ms=bound, bound_by="bytes")
        print(f"    {name + ' ' + var:18s} kernel {kms * 1e3:8.2f} "
              f"({kpaced * 1e3:8.2f}) us  plain {pms * 1e3:9.2f} "
              f"({ppaced * 1e3:9.2f}) us  bound {bound * 1e3:6.2f} us by "
              f"bytes ({byts / 1e6:.2f} MB)", flush=True)
    del variants, lnets, lgum, ar_pri

    lap("[4] the timings")
    # ---- [5] the main path through the kernels, next to the plain path
    kvec = VecGridnetEnv(kenv, B, max_steps=MAX_STEPS)
    pvec = VecGridnetEnv(penv, B, max_steps=MAX_STEPS)
    gen.manual_seed(1)
    steps0 = torch.randint(0, MAX_STEPS, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    ks, ksteps = realistic.clone(), steps0.clone()
    ps, psteps = realistic.clone(), steps0.clone()
    resets = 0
    t0 = time.perf_counter()
    KN.reset_counts()
    for t in range(MAIN_TICKS):
        u0, u1 = uniforms()
        ka0, ka1 = kbot(ks, 0, u0), kbot(ks, 1, u1)
        ks, ksteps, kobs, krew, kdn, krm = kvec.step(ks, ksteps, ka0, ka1)
        pa0, pa1 = pbot(ps, 0, u0), pbot(ps, 1, u1)
        ps, psteps, pobs, prew, pdn, prm = pvec.step(ps, psteps, pa0, pa1)
        expect_equal(f"main path tick {t}", state_pairs(ks, ps) + [
            ("actions p0", ka0, pa0), ("actions p1", ka1, pa1),
            ("steps", ksteps, psteps), ("obs", kobs, pobs),
            ("rewards", krew, prew), ("dones", kdn, pdn),
            ("reset_mask", krm, prm)])
        resets += int(krm.sum())
    counts = KN.counts()
    torch.cuda.synchronize()
    want = dict(actor=2, decode=2, issue_env=2, cycle=1, epilogue=1,
                splice_obs=1, policy_sample=0, policy_logprob_fwd=0,
                policy_logprob_bwd=0, rush=0, event_jump=0, evaluate=0,
                arm_sample=0, arms_to_action=0, mcts_descend=0,
                mcts_backprop=0, enum_next=0, minimax_step=0, issue=0,
                po_state=0, obs_po=0, mcts_reroot=0, believe_update=0,
                env_health=0, distance_fields=0, descend_direction=0,
                distance_field2=0, descend_direction_excluding=0,
                expert_macro=0, expert_detailed=0, range_cover=0,
                dsl_target=0, aim_predict=0, nb_predict=0,
                cooperative_act=0)
    if counts != {n: w * MAIN_TICKS for n, w in want.items()}:
        raise AssertionError(f"launch counts {counts}, want per step {want}")
    if resets == 0:
        raise AssertionError("no env reset during the main path")
    print(f"[5] slice 1's main path: {MAIN_TICKS} ticks identical to the "
          f"plain path, {resets} env resets, launches {counts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def run(vec, bot, n):
        st, sp = realistic.clone(), steps0.clone()
        for _ in range(3):
            u0, u1 = uniforms()
            st, sp, *_ = vec.step(st, sp, bot(st, 0, u0), bot(st, 1, u1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            u0, u1 = uniforms()
            st, sp, obs, rew, dn, rm = vec.step(st, sp, bot(st, 0, u0),
                                                bot(st, 1, u1))
        torch.cuda.synchronize()
        return B * n / (time.perf_counter() - t0)

    sps = run(kvec, kbot, TIME_TICKS)
    sps_plain = run(pvec, pbot, TIME_TICKS // 4)
    print(f"    slice 1 main path env-steps/s/card: kernels {sps:.1f}, plain "
          f"{sps_plain:.1f} (B={B}, 16x16, {TIME_TICKS} steps; {kind}, "
          f"{smi})", flush=True)

    lap("[5]")
    # ---- [6] the rollout through the kernels, next to the plain path
    t0 = time.perf_counter()
    pcfg = PPOConfig(num_envs=B, rollout_len=1, max_steps=MAX_STEPS)
    trainers = []
    for env in (kenv, penv):
        tr = PPOTrainer(env, pcfg, opponent=random_opponent(env, BIAS),
                        model=GridnetPolicy(space, 20 + cfg.num_types))
        tr.model.load_state_dict(net.state_dict())
        trainers.append(tr)
    ktr, ptr = trainers
    kts, pts = ktr.init(seed=None), ptr.init(seed=None)
    kts.env_states, kts.env_steps = realistic.clone(), steps0.clone()
    pts.env_states, pts.env_steps = realistic.clone(), steps0.clone()
    ngen = torch.Generator(device=dev)
    roll_resets = 0
    KN.reset_counts()
    for t in range(ROLL_STEPS):
        ngen.manual_seed(100 + t)
        nz = ktr.draw_noise(ngen)
        kts, ktj, klast, kwins = ktr._rollout(kts, noise=lambda _: nz)
        pts, ptj, plast, pwins = ptr._rollout(pts, noise=lambda _: nz)
        expect_equal(f"rollout step {t}", state_pairs(
            kts.env_states, pts.env_states) + [
            ("steps", kts.env_steps, pts.env_steps)] + [
            (f, getattr(ktj, f), getattr(ptj, f)) for f in (
                "obs", "mask", "action", "value", "reward", "done")] + [
            ("last value", klast, plast), ("wins", kwins, pwins)])
        expect_close(f"rollout step {t}", [("logprob", ktj.logprob,
                                            ptj.logprob)])
        roll_resets += int(ktj.done.sum())
    roll_counts = KN.counts()
    torch.cuda.synchronize()
    if (any(roll_counts[n] == 0 for n in ROLLOUT_KERNELS)
            or any(v for n, v in roll_counts.items()
                   if n not in ROLLOUT_KERNELS)):
        raise AssertionError(f"the rollout launched {roll_counts}; want "
                             f"each of {ROLLOUT_KERNELS} and no other")
    if roll_resets == 0:
        raise AssertionError("no env reset during the rollout")
    print(f"[6] rollout: {ROLL_STEPS} steps identical to the plain path "
          f"(logprob within {LP_TOL}), {roll_resets} env resets, launches "
          f"{roll_counts} ({time.perf_counter() - t0:.1f} s)", flush=True)

    def roll(tr, n):
        cfg_n = PPOConfig(num_envs=B, rollout_len=n, max_steps=MAX_STEPS)
        tr_n = PPOTrainer(tr.env, cfg_n, opponent=tr.opponent,
                          model=tr.model)
        ts = tr_n.init(seed=None)
        ts.env_states, ts.env_steps = realistic.clone(), steps0.clone()
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        tr_n._rollout(ts, gen=g)            # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = tr_n._rollout(ts, gen=g)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        if not torch.isfinite(out[2]).all() or not torch.isfinite(
                out[1].logprob).all():
            raise AssertionError("non-finite rollout output")
        return B * n / sec

    rsps = roll(ktr, ROLL_TIME_STEPS)
    rsps_plain = roll(ptr, 4)
    print(f"    rollout env-steps/s/card: kernels {rsps:.1f}, plain "
          f"{rsps_plain:.1f} (B={B}, 16x16, bf16 policy 64x4, "
          f"{ROLL_TIME_STEPS} steps; {kind}, {smi})", flush=True)

    lap("[6]")
    # ---- [7] training: PPOTrainer.update through the kernels next to the
    # plain path, from the same mid-game rush state with the same noise;
    # beside them the witness, the plain path with the logits' gradient
    # perturbed by WITNESS_REL (what a rounding-level change of K7b's
    # output does to an update)
    t0 = time.perf_counter()
    ucfg = PPOConfig(num_envs=B, rollout_len=UPDATE_LEN, max_steps=MAX_STEPS)
    net_sd = {k: v.detach().clone() for k, v in net.state_dict().items()}

    def trainer(env, tx_name, dtype=torch.bfloat16, witness=False):
        tx = optim.chain(optim.clip_by_global_norm(ucfg.max_grad_norm),
                         optim.sgd(ucfg.lr) if tx_name == "SGD"
                         else optim.adam(ucfg.lr))
        model = GridnetPolicy(space, 20 + cfg.num_types, dtype=dtype)
        model.load_state_dict(net_sd)
        if witness:
            wgen = torch.Generator(device=dev)
            wgen.manual_seed(13)
            forward = model.forward

            def perturbed(obs):
                logits, value = forward(obs)
                if logits.requires_grad:
                    logits.register_hook(lambda d: d * (1 + WITNESS_REL * (
                        torch.randint(0, 2, d.shape, generator=wgen,
                                      device=dev, dtype=d.dtype) * 2 - 1)))
                return logits, value

            model.forward = perturbed
        return PPOTrainer(env, ucfg, opponent=make_bot("WorkerRush", env),
                          model=model, tx=tx)

    def param_gap(got, ref):
        """How far parameters ``got`` are from ``ref`` (both moved from
        ``net_sd``): (max |diff|, its description)."""
        diff = torch.cat([(got[k] - ref[k]).abs().flatten() for k in ref])
        moved = torch.cat([(ref[k] - net_sd[k]).flatten() for k in ref])
        gmoved = torch.cat([(got[k] - net_sd[k]).flatten() for k in ref])
        gap = float((gmoved - moved).norm() / moved.norm())
        cos = float(torch.dot(gmoved, moved)
                    / (gmoved.norm() * moved.norm()))
        q = torch.quantile(diff[:1 << 24].float(),
                           torch.tensor([0.5, 0.99, 0.999], device=dev))
        return float(diff.max()), gap, (
            f"max |diff| {float(diff.max()):.3g}, quantiles 50/99/99.9% "
            f"{[float(v) for v in q]}, share within 1e-5 "
            f"{float((diff <= 1e-5).float().mean()):.6f}, displacement "
            f"differs by {gap:.3g} of its norm, cosine {cos:.6f}")

    def update_pair(tx_name):
        out = {}
        for name, env in (("kernel", kenv), ("plain", penv),
                          ("witness", penv)):
            tr = trainer(env, tx_name, witness=name == "witness")
            ts = tr.init(seed=None)
            ts.env_states, ts.env_steps = rush_start.clone(), steps0.clone()
            g = torch.Generator(device=dev)
            g.manual_seed(11)
            trajs = []
            roll = tr._rollout
            tr._rollout = (lambda *a, **k:
                           trajs.append(roll(*a, **k)) or trajs[-1])
            KN.reset_counts()
            ts2, m = tr.update(ts, gen=g)
            torch.cuda.synchronize()
            out[name] = (ts2, m, trajs[0], tr.model.state_dict(),
                         KN.counts())
        (kts, km, kroll, kp, kc), (pts, pm, proll, pp, pc) = (
            out["kernel"], out["plain"])
        (_, ktj, klast, kwins), (_, ptj, plast, pwins) = kroll, proll
        expect_equal(f"{tx_name} update rollout", state_pairs(
            kts.env_states, pts.env_states) + [
            ("steps", kts.env_steps, pts.env_steps)] + [
            (f, getattr(ktj, f), getattr(ptj, f)) for f in (
                "obs", "mask", "action", "value", "reward", "done")] + [
            ("last value", klast, plast), ("wins", kwins, pwins)])
        expect_close(f"{tx_name} update rollout",
                     [("logprob", ktj.logprob, ptj.logprob)])
        for k in ("mean_reward", "episodes", "wins"):
            if not torch.equal(km[k], pm[k]):
                raise AssertionError(f"{tx_name} update: {k} {km[k]} vs "
                                     f"plain {pm[k]}")
        tol = SGD_TOL if tx_name == "SGD" else ADAM_TOL
        for k in ("pg_loss", "v_loss", "entropy", "ratio"):
            # pg_loss is a mean of terms of RMS about 1 (the advantages are
            # normalised) that cancel to near 0: held against that scale
            scale = 1.0 if k == "pg_loss" else abs(float(pm[k]))
            err = abs(float(km[k]) - float(pm[k]))
            if not err <= tol["metrics_rtol"] * scale:
                raise AssertionError(f"{tx_name} update: {k} {float(km[k])}"
                                     f" vs plain {float(pm[k])}")
        pmax, gap, detail = param_gap(kp, pp)
        _, wgap, wdetail = param_gap(out["witness"][3], pp)
        if tx_name == "SGD":
            ok = pmax <= tol["params_atol"]
        else:
            ok = gap <= tol["gap_vs_witness"] * wgap
        if not ok or not all(torch.isfinite(v).all() for v in kp.values()):
            raise AssertionError(f"{tx_name} update: parameters differ from "
                                 f"the plain path's: {detail}; witness: "
                                 f"{wdetail}")
        if (any(kc[n] == 0 for n in TRAIN_KERNELS)
                or any(kc[n] for n in kc if n not in TRAIN_KERNELS)
                or any(pc.values())):
            raise AssertionError(f"{tx_name} update launched {kc}, plain "
                                 f"{pc}")
        steps_done = ucfg.epochs * ucfg.minibatches
        want = dict(rush=UPDATE_LEN, policy_logprob_fwd=steps_done,
                    policy_logprob_bwd=steps_done,
                    policy_sample=UPDATE_LEN, epilogue=UPDATE_LEN)
        if any(kc[n] != v for n, v in want.items()):
            raise AssertionError(f"{tx_name} update launched {kc}, want "
                                 f"{want}")
        terms = ("pg_loss", "v_loss", "entropy", "ratio")
        print(f"    {tx_name} update: rollout identical, "
              f"{int(ptj.done.sum())} resets; loss terms "
              f"{ {k: float(km[k]) for k in terms} } (plain "
              f"{[float(pm[k]) for k in terms]}); parameters: {detail}; "
              f"witness (plain, logits' gradient x (1 +- {WITNESS_REL})): "
              f"{wdetail}; launches {kc}", flush=True)
        return kc, ktj, klast

    def adam_step(traj, last):
        """One clip + Adam step on minibatch 0 of ``traj``, fp32 model,
        through the kernels, the plain path and the witness."""
        out = {}
        for name, env in (("kernel", kenv), ("plain", penv),
                          ("witness", penv)):
            tr = trainer(env, "Adam", torch.float32, name == "witness")
            adv_n, ret = tr.advantages(traj, last)
            KN.reset_counts()
            _, _, grads = tr.step(traj, adv_n, ret, 0,
                                  tr.tx.init(tr.params()))
            torch.cuda.synchronize()
            out[name] = ([p.detach() for p in tr.params()], grads,
                         KN.counts())
        pp, pg, pc = out["plain"]
        lr, res = ucfg.lr, {}
        for name in ("kernel", "witness"):
            got, gg, _ = out[name]
            big = torch.cat([(g.abs() > ADAM_TOL["step_grad_min"]).flatten()
                             for g in pg])
            diff = torch.cat([(a - b).abs().flatten()
                              for a, b in zip(got, pp)])
            gdiff = torch.cat([(a - b).abs().flatten()
                               for a, b in zip(gg, pg)])
            res[name] = (float(diff[big].max()) / lr, float(diff.max()) / lr,
                         int((diff[big] > ADAM_TOL["step_atol_lr"] * lr)
                             .sum()), float(gdiff.max()),
                         float(big.float().mean()))
        kc = out["kernel"][2]
        if (kc["policy_logprob_fwd"] != 1 or kc["policy_logprob_bwd"] != 1
                or any(pc.values())):
            raise AssertionError(f"Adam step launched {kc}, plain {pc}")
        text = {n: (f"max |diff| / lr {r[0]:.3g} where |g| > "
                    f"{ADAM_TOL['step_grad_min']} ({r[4]:.4f} of the "
                    f"parameters), {r[1]:.3g} anywhere, {r[2]} beyond "
                    f"{ADAM_TOL['step_atol_lr']} lr; gradients' max |diff| "
                    f"{r[3]:.3g}") for n, r in res.items()}
        kr = res["kernel"]
        if not kr[0] <= ADAM_TOL["step_atol_lr"]:
            raise AssertionError(f"Adam step: parameters differ from the "
                                 f"plain path's: {text['kernel']}")
        print(f"    Adam step (fp32 policy, minibatch 0): {text['kernel']}; "
              f"witness: {text['witness']}", flush=True)

    upd_counts, *_ = update_pair("SGD")
    _, atraj, alast = update_pair("Adam")
    adam_step(atraj, alast)
    print(f"[7] training: two updates (rollout_len {UPDATE_LEN}, "
          f"{ucfg.epochs}x{ucfg.minibatches} minibatches, WorkerRush) and "
          f"an Adam step next to the plain path "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def train_rate(T):
        tcfg = PPOConfig(num_envs=B, rollout_len=T)
        model = GridnetPolicy(space, 20 + cfg.num_types)
        model.load_state_dict(net.state_dict())
        tr = PPOTrainer(kenv, tcfg, opponent=make_bot("WorkerRush", kenv),
                        model=model)
        ts = tr.init(seed=None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            mark = {}

            def ev(name):
                if name == "rollout":
                    torch.cuda.synchronize()
                    mark["rollout"] = time.perf_counter()

            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ts, m = tr.update(ts, ev=ev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if not all(torch.isfinite(v).all() for v in m.values()):
                raise AssertionError(f"non-finite training metrics {m}")
            runs.append((t2 - t1, mark["rollout"] - t1, t2 - mark["rollout"],
                         {k: float(v) for k, v in m.items()}))
        return runs, torch.cuda.max_memory_allocated()

    T = TRAIN_LEN
    while True:
        try:
            runs, peak = train_rate(T)
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"    rollout_len {T} does not fit in device memory",
                  flush=True)
            if T <= UPDATE_LEN:
                raise
            T //= 2
    timed = sorted(runs[1:])
    sec = (timed[0][0] + timed[1][0]) / 2
    roll_s = (timed[0][1] + timed[1][1]) / 2
    learn_s = (timed[0][2] + timed[1][2]) / 2
    train_rate_v2 = B * T / sec
    print(f"    training env-steps/s/card: {B * T / sec:.1f} (B={B}, 16x16, "
          f"rollout_len {T}, 4 epochs x 4 minibatches, WorkerRush, bf16 "
          f"policy 64x4, Adam; median of 2 updates after a warm-up: "
          f"{sec:.3f} s per update = rollout {roll_s:.3f} s + learn "
          f"{learn_s:.3f} s; peak device memory {peak / 2**30:.2f} GiB; "
          f"metrics {runs[-1][3]}; {kind}, {smi})", flush=True)

    lap("[7]")
    # ---- [8] the round robin of six bots on basesWorkers16x16: 30 ordered
    # pairs x 34 games = 1020 lanes of one pool batch through
    # TN.round_robin, the kernel path next to the plain path (same seed) at
    # a short cap, then timed at the default cap.  round_robin and
    # play_matches return winners or a table only: their runner is wrapped
    # (until the end of [10]) to keep each run's winners, final state and
    # frame count
    t0 = time.perf_counter()
    games_fn, games = TN._games_fn, []

    def recording_games_fn(*args, **kw):
        run = games_fn(*args, **kw)

        def recorded(*a, **k):
            out = run(*a, **k)
            games.append(out)
            return out
        return recorded

    TN._games_fn = recording_games_fn

    def rr(env, cycles):
        table = TN.round_robin(env, {n: make_bot(n, env) for n in RR_BOTS},
                               RR_GAMES, cycles, seed=0)
        torch.cuda.synchronize()
        return table, *games.pop()

    def matches(env, bot0, bot1, n_games, cycles, seed, chunk=TN.CHUNK):
        w = TN.play_matches(env, make_bot(bot0, env), make_bot(bot1, env),
                            n_games, cycles, seed=seed, chunk=chunk)
        torch.cuda.synchronize()
        out = games.pop()
        if not (out[0].cpu().numpy() == w).all():
            raise AssertionError("play_matches' winners are not its run's")
        return out

    def same_tables(name, a, b):
        if not all((getattr(a, f) == getattr(b, f)).all()
                   for f in ("wins", "ties", "games")):
            raise AssertionError(f"{name}: the tables differ:\n{a.table()}"
                                 f"\n{b.table()}")

    ii, jj = TN.pairings(len(RR_BOTS), RR_GAMES)
    KN.reset_counts()
    ktab, kw, ks, kframes = rr(kenv, RR_CHECK_CYCLES)
    rr_check_counts = KN.counts()
    ptab, pw, ps, pframes = rr(penv, RR_CHECK_CYCLES)
    expect_equal("round robin", state_pairs(ks, ps) + [("winners", kw, pw)])
    same_tables("round robin", ktab, ptab)
    if (any(rr_check_counts[n] == 0 for n in RR_KERNELS)
            or any(rr_check_counts[n] for n in rr_check_counts
                   if n not in RR_KERNELS)):
        raise AssertionError(f"the round robin launched {rr_check_counts}; "
                             f"want each of {RR_KERNELS} and no other")
    print(f"[8] round robin: {len(ii)} lanes x {RR_CHECK_CYCLES} cycles "
          f"({kframes} frames) identical to the plain path (states, "
          f"winners, table; {lane_ticks(ks)} game ticks); launches "
          f"{rr_check_counts} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    # the round robin's check ends no game: finished games (winners,
    # frozen lanes) are held in a pairing that ends early, on 8x8, capped
    # a little after WorkerRush's first wins
    t1 = time.perf_counter()
    out = [matches(GridnetEnv(asset_path(WIN_CHECK_MAP), device=dev,
                              plain=plain),
                   "RandomBiasedAI", "WorkerRush", WIN_CHECK_GAMES,
                   WIN_CHECK_CYCLES, 3, chunk=32) for plain in (False, True)]
    expect_equal("RandomBiasedAI vs WorkerRush", state_pairs(
        out[0][1], out[1][1]) + [("winners", out[0][0], out[1][0])])
    won = int((out[0][0] >= 0).sum())
    print(f"    RandomBiasedAI vs WorkerRush (play_matches on "
          f"{WIN_CHECK_MAP}): {WIN_CHECK_GAMES} games to {WIN_CHECK_CYCLES} "
          f"cycles "
          f"({out[0][2]} frames) identical to the plain path, {won} won "
          f"(winners {torch.bincount(out[0][0] + 1, minlength=3).tolist()} "
          f"draw/p0/p1; game ends at ticks "
          f"{sorted(set(out[0][1].time.tolist()))[:8]}...) "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    if won == 0:
        raise AssertionError("no game ended in the winners check")
    del out
    KN.reset_counts()
    t1 = time.perf_counter()
    rr_table, rw, rs, rframes = rr(kenv, RR_CYCLES)
    rr_sec = time.perf_counter() - t1
    rr_counts = KN.counts()
    if any(rr_counts[n] == 0 for n in RR_KERNELS):
        raise AssertionError(f"the timed round robin launched {rr_counts}")
    if rr_table.wins.sum() == 0:
        raise AssertionError("no game of the round robin was won")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, _, pws, _ = rr(kenv, RR_PROFILE_CYCLES)
        window = (time.perf_counter() - t1) * 1e6
    busy, kern = device_busy(prof)
    rr_ticks = lane_ticks(rs)
    print(rr_table.table())
    print(f"    round robin game-ticks/s/card: {rr_ticks / rr_sec:.1f} "
          f"({rr_ticks} lane ticks in {rr_sec:.3f} s, {rframes} frames, "
          f"{rframes / rr_sec:.1f} frames/s, max_cycles "
          f"{RR_CYCLES}); device busy {100 * busy / window:.1f}% of a "
          f"profiled {RR_PROFILE_CYCLES}-cycle run (top kernels: "
          f"{[(a.key[:24], round(a.self_device_time_total)) for a in kern[:4]]}"
          f" us); launches {rr_counts}; {kind}, {smi}", flush=True)
    del ks, ps, rs, pws

    lap("[8]")
    # ---- [9] MonteCarlo (K=12, playout_len 48, the JAX defaults) vs
    # WorkerRush: one decision on recorded rush states and short games,
    # the kernel path next to the plain path with the same draws; then
    # decisions timed on the recorded states
    t0 = time.perf_counter()
    mc_state = State(**{f: getattr(rush_records[3], f)[:MC_GAMES]
                        for f in FIELD_DTYPES})
    mc_ticks = []

    def mc_bot(env):
        def scored(s, p):
            mc_ticks.append(s.time)
            return EV.simple_sqrt_eval3(s, p, cfg, plain=env.engine.plain)
        return monte_carlo_bot(env, eval_fn=scored)

    kmc, pmc = mc_bot(kenv), mc_bot(penv)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    nz = kmc.draw(g, MC_GAMES)
    KN.reset_counts()
    ka = kmc(mc_state, 0, nz)
    mc_counts = KN.counts()
    pa = pmc(mc_state, 0, nz)
    expect_equal("MonteCarlo decision", [("actions", ka, pa)])
    if (any(mc_counts[n] == 0 for n in MC_KERNELS)
            or any(mc_counts[n] for n in mc_counts if n not in MC_KERNELS)):
        raise AssertionError(f"a MonteCarlo decision launched {mc_counts}; "
                             f"want each of {MC_KERNELS} and no other")
    out = [matches(env, "MonteCarlo", "WorkerRush", MC_GAMES,
                   MC_CHECK_CYCLES, 22) for env in (kenv, penv)]
    expect_equal("MonteCarlo games", state_pairs(out[0][1], out[1][1])
                 + [("winners", out[0][0], out[1][0])])
    print(f"[9] MonteCarlo: one decision of {MC_GAMES} games (K=12, "
          f"playout_len 48, {MC_GAMES * 12} playout lanes) and "
          f"{MC_CHECK_CYCLES}-cycle games vs WorkerRush ({out[0][2]} "
          f"frames) identical to the plain path; a decision launched "
          f"{mc_counts} ({time.perf_counter() - t0:.1f} s)", flush=True)
    del out
    mc_ticks.clear()
    start = mc_state.time.repeat_interleave(12)
    kmc(mc_state, 0, kmc.draw(g, MC_GAMES))        # warm-up
    mc_ticks.clear()
    draws = [kmc.draw(g, MC_GAMES) for _ in range(MC_TIME_DECISIONS)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for d in draws:
        kmc(mc_state, 0, d)
    torch.cuda.synchronize()
    mc_sec = time.perf_counter() - t1
    play_ticks = sum(int((t - start).sum()) for t in mc_ticks)
    print(f"    MonteCarlo decisions/s/card: "
          f"{MC_GAMES * MC_TIME_DECISIONS / mc_sec:.1f} game-decisions/s "
          f"({MC_TIME_DECISIONS} decisions of {MC_GAMES} games in "
          f"{mc_sec:.3f} s); playout ticks/s/card "
          f"{play_ticks / mc_sec:.1f} ({play_ticks} lane ticks, the first "
          f"tick included); {kind}, {smi}", flush=True)

    lap("[9]")
    # ---- [10] evaluate: the seeded bf16 policy (64x4) vs WorkerRush, the
    # kernel path next to the plain path over short games (same seed), then
    # over 1024 games, timed
    t0 = time.perf_counter()
    etrs = []
    for env in (kenv, penv):
        tr = PPOTrainer(env, PPOConfig(num_envs=B),
                        opponent=make_bot("WorkerRush", env),
                        model=GridnetPolicy(space, 20 + cfg.num_types))
        tr.model.load_state_dict(net.state_dict())
        etrs.append(tr)
    out = []
    for tr in etrs:
        wr = evaluate(tr, tr.opponent, EVAL_CHECK_GAMES, EVAL_CHECK_CYCLES)
        torch.cuda.synchronize()
        out.append((wr, *games.pop()))
    expect_equal("evaluate", state_pairs(out[0][2], out[1][2])
                 + [("winners", out[0][1], out[1][1])])
    if out[0][0] != out[1][0]:
        raise AssertionError(f"evaluate: win-rate {out[0][0]}, plain "
                             f"{out[1][0]}")
    print(f"[10] evaluate: {EVAL_CHECK_GAMES} games to {EVAL_CHECK_CYCLES} "
          f"cycles ({out[0][3]} frames) identical to the plain path "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del out
    etr = etrs[0]
    KN.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wr = evaluate(etr, etr.opponent, EVAL_GAMES)
    torch.cuda.synchronize()
    ev_sec = time.perf_counter() - t1
    ev_counts = KN.counts()
    if not 0.0 <= wr <= 1.0 or ev_counts["policy_sample"] == 0 \
            or ev_counts["event_jump"] == 0:
        raise AssertionError(f"evaluate: win-rate {wr}, launches "
                             f"{ev_counts}")
    print(f"    evaluate: win-rate {wr:.4f} of the seeded bf16 policy vs "
          f"WorkerRush over {EVAL_GAMES} games (max_cycles 2000) in "
          f"{ev_sec:.2f} s; launches {ev_counts}; {kind}, {smi}",
          flush=True)

    lap("[10]")
    # ---- [11] tree search: NaiveMCTS and UCT decisions of 16 recorded
    # rush games at a reduced budget and 16 NaiveMCTS-vs-WorkerRush games
    # to 4 cycles (play_matches), kernel vs plain with the same draws;
    # then, on 64 games, a decision of each at the defaults' tree shapes
    # with short playouts, kernel vs plain, and one at the JAX defaults,
    # timed
    t0 = time.perf_counter()
    for name, make, kw, seed in (
            ("NaiveMCTS", TS.naive_mcts_bot,
             dict(TREE_CHECK, n_playouts=TREE_PLAYOUTS_11), 41),
            ("UCT", TS.uct_tree_bot,
             dict(UCT_CHECK, n_playouts=TREE_PLAYOUTS_11), 42)):
        KN.reset_counts()
        kt, ka = tree_decision(kenv, make, kw, tree_state, seed)
        kc = KN.counts()
        pt, pa = tree_decision(penv, make, kw, tree_state, seed)
        expect_equal(f"{name} decision", tree_pairs(kt, pt)
                     + [("actions", ka, pa)])
        if (any(kc[n] == 0 for n in TREE_KERNELS)
                or any(kc[n] for n in kc if n not in TREE_KERNELS)):
            raise AssertionError(f"a {name} decision launched {kc}; want "
                                 f"each of {TREE_KERNELS} and no other")
        print(f"[11] {name}: one decision of {TREE_GAMES} games ({kw}) "
              f"identical to the plain path: trees (nodes "
              f"{kt.nnodes.tolist()}) and actions; launches {kc} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t1 = time.perf_counter()
    out = []
    for env in (kenv, penv):
        w = TN.play_matches(env, TS.naive_mcts_bot(env, **TREE_GAME),
                            make_bot("WorkerRush", env), TREE_GAMES,
                            TREE_GAME_CYCLES, seed=23)
        torch.cuda.synchronize()
        out.append(games.pop())
        if not (out[-1][0].cpu().numpy() == w).all():
            raise AssertionError("play_matches' winners are not its run's")
    TN._games_fn = games_fn
    expect_equal("NaiveMCTS vs WorkerRush", state_pairs(out[0][1], out[1][1])
                 + [("winners", out[0][0], out[1][0])])
    print(f"    NaiveMCTS ({TREE_GAME}) vs WorkerRush (play_matches): "
          f"{TREE_GAMES} games to {TREE_GAME_CYCLES} cycles ({out[0][2]} "
          f"frames) identical to the plain path "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    del out
    # 64 recorded rush lanes at a decision frame of player 0 (an own idle
    # unit), as the game loop calls a bot
    lanes = [(i, b) for i, rs in enumerate(rush_records[1:-1], 1)
             for b in PO.can_act(rs, 0).nonzero().flatten().tolist()]
    lanes = lanes[::max(1, len(lanes) // TREE_TIME_GAMES)][:TREE_TIME_GAMES]
    big = State(**{f: torch.stack([getattr(rush_records[i], f)[b]
                                   for i, b in lanes])
                   for f in FIELD_DTYPES})
    tree_counts, tree_rates = {}, {}
    for name, make in (("NaiveMCTS", TS.naive_mcts_bot),
                       ("UCT", TS.uct_tree_bot)):
        bot = make_bot(name, kenv)
        n_it = TREE_ITERS
        t1 = time.perf_counter()
        kw = TREE_DEEP[name]
        kt, ka = tree_decision(kenv, make, kw, big, 50)
        pt, pa = tree_decision(penv, make, kw, big, 50)
        expect_equal(f"{name} decision at the defaults' tree shapes",
                     tree_pairs(kt, pt) + [("actions", ka, pa)])
        n1 = kt.nplayer.shape[1]
        kids = (kt.nchild[:, :n1 - 1] if hasattr(kt, "nchild")
                else (kt.achild[:, :n1 - 1] >= 0).sum(-1))
        print(f"    {name}: one decision of {TREE_TIME_GAMES} games at the "
              f"defaults' N, C and D ({kw}) identical to the plain path: "
              f"trees (nodes up to {int(kt.nnodes.max())} of {n1 - 1}, "
              f"depth up to {int(kt.ndepth[:, :n1 - 1].max())}, children "
              f"a node up to {int(kids.max())}) and actions "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        del kt, pt
        g = torch.Generator(device=dev)
        g.manual_seed(51)
        nz = bot.draw(g, TREE_TIME_GAMES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        KN.reset_counts()
        t1 = time.perf_counter()
        act = bot(big, 0, nz)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        tc = KN.counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if (any(tc[n] == 0 for n in TREE_KERNELS)
                or any(tc[n] for n in tc if n not in TREE_KERNELS)):
            raise AssertionError(f"a timed {name} decision launched {tc}")
        if act.shape != (TREE_TIME_GAMES, H, W, 7) or not bool(
                (act[..., 0] > 0).any()):
            raise AssertionError(f"{name}: no unit acts in the decision")
        tree_counts[name], tree_rates[name] = tc, TREE_TIME_GAMES / sec
        print(f"    {name} at the JAX defaults: one decision of "
              f"{TREE_TIME_GAMES} games in {sec:.3f} s: game-decisions/s/card "
              f"{TREE_TIME_GAMES / sec:.2f}, tree iterations/s "
              f"{n_it / sec:.1f} ({n_it * TREE_TIME_GAMES / sec:.1f} "
              f"game-iterations/s); {sum(tc.values())} launches {tc}; peak "
              f"device memory {peak:.2f} GiB ({peak - held:.2f} GiB above "
              f"what the script held before); {kind}, {smi}", flush=True)
    print(f"    [11] took {time.perf_counter() - t0:.1f} s", flush=True)

    lap("[11]")
    # ---- [12] minimax: one decision of each of the six bots on the 16
    # recorded rush games at reduced budgets, kernel vs plain with the
    # same draws; 16 ABCD-vs-WorkerRush games to 4 cycles; then one
    # decision of the 64 timed games at the JAX defaults, timed
    t0 = time.perf_counter()
    mm_phase = {}
    for name, kw in MM_REDUCED.items():
        t1 = time.perf_counter()
        out = []
        for env in (kenv, penv):
            KN.reset_counts()
            out.append(minimax_decision(env, MM, name, kw, tree_state, 44)
                       + (KN.counts(),))
        (ka, kst, kx, kc), (pa, pst, px, pc) = out
        pairs = [("actions", ka, pa)]
        for i, (a, b) in enumerate(zip(kst, pst)):
            pairs += [(f"search {i} {lab}", x, y)
                      for lab, x, y in stack_pairs(a, b)]
        pairs += [(f"value {i}", a, b) for i, (a, b) in enumerate(zip(kx,
                                                                      px))]
        expect_equal(f"{name} decision", pairs)
        path = MM_KERNELS[name]
        want = ("enum_next", "minimax_step") if name != "SampledABCD" else ()
        if (any(kc[n] == 0 for n in want)
                or any(kc[n] for n in kc if n not in path)
                or (name == "SampledABCD" and (kc["enum_next"]
                                               or kc["minimax_step"]))
                or any(pc.values())):
            raise AssertionError(f"a {name} decision launched {kc} (plain "
                                 f"{pc}); want enum_next and minimax_step "
                                 f"but for SampledABCD, and only {path}")
        mm_phase[name] = kc
        trips = [int(t.it.max()) for t in kst]
        print(f"[12] {name}: one decision of {TREE_GAMES} games ({kw}) "
              f"identical to the plain path: stacks (largest trip count "
              f"per search {trips}), values and actions; launches "
              f"{ {n: c for n, c in kc.items() if c} } "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
    t1 = time.perf_counter()
    TN._games_fn = recording_games_fn
    out = []
    for env in (kenv, penv):
        w = TN.play_matches(env, MM.abcd_bot(env, **MM_REDUCED["ABCD"]),
                            make_bot("WorkerRush", env), TREE_GAMES,
                            MM_GAME_CYCLES, seed=29)
        torch.cuda.synchronize()
        out.append(games.pop())
        if not (out[-1][0].cpu().numpy() == w).all():
            raise AssertionError("play_matches' winners are not its run's")
    TN._games_fn = games_fn
    expect_equal("ABCD vs WorkerRush", state_pairs(out[0][1], out[1][1])
                 + [("winners", out[0][0], out[1][0])])
    print(f"    ABCD ({MM_REDUCED['ABCD']}) vs WorkerRush (play_matches): "
          f"{TREE_GAMES} games to {MM_GAME_CYCLES} cycles ({out[0][2]} "
          f"frames) identical to the plain path "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    del out
    for name, kw in MM_DEEP.items():
        t1 = time.perf_counter()
        KN.reset_counts()
        ka, kst, kx = minimax_decision(kenv, MM, name, kw, big, 45)
        kc = KN.counts()
        (pa, pst, px), top = deepest_rows(
            MM, lambda: minimax_decision(penv, MM, name, kw, big, 45))
        pairs = [("actions", ka, pa)]
        for i, (a, b) in enumerate(zip(kst, pst)):
            pairs += [(f"search {i} {lab}", x, y)
                      for lab, x, y in stack_pairs(a, b)]
        pairs += [(f"value {i}", a, b) for i, (a, b) in enumerate(zip(kx,
                                                                      px))]
        expect_equal(f"{name} decision at the defaults' shapes", pairs)
        want = ("enum_next", "minimax_step") if name != "SampledABCD" else ()
        if (any(kc[n] == 0 for n in want)
                or any(kc[n] for n in kc if n not in MM_KERNELS[name])):
            raise AssertionError(f"a {name} decision at the defaults' "
                                 f"shapes launched {kc}")
        shape = ([tuple(st.alpha.shape) for st in kst] if kst
                 else [tuple(x.shape) for x in kx])
        print(f"    {name}: one decision of {TREE_TIME_GAMES} games at the "
              f"defaults' shapes ({kw}) identical to the plain path: stacks "
              f"{shape} (lanes, rows; deepest row used {top}), values and "
              f"actions; launches {kc['enum_next']} enum_next, "
              f"{kc['minimax_step']} minimax_step "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        del kst, pst, kx, px
    mm_counts, mm_rates = {}, {}
    for name in MM_TIMED:
        bot = make_bot(name, kenv)
        g = torch.Generator(device=dev)
        g.manual_seed(52)
        nz = bot.draw(g, TREE_TIME_GAMES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        KN.reset_counts()
        t1 = time.perf_counter()
        act = bot(big, 0, nz)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        tc = KN.counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        path = MM_KERNELS[name]
        if (any(tc[n] for n in tc if n not in path)
                or (name != "SampledABCD"
                    and not (tc["enum_next"] and tc["minimax_step"]))):
            raise AssertionError(f"a timed {name} decision launched {tc}")
        if act.shape != (TREE_TIME_GAMES, H, W, 7) or not bool(
                (act[..., 0] > 0).any()):
            raise AssertionError(f"{name}: no unit acts in the decision")
        mm_counts[name], mm_rates[name] = tc, TREE_TIME_GAMES / sec
        print(f"    {name} at the JAX defaults: one decision of "
              f"{TREE_TIME_GAMES} games in {sec:.3f} s: game-decisions/s/card "
              f"{TREE_TIME_GAMES / sec:.2f}; {sum(tc.values())} launches "
              f"{ {n: c for n, c in tc.items() if c} }; peak device memory "
              f"{peak:.2f} GiB ({peak - held:.2f} GiB above what the script "
              f"held before); {kind}, {smi}", flush=True)
        t2 = time.perf_counter()
        budget = "as timed"
        pbot = bot
        if name in ("ABCD", "RTMinimax"):
            budget = MM_PROFILE_ABCD_BUDGET
            pbot = (MM.abcd_bot if name == "ABCD" else MM.rt_minimax_bot)(
                kenv, node_budget=budget)
        # the card's kernels only: tracing every host operation too would
        # slow the decision and take seconds to read back
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            pbot(big, 0, nz)
            torch.cuda.synchronize()
            window = (time.perf_counter() - t1) * 1e6
        busy, kern = device_busy(prof)
        top = {a.key[:24]: round(a.self_device_time_total) for a in kern[:5]}
        mine = {n: round(sum(a.self_device_time_total for a in kern
                             if a.key.startswith(n + "_kernel")))
                for n in ("enum_next", "minimax_step")}
        print(f"    {name}: device busy {100 * busy / window:.1f}% of a "
              f"profiled decision (node budget "
              f"{budget}; "
              f"{busy:.0f} of {window:.0f} us); enum_next/minimax_step "
              f"device time {mine} us; top kernels {top} us "
              f"({time.perf_counter() - t2:.1f} s)", flush=True)
        del prof, kern
    for name in ("IDABCD", "IDRTMinimax"):
        mm_counts[name] = mm_phase[name]
    print(f"    [12] took {time.perf_counter() - t0:.1f} s", flush=True)

    lap("[12]")
    # ---- [13] the PO main path through the kernels, next to the plain
    # path: from the end of [3]'s PO run with random step counts (resets)
    t0 = time.perf_counter()
    kvec_po = VecGridnetEnv(kpo, B, max_steps=MAX_STEPS)
    pvec_po = VecGridnetEnv(ppo, B, max_steps=MAX_STEPS)
    kpbot = random_bot(kpo, BIAS)
    gen.manual_seed(13)
    steps_po = torch.randint(0, MAX_STEPS, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    ks, ksteps = po_start.clone(), steps_po.clone()
    ps, psteps = po_start.clone(), steps_po.clone()
    resets = hidden = 0
    KN.reset_counts()
    for t in range(PO_MAIN_TICKS):
        u0, u1 = uniforms()
        ka0, ka1 = kpbot(ks, 0, u0), kpbot(ks, 1, u1)
        ks, ksteps, kobs, krew, kdn, krm, koh = kvec_po.step(
            ks, ksteps, ka0, ka1, onehot=(0, 1))
        pa0, pa1 = ppbot(ps, 0, u0), ppbot(ps, 1, u1)
        ps, psteps, pobs, prew, pdn, prm, poh = pvec_po.step(
            ps, psteps, pa0, pa1, onehot=(0, 1))
        expect_equal(f"PO main path tick {t}", state_pairs(ks, ps) + [
            ("actions p0", ka0, pa0), ("actions p1", ka1, pa1),
            ("steps", ksteps, psteps), ("obs", kobs, pobs),
            ("onehot", koh, poh), ("rewards", krew, prew),
            ("dones", kdn, pdn), ("reset_mask", krm, prm)])
        resets += int(krm.sum())
        hidden += int(((kobs[0, :, 3] == 0) & (ks.owner == 1)).sum())
    po_counts = KN.counts()
    torch.cuda.synchronize()
    want = {n: PO_STEP_LAUNCHES.get(n, 0) * PO_MAIN_TICKS for n in po_counts}
    if po_counts != want:
        raise AssertionError(f"PO launch counts {po_counts}, want per step "
                             f"{PO_STEP_LAUNCHES} and no other")
    if kobs.shape != (2, B, 8, H, W) or resets == 0 or hidden == 0:
        raise AssertionError(f"PO main path: obs {tuple(kobs.shape)}, "
                             f"{resets} resets, {hidden} hidden enemies")
    print(f"[13] PO main path: {PO_MAIN_TICKS} ticks identical to the plain "
          f"path (state, 8-plane obs, one-hot of both views, rewards, "
          f"dones), {resets} env resets, {hidden} enemy units hidden from "
          f"player 0; launches per step "
          f"{ {n: c // PO_MAIN_TICKS for n, c in po_counts.items() if c} } "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def run_po(vec, bot, n):
        st, sp = po_start.clone(), steps_po.clone()
        for _ in range(3):
            u0, u1 = uniforms()
            st, sp, *_ = vec.step(st, sp, bot(st, 0, u0), bot(st, 1, u1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            u0, u1 = uniforms()
            st, sp, *_ = vec.step(st, sp, bot(st, 0, u0), bot(st, 1, u1))
        torch.cuda.synchronize()
        return B * n / (time.perf_counter() - t1), st, sp

    po_sps, st, sp = run_po(kvec_po, kpbot, PO_TIME_TICKS)
    po_sps_plain = run_po(pvec_po, ppbot, PO_TIME_TICKS // 8)[0]
    sps_now = run(kvec, kbot, TIME_TICKS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(PO_PROFILE_TICKS):
            u0, u1 = uniforms()
            st, sp, *_ = kvec_po.step(st, sp, kpbot(st, 0, u0),
                                      kpbot(st, 1, u1))
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e6
    busy, kern = device_busy(prof)
    po_top = {a.key[:24]: round(a.self_device_time_total / PO_PROFILE_TICKS,
                                1) for a in kern[:8]}
    print(f"    PO main path env-steps/s/card: kernels {po_sps:.1f}, plain "
          f"{po_sps_plain:.1f}; slice 1's step in the same run "
          f"{sps_now:.1f} ({po_sps / sps_now:.3f}x; B={B}, 16x16, "
          f"{PO_TIME_TICKS} steps); device busy "
          f"{100 * busy / window:.1f}% of a profiled {PO_PROFILE_TICKS}-step "
          f"window ({window / PO_PROFILE_TICKS:.0f} us a step; device us a "
          f"step by kernel {po_top}); {kind}, {smi}", flush=True)
    del prof, kern

    # the PO map pool: a padded 8x8 and 9x8 map in a 16x16 pool, each env
    # reset to its own map
    t1 = time.perf_counter()
    pool_paths = [asset_path(m) for m in POOL_MAPS]
    kpool, ppool = (MapPoolVecEnv(pool_paths, B, max_steps=MAX_STEPS,
                                  partial_obs=True, device=dev, plain=plain)
                    for plain in (False, True))
    kpb, ppb = random_bot(kpool.env, BIAS), random_bot(ppool.env, BIAS)
    ks, _ = kpool.reset()
    ps, _ = ppool.reset()
    ksteps, psteps = steps_po.clone(), steps_po.clone()
    pool_resets = 0
    for t in range(POOL_TICKS):
        u0, u1 = uniforms()
        kout = kpool.step(ks, ksteps, kpb(ks, 0, u0), kpb(ks, 1, u1))
        pout = ppool.step(ps, psteps, ppb(ps, 0, u0), ppb(ps, 1, u1))
        expect_equal(f"PO pool tick {t}", state_pairs(kout[0], pout[0]) + [
            (n, a, b) for n, a, b in zip(
                ("steps", "obs", "rewards", "dones", "reset_mask"),
                kout[1:], pout[1:])])
        (ks, ksteps), (ps, psteps) = kout[:2], pout[:2]
        rows = kout[5].nonzero().flatten()
        pool_resets += rows.numel()
        expect_equal("PO pool reset to the env's own map", [
            (f, getattr(ks, f).index_select(0, rows),
             getattr(kpool.init, f).index_select(0, rows))
            for f in FIELD_DTYPES])
    if pool_resets == 0 or not bool((ks.terrain[2][:, 8:] == 1).all()):
        raise AssertionError(f"PO pool: {pool_resets} resets, or the "
                             f"8x8 map's env is not walled at x >= 8")
    torch.cuda.synchronize()
    print(f"    PO map pool ({len(POOL_MAPS)} maps padded to "
          f"{kpool.h}x{kpool.w}): {POOL_TICKS} ticks identical to the plain "
          f"path, {pool_resets} resets to each env's own map "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    del kpool, ppool

    # the PO rushes in a round robin on the PO env, kernel next to plain,
    # then timed
    t1 = time.perf_counter()
    TN._games_fn = recording_games_fn

    def po_rr(env, cycles):
        table = TN.round_robin(env, {n: make_bot(n, env) for n in PO_RR_BOTS},
                               PO_RR_GAMES, cycles, seed=7)
        torch.cuda.synchronize()
        return table, *games.pop()

    KN.reset_counts()
    ktab, kw, ks, kframes = po_rr(kpo, PO_RR_CHECK_CYCLES)
    po_rr_check = KN.counts()
    ptab, pw, ps, pframes = po_rr(ppo, PO_RR_CHECK_CYCLES)
    expect_equal("PO round robin", state_pairs(ks, ps)
                 + [("winners", kw, pw)])
    same_tables("PO round robin", ktab, ptab)
    if (any(po_rr_check[n] == 0 for n in PO_RR_KERNELS)
            or any(po_rr_check[n] for n in po_rr_check
                   if n not in PO_RR_KERNELS)):
        raise AssertionError(f"the PO round robin launched {po_rr_check}; "
                             f"want each of {PO_RR_KERNELS} and no other")
    print(f"    PO round robin: {len(kw)} lanes x {PO_RR_CHECK_CYCLES} "
          f"cycles ({kframes} frames) identical to the plain path (states, "
          f"winners {torch.bincount(kw + 1, minlength=3).tolist()} "
          f"draw/p0/p1, table); launches {po_rr_check} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    KN.reset_counts()
    t1 = time.perf_counter()
    po_table, pow_, pos_, poframes = po_rr(kpo, PO_RR_CYCLES)
    po_rr_sec = time.perf_counter() - t1
    po_rr_counts = KN.counts()
    TN._games_fn = games_fn
    po_rr_ticks = lane_ticks(pos_)
    print(po_table.table())
    print(f"    PO round robin game-ticks/s/card: "
          f"{po_rr_ticks / po_rr_sec:.1f} ({po_rr_ticks} lane ticks in "
          f"{po_rr_sec:.3f} s, {poframes} frames, max_cycles "
          f"{PO_RR_CYCLES}); launches {po_rr_counts}; {kind}, {smi}",
          flush=True)
    if po_table.wins.sum() == 0:
        raise AssertionError("no game of the PO round robin was won")
    print(f"    [13] took {time.perf_counter() - t0:.1f} s", flush=True)
    del ks, ps, pos_

    lap("[13]")
    # ---- [14] the stateful bots: believe memories along a PO rush run
    # (kernel vs plain), warm decisions of BS3_NaiveMCTS and of
    # ContinuingNaiveMCTS over consecutive frames at the JAX defaults
    # (timed), the stateful match loop kernel vs plain
    t0 = time.perf_counter()
    gen.manual_seed(14)
    # the rushes that march on the enemy (the PO rushes stay home: their
    # round robin is all draws), on the PO env
    kpr = [make_bot(n, kpo) for n in ("WorkerRush", "LightRush")]
    kpbot = random_bot(kpo, BIAS)
    st = kpo.reset(B)
    opening = (RUSH_OPEN * (torch.arange(B, device=dev) % 32))[
        :, None, None, None]
    for t in range(BEL_OPEN):
        u0, u1 = uniforms()
        a0 = torch.where(t < opening, kpbot(st, 0, u0), kpr[0](st, 0))
        a1 = torch.where(t < opening, kpbot(st, 1, u1), kpr[1](st, 1))
        st = kpo.step(st, a0, a1)[0]
    variants = [(lv, p) for lv in (1, 2, 3) for p in (0, 1)]
    bots = {v: [BS.believe_state_bot(e, echo, level=v[0])
                for e in (kenv, penv)] for v in variants}
    mems = {v: [b.init(st, v[1]) for b in bots[v]] for v in variants}
    for v in variants:
        for m in mems[v]:
            m.seen_type[B // 2:] = False
    rules = {v: dict.fromkeys(BS.RULES, 0) for v in variants}
    KN.reset_counts()
    for t in range(BEL_TICKS):
        for v in variants:
            (kb, pb), (km, pm) = bots[v], mems[v]
            km, kwld = kb.update(st, km, v[1])
            pm, pwld = pb.update(st, pm, v[1], rules[v])
            expect_equal(f"believe memory level {v[0]} p{v[1]} tick {t}",
                         mem_pairs(km, pm) + state_pairs(kwld, pwld))
            mems[v] = [km, pm]
        a0, a1 = kpr[0](st, 0), kpr[1](st, 1)
        st = kpo.step(st, a0, a1)[0]
    bel_counts = KN.counts()
    want_rules = {1: ("forgotten",),
                  2: ("remembered", "moved_to_fog", "forgotten_by_uid",
                      "forgotten"),
                  3: ("remembered", "moved_to_fog", "forgotten_by_uid",
                      "inferred", "relocated", "dropped")}
    for lv in (1, 2, 3):
        fired = {n: rules[(lv, 0)][n] + rules[(lv, 1)][n]
                 for n in want_rules[lv]}
        if min(fired.values()) == 0:
            raise AssertionError(f"believe level {lv}: a rule never fired "
                                 f"for either observer: {fired}")
    if bel_counts["believe_update"] != BEL_TICKS * len(variants):
        raise AssertionError(f"believe launches {bel_counts}")
    print(f"[14] believe memories: {B} WorkerRush-vs-LightRush games on the "
          f"PO env, "
          f"memories made after {BEL_OPEN} ticks (seen types cleared in "
          f"half the lanes), {BEL_TICKS} ticks kernel equal to plain "
          f"(memories, worlds) for levels and observers {variants}; rule "
          f"cells {[(v, {n: c for n, c in rules[v].items() if c}) for v in variants]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del bots, mems

    lap("[14] believe memories")
    # timed decisions at the JAX defaults on the 64 recorded games
    seen_reroot = []
    real_reroot = TS.mcts_reroot

    def watched_reroot(env, tree, state, maxp, D, live=None):
        """The re-root, then (the games whose root kept its visits: a
        hit, the nodes kept)."""
        real_reroot(env, tree, state, maxp, D, live)
        seen_reroot.append((tree.nvis[:, 0] > 0, tree.nnodes.clone()))
    stateful_counts = {}
    bs3 = make_bot("BS3_NaiveMCTS", kenv)
    nm = make_bot("NaiveMCTS", kenv)
    g = torch.Generator(device=dev)
    g.manual_seed(61)
    bmem = bs3.init(big, 0)
    bs3.step(big, bmem, 0, bs3.draw(g, TREE_TIME_GAMES))    # warm
    nz = bs3.draw(g, TREE_TIME_GAMES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    # BS3_NaiveMCTS and NaiveMCTS decisions in turn on the same games and
    # noise: one warm decision's time swings by tens of percent between
    # runs, so the ratio is read from medians of pairs in one run
    bs3_secs, nm_secs = [], []
    for i in range(BS3_PAIRS):
        KN.reset_counts()
        t1 = time.perf_counter()
        act, bmem2 = bs3.step(big, bmem, 0, nz)
        torch.cuda.synchronize()
        bs3_secs.append(time.perf_counter() - t1)
        tc = KN.counts()
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / 2**30
        if (tc["believe_update"] != 1 or tc["po_state"] != 1
                or any(tc[n] == 0 for n in TREE_KERNELS)
                or any(tc[n] for n in tc if n not in TREE_KERNELS
                       + ("believe_update", "po_state"))):
            raise AssertionError(f"a BS3_NaiveMCTS decision launched {tc}")
        if act.shape != (TREE_TIME_GAMES, H, W, 7) or not bool(
                (act[..., 0] > 0).any()):
            raise AssertionError("BS3_NaiveMCTS: no unit acts in the "
                                 "decision")
        t1 = time.perf_counter()
        nm(big, 0, nz)
        torch.cuda.synchronize()
        nm_secs.append(time.perf_counter() - t1)
    stateful_counts["BS3"] = tc
    sec, nm_sec = statistics.median(bs3_secs), statistics.median(nm_secs)
    pbs3 = BS.believe_state_bot(
        kenv, TS.naive_mcts_bot(kenv, n_playouts=PROFILE_PLAYOUTS), level=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        pbs3.step(big, bmem, 0, nz)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e6
    busy, kern = device_busy(prof)
    print(f"    BS3_NaiveMCTS at the JAX defaults: {BS3_PAIRS} warm "
          f"decisions of {TREE_TIME_GAMES} games, each followed by a "
          f"NaiveMCTS decision on the same games: seconds BS3 "
          f"{[round(x, 3) for x in bs3_secs]}, NaiveMCTS "
          f"{[round(x, 3) for x in nm_secs]}; game-decisions/s/card "
          f"(median) BS3 {TREE_TIME_GAMES / sec:.2f}, NaiveMCTS "
          f"{TREE_TIME_GAMES / nm_sec:.2f}, BS3/NaiveMCTS rate "
          f"{nm_sec / sec:.3f} (pairs "
          f"{[round(n / b, 3) for b, n in zip(bs3_secs, nm_secs)]}); "
          f"{sum(tc.values())} launches "
          f"{ {n: c for n, c in tc.items() if c} }; peak device memory "
          f"{peak:.2f} GiB ({peak - held:.2f} GiB above what the script held "
          f"before); device busy {100 * busy / window:.1f}% of a profiled "
          f"decision of {PROFILE_PLAYOUTS} iterations ({busy:.0f} of "
          f"{window:.0f} us); {kind}, {smi}", flush=True)
    del prof, kern, bmem, bmem2

    cont = make_bot("ContinuingNaiveMCTS", kenv)
    krush = make_bot("WorkerRush", kenv)
    cmem = cont.init(big, 0)
    cs = big.clone()
    cdone = torch.zeros(TREE_TIME_GAMES, dtype=torch.bool, device=dev)
    TS.mcts_reroot = watched_reroot
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    frame_secs, frame_counts, hit_share, carried = [], [], [], []
    try:
        for frame in range(CONT_FRAMES + 1):
            nz = cont.draw(g, TREE_TIME_GAMES)
            if frame == CONT_FRAMES:
                # the decisions' peak, before the copies below
                peak = torch.cuda.max_memory_allocated() / 2**30
                # the re-root alone, timed on copies of this frame's trees
                rr_state = cs
                copies = [clone_tree(cmem) for _ in range(2 * REROOT_N + 1)]
                pcopies = [clone_tree(cmem) for _ in range(2 * 1 + 1)]
                kit, pit = iter(copies), iter(pcopies)
                D_DEF = cont.base.bot.dims[2]
                to_move = torch.where(PO.can_act(cs, 0), 0, 1).int()
                term = kenv.engine.gameover(cs)
                rr_kms = cuda_ms(lambda: KN.REROOT(
                    cfg, next(kit), rr_state, to_move, term, D_DEF), n=REROOT_N,
                    warm=1)[0]
                rr_pms = cuda_ms(lambda: TS.mcts_reroot_plain(
                    next(pit), rr_state, to_move, term, D_DEF), n=1,
                    warm=1)[0]
                # the kernel against the plain re-root at these shapes:
                # whole trees, row N included
                after = clone_tree(cmem)
                KN.REROOT(cfg, after, rr_state, to_move, term, D_DEF)
                errs["mcts_reroot"] = max(errs["mcts_reroot"], expect_equal(
                    "mcts_reroot at the JAX defaults",
                    tree_pairs(after, pcopies[-1])))
                rr_kept = int(torch.where(after.nvis[:, 0] > 0, after.nnodes,
                                          0).max())
                if rr_kept <= 16:
                    raise AssertionError(
                        f"mcts_reroot at the JAX defaults: no game keeps "
                        f"more than 16 rows ({rr_kept})")
                rr_bytes = reroot_bytes(cmem, after, H * W)
                del copies, pcopies, after
                # the profiled decision
                pcont = TS.naive_mcts_continuing(
                    kenv, n_playouts=PROFILE_PLAYOUTS)
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    pcont.step(cs, cmem, 0, nz)
                    torch.cuda.synchronize()
                    window = (time.perf_counter() - t1) * 1e6
                cbusy, kern = device_busy(prof)
                del prof, kern
                break
            KN.reset_counts()
            t1 = time.perf_counter()
            act, cmem = cont.step(cs, cmem, 0, nz)
            torch.cuda.synchronize()
            frame_secs.append(time.perf_counter() - t1)
            frame_counts.append(KN.counts())
            hit, nn = seen_reroot[-1]
            hit_share.append(float(hit.float().mean()))
            carried.append((float(torch.where(hit, nn, 0).float().mean()),
                            int(nn.max())))
            s2 = kenv.step(cs, act, krush(cs, 1))[0]
            cs, cdone = PO.fast_forward(kenv, s2, cdone)
    finally:
        TS.mcts_reroot = real_reroot
    for fc in frame_counts:
        if (fc["mcts_reroot"] != 1 or any(fc[n] == 0 for n in TREE_KERNELS)
                or any(fc[n] for n in fc if n not in TREE_KERNELS
                       + ("mcts_reroot",))):
            raise AssertionError(f"a ContinuingNaiveMCTS decision launched "
                                 f"{fc}")
    csec = sum(frame_secs[1:]) / len(frame_secs[1:])
    stateful_counts["Continuing"] = frame_counts[-1]
    times["mcts_reroot"] = (rr_kms, rr_pms, rr_bytes / HBM_BYTES_PER_S * 1e3,
                            rr_bytes, "bytes")
    print(f"    ContinuingNaiveMCTS at the JAX defaults vs WorkerRush, "
          f"{TREE_TIME_GAMES} games, {CONT_FRAMES} consecutive decisions "
          f"(the first on fresh trees): seconds "
          f"{[round(x, 3) for x in frame_secs]}, game-decisions/s/card over "
          f"the re-rooted ones {TREE_TIME_GAMES / csec:.2f}; re-root hit "
          f"share {[round(x, 3) for x in hit_share]}, nodes carried (mean "
          f"over hits, max) {carried}; launches of the last "
          f"{ {n: c for n, c in frame_counts[-1].items() if c} }; peak "
          f"device memory of the decisions {peak:.2f} GiB ({peak - held:.2f} "
          f"GiB above what the script held before: one {TREE_TIME_GAMES}-game "
          f"tree is "
          f"{nbytes(cmem.tacc, cmem.tvis) / 2**30:.2f} GiB of tacc/tvis); "
          f"device busy {100 * cbusy / window:.1f}% of a profiled decision "
          f"of {PROFILE_PLAYOUTS} iterations ({cbusy:.0f} of {window:.0f} "
          f"us); mcts_reroot of the last "
          f"frame's trees equal to plain (whole trees, a game keeps up to "
          f"{rr_kept} rows); mcts_reroot alone "
          f"{rr_kms * 1e3:.2f} us (plain {rr_pms * 1e3:.2f} us), bound "
          f"{rr_bytes / HBM_BYTES_PER_S * 1e6:.2f} us by bytes "
          f"({rr_bytes / 1e6:.1f} MB); {kind}, {smi}", flush=True)
    del cmem, cs

    # the stateful match loop, kernel next to plain
    t1 = time.perf_counter()
    loop_counts = {}
    for name, opp in (("BS3_NaiveMCTS", "POWorkerRush"),
                      ("ContinuingNaiveMCTS", "WorkerRush")):
        out = []
        for env in (kenv, penv):
            bot0 = (BS.believe_state_bot(env, TS.naive_mcts_bot(
                env, **TREE_GAME)) if name == "BS3_NaiveMCTS"
                else TS.naive_mcts_continuing(env, **TREE_GAME))
            KN.reset_counts()
            out.append(BS.play_matches_stateful(
                env, bot0, BS.stateless(make_bot(opp, env)), TREE_GAMES,
                STATEFUL_GAME_CYCLES, seed=37) + (KN.counts(),))
        (kw_, ks, kf, kc), (pw, ps, pf, pc) = out
        expect_equal(f"{name} vs {opp} (play_matches_stateful)",
                     state_pairs(ks, ps) + [("winners", kw_, pw)])
        need = ("believe_update",) if name == "BS3_NaiveMCTS" else (
            "mcts_reroot",)
        if kf != pf or any(kc[n] == 0 for n in need) or any(pc.values()):
            raise AssertionError(f"{name}: frames {kf} / {pf}, launches "
                                 f"{kc}, plain {pc}")
        loop_counts[name] = kc
        print(f"    {name} ({TREE_GAME}) vs {opp} (play_matches_stateful): "
              f"{TREE_GAMES} games to {STATEFUL_GAME_CYCLES} cycles ({kf} "
              f"frames) identical to the plain path; launches "
              f"{ {n: c for n, c in kc.items() if c} } "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
    print(f"    [14] took {time.perf_counter() - t0:.1f} s", flush=True)

    lap("[14]")
    # ---- [15] slice 9 at full width: UTT v3, the eight rewards and the
    # quarantine on the vec step (kernel next to plain, then timed beside
    # slice 1's v2 step), a PPO update on that env, a CANCEL_RANDOM PO
    # round robin kernel next to plain, a MonteCarlo decision under v3
    t0 = time.perf_counter()
    k3vec = VecGridnetEnv(k3env, B, max_steps=MAX_STEPS, quarantine=True)
    p3vec = VecGridnetEnv(p3env, B, max_steps=MAX_STEPS, quarantine=True)
    krush3 = (make_bot("WorkerRush", k3env), make_bot("LightRush", k3env))
    prush3 = (make_bot("WorkerRush", p3env), make_bot("LightRush", p3env))
    # the plain env's cycles counted: completing attacks whose drawn
    # damage is above their type's minimum
    drawn = []
    pcycle = peng3.cycle

    def probed(state, active=None, u01=None):
        t = (state.utype.long() - 1).clamp(0, cfg3.num_types - 1)
        lo = peng3.lut("min_damage", dev)[t]
        hi = peng3.lut("max_damage", dev)[t]
        comp = state.busy & (state.aticks <= 1) & (state.atype == ATTACK)
        drawn.append(int((comp & (hi > lo)
                          & ((u01 * (hi - lo + 1)).int() > 0)).sum()))
        return pcycle(state, active, u01)

    peng3.cycle = probed
    gen.manual_seed(15)
    steps3 = torch.randint(0, MAX_STEPS, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    ks, ksteps = rush_start.clone(), steps3.clone()
    ps, psteps = rush_start.clone(), steps3.clone()
    quarantined = closer = resets = 0
    KN.reset_counts()
    for t in range(V3_CHECK_TICKS):
        u01 = k3env.draw_u01(gen, 1, B)
        lane = (37 * t) % B
        if t % V3_FAULT_EVERY == 1:     # a negative stockpile, both paths
            ks.resources[lane, 0] = -1
            ps.resources[lane, 0] = -1
        ka = (krush3[0](ks, 0), krush3[1](ks, 1))
        pa = (prush3[0](ps, 0), prush3[1](ps, 1))
        kout = k3vec.step(ks, ksteps, *ka, u01=u01)
        pout = p3vec.step(ps, psteps, *pa, u01=u01)
        expect_equal(f"v3 quarantined step tick {t}", state_pairs(
            kout[0], pout[0]) + [
            ("actions p0", ka[0], pa[0]), ("actions p1", ka[1], pa[1])] + [
            (n, a, b) for n, a, b in zip(
                ("steps", "obs", "rewards", "dones", "reset_mask"),
                kout[1:], pout[1:])])
        if t % V3_FAULT_EVERY == 1:
            if not (bool(kout[5][lane]) and int(kout[1][lane]) == 0):
                raise AssertionError(f"v3 step tick {t}: the planted lane "
                                     f"{lane} was not quarantined")
            quarantined += 1
        closer += int((kout[3][..., 6:] != 0).sum())
        resets += int(kout[5].sum())
        (ks, ksteps), (ps, psteps) = kout[:2], pout[:2]
    v3_counts = KN.counts()
    torch.cuda.synchronize()
    del peng3.cycle
    want = dict(rush=2, decode=2, issue_env=2, cycle=1, epilogue=1,
                env_health=1, splice_obs=1)
    if v3_counts != {n: want.get(n, 0) * V3_CHECK_TICKS for n in v3_counts}:
        raise AssertionError(f"v3 step launch counts {v3_counts}, want per "
                             f"step {want} and no other")
    if sum(drawn) == 0 or closer == 0 or quarantined == 0:
        raise AssertionError(f"v3 step: {sum(drawn)} attacks above their "
                             f"minimum, {closer} closer rewards non-zero, "
                             f"{quarantined} lanes quarantined")
    print(f"[15] v3 quarantined step (UTT v3, eight rewards, WorkerRush vs "
          f"LightRush from the end of [3]'s rush run): {V3_CHECK_TICKS} "
          f"ticks identical to the plain path; {sum(drawn)} completing "
          f"attacks drawn above their minimum, {closer} closer rewards "
          f"non-zero, {quarantined} planted lanes quarantined and reset, "
          f"{resets} resets; launches per step "
          f"{ {n: c // V3_CHECK_TICKS for n, c in v3_counts.items() if c} } "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def run3(vec, n, draw):
        st, sp = realistic.clone(), steps0.clone()
        bot = random_bot(vec.env, BIAS)

        def step(st, sp):
            u0, u1 = uniforms()
            return vec.step(st, sp, bot(st, 0, u0), bot(st, 1, u1),
                            gen=gen if draw else None)[:2]
        for _ in range(3):
            st, sp = step(st, sp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            st, sp = step(st, sp)
        torch.cuda.synchronize()
        return B * n / (time.perf_counter() - t1)

    rates = {"v2": [], "v3": []}
    for name in ("v2", "v3", "v3", "v2"):
        rates[name].append(run3(kvec if name == "v2" else k3vec,
                                V3_TIME_TICKS, name == "v3"))
    print(f"    v3 quarantined step env-steps/s/card: "
          f"{', '.join(f'{v:.1f}' for v in rates['v3'])}; slice 1's v2 step "
          f"in the same window {', '.join(f'{v:.1f}' for v in rates['v2'])} "
          f"(v2, v3, v3, v2; RandomBiasedAI both sides, B={B}, "
          f"{V3_TIME_TICKS} steps each; v3 draws its damage uniforms from "
          f"the generator; {kind}, {smi})", flush=True)

    t1 = time.perf_counter()
    model = GridnetPolicy(space, 20 + cfg.num_types)
    model.load_state_dict(net.state_dict())
    tr3 = PPOTrainer(k3env, PPOConfig(num_envs=B, rollout_len=T),
                     opponent=make_bot("WorkerRush", k3env), model=model)
    ts3 = tr3.init(seed=None)
    upd3 = []
    for _ in range(V3_UPDATES):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ts3, m3 = tr3.update(ts3)
        torch.cuda.synchronize()
        upd3.append(time.perf_counter() - t2)
        if not all(torch.isfinite(v).all() for v in m3.values()):
            raise AssertionError(f"non-finite v3 training metrics {m3}")
    del tr3, ts3, model
    print(f"    PPOTrainer.update on the v3 env (eight rewards, WorkerRush, "
          f"PPOConfig(num_envs={B}), rollout_len {T}): "
          f"{B * T / upd3[-1]:.1f} env-steps/s/card on the last of "
          f"{V3_UPDATES} updates ({', '.join(f'{x:.3f}' for x in upd3)} s "
          f"each; phase 7's v2 rate {train_rate_v2:.1f}); metrics "
          f"{ {k: round(float(v), 4) for k, v in m3.items()} }; {kind}, "
          f"{smi} ({time.perf_counter() - t1:.1f} s)", flush=True)

    # the CANCEL_RANDOM PO round robin: the coins drawn each frame
    t1 = time.perf_counter()
    kpor = GridnetEnv(asset_path(MAP), UnitTypeTable(2, 2),
                      partial_obs=True, device=dev)
    ppor = GridnetEnv(asset_path(MAP), UnitTypeTable(2, 2),
                      partial_obs=True, device=dev, plain=True)
    TN._games_fn = recording_games_fn
    out = []
    for env in (kpor, ppor):
        KN.reset_counts()
        table = TN.round_robin(env, {n: make_bot(n, env)
                                     for n in RANDOM_RR_BOTS},
                               RANDOM_RR_GAMES, RANDOM_RR_CYCLES, seed=15)
        torch.cuda.synchronize()
        out.append((table, *games.pop(), KN.counts()))
    TN._games_fn = games_fn
    (ktab, kw, ks, kframes, kc), (ptab, pw, ps, _, pc) = out
    expect_equal("CANCEL_RANDOM PO round robin", state_pairs(ks, ps)
                 + [("winners", kw, pw)])
    same_tables("CANCEL_RANDOM PO round robin", ktab, ptab)
    if kc["issue"] == 0 or any(pc.values()):
        raise AssertionError(f"CANCEL_RANDOM PO round robin launched {kc}, "
                             f"plain {pc}")
    print(f"    CANCEL_RANDOM PO round robin ({RANDOM_RR_BOTS}, "
          f"{len(kw)} lanes x {RANDOM_RR_CYCLES} cycles, {kframes} frames): "
          f"identical to the plain path (states, winners, table); launches "
          f"{ {n: c for n, c in kc.items() if c} } "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    del out, ks, ps

    # one MonteCarlo decision at the JAX defaults under v3 on [9]'s games
    t1 = time.perf_counter()
    kmc3, pmc3 = make_bot("MonteCarlo", k3env), make_bot("MonteCarlo",
                                                          p3env)
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    nz = kmc3.draw(g, MC_GAMES)
    KN.reset_counts()
    ka = kmc3(mc_state, 0, nz)
    mc3_counts = KN.counts()
    pa = pmc3(mc_state, 0, nz)
    expect_equal("MonteCarlo decision (UTT v3)", [("actions", ka, pa)])
    if any(mc3_counts[n] == 0 for n in MC_KERNELS):
        raise AssertionError(f"a v3 MonteCarlo decision launched "
                             f"{mc3_counts}")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    kmc3(mc_state, 0, kmc3.draw(g, MC_GAMES))
    torch.cuda.synchronize()
    mc3_sec = time.perf_counter() - t2
    print(f"    MonteCarlo (the JAX defaults) under UTT v3: one decision of "
          f"{MC_GAMES} games identical to the plain path (damage uniforms "
          f"{tuple(nz.u01.shape)}); a warm decision {mc3_sec:.3f} s = "
          f"{MC_GAMES / mc3_sec:.1f} game-decisions/s/card; launches "
          f"{ {n: c for n, c in mc3_counts.items() if c} } "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    print(f"    [15] took {time.perf_counter() - t0:.1f} s", flush=True)

    lap("[15]")
    # ---- [16] slice 10 at full width: the expert macro env (step_vs
    # against WorkerRush, the detailed mode, self-play) and the DSL
    # synthesis (evaluate_population on 1024 lanes, the CLI)
    t0 = time.perf_counter()
    kx, px = ExpertEnv(kenv), ExpertEnv(penv)
    kwr, pwr = make_bot("WorkerRush", kenv), make_bot("WorkerRush", penv)
    gen.manual_seed(16)

    def macros(ex, st, roles, p):
        return torch.multinomial(ex.action_mask(st, roles, p).float(), 1,
                                 generator=gen)[:, 0].int()

    def profiled(fn, n):
        """(device busy share, wall us a tick) of ``n`` calls of fn."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t2 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t2) * 1e6
        busy, _ = device_busy(prof)
        return busy / window, window / n

    # (a) step_vs: macros drawn from the action mask, kernel next to plain
    ks, ps = kenv.reset(B), penv.reset(B)
    kr, pr = ExpertRoles.init(B, dev), ExpertRoles.init(B, dev)
    KN.reset_counts()
    for t in range(EXPERT_CHECK_TICKS):
        mac = macros(kx, ks, kr, 0)
        nz = ExpertNoise.draw(gen, B, kenv)
        ks, kr, krw, kd = kx.step_vs(ks, kr, mac, kwr, nz)
        ps, pr, prw, pd = px.step_vs(ps, pr, mac, pwr, nz)
        expect_equal(f"expert step_vs tick {t}", state_pairs(ks, ps) + [
            (f, getattr(kr, f), getattr(pr, f)) for f in ExpertRoles.FIELDS]
            + [("rewards", krw, prw), ("dones", kd, pd)])
    xv_counts = KN.counts()
    torch.cuda.synchronize()
    want = dict(expert_macro=1, rush=1, decode=2, issue_env=2, cycle=1,
                epilogue=1)
    if xv_counts != {n: want.get(n, 0) * EXPERT_CHECK_TICKS
                     for n in xv_counts}:
        raise AssertionError(f"expert step_vs launch counts {xv_counts}, "
                             f"want per step {want} and no other")
    roles_used = (int(kr.harvester.sum()), int(kr.has_target.sum()))
    if min(roles_used) == 0:
        raise AssertionError(f"expert step_vs roles {roles_used}")
    x_state = {"s": ks, "r": kr}

    def expert_tick():
        st, ro = x_state["s"], x_state["r"]
        mac = macros(kx, st, ro, 0)
        x_state["s"], x_state["r"], _, _ = kx.step_vs(
            st, ro, mac, kwr, ExpertNoise.draw(gen, B, kenv))

    for _ in range(3):
        expert_tick()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for _ in range(EXPERT_TIME_TICKS):
        expert_tick()
    torch.cuda.synchronize()
    x_sps = B * EXPERT_TIME_TICKS / (time.perf_counter() - t1)
    x_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    x_busy, x_us = profiled(expert_tick, EXPERT_PROFILE_TICKS)
    print(f"[16] expert step_vs (macros drawn from the action mask, "
          f"WorkerRush): {EXPERT_CHECK_TICKS} ticks of {B} envs identical "
          f"to the plain path (states, roles {roles_used}, rewards, dones); "
          f"launches per step "
          f"{ {n: c // EXPERT_CHECK_TICKS for n, c in xv_counts.items() if c} }"
          f"; timed {x_sps:.1f} env-steps/s/card (mask and draws included), "
          f"busy {100 * x_busy:.1f}% of a profiled {EXPERT_PROFILE_TICKS}-"
          f"step window ({x_us:.0f} us a step), peak {x_peak:.2f} GiB; "
          f"{kind}, {smi} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # (b) the detailed mode (player 0, seeded logits per env) against
    # WorkerRush through the self-play step, then the self-play macro step
    t1 = time.perf_counter()
    dtl = torch.randn((B, cfg.num_types), generator=gen, device=dev)
    dml = torch.randn((B, H, W), generator=gen, device=dev)
    ks, ps = kenv.reset(B), penv.reset(B)
    KN.reset_counts()
    for t in range(DETAILED_CHECK_TICKS):
        dn = DetailedNoise.draw(gen, B, kenv)
        ka = detailed_to_gridnet(kx, ks, 0, dtl, dml, dn)
        pa = detailed_to_gridnet(px, ps, 0, dtl, dml, dn)
        ks, krw, kd = kenv.step(ks, ka, kwr(ks, 1))
        ps, prw, pd = penv.step(ps, pa, pwr(ps, 1))
        expect_equal(f"detailed step tick {t}", state_pairs(ks, ps) + [
            ("actions", ka, pa), ("rewards", krw, prw), ("dones", kd, pd)])
    det_counts = KN.counts()
    torch.cuda.synchronize()
    g_mb = nbytes(*dn) / 1e6
    del dn
    if det_counts["expert_detailed"] != DETAILED_CHECK_TICKS:
        raise AssertionError(f"detailed launch counts {det_counts}")
    d_state = {"s": ks}

    def detailed_tick():
        st = d_state["s"]
        a = detailed_to_gridnet(kx, st, 0, dtl, dml,
                                DetailedNoise.draw(gen, B, kenv))
        d_state["s"] = kenv.step(st, a, kwr(st, 1))[0]

    for _ in range(2):
        detailed_tick()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    for _ in range(DETAILED_TIME_TICKS):
        detailed_tick()
    torch.cuda.synchronize()
    d_sps = B * DETAILED_TIME_TICKS / (time.perf_counter() - t2)
    d_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d_busy, d_us = profiled(detailed_tick, 10)
    ks, ps = kenv.reset(B), penv.reset(B)
    kr = [ExpertRoles.init(B, dev), ExpertRoles.init(B, dev)]
    pr = [ExpertRoles.init(B, dev), ExpertRoles.init(B, dev)]
    KN.reset_counts()
    for t in range(SELFPLAY_CHECK_TICKS):
        m0, m1 = macros(kx, ks, kr[0], 0), macros(kx, ks, kr[1], 1)
        n0, n1 = (ExpertNoise.draw(gen, B, kenv) for _ in (0, 1))
        ks, kr[0], kr[1], krw, kd = kx.step(ks, kr[0], kr[1], m0, m1, n0, n1)
        ps, pr[0], pr[1], prw, pd = px.step(ps, pr[0], pr[1], m0, m1, n0, n1)
        expect_equal(f"expert self-play tick {t}", state_pairs(ks, ps) + [
            (f"{f} p{p}", getattr(kr[p], f), getattr(pr[p], f))
            for p in (0, 1) for f in ExpertRoles.FIELDS]
            + [("rewards", krw, prw), ("dones", kd, pd)])
    sp_counts = KN.counts()
    torch.cuda.synchronize()
    if sp_counts["expert_macro"] != 2 * SELFPLAY_CHECK_TICKS or sp_counts[
            "rush"]:
        raise AssertionError(f"self-play launch counts {sp_counts}")
    s_state = {"s": ks, "r": kr}

    def selfplay_tick():
        st, (r0, r1) = s_state["s"], s_state["r"]
        m0, m1 = macros(kx, st, r0, 0), macros(kx, st, r1, 1)
        st, r0, r1, _, _ = kx.step(st, r0, r1, m0, m1,
                                   ExpertNoise.draw(gen, B, kenv),
                                   ExpertNoise.draw(gen, B, kenv))
        s_state["s"], s_state["r"] = st, [r0, r1]

    for _ in range(3):
        selfplay_tick()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(SELFPLAY_TIME_TICKS):
        selfplay_tick()
    torch.cuda.synchronize()
    s_sps = B * SELFPLAY_TIME_TICKS / (time.perf_counter() - t2)
    print(f"    detailed mode (player 0, seeded logits, vs WorkerRush): "
          f"{DETAILED_CHECK_TICKS} ticks identical to the plain path "
          f"(Gumbel noise {g_mb:.1f} MB a player a step), launches per step "
          f"{ {n: c // DETAILED_CHECK_TICKS for n, c in det_counts.items() if c} }"
          f"; timed {d_sps:.1f} env-steps/s/card (draws included), busy "
          f"{100 * d_busy:.1f}% ({d_us:.0f} us a step), peak {d_peak:.2f} "
          f"GiB; self-play macro step: {SELFPLAY_CHECK_TICKS} ticks "
          f"identical, launches per step "
          f"{ {n: c // SELFPLAY_CHECK_TICKS for n, c in sp_counts.items() if c} }"
          f"; timed {s_sps:.1f} env-steps/s/card "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    del x_state, d_state, s_state

    # (c) evaluate_population: SEED_PROGRAM and 7 mutations of
    # random.Random(0) against WorkerRush and LightRush, 32 games a side:
    # 1024 lanes, kernel next to plain for a checked prefix, then timed at
    # the JAX default max_cycles
    t1 = time.perf_counter()
    import random as _random
    rng0 = _random.Random(0)
    progs = [DSL.SEED_PROGRAM] + [SYN.mutate(DSL.SEED_PROGRAM, rng0)
                                  for _ in range(7)]
    kopp = [make_bot(n, kenv) for n in SYN_OPPONENTS]
    popp = [make_bot(n, penv) for n in SYN_OPPONENTS]
    kout, pout = {}, {}
    KN.reset_counts()
    kfit = SYN.evaluate_population(kenv, progs, kopp, SYN_GAMES,
                                   SYN_CHECK_TICKS, seed=16, out=kout)
    syn_counts = KN.counts()
    pfit = SYN.evaluate_population(penv, progs, popp, SYN_GAMES,
                                   SYN_CHECK_TICKS, seed=16, out=pout)
    torch.cuda.synchronize()
    L = int(kout["winner"].shape[0])
    expect_equal("evaluate_population", state_pairs(
        kout["state"], pout["state"]) + [
        ("winners", kout["winner"], pout["winner"]),
        ("fitness", torch.from_numpy(kfit), torch.from_numpy(pfit))])
    need = ("distance_fields", "descend_direction", "dsl_target", "rush")
    if L != 1024 or min(syn_counts[n] for n in need) == 0 or syn_counts[
            "expert_macro"]:
        raise AssertionError(f"evaluate_population: {L} lanes, launches "
                             f"{syn_counts}")
    # the timed run keeps its state every SYN_SNAP_EVERY ticks (a list of
    # references: the loop makes a new state each tick)
    tout, snaps = {}, []

    def snap(tick, st):
        if tick % SYN_SNAP_EVERY == 0:
            snaps.append((tick, st))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    tfit = SYN.evaluate_population(kenv, progs, kopp, SYN_GAMES, SYN_CYCLES,
                                   seed=16, out=tout, on_tick=snap)
    torch.cuda.synchronize()
    syn_sec = time.perf_counter() - t2
    syn_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lane_t = int(tout["state"].time.sum())
    ended = int((tout["winner"] >= 0).sum())
    print(f"    evaluate_population ({len(progs)} programs x "
          f"{len(SYN_OPPONENTS)} opponents x 2 sides x {SYN_GAMES} = {L} "
          f"lanes): {SYN_CHECK_TICKS} ticks identical to the plain path "
          f"(states, winners, fitness), launches per tick "
          f"{ {n: round(c / SYN_CHECK_TICKS, 1) for n, c in syn_counts.items() if c} }"
          f"; timed to {SYN_CYCLES} cycles {syn_sec:.2f} s = "
          f"{lane_t / syn_sec:.1f} lane-ticks/s/card ({lane_t} lane-ticks, "
          f"{ended} games ended), peak {syn_peak:.2f} GiB, fitness "
          f"{[round(float(f), 4) for f in tfit]} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)

    lap("[16] expert, evaluate_population timed")
    # contact windows: from the timed run's kept state with the most lanes
    # in contact both ways, its programs and two programs that reach every
    # DSL kernel (the two-nearest field, the range covers, Random's
    # uniforms) go on kernel next to plain, so that the attacks, the range
    # covers, MoveAway and the ally fields are held in contact; each
    # program bot counts the ATTACKs it issues, and a window fails without
    # any
    t2 = time.perf_counter()
    cover = (
        (DSL.If(DSL.AllyInEnemyRange(), (DSL.MoveAway("All"),)),
         DSL.MoveToUnit("Worker", "Closest", "Ally"),
         DSL.Attack("All", "Random")),
        (DSL.If(DSL.EnemyInUnitsRange(), (DSL.Attack("All", "Weakest"),)),
         DSL.MoveToUnit("All", "Random", "Enemy"), DSL.Harvest(2),
         DSL.Attack("All", "Closest")))
    cl = [(pi, side) for pi in range(len(cover)) for side in (0, 1)
          for _ in range(L // 4)]
    dsl_k = ("distance_fields", "descend_direction", "distance_field2",
             "descend_direction_excluding", "range_cover", "dsl_target")

    def in_contact(s0, sides):
        """Lanes where an enemy covers one of the program's units
        (AllyInEnemyRange) and where one of its units covers an enemy
        (EnemyInUnitsRange)."""
        rng_ = peng.lut("attack_range", dev)[
            (s0.utype.long() - 1).clamp(0, cfg.num_types - 1)]
        seat = torch.as_tensor(sides, device=dev).view(-1, 1, 1)
        mine = (s0.utype > 0) & (s0.owner == seat)
        en = (s0.utype > 0) & (s0.owner == 1 - seat)
        return tuple(int((m & DSL.range_cover_plain(
            c, rng_, cfg.max_range)).flatten(1).any(1).sum())
            for m, c in ((mine, en), (en, mine)))

    snap_tick, snap_st = max(snaps, key=lambda ts: min(in_contact(
        ts[1], tout["sides"])))
    del snaps
    start = (snap_st, torch.zeros(L, dtype=torch.bool, device=dev),
             torch.full((L,), -1, dtype=torch.int32, device=dev))

    def counted(bots, tally):
        def wrap(bot):
            def act(st, p, nz):
                a = bot(st, p, nz)
                tally.append((a[..., 0] == ATTACK).sum())
                return a
            return S.Opponent(act, bot.draw)
        return [wrap(b) for b in bots]

    def go_on(name, kbots, pbots, kopps, popps, pis, ois, sides, n):
        tk, tp = [], []
        gk, gp = (torch.Generator(device=dev) for _ in (0, 1))
        gk.manual_seed(160)
        gp.manual_seed(160)
        KN.reset_counts()
        kw, kst, kdn = SYN.play_lanes(kenv, counted(kbots, tk), kopps, pis,
                                      ois, sides, n, gk, start=start)
        c = KN.counts()
        pw, pst, pdn = SYN.play_lanes(penv, counted(pbots, tp), popps, pis,
                                      ois, sides, n, gp, start=start)
        expect_equal(name, state_pairs(kst, pst) + [
            ("winners", kw, pw), ("done", kdn, pdn),
            ("attacks", torch.stack(tk), torch.stack(tp))])
        attacks = int(torch.stack(tk).sum())
        contact = in_contact(snap_st, sides)
        if attacks == 0 or min(contact) == 0:
            raise AssertionError(f"{name}: {attacks} program ATTACKs, lanes "
                                 f"in contact {contact}")
        return c, attacks, int(kdn.sum()), contact

    syn_go = go_on("evaluate_population in contact", tout["bots"],
                   [DSL.program_opponent(penv, p) for p in progs], kopp,
                   popp, tout["pis"], tout["ois"], tout["sides"],
                   SYN_CONTACT_TICKS)
    cov_go = go_on("every DSL kernel in contact",
                   [DSL.program_opponent(kenv, p) for p in cover],
                   [DSL.program_opponent(penv, p) for p in cover], kopp[:1],
                   popp[:1], [c[0] for c in cl], [0] * len(cl),
                   [c[1] for c in cl], COVER_CONTACT_TICKS)
    cover_counts = cov_go[0]
    if min(cover_counts[n] for n in dsl_k) == 0:
        raise AssertionError(f"DSL kernels not launched: {cover_counts}")
    for what, ticks, (_, attacks, ended, contact) in (
            ("the timed programs", SYN_CONTACT_TICKS, syn_go),
            ("the programs of every DSL kernel", COVER_CONTACT_TICKS,
             cov_go)):
        print(f"    {what} from the timed run's tick {snap_tick} ({contact[0]}"
              f" lanes with a program unit in enemy range, {contact[1]} with "
              f"an enemy in its units' range): {ticks} ticks identical to the "
              f"plain path (states, winners, done, ATTACKs a call), "
              f"{attacks} program ATTACKs, {ended} games over by the end",
              flush=True)
    print(f"    (the contact windows took {time.perf_counter() - t2:.1f} s)",
          flush=True)

    # (d) the CLI on basesWorkers8x8 with small settings
    t2 = time.perf_counter()
    import contextlib
    import io
    from microrts_tpu_torch.synth import export as SX
    from microrts_tpu_torch.synth.__main__ import main as synth_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = synth_main(["--map", "maps/8x8/basesWorkers8x8.xml",
                         "--opponents", "WorkerRush", "LightRush",
                         "--generations", "1", "--population", "4",
                         "--games-per-pair", "4", "--max-cycles", "100",
                         "--clean", "behavior"])
    cli = buf.getvalue()
    text = cli[cli.index("(\n"):] if "(\n" in cli else ""
    if rc != 0 or "clean(behavior)" not in cli or not text:
        raise AssertionError(f"synth CLI rc {rc}: {cli!r}")
    prog_ok = text.strip() == SX.dumps(()) or bool(SX.loads(text))
    print(f"    launches of every DSL kernel in contact "
          f"{ {n: cover_counts[n] for n in dsl_k} }; python -m "
          f"microrts_tpu_torch.synth (basesWorkers8x8, 1 generation of 4, "
          f"4 games a pair, 100 cycles, --clean behavior): rc {rc} in "
          f"{time.perf_counter() - t2:.1f} s, {cli.splitlines()[0]}; "
          f"{cli.splitlines()[1]}; the program text loads {prog_ok}:\n"
          f"{text}", flush=True)
    lap("[16] contact windows, the CLI")
    print(f"    [16] took {time.perf_counter() - t0:.1f} s (the script "
          f"{time.perf_counter() - t_main:.1f} s so far)", flush=True)

    # ---- [17] slice 11, the learned models at full width: the new kernels
    # held on [16]'s kept in-contact state; InformedNaiveMCTS on the 64
    # timed games, kernel vs plain at the defaults' tree shapes, then timed
    # at the JAX defaults; the learned bots' round robin, kernel vs plain,
    # then timed; the naive-Bayes self-play, kernel vs plain, then timed
    t0 = time.perf_counter()
    contact_acts = {"acting cells": 0, "cooperative actions": 0,
                    "informed draws": 0}
    hold_learned(snap_st, f"in contact (tick {snap_tick})", contact_acts)
    torch.cuda.synchronize()
    del snap_st, start
    print(f"[17] aim_predict (4 modes), nb_predict (3 modes), "
          f"cooperative_act and arm_sample informed on [16]'s in-contact "
          f"state (tick {snap_tick}, {B} lanes, 3 player settings) equal to "
          f"plain ({contact_acts}; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    t1 = time.perf_counter()
    informed = functools.partial(TS.informed_naive_mcts_bot, model=aim)
    kt, ka = tree_decision(kenv, informed, INF_CHECK, big, 70)
    pt, pa = tree_decision(penv, informed, INF_CHECK, big, 70)
    expect_equal("InformedNaiveMCTS decision at the defaults' tree shapes",
                 tree_pairs(kt, pt) + [("actions", ka, pa)])
    print(f"    InformedNaiveMCTS: one decision of {TREE_TIME_GAMES} games "
          f"at the defaults' N, C and D ({INF_CHECK}) identical to the "
          f"plain path: trees (nodes up to {int(kt.nnodes.max())}) and "
          f"actions ({time.perf_counter() - t1:.1f} s)", flush=True)
    del kt, pt
    ibot = make_bot("InformedNaiveMCTS", kenv)
    g = torch.Generator(device=dev)
    g.manual_seed(71)
    ibot(big, 0, ibot.draw(g, TREE_TIME_GAMES))               # warm
    nz = ibot.draw(g, TREE_TIME_GAMES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    KN.reset_counts()
    t1 = time.perf_counter()
    act = ibot(big, 0, nz)
    torch.cuda.synchronize()
    inf_sec = time.perf_counter() - t1
    inf_counts = KN.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    inf_k = TREE_KERNELS + ("aim_predict",)
    if (any(inf_counts[n] == 0 for n in inf_k)
            or any(inf_counts[n] for n in inf_counts if n not in inf_k)):
        raise AssertionError(f"a timed InformedNaiveMCTS decision launched "
                             f"{inf_counts}")
    if act.shape != (TREE_TIME_GAMES, H, W, 7) or not bool(
            (act[..., 0] > 0).any()):
        raise AssertionError("InformedNaiveMCTS: no unit acts")
    print(f"    InformedNaiveMCTS at the JAX defaults (make_bot: "
          f"{ibot.bot.n_playouts} playouts of 100 ticks, the AIM-WR prior "
          f"and model playouts): one warm decision of {TREE_TIME_GAMES} "
          f"games in {inf_sec:.3f} s: game-decisions/s/card "
          f"{TREE_TIME_GAMES / inf_sec:.2f} (NaiveMCTS in [11]: "
          f"{tree_rates['NaiveMCTS']:.2f}); {sum(inf_counts.values())} "
          f"launches { {n: c for n, c in inf_counts.items() if c} }; peak "
          f"device memory {peak:.2f} GiB ({peak - held:.2f} GiB above what "
          f"the script held before); {kind}, {smi}", flush=True)
    del nz, act
    lap("[17] InformedNaiveMCTS")

    # the learned bots' round robin (the tournament draws each bot's noise
    # a frame through its draw)
    t1 = time.perf_counter()
    TN._games_fn = recording_games_fn

    def lrr(env, cycles, coop_acts=None):
        bots = {n: make_bot(n, env) for n in LRR_BOTS}
        # CooperativeAI on seed 1's genomes, whose units act (the default
        # seed's act on none of basesWorkers16x16's); ``coop_acts`` gets
        # the count of its acting cells a frame
        coop = CO.cooperative_bot(env, seed=1)
        if coop_acts is not None:
            inner = coop.bot

            def counted(st, p, nz=None):
                a = inner(st, p)
                coop_acts.append(int((a[..., 0] > 0).sum()))
                return a
            coop = S.Opponent(counted, coop.draw)
        bots["CooperativeAI"] = coop
        table = TN.round_robin(env, bots, LRR_GAMES, cycles, seed=7)
        torch.cuda.synchronize()
        return table, *games.pop()

    KN.reset_counts()
    coop_acts = []
    ktab, kw, ks, kframes = lrr(kenv, LRR_CHECK_CYCLES, coop_acts)
    lrr_check_counts = KN.counts()
    if sum(coop_acts) == 0:
        raise AssertionError("CooperativeAI issued no action in the "
                             "learned round robin's check")
    ptab, pw, ps, _ = lrr(penv, LRR_CHECK_CYCLES)
    expect_equal("learned round robin", state_pairs(ks, ps)
                 + [("winners", kw, pw)])
    same_tables("learned round robin", ktab, ptab)
    if min(lrr_check_counts[n] for n in ("aim_predict", "cooperative_act",
                                         "rush", "actor")) == 0:
        raise AssertionError(f"the learned round robin launched "
                             f"{lrr_check_counts}")
    print(f"    learned round robin {LRR_BOTS}: {ks.batch} lanes x "
          f"{LRR_CHECK_CYCLES} cycles ({kframes} frames) identical to the "
          f"plain path (states, winners, table); CooperativeAI's acting "
          f"cells {sum(coop_acts)} over {len(coop_acts)} calls; launches "
          f"{ {n: c for n, c in lrr_check_counts.items() if c} } "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    del ks, ps
    KN.reset_counts()
    t1 = time.perf_counter()
    ltab, lw, ls, lframes = lrr(kenv, LRR_CYCLES)
    lrr_sec = time.perf_counter() - t1
    lrr_counts = KN.counts()
    if ltab.wins.sum() == 0:
        raise AssertionError("no game of the learned round robin ended")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        lrr(kenv, LRR_PROFILE_CYCLES)
        window = (time.perf_counter() - t1) * 1e6
    busy, kern = device_busy(prof)
    TN._games_fn = games_fn
    lrr_ticks = lane_ticks(ls)
    wr = LRR_BOTS.index("WorkerRush")
    print(ltab.table())
    print(f"    learned round robin game-ticks/s/card: "
          f"{lrr_ticks / lrr_sec:.1f} ({lrr_ticks} lane ticks in "
          f"{lrr_sec:.3f} s, {lframes} frames, max_cycles {LRR_CYCLES}); "
          f"WorkerRush's wins against "
          f"{ {n: int(ltab.wins[wr, i]) for i, n in enumerate(LRR_BOTS)} } "
          f"of {2 * LRR_GAMES} games each; device busy "
          f"{100 * busy / window:.1f}% of a profiled {LRR_PROFILE_CYCLES}-"
          f"cycle run (top kernels: "
          f"{[(a.key[:24], round(a.self_device_time_total)) for a in kern[:4]]}"
          f" us); launches { {n: c for n, c in lrr_counts.items() if c} }; "
          f"{kind}, {smi}", flush=True)
    del ls, prof, kern
    lap("[17] learned round robin")

    # the naive-Bayes self-play of B envs (a model of seeded counts), so
    # that nb_predict runs under load
    t1 = time.perf_counter()
    nbm = seeded_nb_model(NA, NB.feature_sizes(cfg), 1)
    kb, pb = NB.bayes_bot(kenv, nbm), NB.bayes_bot(penv, nbm)
    g = torch.Generator(device=dev)
    g.manual_seed(72)
    ks = kenv.reset(B)
    ps = ks.clone()
    KN.reset_counts()
    for t in range(NB_CHECK_TICKS):
        n0, n1 = kb.draw(g, B), kb.draw(g, B)
        ks = kenv.step(ks, kb(ks, 0, n0), kb(ks, 1, n1))[0]
        ps = penv.step(ps, pb(ps, 0, n0), pb(ps, 1, n1))[0]
        expect_equal(f"bayes self-play tick {t}", state_pairs(ks, ps))
    nb_counts = KN.counts()
    if nb_counts["nb_predict"] != 2 * NB_CHECK_TICKS:
        raise AssertionError(f"the bayes self-play launched {nb_counts}")
    del ps
    for _ in range(3):
        ks = kenv.step(ks, kb(ks, 0, kb.draw(g, B)),
                       kb(ks, 1, kb.draw(g, B)))[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(NB_TIME_TICKS):
        ks = kenv.step(ks, kb(ks, 0, kb.draw(g, B)),
                       kb(ks, 1, kb.draw(g, B)))[0]
    torch.cuda.synchronize()
    nb_sps = B * NB_TIME_TICKS / (time.perf_counter() - t2)
    units = int((ks.utype > 0).sum())
    print(f"    bayes_bot self-play: {B} envs x {NB_CHECK_TICKS} ticks "
          f"identical to the plain path (launches "
          f"{ {n: c for n, c in nb_counts.items() if c} }), then "
          f"env-steps/s/card {nb_sps:.1f} over {NB_TIME_TICKS} ticks "
          f"({units} units on the boards at the end; "
          f"{time.perf_counter() - t1:.1f} s); {kind}, {smi}", flush=True)
    del ks
    lap("[17] bayes self-play")
    print(f"    [17] took {time.perf_counter() - t0:.1f} s (the script "
          f"{time.perf_counter() - t_main:.1f} s so far)", flush=True)

    # ---- [18] results
    kernels = []
    tree_k = ("arm_sample", "arms_to_action", "mcts_descend",
              "mcts_backprop")
    for k in KN.KERNELS:
        kms, pms, bound, byts, by = times[k.name]
        new = k.name in ("event_jump", "evaluate")
        launches = (tree_counts["NaiveMCTS"][k.name] if k.name in tree_k
                    else mm_counts["ABCD"][k.name]
                    if k.name in ("enum_next", "minimax_step")
                    else po_counts[k.name]
                    if k.name in ("issue", "po_state", "obs_po")
                    else stateful_counts["Continuing"][k.name]
                    if k.name == "mcts_reroot"
                    else stateful_counts["BS3"][k.name]
                    if k.name == "believe_update"
                    else v3_counts[k.name] if k.name == "env_health"
                    else xv_counts[k.name] if k.name == "expert_macro"
                    else det_counts[k.name] if k.name == "expert_detailed"
                    else syn_counts[k.name] if k.name in (
                        "distance_fields", "descend_direction", "dsl_target")
                    else cover_counts[k.name] if k.name in (
                        "distance_field2", "descend_direction_excluding",
                        "range_cover")
                    else inf_counts[k.name] if k.name == "aim_predict"
                    else lrr_counts[k.name] if k.name == "cooperative_act"
                    else nb_counts[k.name] if k.name == "nb_predict"
                    else mc_counts[k.name] if new else upd_counts[k.name])
        by_phase = {"5": counts[k.name], "6": roll_counts[k.name],
                    "7": upd_counts[k.name], "8": rr_counts[k.name],
                    "9": mc_counts[k.name], "10": ev_counts[k.name],
                    "11 NaiveMCTS": tree_counts["NaiveMCTS"][k.name],
                    "11 UCT": tree_counts["UCT"][k.name]}
        by_phase.update({f"12 {n}": c[k.name] for n, c in mm_counts.items()})
        by_phase.update({"13 PO step": po_counts[k.name],
                         "13 PO round robin": po_rr_counts[k.name],
                         "14 believe memories": bel_counts[k.name],
                         "14 BS3_NaiveMCTS": stateful_counts["BS3"][k.name],
                         "14 ContinuingNaiveMCTS":
                             stateful_counts["Continuing"][k.name]})
        by_phase.update({f"14 {n} games": c[k.name]
                         for n, c in loop_counts.items()})
        by_phase.update({"15 v3 step": v3_counts[k.name],
                         "15 v3 MonteCarlo": mc3_counts[k.name],
                         "16 expert step_vs": xv_counts[k.name],
                         "16 expert detailed": det_counts[k.name],
                         "16 expert self-play": sp_counts[k.name],
                         "16 evaluate_population": syn_counts[k.name],
                         "16 evaluate_population in contact":
                             syn_go[0][k.name],
                         "16 every DSL kernel in contact":
                             cover_counts[k.name],
                         "17 InformedNaiveMCTS": inf_counts[k.name],
                         "17 learned round robin": lrr_counts[k.name],
                         "17 bayes self-play": nb_counts[k.name]})
        kernels.append(dict(
            name=k.name, status="equal to plain", route="cuda",
            source=k.source, replaces=k.replaces, launches=launches,
            launches_by_phase=by_phase,
            max_abs_err=errs[k.name], ms=kms, plain_ms=pms, bound_ms=bound,
            bound_by=by, library_ms=None, **variant_times.get(k.name, {})))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
