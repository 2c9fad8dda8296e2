"""Card tests of the port: the CUDA kernels against their plain PyTorch
versions, on the main path with resets and on the policy-driven rollout.
They skip on a machine without a CUDA card.  This file imports neither JAX
nor the JAX package, so it runs where only the port is installed::

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: exact (the tree search too: its floats are sums and quotients
in the same order, and logf/sqrtf as PyTorch rounds them), except the
policy sampler's and K7b's logprob and entropy (fp32 sums in another
order than the plain version's: 1e-5
relative + 1e-4 absolute), K7b's gradient of the logits (1e-4 relative +
1e-5 absolute, against autograd through the plain version), the float
evaluation functions of K12a (Simple, Opt, Lanchester: float32 sums in
another order, within 1e-5 of the larger of the value and 1; the Sqrt
family and the upper bound sum small integers and are exact), and the
parameters after a PPO update on the kernel path against the plain path
(see ``test_update_kernel_path_matches_plain_on_card``).
"""

import dataclasses

import pytest
import torch

from microrts_tpu_torch.bots import scripted as S
from microrts_tpu_torch.bots.scripted import random_bot, random_opponent
from microrts_tpu_torch.config import RUSH_BOTS, make_bot
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.env.vec import VecGridnetEnv
from microrts_tpu_torch.models.gridnet_policy import (
    ActionSpace, GridnetPolicy, action_logprob, greedy_action, gumbel_noise,
    sample_action)
from microrts_tpu_torch.train.ppo import PPOConfig, PPOTrainer
from microrts_tpu_torch.utils.assets import asset_path

BIAS = 5.0
MAPS = ["maps/8x8/melee8x8Mixed6.xml", "maps/16x16/basesWorkers16x16.xml"]
LP_TOL = dict(rtol=1e-5, atol=1e-4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_kernel_path_equals_plain_on_card(map_rel):
    """The main path through the kernels equals the plain path on the
    card, tick by tick with resets, and launches each kernel as often as
    the step calls it."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    dev = torch.device("cuda")
    B, ticks = 64, 80
    kenv = GridnetEnv(asset_path(map_rel), device=dev)
    penv = GridnetEnv(asset_path(map_rel), device=dev, plain=True)
    kvec, pvec = VecGridnetEnv(kenv, B, 30), VecGridnetEnv(penv, B, 30)
    kbot, pbot = random_bot(kenv, BIAS), random_bot(penv, BIAS)
    ks, ksteps = kvec.reset()
    ps, psteps = pvec.reset()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    KN.reset_counts()
    for t in range(ticks):
        u0, u1 = (torch.rand((B, kenv.h, kenv.w, 2), generator=g, device=dev)
                  for _ in (0, 1))
        ka = (kbot(ks, 0, u0), kbot(ks, 1, u1))
        pa = (pbot(ps, 0, u0), pbot(ps, 1, u1))
        kout = kvec.step(ks, ksteps, *ka)
        pout = pvec.step(ps, psteps, *pa)
        (ks, ksteps), (ps, psteps) = kout[:2], pout[:2]
        assert ks.equal(ps) == (True, ""), (t, ks.equal(ps))
        for a, b in zip(ka + kout[1:], pa + pout[1:]):
            assert torch.equal(a, b), t
        assert torch.equal(kvec.masks(ks), pvec.masks(ps)), t
    torch.cuda.synchronize()
    assert KN.counts() == dict(
        actor=4 * ticks, decode=2 * ticks, issue_env=2 * ticks, cycle=ticks,
        epilogue=ticks, splice_obs=ticks, policy_sample=0,
        policy_logprob_fwd=0, policy_logprob_bwd=0, rush=0, event_jump=0,
        evaluate=0, arm_sample=0, arms_to_action=0, mcts_descend=0,
        mcts_backprop=0, enum_next=0, minimax_step=0, issue=0, po_state=0,
        obs_po=0, mcts_reroot=0, believe_update=0, env_health=0,
        distance_fields=0, descend_direction=0, distance_field2=0,
        descend_direction_excluding=0, expert_macro=0, expert_detailed=0,
        range_cover=0, dsl_target=0, aim_predict=0, nb_predict=0,
        cooperative_act=0)


def _states(env, B, ticks, seed):
    """Plain-path states along a random-bot trajectory on the card:
    [(pre, c0, c1, post)] of every tick."""
    dev = env.device
    bot = random_bot(env, BIAS)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    s = env.reset(B)
    out = []
    for _ in range(ticks):
        u0, u1 = (torch.rand((B, env.h, env.w, 2), generator=g, device=dev)
                  for _ in (0, 1))
        c0, c1, post, _ = env.advance(s, bot(s, 0, u0), bot(s, 1, u1))
        out.append((s, c0, c1, post))
        s = post
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_epilogue_splice_sample_equal_plain_on_card(map_rel):
    """EPILOGUE, SPLICE_OBS and SAMPLE against their plain versions at
    B=64 on the states of a 60-tick trajectory (with terminal envs forced
    in by max_steps and by removing a player's units)."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    dev = torch.device("cuda")
    B = 64
    env = GridnetEnv(asset_path(map_rel), device=dev, plain=True)
    cfg = env.cfg.engine
    T = cfg.num_types
    space = ActionSpace(T, 2 * cfg.max_range + 1)
    net = GridnetPolicy(space, 20 + T).init_params(
        torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    recs = _states(env, B, 60, seed=2)
    for t, (pre, c0, c1, post) in enumerate(recs[::6]):
        if t == 1:      # player 0 loses every unit in half the envs
            gone = (post.owner == 0) & (torch.arange(B, device=dev) % 2 == 0
                                        )[:, None, None]
            post = post.replace(utype=torch.where(gone, 0, post.utype),
                                owner=torch.where(gone, -1, post.owner))
        steps = torch.randint(0, 30, (B,), generator=g, device=dev,
                              dtype=torch.int32)
        rew, dn, rm, st = KN.EPILOGUE(env.cfg, post, pre, c0, c1, steps, 30,
                                      done_copies=2)
        pdn = env.dones_plain(post)
        assert torch.equal(rew, env.rewards_plain(pre, c0, c1, post)), t
        assert torch.equal(dn, torch.stack([pdn, pdn])), t
        s1 = steps + 1
        prm = pdn[:, 0] | (s1 >= 30)
        assert torch.equal(rm, prm), t
        assert torch.equal(st, torch.where(prm, 0, s1).int()), t
        assert torch.equal(KN.EPILOGUE(env.cfg, post)[1], pdn), t

        sp, obs, oh = KN.SPLICE_OBS(cfg, post, rm, env.init_state,
                                    obs=(0, 1), onehot=(1, 0))
        psp = post.select(rm, env.init_state)
        assert sp.equal(psp) == (True, ""), t
        for i, p in enumerate((0, 1)):
            assert torch.equal(obs[i], env.observation_plain(psp, p)), t
        for i, p in enumerate((1, 0)):
            assert torch.equal(oh[i], env.observation_onehot_plain(psp, p))
        for p in (0, 1):
            assert torch.equal(KN.SPLICE_OBS(cfg, post, onehot=(p,))[2][0],
                               env.observation_onehot_plain(post, p)), t

        with torch.no_grad():
            logits, _ = net(env.observation_onehot_plain(psp, 0))
        mask = env.masks_plain(psp, 0)
        gum = gumbel_noise(logits.shape, g, dev)
        ka, klp, kent, kenv = sample_action(logits, mask, space, gum)
        pa, plp, pent, penv = sample_action(logits, mask, space, gum,
                                            plain=True)
        assert torch.equal(ka, pa), t
        for k, p in ((klp, plp), (kent, pent), (kenv, penv)):
            torch.testing.assert_close(k, p, **LP_TOL)
        assert torch.equal(greedy_action(logits, mask, space),
                           greedy_action(logits, mask, space, plain=True))
        # an all-masked cell samples from its raw logits
        none = torch.zeros_like(mask)
        assert torch.equal(sample_action(logits, none, space, gum)[0],
                           sample_action(logits, none, space, gum,
                                         plain=True)[0])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("selfplay", [False, True])
def test_rollout_kernel_path_equals_plain_on_card(selfplay):
    """PPOTrainer._rollout through the kernels equals the plain path for 8
    steps (16x16, 32 envs, bf16 policy, resets by max_steps), and launches
    every kernel of the rollout."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    dev = torch.device("cuda")
    path = asset_path(MAPS[1])
    cfg = PPOConfig(num_envs=32, rollout_len=8, max_steps=5)
    out = []
    for plain in (False, True):
        torch.backends.cudnn.deterministic = True   # same logits both ways
        torch.backends.cudnn.benchmark = False
        env = GridnetEnv(path, device=dev, plain=plain)
        tr = PPOTrainer(env, cfg, selfplay=selfplay,
                        opponent=None if selfplay else random_opponent(env))
        ts = tr.init(seed=0)
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        KN.reset_counts()
        out.append(tr._rollout(ts, gen=g))
        counts = KN.counts()
        if not plain:
            # every kernel of the rollout; the learner's and the rush
            # bot's are not on this path
            rollout = ("actor", "decode", "issue_env", "cycle", "epilogue",
                       "splice_obs", "policy_sample")
            assert all(counts[n] > 0 for n in rollout), counts
            assert all(counts[n] == 0 for n in counts
                       if n not in rollout), counts
            assert counts["policy_sample"] == 8 * (2 if selfplay else 1)
            assert counts["epilogue"] == 8
            # the first observation, one per step, and in self-play the
            # opponent's one-hot observation every step
            assert counts["splice_obs"] == 9 + (8 if selfplay else 0)
        else:
            assert not any(counts.values()), counts
    (kts, ktr, klast, kwins), (pts, ptr, plast, pwins) = out
    assert kts.env_states.equal(pts.env_states) == (True, "")
    for f in ("obs", "mask", "action", "reward", "done", "value"):
        assert torch.equal(getattr(ktr, f), getattr(ptr, f)), f
    assert ktr.done.any()
    torch.testing.assert_close(ktr.logprob, ptr.logprob, **LP_TOL)
    assert torch.equal(klast, plast) and int(kwins) == int(pwins)


@pytest.mark.gpu
def test_kernel_rejects_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"), device="cuda")
    s = env.reset(4)
    with pytest.raises(TypeError):
        KN.CYCLE(env.cfg.engine, s.replace(hp=s.hp.int()))
    with pytest.raises(ValueError):
        KN.ISSUE_ENV(env.cfg.engine, s.replace(utype=s.utype.cpu()),
                     env.decode(s, torch.zeros((4, 8, 8, 7), dtype=torch.int32,
                                               device="cuda"), 0))
    u = torch.rand((4, 8, 8, 2), device="cuda").transpose(1, 2)
    with pytest.raises(ValueError):
        KN.ACTOR(env.cfg.engine, s, 0, u=u, weights=(1,) * 6)
    # epilogue, splice_obs, policy_sample
    c = env.decode(s, torch.zeros((4, 8, 8, 7), dtype=torch.int32,
                                  device="cuda"), 0)
    with pytest.raises(TypeError):
        KN.EPILOGUE(env.cfg, s, s, c, c, torch.zeros(4, device="cuda"), 9)
    with pytest.raises(ValueError):
        KN.EPILOGUE(env.cfg, s, s.replace(owner=s.owner[:2]), c, c)
    with pytest.raises(ValueError):     # init of batch neither 1 nor B
        KN.SPLICE_OBS(env.cfg.engine, s, torch.zeros(4, dtype=torch.bool,
                                                     device="cuda"),
                      State(**{f: getattr(s, f)[:2] for f in FIELD_DTYPES}))
    with pytest.raises(TypeError):
        KN.SPLICE_OBS(env.cfg.engine, s, torch.zeros(4, device="cuda"),
                      env.init_state)
    with pytest.raises(ValueError):
        KN.SPLICE_OBS(env.cfg.engine, s)
    sizes = (6, 4, 4, 4, 4, 7, 49)
    logits = torch.zeros((4, 8, 8, 78), device="cuda")
    mask = torch.ones((4, 8, 8, 79), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        KN.SAMPLE(sizes, logits, mask[..., 1:].contiguous())
    with pytest.raises(TypeError):
        KN.SAMPLE(sizes, logits, mask.bool())
    with pytest.raises(ValueError):
        KN.SAMPLE(sizes, logits, mask, logits[..., :77].contiguous())
    with pytest.raises(ValueError):
        KN.SAMPLE(sizes, logits.transpose(1, 2), mask)


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_logprob_kernels_equal_plain_on_card(map_rel):
    """K7b forward and backward against the plain version and autograd
    through it, on the logits of the seeded bf16 policy over a random-bot
    trajectory, with masks that hold components with no legal entry."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    dev = torch.device("cuda")
    B = 32
    env = GridnetEnv(asset_path(map_rel), device=dev, plain=True)
    cfg = env.cfg.engine
    space = ActionSpace(cfg.num_types, 2 * cfg.max_range + 1)
    net = GridnetPolicy(space, 20 + cfg.num_types).init_params(
        torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for t, (pre, *_) in enumerate(_states(env, B, 30, seed=4)[::10]):
        with torch.no_grad():
            logits, _ = net(env.observation_onehot_plain(pre, 0))
        mask = env.masks_plain(pre, 0)[..., 1:] != 0
        if t == 1:      # random masks: some components with no legal entry
            mask = torch.rand(mask.shape, generator=g, device=dev) < 0.3
        act = sample_action(logits, env.masks_plain(pre, 0), space,
                            gumbel_noise(logits.shape, g, dev),
                            plain=True)[0]
        w1 = torch.randn(logits.shape[:-1], generator=g, device=dev)
        w2 = torch.randn(logits.shape[:-1], generator=g, device=dev)
        KN.reset_counts()
        lg = logits.clone().requires_grad_(True)
        klp, kent = action_logprob(lg, mask, act, space)
        (w1 * klp + w2 * kent).sum().backward()
        assert KN.LOGPROB.launches == 1 and KN.LOGPROB_BWD.launches == 1
        plg = logits.clone().requires_grad_(True)
        plp, pent = action_logprob(plg, mask, act, space, plain=True)
        (w1 * plp + w2 * pent).sum().backward()
        torch.testing.assert_close(klp, plp, **LP_TOL)
        torch.testing.assert_close(kent, pent, **LP_TOL)
        torch.testing.assert_close(lg.grad, plg.grad, rtol=1e-4, atol=1e-5)
        # an upstream gradient on lp alone (entropy unused)
        lg.grad = None
        action_logprob(lg, mask, act, space)[0].sum().backward()
        plg.grad = None
        action_logprob(plg, mask, act, space, plain=True)[0].sum().backward()
        torch.testing.assert_close(lg.grad, plg.grad, rtol=1e-4, atol=1e-5)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", ["maps/8x8/basesWorkers8x8.xml",
                                     MAPS[1]])
def test_rush_kernel_equals_plain_on_card(map_rel):
    """The rush kernel against rush_bot_plain for every ported spec (and
    the expansion branch), both players, on the states of a plain
    WorkerRush-vs-LightRush run (240 ticks on 8x8, 432 on 16x16; the envs
    open with a few random ticks each) with some bases removed."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    dev = torch.device("cuda")
    B = 32
    env = GridnetEnv(asset_path(map_rel), device=dev, plain=True)
    kenv = GridnetEnv(asset_path(map_rel), device=dev)
    p0, p1 = S.worker_rush(env), S.light_rush(env)
    rnd = random_bot(env, BIAS)
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    s = env.reset(B)
    states = []
    every = 2 * env.h + 4           # 12 states, long enough to fight
    # env k opens with 2 (k % 16) random ticks, so that the envs differ
    opening = (2 * (torch.arange(B, device=dev) % 16))[:, None, None, None]
    for t in range(12 * every):
        if t % every == every // 2:
            states.append(s)
        u0, u1 = (torch.rand((B, env.h, env.w, 2), generator=g, device=dev)
                  for _ in (0, 1))
        a0 = torch.where(t < opening, rnd(s, 0, u0), p0(s, 0))
        a1 = torch.where(t < opening, rnd(s, 1, u1), p1(s, 1))
        s, _, _ = env.step(s, a0, a1)
    # bases removed and resources raised in half the envs (rebuilds)
    base = (s.utype == 2) & (torch.arange(B, device=dev) % 2 == 0)[
        :, None, None]
    states.append(s.replace(utype=torch.where(base, 0, s.utype),
                            owner=torch.where(base, -1, s.owner),
                            resources=s.resources.clamp(min=20)))
    specs = [make_bot(n, kenv).bot.plan for n in RUSH_BOTS] + [
        S.rush_plan(kenv, S.RushSpec("Light", expand=True))]
    counts = {}
    KN.reset_counts()
    for st in states:
        for plan in specs:
            for p in (0, 1):
                k = KN.RUSH(kenv.cfg.engine, plan, st, p)
                want = S.rush_bot_plain(env, plan, st, p, counts)
                assert torch.equal(k, want), (plan, p)
    torch.cuda.synchronize()
    assert KN.RUSH.launches == len(states) * len(specs) * 2
    for b in ("train_worker", "harvest", "return", "attack",
              "move_to_enemy", "rebuild_base"):
        assert counts.get(b, 0) > 0, (b, counts)


@pytest.mark.gpu
def test_update_kernel_path_matches_plain_on_card():
    """One PPOTrainer.update (16x16, 32 envs, 4 steps, 2 epochs x 2
    minibatches, bf16 policy, WorkerRush, SGD) through the kernels against
    the plain path from the same start with the same noise and cuDNN
    deterministic: the rollout exact; the loss terms within 1e-3 relative
    and every parameter within 1e-5 absolute of the plain path's (K7b's
    float32 sums in another order, through a bf16 backward)."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.train import optim
    dev = torch.device("cuda")
    cfg = PPOConfig(num_envs=32, rollout_len=4, max_steps=5, epochs=2,
                    minibatches=2)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = []
    for plain in (False, True):
        env = GridnetEnv(asset_path(MAPS[1]), device=dev, plain=plain)
        tr = PPOTrainer(env, cfg, opponent=make_bot("WorkerRush", env),
                        tx=optim.chain(optim.clip_by_global_norm(0.5),
                                       optim.sgd(cfg.lr)))
        ts = tr.init(seed=0)
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        trajs = []
        roll = tr._rollout
        tr._rollout = lambda *a, **k: trajs.append(roll(*a, **k)) or trajs[-1]
        KN.reset_counts()
        ts2, m = tr.update(ts, gen=g)
        counts = KN.counts()
        if plain:
            assert not any(counts.values()), counts
        else:
            # every kernel of training; the decision-frame path's, the
            # tree search's, the minimax search's, the fog's, the
            # stateful bots', the scripted strategies' and the learned
            # models' not
            search = ("event_jump", "evaluate", "arm_sample",
                      "arms_to_action", "mcts_descend", "mcts_backprop",
                      "enum_next", "minimax_step", "issue", "po_state",
                      "obs_po", "mcts_reroot", "believe_update",
                      "env_health", "distance_fields", "descend_direction",
                      "distance_field2", "descend_direction_excluding",
                      "expert_macro", "expert_detailed", "range_cover",
                      "dsl_target", "aim_predict", "nb_predict",
                      "cooperative_act")
            assert all(v > 0 for n, v in counts.items()
                       if n not in search), counts
            assert not any(counts[n] for n in search), counts
            assert counts["policy_logprob_fwd"] == 4
            assert counts["policy_logprob_bwd"] == 4
            assert counts["rush"] == 4
        out.append((ts2, m, trajs[0][1], tr.model.state_dict()))
    (kts, km, ktj, kp), (pts, pm, ptj, pp) = out
    assert kts.env_states.equal(pts.env_states) == (True, "")
    for f in ("obs", "mask", "action", "reward", "done", "value"):
        assert torch.equal(getattr(ktj, f), getattr(ptj, f)), f
    for k in ("pg_loss", "v_loss", "entropy", "ratio"):
        torch.testing.assert_close(km[k], pm[k], rtol=1e-3, atol=0)
    for k in kp:
        torch.testing.assert_close(kp[k], pp[k], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_new_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    sizes = (6, 4, 4, 4, 4, 7, 49)
    logits = torch.zeros((4, 8, 8, 78), device="cuda")
    mask = torch.ones((4, 8, 8, 78), dtype=torch.bool, device="cuda")
    act = torch.zeros((4, 8, 8, 7), dtype=torch.int32, device="cuda")
    g = torch.zeros((4, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        KN.LOGPROB(sizes, logits, mask.int(), act)
    with pytest.raises(ValueError):
        KN.LOGPROB(sizes, logits[..., :77].contiguous(), mask, act)
    with pytest.raises(TypeError):
        KN.LOGPROB_BWD(sizes, logits, mask, act.long(), g, g)
    with pytest.raises(ValueError):
        KN.LOGPROB_BWD(sizes, logits, mask, act, g[:2], g)
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cuda")
    s = env.reset(4)
    plan = S.worker_rush(env).plan
    with pytest.raises(TypeError):
        KN.RUSH(env.cfg.engine, plan, s.replace(uid=s.uid.short()), 0)


def _random_states(env, B, ticks, seed):
    """Plain-path states of a RandomBiasedAI trajectory on the card, every
    tenth tick from the tenth, and the initial state (no busy unit)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bot = random_bot(env, BIAS)
    s = env.reset(B)
    out = [s]
    for t in range(ticks):
        u0, u1 = (torch.rand((B, env.h, env.w, 2), generator=g,
                             device="cuda") for _ in (0, 1))
        s, _, _ = env.step(s, bot(s, 0, u0), bot(s, 1, u1))
        if t % 10 == 9:
            out.append(s)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_event_jump_evaluate_cycle_active_equal_plain_on_card(map_rel):
    """K8 in both modes with and without a cap, the cycle kernel's active
    flag, decode's NONE duration and K12a's seven functions against their
    plain versions (B=64)."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.ops import evaluation as EV
    from microrts_tpu_torch.ops import playout as PO
    B = 64
    kenv = GridnetEnv(asset_path(map_rel), device="cuda")
    penv = GridnetEnv(asset_path(map_rel), device="cuda", plain=True)
    cfg = kenv.cfg.engine
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    ids = {n: kenv.utt.get_unit_type(n).ID for n in (
        "Base", "Barracks", "Worker", "Light", "Heavy", "Ranged")}
    lanes = (torch.arange(B, device="cuda") % 2).int()
    for s in _random_states(penv, B, 60, 1):
        te = s.time + torch.randint(-2, 30, (B,), generator=g, device="cuda",
                                    dtype=torch.int32)
        dn = torch.rand(B, generator=g, device="cuda") < 0.2
        for d, t in ((None, None), (None, te), (dn, None), (dn, te)):
            k, p = (KN.EVENT_JUMP(s, t, 512, d),
                    PO.event_jump_plain(penv, s, t, 512, d))
            assert k[0].equal(p[0]) == (True, "")
            assert torch.equal(k[1], p[1])
            if d is None:
                assert torch.equal(k[2], p[2])
            else:
                assert k[2] is None and p[2] is None
            kc, kd = KN.CYCLE(cfg, k[0], k[1])
            pc, pd = penv.engine.cycle_plain(p[0], p[1])
            assert kc.equal(pc) == (True, "") and torch.equal(kd, pd)
        a = random_bot(penv, BIAS)(s, 0, torch.rand(
            (B, kenv.h, kenv.w, 2), generator=g, device="cuda"))
        for nd in (None, 10):
            kc, pc = KN.DECODE(kenv.cfg, s, a, 0, nd), penv.decode_plain(
                s, a, 0, nd)
            for f in ("atype", "aparam", "atx", "aty", "aptype", "rank"):
                assert torch.equal(getattr(kc, f), getattr(pc, f)), f
        for name in ("simple_eval", "simple_sqrt_eval", "simple_sqrt_eval2",
                     "simple_sqrt_eval3", "simple_opt_eval",
                     "lanchester_eval"):
            fn = getattr(EV, name)
            for p in (0, 1, lanes):
                extra = (ids,) if name == "lanchester_eval" else ()
                kv = fn(s, p, cfg, *extra)
                pv = fn(s, p, cfg, *extra, plain=True)
                if "sqrt" in name:
                    assert torch.equal(kv, pv), name
                else:
                    assert ((kv - pv).abs()
                            <= 1e-5 * pv.abs().clamp(min=1)).all(), name
        assert torch.equal(EV.simple_opt_upper_bound(s, cfg),
                           EV.simple_opt_upper_bound(s, cfg, plain=True))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_decision_frame_path_equals_plain_on_card():
    """A round robin of three bots (6 lanes, 80 cycles) and MonteCarlo
    (K=4, playout_len 16) against WorkerRush (4 games, 12 cycles) through
    the kernels equal the plain path with the same generator: winners and
    final states; the tournament launches event_jump, MonteCarlo also
    evaluate."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots.search import monte_carlo_bot
    from microrts_tpu_torch.eval import tournament as TN
    path = asset_path("maps/8x8/basesWorkers8x8.xml")
    names = ("RandomBiasedAI", "WorkerRush", "LightRush")
    ii, jj = TN.pairings(3, 1)
    z = torch.zeros(4, dtype=torch.int64)
    out = []
    for plain in (False, True):
        env = GridnetEnv(path, device="cuda", plain=plain)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        KN.reset_counts()
        rr = TN._games_fn(env, [make_bot(n, env) for n in names], 80)(
            torch.from_numpy(ii), torch.from_numpy(jj), g)
        rr_counts = KN.counts()
        KN.reset_counts()
        mc = TN._games_fn(env, [monte_carlo_bot(env, 4, 16),
                                make_bot("WorkerRush", env)], 12,
                          fixed_pair=True)(z, z + 1, g)
        mc_counts = KN.counts()
        if plain:
            assert not any(rr_counts.values()) and not any(
                mc_counts.values())
        else:
            assert rr_counts["event_jump"] > 0 and rr_counts["rush"] > 0
            assert rr_counts["evaluate"] == 0
            assert mc_counts["event_jump"] > 0 and mc_counts["evaluate"] > 0
        out.append((rr, mc))
    torch.cuda.synchronize()
    for (kw, ks, _), (pw, ps, _) in zip(out[0], out[1]):
        assert torch.equal(kw, pw)
        assert ks.equal(ps) == (True, "")


@pytest.mark.gpu
def test_decision_frame_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cuda")
    s = env.reset(4)
    cfg = env.cfg.engine
    with pytest.raises(TypeError):
        KN.EVENT_JUMP(s, s.time.long(), 512)
    with pytest.raises(ValueError):
        KN.EVENT_JUMP(s, None, 512, torch.zeros(3, dtype=torch.bool,
                                                device="cuda"))
    with pytest.raises(TypeError):
        KN.CYCLE(cfg, s, torch.ones(4, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError):
        KN.DECODE(env.cfg, s, torch.zeros((4, 8, 8, 7), dtype=torch.int32,
                                          device="cuda"), 0, -1)
    p = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        KN.EVALUATE(cfg, "sqrt3", s.replace(hp=s.hp.int()), p)
    with pytest.raises(ValueError):
        KN.EVALUATE(cfg, "sqrt3", s, p[:2])
    with pytest.raises(KeyError):
        KN.EVALUATE(cfg, "nope", s, p)


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_per_lane_player_actor_decode_on_card(map_rel):
    """The actor's masks and decode with a per-env player vector equal two
    single-player launches merged by lane, and the plain versions."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    env = GridnetEnv(asset_path(map_rel), device="cuda")
    penv = GridnetEnv(asset_path(map_rel), device="cuda", plain=True)
    B = 64
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    pl = (torch.rand(B, generator=g, device="cuda") < 0.5).to(torch.int32)
    lane = (pl == 1)[:, None, None, None]
    for s in _random_states(penv, B, 40, 6):
        m = KN.ACTOR(env.cfg.engine, s, pl, masks=True)[1]
        one = [KN.ACTOR(env.cfg.engine, s, p, masks=True)[1] for p in (0, 1)]
        assert torch.equal(m, torch.where(lane, one[1], one[0]))
        assert torch.equal(m, penv.masks(s, pl))
        a = random_bot(penv, BIAS)(s, 0, torch.rand(
            (B, env.h, env.w, 2), generator=g, device="cuda"))
        a = torch.where(lane, random_bot(penv, BIAS)(s, 1, torch.rand(
            (B, env.h, env.w, 2), generator=g, device="cuda")), a)
        c = KN.DECODE(env.cfg, s, a, pl)
        c1 = [KN.DECODE(env.cfg, s, a, p) for p in (0, 1)]
        cp = penv.decode(s, a, pl)
        for f in ("atype", "aparam", "atx", "aty", "aptype", "rank"):
            want = torch.where(lane[..., 0], getattr(c1[1], f),
                               getattr(c1[0], f))
            assert torch.equal(getattr(c, f), want), f
            assert torch.equal(getattr(c, f), getattr(cp, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_arm_sample_arms_to_action_equal_plain_on_card(map_rel):
    """K12b in its four modes on random visit tables, and arms_to_action,
    against their plain versions: arm planes and actions equal."""
    _need_card()
    from microrts_tpu_torch.ops import arms as AR
    penv = GridnetEnv(asset_path(map_rel), device="cuda", plain=True)
    sp = AR.arm_space(penv)
    B, N1, A = 32, 5, sp.n_arms
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    dev = "cuda"
    for s in _random_states(penv, B, 30, 8):
        pl = (torch.rand(B, generator=g, device=dev) < 0.5).to(torch.int32)
        mask = penv.masks(s, pl)
        shape = (B, N1, penv.h, penv.w, A)
        tvis = torch.randint(0, 3, shape, generator=g, device=dev,
                             dtype=torch.int32)
        tacc = torch.randn(shape, generator=g, device=dev) * tvis
        nvis = torch.randint(0, 40, (B, N1), generator=g, device=dev,
                             dtype=torch.int32)
        cur = torch.randint(0, N1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        gum = gumbel_noise((B, penv.h, penv.w, A), g, dev)
        for mode in ("egreedy", "ucb", "unit_uct"):
            args = (sp, mask, gum, mode, (tvis, tacc, nvis), cur, pl, 0,
                    0.3, 0.7, 0.05)
            k = AR.arm_sample(*args)
            p = AR.arm_sample(*args, plain=True)
            assert torch.equal(k[0], p[0]), mode
            assert torch.equal(k[1], p[1]), mode
            assert (k[0] >= 0).any()
        gk = gumbel_noise((B, 3, penv.h, penv.w, A), g, dev)
        k = AR.arm_sample(sp, mask, gk, "uniform")[0]
        assert torch.equal(k, AR.arm_sample(sp, mask, gk, "uniform",
                                            plain=True)[0])
        assert torch.equal(AR.arms_to_action(sp, k[:, 1].contiguous()),
                           AR.arms_to_action_plain(sp, k[:, 1]))


def _tree_eq(kt, pt):
    for f in type(kt).FIELDS:
        assert torch.equal(getattr(kt, f), getattr(pt, f)), f
    assert kt.states.equal(pt.states) == (True, "")


@pytest.mark.gpu
def test_tree_search_kernels_equal_plain_on_card():
    """NaiveMCTS (epsilon-greedy, TwoPhase, MLPS, UCTUnitActions) and UCT
    (with and without first-play urgency) decisions through the kernels
    equal the plain path with the same draws: whole trees and actions;
    K12b-d launched on the kernel path."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import treesearch as TS
    path = asset_path("maps/8x8/basesWorkers8x8.xml")
    kenv = GridnetEnv(path, device="cuda")
    penv = GridnetEnv(path, device="cuda", plain=True)
    s = _random_states(penv, 8, 20, 9)[-1]
    tiny = dict(n_playouts=6, max_nodes=12, max_children=4, max_depth=3,
                playout_len=8)
    cases = [(TS.naive_mcts_bot, tiny),
             (TS.naive_mcts_bot, dict(tiny, eps0=1.0, eps_g=0.3,
                                      phase2=(0.0, 0.3, 0.3))),
             (TS.mlps_mcts_bot, dict(tiny, max_nodes=4)),
             (TS.uct_unit_actions_bot, tiny),
             (TS.uct_tree_bot, dict(n_playouts=6, max_nodes=12,
                                    n_candidates=4, max_depth=3,
                                    playout_len=8)),
             (TS.uct_tree_bot, dict(n_playouts=6, max_nodes=4,
                                    n_candidates=4, max_depth=3,
                                    playout_len=8, fpu=0.5))]
    for make, kw in cases:
        out = []
        for env in (kenv, penv):
            bot = make(env, **kw)
            g = torch.Generator(device="cuda")
            g.manual_seed(11)
            nz = bot.draw(g, s.batch)
            b = bot.bot
            KN.reset_counts()
            if make is TS.uct_tree_bot:
                tree = b.init_tree(s, 1, nz.root())
            else:
                tree = b.init_tree(s, 1)
            b.search(tree, 1, s.time, nz)
            out.append((tree, b.best_action(tree), KN.counts()))
        (kt, ka, kc), (pt, pa, pc) = out
        _tree_eq(kt, pt)
        assert torch.equal(ka, pa)
        assert not any(pc.values())
        assert kc["arm_sample"] > 0 and kc["mcts_descend"] > 0
        assert kc["mcts_backprop"] == kw["n_playouts"]
        assert kc["evaluate"] == kw["n_playouts"]


@pytest.mark.gpu
def test_tree_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.ops import arms as AR
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cuda")
    sp = AR.arm_space(env)
    s = env.reset(4)
    mask = env.masks(s, 0)
    gum = torch.zeros((4, 2, 8, 8, sp.n_arms), device="cuda")
    with pytest.raises(TypeError):
        KN.ARM_SAMPLE(sp, 0, mask.long(), gum)
    with pytest.raises(ValueError):
        KN.ARM_SAMPLE(sp, 0, mask, gum[:2])
    with pytest.raises(TypeError):
        KN.ARMS_TO_ACTION(sp, torch.zeros((4, 8, 8), device="cuda"))
    with pytest.raises(ValueError):
        KN.ACTOR(env.cfg.engine, s, torch.zeros(3, dtype=torch.int32,
                                                device="cuda"), masks=True)


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_enum_next_equals_plain_on_card(map_rel):
    """``enum_next`` (K12e): eight successive draws of both players'
    odometers on recorded states, all lanes active and then every other
    lane, equal the plain version (arms, valid, trips and the odometers
    advanced in place); the initial state (no busy unit) too."""
    _need_card()
    from microrts_tpu_torch.ops import enumerate as EN
    path = asset_path(map_rel)
    kenv = GridnetEnv(path, device="cuda")
    penv = GridnetEnv(path, device="cuda", plain=True)
    seen = 0
    for s in _random_states(penv, 16, 30, 13):
        for p in (0, 1):
            (ki, kn), (pi, pn) = (EN.make_enumerator(e) for e in (kenv, penv))
            kod, kctx = ki(s, p)
            pod, pctx = pi(s, p)
            for i in range(8):
                act = (None if i < 4 else
                       torch.arange(s.batch, device="cuda") % 2 == i % 2)
                got = kn(kod, kctx, active=act)
                for a, b in zip(got, pn(pod, pctx, active=act)):
                    assert torch.equal(a, b), (p, i)
                assert torch.equal(kod.choice, pod.choice)
                assert torch.equal(kod.more, pod.more)
                seen += int(got[1].sum())
    assert seen > 0


@pytest.mark.gpu
def test_minimax_kernels_equal_plain_on_card():
    """ABCD, RTMinimax, IDRTMinimaxRandomized and SampledABCD decisions
    through the kernels equal the plain path with the same draws: whole
    stacks (row S too), root values and actions; ``enum_next`` and
    ``minimax_step`` launched on the kernel path, none on the plain."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import minimax as MM
    path = asset_path("maps/8x8/basesWorkers8x8.xml")
    kenv = GridnetEnv(path, device="cuda")
    penv = GridnetEnv(path, device="cuda", plain=True)
    s = _random_states(penv, 8, 20, 9)[-1]
    for make, kw in ((MM.abcd_bot, dict(max_depth=2, playout_len=8,
                                        node_budget=48)),
                     (MM.rt_minimax_bot, dict(lookahead=12, stack_cap=6,
                                              node_budget=48))):
        out = []
        for env in (kenv, penv):
            KN.reset_counts()
            out.append(make(env, **kw).bot.run(s, 1) + (KN.counts(),))
        (ka, kv, ks, kc), (pa, pv, ps, pc) = out
        assert torch.equal(ka, pa) and torch.equal(kv, pv)
        for f, t in ks.tensors().items():
            assert torch.equal(t, ps.tensors()[f]), f
        assert ks.states.equal(ps.states) == (True, "")
        assert ks.cur.equal(ps.cur) == (True, "")
        assert kc["enum_next"] > 0 and kc["minimax_step"] > 0
        assert not any(pc.values())
    for make, kw in ((MM.idrt_minimax_randomized_bot,
                      dict(k_moves=4, repeats=4, lookahead=12, stack_cap=6,
                           node_budget=24)),
                     (MM.sampled_abcd_bot, dict(k_moves=4, playout_len=8))):
        out = []
        for env in (kenv, penv):
            bot = make(env, **kw)
            g = torch.Generator(device="cuda")
            g.manual_seed(5)
            KN.reset_counts()
            out.append((bot(s, 0, bot.draw(g, s.batch)), KN.counts()))
        assert torch.equal(out[0][0], out[1][0])
        assert not any(out[1][1].values())
        want = make is MM.idrt_minimax_randomized_bot
        assert (out[0][1]["enum_next"] > 0) == want
        assert (out[0][1]["minimax_step"] > 0) == want


@pytest.mark.gpu
def test_minimax_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import minimax as MM
    from microrts_tpu_torch.ops import arms as AR
    from microrts_tpu_torch.ops import enumerate as EN
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cuda")
    sp = AR.arm_space(env)
    s = env.reset(4)
    od, ctx = EN.make_enumerator(env)[0](s, 0)
    row = torch.zeros(4, dtype=torch.int32, device="cuda")
    act = torch.ones(4, dtype=torch.bool, device="cuda")
    cfg = env.cfg.engine
    with pytest.raises(TypeError):
        KN.ENUM_NEXT(cfg, sp, od._replace(choice=od.choice.long()), ctx, row,
                     act)
    with pytest.raises(ValueError):
        KN.ENUM_NEXT(cfg, sp, od, ctx._replace(la=ctx.la[:, :, :, :2]), row,
                     act)
    with pytest.raises(ValueError):
        KN.ENUM_NEXT(cfg, sp, od, ctx, row[:3], act)
    with pytest.raises(TypeError):
        KN.ENUM_NEXT(cfg, sp, od, ctx, row.long(), act)
    stk = MM.new_stack(s, 3, ctx, act, row, row, row.float())
    trip = MM.Trip(act, act, ~act, torch.full((4, 8, 8), -1,
                                              dtype=torch.int32,
                                              device="cuda"))
    with pytest.raises(TypeError):
        KN.MINIMAX_STEP(cfg, sp, stk, trip._replace(finish=row), 0)
    with pytest.raises(ValueError):
        KN.MINIMAX_STEP(cfg, sp, stk, trip._replace(push=act), 0)
    with pytest.raises(TypeError):
        KN.MINIMAX_STEP(cfg, sp, dataclasses.replace(stk,
                                                     alpha=stk.alpha.double()),
                        trip, 0)
    KN.MINIMAX_STEP(cfg, sp, stk, trip, 0)
    assert stk.done.all() and (stk.it == 1).all()


def _claims(g, s, T):
    """Random candidates for every cell of ``s``: mostly moves and
    produces in random directions (parameters past the range too), ranks
    a random permutation of the cells per env."""
    B, H, W = s.utype.shape
    dev = s.utype.device

    def ri(lo, hi):
        return torch.randint(lo, hi, (B, H, W), generator=g, device=dev,
                             dtype=torch.int32)
    coin = torch.rand((B, H, W), generator=g, device=dev)
    at = torch.where(coin < 0.35, 1, torch.where(coin < 0.7, 4, ri(-1, 6)))
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    rank = torch.argsort(torch.rand((B, H * W), generator=g, device=dev), 1)
    from microrts_tpu_torch.engine.types import Candidates
    return Candidates(atype=at.int(), aparam=ri(-1, 5),
                      atx=(xs + ri(-3, 4)).int(), aty=(ys + ri(-3, 4)).int(),
                      aptype=ri(0, T), rank=rank.int().reshape(B, H, W))


def _po_inputs(env, B, ticks, seed):
    """The plain PO step's inputs on the card: [(state, candidates p0,
    state after p0's issue, candidates p1)] of every tick."""
    dev = env.device
    bot = random_bot(env, BIAS)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    s = env.reset(B)
    out = []
    for _ in range(ticks):
        u0, u1 = (torch.rand((B, env.h, env.w, 2), generator=g, device=dev)
                  for _ in (0, 1))
        a0, a1 = bot(s, 0, u0), bot(s, 1, u1)
        c0 = env.decode(s, a0, 0, view=env.po_view(s, 0))
        s1 = env.engine.issue(s, c0)
        c1 = env.decode(s1, a1, 1, view=env.po_view(s1, 1))
        out.append((s, c0, s1, c1))
        s, _ = env.engine.cycle(env.engine.issue(s1, c1))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_issue_kernel_equals_plain_on_card(map_rel):
    """The issue kernel against the plain ``issue``: on the PO step's
    inputs and on random candidate tables under the three move-conflict
    policies (whole states), and against ``issue_env`` on decode-vetted
    full-observation candidates."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.engine.kernel import make_engine
    dev = torch.device("cuda")
    penv = GridnetEnv(asset_path(map_rel), partial_obs=True, device=dev,
                      plain=True)
    cfg = penv.cfg.engine
    B = 64
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bot = random_bot(penv, BIAS)
    counts = {}
    for s, c0, s1, c1 in _po_inputs(penv, B, 40, 1)[::4]:
        for p, st, c in ((0, s, c0), (1, s1, c1)):
            assert KN.ISSUE(cfg, st, c).equal(
                penv.engine.issue_plain(st, c)) == (True, "")
            # decode against the full state's claims: issue_env's inputs
            u = torch.rand((B, penv.h, penv.w, 2), generator=g, device=dev)
            fc = penv.decode_plain(st, bot(st, p, u), p)
            assert KN.ISSUE(cfg, st, fc).equal(
                KN.ISSUE_ENV(cfg, st, fc)) == (True, "")
        for policy in (1, 2, 3):
            pcfg = dataclasses.replace(cfg, move_conflict_policy=policy)
            eng = make_engine(pcfg, plain=True)
            st = s1.replace(
                cancel_ctr=torch.randint(0, 6, (B,), generator=g, device=dev,
                                         dtype=torch.int32),
                resources=torch.randint(0, 12, (B, 2), generator=g,
                                        device=dev, dtype=torch.int32))
            c = _claims(g, st, cfg.num_types)
            coins = torch.rand((B, penv.h, penv.w, 4), generator=g,
                               device=dev) < 0.5
            want = eng.issue_plain(st, c, coins, counts)
            assert KN.ISSUE(pcfg, st, c, coins).equal(want) == (True, "")
    # melee8x8Mixed6 has no producer: its produces never reach the
    # resource cancel
    assert counts["xc_position"] > 0, counts
    assert counts["xc_resource"] > 0 or "melee" in map_rel, counts


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_fog_kernels_equal_plain_on_card(map_rel):
    """po_state, obs_po (with the one-hot) and decode with a view against
    their plain versions, both players and a per-lane player vector."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.engine import fog
    from microrts_tpu_torch.engine.types import Candidates
    dev = torch.device("cuda")
    penv = GridnetEnv(asset_path(map_rel), partial_obs=True, device=dev,
                      plain=True)
    kenv = GridnetEnv(asset_path(map_rel), partial_obs=True, device=dev)
    cfg = penv.cfg.engine
    B = 64
    lanes = (torch.arange(B, device=dev) % 2).int()
    bot = random_bot(penv, BIAS)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    for s, _, _, _ in _po_inputs(penv, B, 60, 2)[::6]:
        for p in (0, 1, lanes):
            view, vis = KN.PO_STATE(cfg, s, p)
            assert view.equal(fog.po_state_plain(s, p, cfg)) == (True, "")
            assert torch.equal(vis, fog.visibility_plain(s, p, cfg))
            assert torch.equal(KN.PO_STATE(cfg, s, p, view=False)[1], vis)
            obs, oh = KN.OBS_PO(cfg, s, (p, 0), onehot=(0, 1))
            assert torch.equal(obs[0], fog.observation_po_plain(s, p, cfg))
            assert torch.equal(obs[1], fog.observation_po_plain(s, 0, cfg))
            assert torch.equal(oh[1], penv.observation_onehot_plain(s, 0))
            u = torch.rand((B, penv.h, penv.w, 2), generator=g, device=dev)
            a = bot(s, 0, u)
            kc = kenv.decode(s, a, p, view=view)
            pc = penv.decode_plain(s, a, p, view=view)
            for f in Candidates.FIELDS:
                assert torch.equal(getattr(kc, f), getattr(pc, f)), f


@pytest.mark.gpu
def test_po_vec_env_and_pool_equal_plain_on_card():
    """The PO ``VecGridnetEnv`` and a PO ``MapPoolVecEnv`` (a padded 8x8
    map in a 16x16 pool) through the kernels against the plain path, with
    resets, and the PO step's launches."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.env.pool import MapPoolVecEnv
    dev = torch.device("cuda")
    path = asset_path(MAPS[1])
    pool_maps = [path, asset_path("maps/8x8/basesWorkers8x8.xml"),
                 asset_path("maps/16x16/TwoBasesBarracks16x16.xml")]
    B, ticks = 48, 40
    pairs = [(VecGridnetEnv(GridnetEnv(path, partial_obs=True, device=dev),
                            B, 20),
              VecGridnetEnv(GridnetEnv(path, partial_obs=True, device=dev,
                                       plain=True), B, 20)),
             tuple(MapPoolVecEnv(pool_maps, B, max_steps=20,
                                 partial_obs=True, device=dev, plain=plain)
                   for plain in (False, True))]
    for kvec, pvec in pairs:
        kbot, pbot = random_bot(kvec.env, BIAS), random_bot(pvec.env, BIAS)
        ks, ksteps = kvec.reset()
        ps, psteps = pvec.reset()
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        resets = 0
        KN.reset_counts()
        for t in range(ticks):
            u0, u1 = (torch.rand((B, 16, 16, 2), generator=g, device=dev)
                      for _ in (0, 1))
            kout = kvec.step(ks, ksteps, kbot(ks, 0, u0), kbot(ks, 1, u1),
                             onehot=(1,))
            pout = pvec.step(ps, psteps, pbot(ps, 0, u0), pbot(ps, 1, u1),
                             onehot=(1,))
            assert kout[0].equal(pout[0]) == (True, ""), t
            for a, b in zip(kout[1:], pout[1:]):
                assert torch.equal(a, b), t
            (ks, ksteps), (ps, psteps) = kout[:2], pout[:2]
            resets += int(kout[5].sum())
        assert resets > 0
        c = KN.counts()
        assert c == dict(c, actor=2 * ticks, decode=2 * ticks,
                         issue=2 * ticks, po_state=2 * ticks, cycle=ticks,
                         epilogue=ticks, splice_obs=ticks, obs_po=ticks)
        assert sum(c.values()) == 12 * ticks, c


@pytest.mark.gpu
def test_fog_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     partial_obs=True, device="cuda")
    cfg = env.cfg.engine
    s = env.reset(4)
    z = torch.zeros((4, 8, 8, 7), dtype=torch.int32, device="cuda")
    c = env.decode(s, z, 0)
    rnd = dataclasses.replace(cfg, move_conflict_policy=2)
    with pytest.raises(ValueError, match="coins"):
        KN.ISSUE(rnd, s, c)
    with pytest.raises(TypeError):
        KN.ISSUE(rnd, s, c, torch.zeros((4, 8, 8, 4), device="cuda"))
    with pytest.raises(TypeError):
        KN.PO_STATE(cfg, s, torch.zeros(4, dtype=torch.int64,
                                        device="cuda"))
    with pytest.raises(ValueError):
        KN.OBS_PO(cfg, s, (0, 1, 0))
    with pytest.raises(ValueError):
        KN.DECODE(env.cfg, s, z, 0, view=State(**{
            f: getattr(s, f)[:2] for f in FIELD_DTYPES}))
    assert KN.ISSUE(cfg, s, c).equal(env.engine.issue_plain(s, c)) == (
        True, "")


# ----------------------------------------------------------------------
# the stateful bots (K13 believe_update, K12g mcts_reroot)

def _rush_po_states(env, B, ticks, seed):
    """Plain WorkerRush-vs-LightRush states on the card after 4k random
    ticks (env k), every 8th tick."""
    rnd = random_bot(env, BIAS)
    p0, p1 = S.worker_rush(env), S.light_rush(env)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    s = env.reset(B)
    early = (torch.arange(B, device="cuda") * 4)[:, None, None, None]
    out = []
    for t in range(ticks):
        if t % 8 == 0:
            out.append(s)
        u = [torch.rand((B, env.h, env.w, 2), generator=g, device="cuda")
             for _ in (0, 1)]
        a0 = torch.where(t < early, rnd(s, 0, u[0]), p0(s, 0))
        a1 = torch.where(t < early, rnd(s, 1, u[1]), p1(s, 1))
        s = env.step(s, a0, a1)[0]
    return out


def _mem_eq(a, b):
    from microrts_tpu_torch.bots.believestate import BelieveMem
    for f in BelieveMem.PLANES:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.prev.equal(b.prev) == (True, "")


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", ["maps/8x8/basesWorkers8x8.xml",
                                     MAPS[1]])
def test_believe_update_equals_plain_on_card(map_rel):
    """``believe_update`` (init, update and the sampled world) for the
    three levels and both observers against the plain versions, tick by
    tick along a rush run (half the lanes with their seen types cleared,
    so that producers are inferred), with one launch an init or update."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import believestate as BS
    dev = torch.device("cuda")
    kenv = GridnetEnv(asset_path(map_rel), device=dev)
    penv = GridnetEnv(asset_path(map_rel), device=dev, plain=True)
    B = 32
    states = _rush_po_states(penv, B, 240, 3)
    inner = S.Opponent(lambda w, p, n: w)
    for level in (1, 2, 3):
        counts = dict.fromkeys(BS.RULES, 0)
        for p in (0, 1):
            kb = BS.believe_state_bot(kenv, inner, level=level)
            pb = BS.believe_state_bot(penv, inner, level=level)
            KN.reset_counts()
            km, pm = kb.init(states[8], p), pb.init(states[8], p)
            _mem_eq(km, pm)
            km.seen_type[B // 2:] = False
            pm.seen_type[B // 2:] = False
            for s in states[9:]:
                km, kw = kb.update(s, km, p)
                pm, pw = pb.update(s, pm, p, counts)
                _mem_eq(km, pm)
                assert kw.equal(pw) == (True, "")
            c = KN.counts()
            n = len(states) - 8
            assert c["believe_update"] == n and c["po_state"] == n, c
        for rule in ("remembered", "forgotten_by_uid", "inferred",
                     "relocated") if level == 3 else ():
            assert counts[rule] > 0, (rule, counts)


@pytest.mark.gpu
def test_reroot_equals_plain_on_card():
    """``mcts_reroot`` against the plain version on NaiveMCTS trees after
    a real step: hits at the node of the played action or deeper, misses,
    lanes left out by ``live``; and ContinuingNaiveMCTS decisions over
    frames through the kernels equal to the plain path (whole trees,
    actions) with the re-root launched once a decision."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import treesearch as TS
    from microrts_tpu_torch.ops.playout import fast_forward
    path = asset_path("maps/8x8/basesWorkers8x8.xml")
    kenv = GridnetEnv(path, device="cuda")
    penv = GridnetEnv(path, device="cuda", plain=True)
    kw = dict(n_playouts=8, max_nodes=24, max_children=4, max_depth=3,
              playout_len=8)
    B = 16
    s = _random_states(penv, B, 20, 9)[-1]
    rush = make_bot("WorkerRush", penv)
    bots = [TS.naive_mcts_continuing(e, **kw) for e in (kenv, penv)]
    mems = [b.init(s, 0) for b in bots]
    done = torch.zeros(B, dtype=torch.bool, device="cuda")
    g = torch.Generator(device="cuda")
    hits = 0
    for frame in range(4):
        out = []
        for env, b, m in zip((kenv, penv), bots, mems):
            g.manual_seed(30 + frame)
            KN.reset_counts()
            # the re-root alone, on a copy, then the whole step
            t = dataclasses.replace(m, states=m.states.clone(), **{
                f: getattr(m, f).clone() for f in TS.NaiveTree.FIELDS})
            live = torch.arange(B, device="cuda") % 3 != 0
            TS.mcts_reroot(env, t, s, 0, kw["max_depth"], live)
            out.append((t,) + b.step(s, m, 0, b.draw(g, B)) + (KN.counts(),))
        (kt, ka, km, kc), (pt, pa, pm, pc) = out
        _tree_eq(kt, pt)
        _tree_eq(km, pm)
        assert torch.equal(ka, pa)
        assert kc["mcts_reroot"] == 2 and not any(pc.values()), (kc, pc)
        hits += int((km.nvis[:, 0] > kw["n_playouts"]).sum())
        mems = [km, pm]
        s, _, d = penv.step(s, pa, rush(s, 1))
        done = done | d
        s, done = fast_forward(penv, s, done)
    assert hits > 0


@pytest.mark.gpu
def test_stateful_loop_equals_plain_on_card():
    """``play_matches_stateful`` of BS3 (small NaiveMCTS) against
    POWorkerRush and of ContinuingNaiveMCTS against WorkerRush through the
    kernels equal to the plain path: winners, final states."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import believestate as BS
    from microrts_tpu_torch.bots import treesearch as TS
    path = asset_path("maps/8x8/basesWorkers8x8.xml")
    kw = dict(n_playouts=2, max_nodes=12, max_children=4, max_depth=3,
              playout_len=8)
    out = []
    for plain in (False, True):
        env = GridnetEnv(path, device="cuda", plain=plain)
        pairs = [(BS.believe_state_bot(env, TS.naive_mcts_bot(env, **kw)),
                  BS.stateless(make_bot("POWorkerRush", env))),
                 (TS.naive_mcts_continuing(env, **kw),
                  BS.stateless(make_bot("WorkerRush", env)))]
        KN.reset_counts()
        out.append([BS.play_matches_stateful(env, a, b, 8, 12, seed=5)
                    for a, b in pairs] + [KN.counts()])
    for (kw_, ks, kf), (pw, ps, pf) in zip(out[0][:2], out[1][:2]):
        assert kf == pf and torch.equal(kw_, pw)
        assert ks.equal(ps) == (True, "")
    kc = out[0][2]
    assert kc["believe_update"] > 0 and kc["mcts_reroot"] > 0, kc
    assert not any(out[1][2].values())


@pytest.mark.gpu
def test_stateful_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import believestate as BS
    from microrts_tpu_torch.bots import treesearch as TS
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cuda")
    cfg = env.cfg.engine
    s = env.reset(4)
    view, vis = KN.PO_STATE(cfg, s, 0)
    sp, pr = BS.spiral_offsets(6), BS.producers(cfg)
    mem = BS.BelieveMem(prev=view, prev_vis=vis, **KN.BELIEVE(
        cfg, 3, sp, pr, s, view, vis, 0)[0])
    with pytest.raises(ValueError):
        KN.BELIEVE(cfg, 4, sp, pr, s, view, vis, 0, mem)
    with pytest.raises(ValueError):
        KN.BELIEVE(cfg, 3, sp, pr[:-1], s, view, vis, 0, mem)
    with pytest.raises(TypeError):
        KN.BELIEVE(cfg, 3, sp, pr, s, view, vis.int(), 0, mem)
    with pytest.raises(ValueError):
        KN.BELIEVE(cfg, 3, sp, pr, s, view, vis, 0, dataclasses.replace(
            mem, b_hp=mem.b_hp[:2]))
    with pytest.raises(ValueError):
        KN.BELIEVE(cfg, 3, sp, pr, s, view, vis.cpu(), 0, mem)
    with pytest.raises(ValueError):
        BS.believe_state_bot(env, S.Opponent(lambda w, p, n: w)).update(
            s, mem, 0, dict.fromkeys(BS.RULES, 0))
    bot = TS.naive_mcts_bot(env, n_playouts=2, max_nodes=6, max_children=2,
                            max_depth=2, playout_len=4).bot
    tree = bot.init_tree(s, 0)
    to_move = torch.zeros(4, dtype=torch.int32, device="cuda")
    term = torch.zeros(4, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        KN.REROOT(cfg, tree, s, to_move.long(), term, 2)
    with pytest.raises(ValueError):
        KN.REROOT(cfg, tree, State(**{f: getattr(s, f)[:2]
                                      for f in FIELD_DTYPES}),
                  to_move, term, 2)
    with pytest.raises(ValueError):
        KN.REROOT(cfg, dataclasses.replace(tree, tacc=tree.tacc[:, :, :4]),
                  s, to_move, term, 2)
    KN.REROOT(cfg, tree, s, to_move, term, 2)
    assert int(tree.nnodes.sum()) == 4


# ----------------------------------------------------------------------
# slice 9: UTT v3's damage draw in cycle, the closer rewards in the
# epilogue, env_health and the quarantined vec step

@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_v3_quarantined_step_equals_plain_on_card(map_rel):
    """The vec step under UTT v3 with all eight rewards and quarantine,
    kernel path against plain path with the same draws (damage uniforms
    from one generator): states, observations, rewards and reset mask
    equal every tick; lanes with planted faults quarantined on both;
    ``cycle`` with ``u01`` and ``env_health`` launched once a tick."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.engine.utt import UnitTypeTable
    from microrts_tpu_torch.env.gridnet import REWARD_NAMES
    dev = torch.device("cuda")
    B, ticks = 64, 60
    envs = [GridnetEnv(asset_path(map_rel), UnitTypeTable(3), device=dev,
                       reward_fns=REWARD_NAMES, plain=p)
            for p in (False, True)]
    vecs = [VecGridnetEnv(e, B, 40, quarantine=True) for e in envs]
    bots = [random_bot(e, BIAS) for e in envs]
    st = [v.reset() for v in vecs]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    KN.reset_counts()
    quarantined = closer = 0
    for t in range(ticks):
        u0, u1 = (torch.rand((B, envs[0].h, envs[0].w, 2), generator=g,
                             device=dev) for _ in (0, 1))
        u01 = envs[0].draw_u01(g, 1, B)
        if t % 10 == 5:   # a negative stockpile in lane t
            for s, _ in st:
                s.resources[t, 0] = -1
        outs = [v.step(s, n, b(s, 0, u0), b(s, 1, u1), u01=u01)
                for v, b, (s, n) in zip(vecs, bots, st)]
        (ko, po) = outs
        assert ko[0].equal(po[0]) == (True, ""), (t, ko[0].equal(po[0]))
        for a, b in zip(ko[1:], po[1:]):
            assert torch.equal(a, b), t
        if t % 10 == 5:
            assert bool(ko[5][t]) and int(ko[1][t]) == 0, t
            quarantined += 1
        closer += int((ko[3][..., 6:] != 0).sum())
        st = [o[:2] for o in outs]
    torch.cuda.synchronize()
    c = KN.counts()
    assert c["cycle"] == ticks and c["env_health"] == ticks, c
    assert c["epilogue"] == ticks, c
    assert quarantined == ticks // 10 and closer > 0


@pytest.mark.gpu
def test_v3_cycle_active_and_env_health_equal_plain_on_card():
    """``cycle`` with ``u01`` and ``active`` lanes, and ``env_health`` on
    planted faults, each against its plain version."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.engine.utt import UnitTypeTable
    from microrts_tpu_torch.env.vec import env_health_plain
    dev = torch.device("cuda")
    env = GridnetEnv(asset_path(MAPS[0]), UnitTypeTable(3), device=dev,
                     plain=True)
    B = 64
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bot = random_bot(env, BIAS)
    s = env.reset(B)
    above = 0
    for t in range(120):
        u0, u1 = (torch.rand((B, env.h, env.w, 2), generator=g, device=dev)
                  for _ in (0, 1))
        c0 = env.decode(s, bot(s, 0, u0), 0)
        s1 = env.engine.issue_env(s, c0)
        s2 = env.engine.issue_env(s1, env.decode(s1, bot(s1, 1, u1), 1))
        u01 = torch.rand((B, env.h, env.w), generator=g, device=dev)
        active = torch.rand(B, generator=g, device=dev) < 0.7
        for act in (active, None):
            kn, kd = KN.CYCLE(env.cfg.engine, s2, act, u01)
            pn, pd = env.engine.cycle_plain(s2, act, u01)
            assert kn.equal(pn) == (True, "") and torch.equal(kd, pd), t
        above += int(((s2.hp - kn.hp) > 2).sum())
        s = pn   # every lane cycled: no post-issue NONE(-1) left busy
    assert above > 0
    rew = torch.zeros((B, 16), device=dev)
    bad = s.clone()
    bad.hp[1] = torch.where(bad.utype[1] > 0, 0, bad.hp[1])
    bad.utype[2, 0, 0] = env.cfg.engine.num_types + 1
    bad.busy[3, 0, 0], bad.aticks[3, 0, 0] = True, -1
    bad.resources[4, 1] = -5
    rew[5, 7] = float("nan")
    rew[6, 0] = float("-inf")
    k = KN.ENV_HEALTH(env.cfg.engine, bad, rew)
    assert torch.equal(k, env_health_plain(bad, rew, env.cfg.engine))
    assert k[1:7].all() and not k[7:].any()


@pytest.mark.gpu
def test_slice9_kernels_reject_bad_input_on_card():
    """v3 without ``u01``, ``u01`` under v2, a wrong-shaped ``u01`` and a
    wrong-shaped reward table are refused on the card."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.engine.utt import UnitTypeTable
    dev = torch.device("cuda")
    e3 = GridnetEnv(asset_path(MAPS[0]), UnitTypeTable(3), device=dev)
    e2 = GridnetEnv(asset_path(MAPS[0]), device=dev)
    s3, s2 = e3.reset(4), e2.reset(4)
    with pytest.raises(ValueError, match="needs u01"):
        KN.CYCLE(e3.cfg.engine, s3)
    with pytest.raises(ValueError, match="needs u01"):
        e3.engine.cycle(s3)
    u = torch.rand((4, e3.h, e3.w), device=dev)
    with pytest.raises(ValueError, match="deterministic"):
        KN.CYCLE(e2.cfg.engine, s2, None, u)
    with pytest.raises(ValueError, match="shape"):
        KN.CYCLE(e3.cfg.engine, s3, None, u[:, :-1])
    with pytest.raises(TypeError):
        KN.CYCLE(e3.cfg.engine, s3, None, u.double())
    with pytest.raises(ValueError):
        KN.ENV_HEALTH(e2.cfg.engine, s2, torch.zeros(4, device=dev))
    with pytest.raises(ValueError):
        KN.ENV_HEALTH(e2.cfg.engine, s2, torch.zeros((4, 2)))


# ----------------------------------------------------------------------
# slice 10: the standalone BFS fields (K9 rest), the expert interface and
# the DSL's stencils

def _rush_states(env, B, ticks, seed):
    """Kernel-path WorkerRush-vs-LightRush states (RandomBiasedAI for
    player 0's first 20 ticks), every 20th tick."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bot = random_bot(env, BIAS)
    wr, lr = make_bot("WorkerRush", env), make_bot("LightRush", env)
    s = env.reset(B)
    out = []
    for t in range(ticks):
        u = torch.rand((B, env.h, env.w, 2), generator=g, device="cuda")
        s, _, _ = env.step(s, bot(s, 0, u) if t < 20 else wr(s, 0),
                           lr(s, 1))
        if t % 20 == 19:
            out.append(s)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_field_kernels_equal_plain_on_card(map_rel):
    """DISTANCE_FIELDS, DESCEND, DISTANCE_FIELD2 and DESCEND_EXCLUDING
    against the plain versions on random planes (B=64, F=3, H+W sweeps)
    and on a serpentine maze whose far end lies beyond H+W."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.ops import fields as FL
    env = GridnetEnv(asset_path(map_rel), device="cuda")
    H, W = env.h, env.w
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    B = 64
    src = torch.rand((B, 3, H, W), generator=g, device="cuda") < 0.05
    pas = torch.rand((B, H, W), generator=g, device="cuda") < 0.7
    pas[0] = True
    for row in range(1, H - 1, 2):      # the maze in env 0
        pas[0, row] = False
        pas[0, row, (W - 1) * ((row // 2) % 2 == 0)] = True
    src[0] = False
    src[0, :, 0, 0] = True
    mov = torch.rand((B, H, W, 4), generator=g, device="cuda") < 0.8
    d = KN.DISTANCE_FIELDS(src, pas, H + W)
    assert torch.equal(d, FL.distance_fields_plain(src, pas, H + W))
    # the corridor's cell H + W steps away is reached, the ones beyond not
    assert (d[0, 0] == H + W).any() and ((d[0, 0] == (1 << 30))
                                         & pas[0]).any()
    d0 = d[:, 0].contiguous()
    assert torch.equal(KN.DESCEND(d0, mov),
                       FL.descend_direction_plain(d0, mov))
    s0 = src[:, 0].contiguous()
    st = KN.DISTANCE_FIELD2(s0, pas, H + W)
    for a, b in zip(st, FL.distance_field2_plain(s0, pas, H + W)):
        assert torch.equal(a, b)
    sid = torch.randint(-1, H * W, (B, H, W), generator=g, device="cuda",
                        dtype=torch.int32)
    assert torch.equal(KN.DESCEND_EXCLUDING(st, mov, sid),
                       FL.descend_direction_excluding_plain(st, mov, sid))


@pytest.mark.gpu
def test_expert_kernels_equal_plain_on_card():
    """EXPERT_MACRO for every macro and both players (random role tables)
    and EXPERT_DETAILED (seeded logits) against the plain versions on
    rush states of basesWorkers16x16; then 40 ticks of ExpertEnv.step_vs
    against WorkerRush kernel vs plain, states and roles equal."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.env.expert import (DetailedNoise, ExpertEnv,
                                               ExpertNoise, ExpertRoles,
                                               NUM_MACROS,
                                               detailed_to_gridnet)
    dev = torch.device("cuda")
    B = 64
    kenv = GridnetEnv(asset_path(MAPS[1]), device=dev)
    penv = GridnetEnv(asset_path(MAPS[1]), device=dev, plain=True)
    kex, pex = ExpertEnv(kenv), ExpertEnv(penv)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    T = kenv.cfg.engine.num_types
    for s in _rush_states(kenv, B, 120, 5):
        for p in (0, 1):
            roles = ExpertRoles(
                torch.rand((B, 1024), generator=g, device=dev) < 0.5,
                torch.rand((B, 1024), generator=g, device=dev) < 0.5,
                torch.randint(0, 16, (B, 1024), generator=g, device=dev,
                              dtype=torch.int32),
                torch.randint(0, 16, (B, 1024), generator=g, device=dev,
                              dtype=torch.int32))
            for m in range(NUM_MACROS):
                nz = ExpertNoise.draw(g, B, kenv)
                mac = torch.full((B,), m, dtype=torch.int32, device=dev)
                ka, kr = kex.macro_to_gridnet(s, roles, p, mac, nz)
                pa, pr = pex.macro_to_gridnet(s, roles, p, mac, nz)
                assert torch.equal(ka, pa), (m, p)
                for f in ExpertRoles.FIELDS:
                    assert torch.equal(getattr(kr, f), getattr(pr, f)), f
            tl = torch.randn((B, T), generator=g, device=dev)
            ml = torch.randn((B, 16, 16), generator=g, device=dev)
            dn = DetailedNoise.draw(g, B, kenv)
            assert torch.equal(detailed_to_gridnet(kex, s, p, tl, ml, dn),
                               detailed_to_gridnet(pex, s, p, tl, ml, dn))
    ks = kenv.reset(B)
    ps = ks.clone()
    kr, pr = ExpertRoles.init(B, dev), ExpertRoles.init(B, dev)
    kw, pw = make_bot("WorkerRush", kenv), make_bot("WorkerRush", penv)
    KN.reset_counts()
    for t in range(40):
        mac = torch.multinomial(kex.action_mask(ks, kr, 0).float(), 1,
                                generator=g)[:, 0].int()
        nz = ExpertNoise.draw(g, B, kenv)
        ks, kr, krw, kd = kex.step_vs(ks, kr, mac, kw, nz)
        ps, pr, prw, pd = pex.step_vs(ps, pr, mac, pw, nz)
        assert ks.equal(ps) == (True, ""), t
        for f in ExpertRoles.FIELDS:
            assert torch.equal(getattr(kr, f), getattr(pr, f)), (t, f)
        assert torch.equal(krw, prw) and torch.equal(kd, pd), t
    c = KN.counts()
    assert c["expert_macro"] == 40 and c["rush"] == 40, c
    assert c["distance_fields"] == 0 and c["expert_detailed"] == 0, c


@pytest.mark.gpu
def test_dsl_kernels_and_programs_equal_plain_on_card():
    """RANGE_COVER and DSL_TARGET (all six modes) against their plain
    versions on rush states of basesWorkers16x16, both players; then
    SEED_PROGRAM, a program of every MoveToUnit target and both sides
    and 8 random programs compiled on the kernel env against the plain
    env, with their DslNoise."""
    _need_card()
    import random

    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.env.expert import scan_offsets
    from microrts_tpu_torch.synth import dsl as DS
    from microrts_tpu_torch.synth.search import TARGETS, random_program
    dev = torch.device("cuda")
    B = 64
    kenv = GridnetEnv(asset_path(MAPS[1]), device=dev)
    penv = GridnetEnv(asset_path(MAPS[1]), device=dev, plain=True)
    cfg = kenv.cfg.engine
    R = cfg.max_range
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    states = _rush_states(kenv, B, 120, 9)
    for s in states:
        t = (s.utype.long() - 1).clamp(0, cfg.num_types - 1)
        rng = penv.engine.lut("attack_range", dev)[t]
        dmg = penv.engine.lut("max_damage", dev)[t]
        u = torch.rand((B, (2 * R + 1) ** 2, 16, 16), generator=g,
                       device=dev)
        for p in (0, 1):
            mine = (s.utype > 0) & (s.owner == p)
            enemy = (s.utype > 0) & (s.owner >= 0) & (s.owner != p)
            assert torch.equal(KN.RANGE_COVER(cfg, s, mine),
                               DS.range_cover_plain(mine, rng, R))
            for mode in range(6):
                for a, b in zip(
                        KN.DSL_TARGET(cfg, s, p, mode, u, scan_offsets(R)),
                        DS.dsl_target_plain(mode, enemy, s.hp, dmg, rng, R,
                                            u)):
                    assert torch.equal(a, b), mode
    progs = [DS.SEED_PROGRAM, tuple(
        DS.MoveToUnit("All", t, side) for t in TARGETS
        for side in ("Ally", "Enemy"))]
    progs += [random_program(random.Random(i)) for i in range(8)]
    players = (torch.arange(B, device=dev) % 2).int()
    for prog in progs:
        kb = DS.program_opponent(kenv, prog)
        pb = DS.compile_program(penv, prog)
        for s in states:
            for p in (0, 1, players):
                nz = kb.draw(g, B)
                assert torch.equal(kb(s, p, nz), pb(s, p, nz)), prog


@pytest.mark.gpu
def test_slice10_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.env.expert import (DetailedNoise, ExpertEnv,
                                               ExpertNoise, ExpertRoles,
                                               detailed_to_gridnet,
                                               scan_offsets)
    from microrts_tpu_torch.synth import dsl as DS
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cuda")
    cfg = env.cfg.engine
    s = env.reset(4)
    src = torch.zeros((4, 2, 8, 8), dtype=torch.bool, device="cuda")
    pas = torch.ones((4, 8, 8), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        KN.DISTANCE_FIELDS(src.cpu(), pas.cpu(), 16)
    with pytest.raises(TypeError):
        KN.DISTANCE_FIELDS(src.int(), pas, 16)
    with pytest.raises(ValueError):
        KN.DISTANCE_FIELDS(src, pas[:2], 16)
    with pytest.raises(TypeError):
        KN.DESCEND(torch.zeros((4, 8, 8), device="cuda"),
                   torch.ones((4, 8, 8, 4), dtype=torch.bool, device="cuda"))
    with pytest.raises(ValueError):
        KN.DISTANCE_FIELD2(src[:, 0], pas, 16)        # not contiguous
    ex = ExpertEnv(env)
    roles = ExpertRoles.init(4, "cuda")
    g = torch.Generator(device="cuda")
    nz = ExpertNoise.draw(g, 4, env)
    with pytest.raises(ValueError):
        ex.macro_to_gridnet(s, roles, 0, 1, None)
    with pytest.raises(ValueError):
        ex.macro_to_gridnet(s, ExpertRoles(*[getattr(roles, f)[:, :512]
                                             for f in ExpertRoles.FIELDS]),
                            0, 1, nz)
    with pytest.raises(TypeError):
        ex.macro_to_gridnet(s, roles, 0, 1, nz._replace(rx=nz.rx.long()))
    T = cfg.num_types
    dn = DetailedNoise.draw(g, 4, env)
    with pytest.raises(ValueError):
        detailed_to_gridnet(ex, s, 0, torch.zeros(T), torch.zeros(8, 8), None)
    with pytest.raises(ValueError):
        KN.EXPERT_DETAILED(cfg, s, 0, torch.zeros((4, T), device="cuda"),
                           torch.zeros((4, 8, 8), device="cuda"),
                           dn._replace(g_tile=dn.g_tile[..., :32]))
    with pytest.raises(ValueError):
        KN.DSL_TARGET(cfg, s, 0, 5, None, scan_offsets(cfg.max_range))
    with pytest.raises(ValueError):
        KN.DSL_TARGET(cfg, s, 0, 6, None, scan_offsets(cfg.max_range))
    with pytest.raises(TypeError):
        KN.RANGE_COVER(cfg, s, pas.int())
    bot = DS.compile_program(env, (DS.Attack("All", "Random"),))
    with pytest.raises(ValueError):
        bot(s, 0, None)


# ----------------------------------------------------------------------
# slice 11: the learned models (K14a aim_predict, K14b nb_predict, K14c
# cooperative_act, K12b's informed mode).  Tolerance: exact (the plain
# versions add in the kernels' order; atan2f, expf, logf as PyTorch
# rounds them on the card).

def _nb_model(sp, sizes, seed):
    """A naive-Bayes model of seeded counts."""
    import numpy as np
    from microrts_tpu_torch.ml.bayes import NaiveBayesModel
    rng = np.random.default_rng(seed)
    return NaiveBayesModel(
        prior=rng.integers(0, 50, sp.n_arms).astype(np.float64),
        cpds=[rng.integers(0, 20, (sp.n_arms, x)).astype(np.float64)
              for x in sizes], calibration=0.35)


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", MAPS)
def test_learned_model_kernels_equal_plain_on_card(map_rel):
    """AIM_PREDICT in its four modes, NB_PREDICT in its three, both
    players and a per-env player vector, COOPERATIVE_ACT on the default
    genomes' nets and ARM_SAMPLE's informed mode on random visit tables
    with the model's prior, against the plain versions on random and rush
    states: exact."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import cooperative as CO
    from microrts_tpu_torch.config import pretrained_wr
    from microrts_tpu_torch.ml import bayes as NB
    from microrts_tpu_torch.ml import pretrained as PT
    from microrts_tpu_torch.ops import arms as AR
    dev = torch.device("cuda")
    B = 64
    kenv = GridnetEnv(asset_path(map_rel), device=dev)
    penv = GridnetEnv(asset_path(map_rel), device=dev, plain=True)
    sp = AR.arm_space(kenv)
    A = sp.n_arms
    pm = PT.load_pretrained(pretrained_wr(), kenv)
    cfg = kenv.cfg.engine
    tab = NB.nb_tables(_nb_model(sp, NB.feature_sizes(cfg), 3), dev)
    coop = CO.cooperative_bot(kenv, seed=1).bot   # genomes whose units act
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    states = _random_states(penv, B, 30, 21)[1:] + _rush_states(kenv, B,
                                                                 100, 22)
    KN.reset_counts()
    acted = 0
    for s in states:
        vec = (torch.rand(B, generator=g, device=dev) < 0.5).to(torch.int32)
        for p in (0, 1, vec):
            mask = kenv.masks(s, p)
            gum = gumbel_noise((B, kenv.h, kenv.w, A), g, dev)
            for mode in PT.MODES:
                gg = gum if mode == "sample" else None
                k = PT.aim_predict(pm, s, mask, p, mode, gg)
                q = PT.aim_predict(pm, s, mask, p, mode, gg, plain=True)
                for a, b in zip(k if isinstance(k, tuple) else (k,),
                                q if isinstance(q, tuple) else (q,)):
                    assert torch.equal(a, b), mode
            for mode in NB.MODES:
                gg = gum if mode == "sample" else None
                k = NB.nb_predict(tab, cfg, sp, s, mask, p, mode, gg)
                q = NB.nb_predict(tab, cfg, sp, s, mask, p, mode, gg,
                                  plain=True)
                for a, b in zip(k if isinstance(k, tuple) else (k,),
                                q if isinstance(q, tuple) else (q,)):
                    assert torch.equal(a, b), mode
            nets = CO.cooperative_nets(kenv, s, p, coop.genomes, coop.dims, 4)
            ka = CO.cooperative_act(kenv, s, p, nets)
            assert torch.equal(ka, CO.cooperative_act_plain(kenv, s, p, nets))
            acted += int((ka[..., 0] > 0).sum())
            pri = PT.aim_predict(pm, s, mask, p, "prior")
            shape = (B, 3, kenv.h, kenv.w, A)
            tvis = torch.randint(0, 3, shape, generator=g, device=dev,
                                 dtype=torch.int32)
            tvis[:, 0] = 0              # row 0 unvisited: the prior's draw
            tacc = torch.randn(shape, generator=g, device=dev) * tvis
            nvis = torch.randint(0, 40, (B, 3), generator=g, device=dev,
                                 dtype=torch.int32)
            cur = torch.randint(0, 3, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            pl = p if isinstance(p, torch.Tensor) else torch.full(
                (B,), p, dtype=torch.int32, device=dev)
            args = (sp, mask, gum, "informed", (tvis, tacc, nvis), cur, pl,
                    0, 0.3, 0.7, 0.05, pri)
            k, q = AR.arm_sample(*args), AR.arm_sample(*args, plain=True)
            assert torch.equal(k[0], q[0]) and torch.equal(k[1], q[1])
    c = KN.counts()
    assert c["aim_predict"] > 0 and c["nb_predict"] > 0
    assert c["cooperative_act"] > 0 and c["arm_sample"] > 0
    assert acted > 0


@pytest.mark.gpu
def test_learned_bots_equal_plain_on_card():
    """InformedNaiveMCTS (reduced budget) decisions, whole trees and
    actions, and UnitActionProbabilityDistributionAI, CooperativeAI and a
    naive-Bayes bot playing WorkerRush (play_matches) through the kernels
    equal the plain path with the same draws."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.bots import treesearch as TS
    from microrts_tpu_torch.config import pretrained_wr
    from microrts_tpu_torch.eval.tournament import play_matches
    from microrts_tpu_torch.ml import bayes as NB
    from microrts_tpu_torch.ops.arms import arm_space
    path = asset_path("maps/8x8/basesWorkers8x8.xml")
    kenv = GridnetEnv(path, device="cuda")
    penv = GridnetEnv(path, device="cuda", plain=True)
    s = _random_states(penv, 8, 20, 9)[-1]
    kw = dict(n_playouts=6, max_nodes=12, max_children=4, max_depth=3,
              playout_len=12)
    out = []
    for env in (kenv, penv):
        bot = TS.informed_naive_mcts_bot(env, pretrained_wr(), **kw)
        g = torch.Generator(device="cuda")
        g.manual_seed(11)
        nz = bot.draw(g, s.batch)
        KN.reset_counts()
        tree = bot.bot.init_tree(s, 0)
        bot.bot.search(tree, 0, s.time, nz)
        out.append((tree, bot.bot.best_action(tree), KN.counts()))
    (kt, ka, kc), (pt, pa, pc) = out
    _tree_eq(kt, pt)
    assert torch.equal(ka, pa)
    assert not any(pc.values())
    assert kc["aim_predict"] > kc["arm_sample"] > 0
    sizes = NB.feature_sizes(kenv.cfg.engine)
    for name in ("UnitActionProbabilityDistributionAI", "CooperativeAI",
                 "nb"):
        ws = []
        for env in (kenv, penv):
            bot = (NB.bayes_bot(env, _nb_model(arm_space(env), sizes, 4))
                   if name == "nb" else make_bot(name, env))
            ws.append(play_matches(env, bot, make_bot("WorkerRush", env),
                                   16, max_cycles=60, seed=2))
        assert (ws[0] == ws[1]).all(), name


@pytest.mark.gpu
def test_learned_kernels_reject_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    from microrts_tpu_torch.config import pretrained_wr
    from microrts_tpu_torch.ml import pretrained as PT
    from microrts_tpu_torch.ops import arms as AR
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cuda")
    s = env.reset(4)
    mask = env.masks(s, 0)
    pm = PT.load_pretrained(pretrained_wr(), env)
    with pytest.raises(ValueError):
        PT.aim_predict(pm, s, mask, 0, "sample")             # no gumbel
    with pytest.raises(ValueError):
        KN.AIM_PREDICT(pm, s, mask[:2], 0, 0)                # batch
    with pytest.raises(ValueError):
        KN.AIM_PREDICT(pm, s, mask, 0, 0, torch.zeros(
            (4, 8, 8, pm.sp.n_arms), device="cuda"))         # gumbel, logits
    with pytest.raises(TypeError):
        KN.AIM_PREDICT(pm, s, mask.float(), 0, 0)
    sp = AR.arm_space(env)
    gum = torch.zeros((4, 8, 8, sp.n_arms), device="cuda")
    tabs = (torch.zeros((4, 2, 8, 8, sp.n_arms), dtype=torch.int32,
                        device="cuda"),
            torch.zeros((4, 2, 8, 8, sp.n_arms), device="cuda"),
            torch.zeros((4, 2), dtype=torch.int32, device="cuda"))
    z = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        AR.arm_sample(sp, mask, gum, "informed", tabs, z, z)  # no prior
    with pytest.raises(ValueError):
        KN.ARM_SAMPLE(sp, 4, mask, gum, tabs, z, z, 0, 0.3, 0.7, 0.0,
                      gum[:2])
    with pytest.raises(ValueError):
        KN.COOPERATIVE_ACT(env.cfg.engine, s, 0,
                           torch.zeros((4, 64, 64), device="cuda"))
