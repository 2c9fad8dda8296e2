"""Helpers of the DSL parity tests: recorded WorkerRush-vs-LightRush
states of the port's plain path on the two 8x8 maps (``dsl_records``),
the JAX package's compiled programs jitted one by one at XLA's lowest
optimization level (vmapped over envs, the player traced: ~2 s of
compile a program, where jitting a file's programs together takes
minutes), run with per-env keys, and the ``DslNoise`` the port reads for
those keys: the ``Random`` target's ``uniform(fold_in(key, rel), (H,
W))`` for every window offset and ``MoveToUnit``'s ``uniform(key, (H,
W))``."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.synth import dsl as JD
from microrts_tpu_torch.synth.dsl import (
    AllyInEnemyRange, Attack, Build, CanAfford, Cluster, DistanceFromEnemy,
    DslNoise, EnemyInRange, EnemyInUnitsRange, For, Harvest, Idle, If,
    IsPlayerInPosition, MoveAway, MoveToCoord, MoveToUnit, NAllyAttacking,
    NAllyHarvesting, NAllyOfType, NEnemyOfType, Train, UnitsStrongest,
    compile_program)
from microrts_tpu_torch.synth.search import TARGETS

from torch_parity import assert_eq, envs, jax_state
from torch_rush_parity import MAPS, _cat, _playout, _without_bases

_jit_fast = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


def random_boards(env, n, seed):
    """``n`` random boards of ``env``'s map size: a unit on ~35% of the
    cells (a resource node, or a unit of a random type and player, hp
    1..max, busy with a random action in a third), a wall on ~10% of the
    rest, unique uids, random stocks and carried resources.  The DSL bot
    is a function of the state, so such boards reach every condition and
    target policy cheaply."""
    from microrts_tpu_torch.engine.types import state_from_numpy
    rng = np.random.default_rng(seed)
    ecfg = env.cfg.engine
    H, W, T = env.h, env.w, ecfg.num_types
    shape = (n, H, W)
    unit = rng.random(shape) < 0.35
    t = rng.integers(0, T, shape)
    res = np.asarray(ecfg.is_resource)[t]
    owner = np.where(res, -1, rng.integers(0, 2, shape))
    hpmax = np.asarray(ecfg.hp)[t]
    hp = rng.integers(1, np.maximum(hpmax, 1) + 1)
    busy = unit & ~res & (rng.random(shape) < 0.33)
    z = np.zeros(shape, np.int32)
    leaves = dict(
        terrain=np.where(~unit & (rng.random(shape) < 0.1), 1, 0),
        utype=np.where(unit, t + 1, 0), owner=np.where(unit, owner, -1),
        hp=np.where(unit, hp, 0),
        carried=np.where(unit, np.where(res, rng.integers(1, 20, shape),
                                        rng.integers(0, 2, shape)), 0),
        uid=np.where(unit, rng.permuted(
            np.broadcast_to(np.arange(H * W), (n, H * W)), axis=1)
            .reshape(shape) + 1, 0),
        busy=busy, atype=np.where(busy, rng.integers(1, 6, shape), 0),
        aparam=z, atx=z, aty=z, aptype=z,
        aticks=np.where(busy, rng.integers(1, 5, shape), 0),
        aorder=z, atime=np.where(busy, 0, -1),
        time=np.zeros(n, np.int32), resources=rng.integers(0, 16, (n, 2)),
        next_id=np.full(n, H * W + 1), order_ctr=np.zeros(n, np.int32),
        cancel_ctr=np.zeros(n, np.int32))
    return state_from_numpy(leaves)


@functools.lru_cache(maxsize=None)
def dsl_records():
    """(port env, JAX env, States): WorkerRush (player 0) vs LightRush on
    basesWorkers8x8, 4 envs each opening with 6k random ticks, every 8th
    tick of ticks 16-79, plus the last 8 with the bases removed and the
    resources raised, plus 48 ``random_boards``."""
    from microrts_tpu_torch.engine.types import State
    jenv, env = envs(MAPS[0])
    part = _playout(MAPS[0], batch=4, ticks=80)
    late = State(**{f: getattr(part, f)[-8:] for f in vars(part)})
    return env, jenv, _cat([part, _without_bases(late, range(8)),
                            random_boards(env, 48, 5)])


def to_jax(node):
    """The JAX package's AST node equal to a port node (same class name
    and fields)."""
    if isinstance(node, tuple):
        return tuple(to_jax(n) for n in node)
    if not hasattr(node, "__dataclass_fields__"):
        return node
    cls = getattr(JD, type(node).__name__)
    return cls(**{f: to_jax(getattr(node, f))
                  for f in node.__dataclass_fields__})


def keys_for(B, player):
    return jax.random.split(jax.random.PRNGKey(1000 + player), B)


@functools.lru_cache(maxsize=None)
def _noise_fn(H, W, DD):
    def one(key):
        return (jax.vmap(lambda r: jax.random.uniform(
            jax.random.fold_in(key, r), (H, W)))(jnp.arange(DD)),
            jax.random.uniform(key, (H, W)))
    return jax.jit(jax.vmap(one))


def port_noise(env, keys) -> DslNoise:
    D_ = 2 * env.cfg.engine.max_range + 1
    u_rel, u_move = _noise_fn(env.h, env.w, D_ * D_)(keys)
    return DslNoise(torch.from_numpy(np.array(u_rel)),
                    torch.from_numpy(np.array(u_move)))


@functools.lru_cache(maxsize=None)
def _jax_bot(jenv, program):
    bot = JD.compile_program(jenv, to_jax(program))
    return _jit_fast(jax.vmap(bot, in_axes=(0, None, 0)))


def jax_actions(jenv, program, s, player):
    """numpy int32 ``[B, H, W, 7]``: the JAX package's compiled
    ``program`` (a port AST tuple) on the port State batch ``s``."""
    return np.asarray(_jax_bot(jenv, program)(
        jax_state(s), player, keys_for(s.batch, player)))


def check_program(env, jenv, program, s):
    """The port's plain compiled ``program`` on ``s`` against JAX's, both
    players; returns bool numpy ``[2, B]``: the envs where some unit of
    the player acted."""
    bot = compile_program(env, program)
    acted = []
    for p in (0, 1):
        a = bot(s, p, port_noise(env, keys_for(s.batch, p)))
        assert_eq(jax_actions(jenv, program, s, p), a, f"{program} p{p}")
        acted.append((a[..., 0] > 0).flatten(1).any(1).numpy())
    return np.stack(acted)


# ---- the parity cases: one a command, target policy, MoveToUnit target
# and side, and condition (guarding a harvest and an attack)

CLOSEST = Attack("All", "Closest")
COMMANDS = {
    "Train": (Train("Base", "Worker", 20), Train("Barracks", "Light", 4),
              Train("Barracks", "Ranged", 9)),
    "Build": (Build("Barracks", 2), Train("Base", "Worker", 3)),
    "Harvest": (Harvest(2), CLOSEST),
    "MoveAway": (MoveAway("All"),),
    "Idle": (Idle("Worker"), CLOSEST),
    "MoveToCoord": (MoveToCoord(3, 4, "Worker"), MoveToCoord(7, 0, "All")),
    "Cluster": (Cluster("All"),),
    "For": (For(2, (Harvest(1), Attack("Worker", "Weakest"))),),
}
ATTACKS = {t: (Attack("All", t),) for t in TARGETS}
MOVES = {f"{t}-{side}": (MoveToUnit("All", t, side), CLOSEST)
         for t in TARGETS for side in ("Enemy", "Ally")}
CONDS = {type(c).__name__ + str(i): (If(c, (Harvest(3), CLOSEST)),
                                     Idle("All"))
         for i, c in enumerate((
             NAllyOfType("Worker", 2, ">="), NEnemyOfType("Light", 1, ">"),
             NAllyAttacking(1, ">="), NAllyHarvesting(1, "<="),
             EnemyInRange(6), AllyInEnemyRange(), EnemyInUnitsRange(),
             DistanceFromEnemy(5, "<="), DistanceFromEnemy(4, ">"),
             UnitsStrongest("Ally"), UnitsStrongest("Enemy"),
             IsPlayerInPosition(0), IsPlayerInPosition(3),
             CanAfford("Barracks"), NAllyOfType("Heavy", 1, "==")))}


def check_condition(name):
    """``CONDS[name]`` against JAX on the DSL records: some env acts
    (``EnemyInRange`` none: see test_torch_dsl_conds.py) and, on the
    random boards, some env does not."""
    env, jenv, s = dsl_records()
    acted = check_program(env, jenv, CONDS[name], s)
    if name.startswith("EnemyInRange"):
        assert not acted.any()
    else:
        assert acted.any() and not acted[:, -48:].all()


def check_random_program(seed):
    """``random_program(random.Random(seed))`` against JAX on the DSL
    records; the JAX package's generator must give the same program."""
    import random

    from microrts_tpu.synth.search import random_program as jax_random
    from microrts_tpu_torch.synth.search import random_program
    prog = random_program(random.Random(seed))
    assert to_jax(prog) == jax_random(random.Random(seed))
    env, jenv, s = dsl_records()
    assert check_program(env, jenv, prog, s).any()
