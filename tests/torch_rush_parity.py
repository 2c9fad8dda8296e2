"""Helpers of the rush-bot parity tests: recorded states of plain
rush-vs-rush playouts of the port on the 8x8 maps, and the JAX package's
``rush_bot`` for several specs jitted together (one compile for all)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import scripted as JS
from microrts_tpu_torch.bots import scripted as S
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State

from torch_parity import BIAS, envs, jax_state

MAPS = ("maps/8x8/basesWorkers8x8.xml", "maps/8x8/basesWorkersBarracks8x8.xml")
# a spec no Java bot uses: the expansion branch (BasicConfigurableScript)
EXPAND = S.RushSpec("Light", expand=True)


def _cat(states):
    return State(**{f: torch.cat([getattr(s, f) for s in states])
                    for f in FIELD_DTYPES})


def _playout(map_rel, batch=4, ticks=200, every=8):
    """WorkerRush (player 0) against LightRush (player 1), plain path; env
    k plays RandomBiasedAI for both players during its first 6k ticks, so
    that the envs differ.  Returns the states at every ``every``-th tick
    from tick 16, as one batch."""
    _, env = envs(map_rel)
    p0, p1 = S.worker_rush(env), S.light_rush(env)
    rnd = S.random_bot(env, BIAS)
    rng = np.random.default_rng(len(map_rel))
    s = env.reset(batch)
    early = (torch.arange(batch) * 6)[:, None, None, None]
    out = []
    for t in range(ticks):
        if t >= 16 and t % every == 0:
            out.append(s)
        u = [torch.from_numpy(rng.random((batch, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        a0 = torch.where(t < early, rnd(s, 0, u[0]), p0(s, 0))
        a1 = torch.where(t < early, rnd(s, 1, u[1]), p1(s, 1))
        s, _, _ = env.step(s, a0, a1)
    return _cat(out)


def _without_bases(s, env_rows):
    """A copy of ``s`` with every base removed in ``env_rows`` and both
    players' resources raised to 20 there (so that a rebuild is
    affordable)."""
    utype, owner, res = s.utype.clone(), s.owner.clone(), s.resources.clone()
    for b in env_rows:
        base = utype[b] == 2          # Base: type id 1, utype 2
        utype[b][base] = 0
        owner[b][base] = -1
        res[b] = torch.clamp(res[b], min=20)
    return s.replace(utype=utype, owner=owner, resources=res)


@functools.lru_cache(maxsize=None)
def recorded_states():
    """(the port env of the first map, the JAX env, one batch of recorded
    states of both maps, plus copies of each map's last ten with the bases
    removed)."""
    parts = [_playout(m) for m in MAPS]
    late = [State(**{f: getattr(p, f)[-40:] for f in FIELD_DTYPES})
            for p in parts]
    s = _cat(parts + [_without_bases(p, range(40)) for p in late])
    jenv, env = envs(MAPS[0])
    return env, jenv, s


@functools.lru_cache(maxsize=None)
def jax_actions(names):
    """The JAX package's rush bots ``names`` (make_bot names, or "expand")
    on the recorded states, for both players: {(name, player): int32
    numpy [B, H, W, 7]}; the bots are jitted together."""
    from microrts_tpu.config import make_bot as jax_make_bot
    env, jenv, s = recorded_states()
    bots = [JS.rush_bot(jenv, JS.RushSpec(**vars(EXPAND))) if n == "expand"
            else jax_make_bot(n, jenv) for n in names]
    key = jax.random.PRNGKey(0)
    fn = jax.jit(jax.vmap(lambda st, p: jnp.stack([b(st, p, key)
                                                    for b in bots]),
                          in_axes=(0, None)))
    js = jax_state(s)
    out = {}
    for p in (0, 1):
        a = np.asarray(fn(js, p))
        for i, n in enumerate(names):
            out[(n, p)] = a[:, i]
    return out


def port_bot(name, env):
    if name == "expand":
        return S.rush_bot(env, EXPAND)
    return make_bot(name, env).bot


def branch_counts(names):
    """The plain rush bots' decision counts over the recorded states, both
    players, summed over ``names``."""
    env, _, s = recorded_states()
    counts = {}
    for n in names:
        for p in (0, 1):
            S.rush_bot_plain(env, port_bot(n, env).plan, s, p, counts)
    return counts
