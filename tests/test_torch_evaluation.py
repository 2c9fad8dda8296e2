"""K12a (ops/evaluation.py): the port's plain evaluation functions against
the JAX package's, on random planes (8x8, and 2x128 for Lanchester's
wide-map weights) and on recorded 8x8 states of RandomBiasedAI self-play
(with one or both players wiped out), from player 0's and player 1's view
and for a per-env player vector.

Tolerance: the Sqrt family (``simple_sqrt_eval``, ``2`` and ``3``) and
``simple_opt_upper_bound`` sum small integers, exact in any order, as
long as no hp exceeds its type's maximum (play never makes it): they are
held bit-equal.  ``simple_eval``, ``simple_opt_eval`` and
``lanchester_eval`` sum float32 terms (``hp / maxhp`` ratios, tuned
weights, a power and a sigmoid), whose order differs between XLA and
PyTorch: within 1e-5 relative to the scale of the score (the larger of
the value and 1)."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.engine import types as JT
from microrts_tpu.engine.utt import UnitTypeTable as JaxUTT
from microrts_tpu.ops import evaluation as JE
from microrts_tpu_torch.engine.types import EngineConfig, State
from microrts_tpu_torch.engine.utt import UnitTypeTable
from microrts_tpu_torch.ops import evaluation as E

from torch_parity import torch_one_thread, assert_eq, jax_state
from torch_playout_parity import recorded

pytestmark = pytest.mark.usefixtures("torch_one_thread")

EXACT = ("simple_sqrt_eval", "simple_sqrt_eval2", "simple_sqrt_eval3")
FLOAT = ("simple_eval", "simple_opt_eval")
RTOL = 1e-5
NAMES = ("Base", "Barracks", "Worker", "Light", "Heavy", "Ranged")


def _type_ids(utt):
    return {n: utt.get_unit_type(n).ID for n in NAMES}


def _random_state(rng, B, H, W, T, maxhp=None):
    """Random planes: units of every type and owner (neutral ones too),
    carried, resources; hp from 0 to the type's maximum ``maxhp`` (as in
    play, where damage only lowers it), or to 11 when ``maxhp`` is None."""
    utype = np.where(rng.random((B, H, W)) < 0.6,
                     rng.integers(1, T + 1, (B, H, W)), 0).astype(np.int8)
    owner = np.where(utype > 0, rng.integers(-1, 2, (B, H, W)),
                     -1).astype(np.int8)
    owner[0] = np.where(utype[0] > 0, 0, -1)       # player 1 wiped out
    utype[1] = 0                                    # an empty board
    owner[1] = -1
    z = np.zeros((B, H, W))
    planes = dict(
        terrain=z.astype(np.int8), utype=utype, owner=owner,
        hp=(rng.integers(0, 12, (B, H, W)) if maxhp is None else
            np.floor(rng.random((B, H, W)) * (np.asarray(maxhp)[
                np.clip(utype - 1, 0, T - 1)] + 1))).astype(np.int16),
        carried=rng.integers(0, 6, (B, H, W)).astype(np.int16),
        uid=z.astype(np.int32), busy=z.astype(bool),
        atype=z.astype(np.int8), aparam=z.astype(np.int16),
        atx=z.astype(np.int16), aty=z.astype(np.int16),
        aptype=z.astype(np.int8), aticks=z.astype(np.int16),
        aorder=z.astype(np.int32), atime=z.astype(np.int32),
        time=np.zeros(B, np.int32),
        resources=rng.integers(0, 30, (B, 2)).astype(np.int32),
        next_id=np.zeros(B, np.int32), order_ctr=np.zeros(B, np.int32),
        cancel_ctr=np.zeros(B, np.int32))
    return State(**{k: torch.from_numpy(v) for k, v in planes.items()})


@functools.lru_cache(maxsize=None)
def _jax_eval(name, jcfg, per_lane, type_ids=None):
    fn = getattr(JE, name)
    if name == "simple_opt_upper_bound":
        return jax.jit(jax.vmap(lambda s, p: fn(s, jcfg), in_axes=(0, None)))
    if name == "lanchester_eval":
        ids = dict(type_ids)
        return jax.jit(jax.vmap(lambda s, p: fn(s, p, jcfg, ids),
                                in_axes=(0, 0 if per_lane else None)))
    return jax.jit(jax.vmap(lambda s, p: fn(s, p, jcfg),
                            in_axes=(0, 0 if per_lane else None)))


def _port_eval(name, s, p, cfg, type_ids):
    fn = getattr(E, name)
    if name == "simple_opt_upper_bound":
        return fn(s, cfg)
    if name == "lanchester_eval":
        return fn(s, p, cfg, dict(type_ids))
    return fn(s, p, cfg)


def _players(s):
    return (0, 1, np.arange(s.batch, dtype=np.int32) % 2)


def _check(name, s, cfg, jcfg, type_ids, exact):
    js = jax_state(s)
    out = []
    for p in _players(s):
        per_lane = isinstance(p, np.ndarray)
        jv = _jax_eval(name, jcfg, per_lane, tuple(sorted(type_ids.items())))(
            js, jnp.asarray(p) if per_lane else p)
        v = _port_eval(name, s, torch.from_numpy(p) if per_lane else p, cfg,
                       type_ids)
        assert v.dtype == torch.float32 and v.shape == (s.batch,)
        if exact:
            assert_eq(jv, v, f"{name} player {p}")
        else:
            jv = np.asarray(jv)
            tol = RTOL * np.maximum(np.abs(jv), 1.0)
            err = np.abs(v.numpy() - jv)
            assert (err <= tol).all(), (name, p, float(err.max()))
        out.append(v)
    return out


def _cfgs(H, W):
    utt = UnitTypeTable(2)
    return (EngineConfig.from_utt(utt, H, W),
            JT.EngineConfig.from_utt(JaxUTT(2), H, W), _type_ids(utt))


@pytest.mark.parametrize("name", EXACT + FLOAT + ("simple_opt_upper_bound",
                                                  "lanchester_eval"))
def test_evaluation_matches_jax_on_random_planes(name):
    cfg, jcfg, ids = _cfgs(8, 8)
    s = _random_state(np.random.default_rng(len(name)), 16, 8, 8,
                      cfg.num_types, cfg.hp)
    v = _check(name, s, cfg, jcfg, ids,
               name in EXACT + ("simple_opt_upper_bound",))
    assert len(set(v[0].tolist())) > 3


@pytest.mark.parametrize("name", EXACT)
def test_sqrt_family_above_full_health_matches_jax(name):
    """hp above the type's maximum (no game reaches it) makes hp // maxhp
    2 or more and its square root irrational: then the Sqrt family sums
    floats too and is held to the float tolerance."""
    cfg, jcfg, ids = _cfgs(8, 8)
    s = _random_state(np.random.default_rng(5), 16, 8, 8, cfg.num_types)
    assert (s.hp.long() >= 2 * torch.tensor(cfg.hp)[
        (s.utype.long() - 1).clamp(0, cfg.num_types - 1)]).any()
    _check(name, s, cfg, jcfg, ids, False)


def test_lanchester_wide_map_weights_match_jax():
    cfg, jcfg, ids = _cfgs(2, 128)
    s = _random_state(np.random.default_rng(1), 8, 2, 128, cfg.num_types,
                      cfg.hp)
    v128 = _check("lanchester_eval", s, cfg, jcfg, ids, False)
    cfg8, _, _ = _cfgs(2, 64)
    v64 = E.lanchester_eval(s, 0, cfg8, ids)
    assert not torch.equal(v128[0], v64)       # the other weight table


@pytest.mark.parametrize("name", EXACT + FLOAT + ("simple_opt_upper_bound",
                                                  "lanchester_eval"))
def test_evaluation_matches_jax_on_recorded_states(name):
    jenv, env, s = recorded("maps/8x8/basesWorkers8x8.xml")
    _check(name, s, env.cfg.engine, jenv.cfg.engine, _type_ids(env.utt),
           name in EXACT + ("simple_opt_upper_bound",))


def test_maxplayer_must_be_a_player():
    cfg, _, _ = _cfgs(8, 8)
    s = _random_state(np.random.default_rng(0), 2, 8, 8, cfg.num_types)
    with pytest.raises(ValueError):
        E.simple_sqrt_eval3(s, 2, cfg)
