"""CooperativeAI: per-unit networks choosing (target tile, unit type).

A port of ``microrts_tpu.bots.cooperative`` (see its docstring for the
Java sources and the documented divergences): every idle own unit runs
its unit type's network over the flattened board and outputs a target
tile plus a unit type (the last type slot is the nullop); the choice is
compiled to an action by the macro rules of CooperativeAI.java:112-173.

The per-type networks are SSVD genomes (``models.ssvd``) over a fixed
MLP, run as batched ``torch.matmul`` in float32 (JAX leaves them to XLA
outside any kernel): ``cell_in`` is built as JAX builds it, ``[B, H*W,
6HW + 2 + T]``, and each type's net runs over every cell, its output kept
where the cell holds that type.  Everything after the nets is K14c
(``cooperative_act``): the first maxima of the tile and type logits, the
target tile's flags, the greedy step, the own bases' distance field and
its descent, and the rules in JAX's order.  On CUDA tensors it is the
``cooperative_act`` kernel; CPU tensors (or a ``plain=True`` env) take
the plain version.

Default genomes: JAX draws them from ``jax.random.normal(PRNGKey(seed))``,
which torch cannot reproduce; the port draws ``0.1 * randn`` from a CPU
``torch.Generator`` seeded with ``seed`` (the same on every device).
Pass JAX's genomes in (``genomes=``) to play JAX's nets.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels as KN
from ..engine.kernel import as_player, balance, iota, pull
from ..engine.types import (ATTACK, DIR_X, DIR_Y, HARVEST, MOVE, PRODUCE,
                            RETURN, State)
from ..env.gridnet import GridnetEnv
from ..models.ssvd import genome_size, logits_net
from ..ops.arms import first_max
from ..ops.fields import distance_field_plain
from .scripted import Opponent, _set

I32 = torch.int32
F32 = torch.float32
# A* expansion tie order down, left, up, right as direction indices
_TIE = (2, 3, 0, 1)


def cooperative_dims(env: GridnetEnv, hidden: int = 32):
    """Layer dims of the per-unit network: flattened 6-plane observation
    + own (x, y) + own-type one-hot -> [H*W tile logits, T+1 type logits]
    (the last type the nullop)."""
    T = env.cfg.engine.num_types
    H, W = env.h, env.w
    return (6 * H * W + 2 + T, hidden, H * W + T + 1)


def cooperative_genome_spec(env: GridnetEnv, hidden: int = 32,
                            rank: int = 4):
    """(per-type genome length, layer dims) for ES over ``[T, G]``
    genomes."""
    dims = cooperative_dims(env, hidden)
    return genome_size(dims, rank), dims


def cooperative_nets(env: GridnetEnv, state: State, player, genomes,
                     dims, rank: int) -> torch.Tensor:
    """float32 ``[B, H*W, H*W + T + 1]``: every cell's row of its unit
    type's network output (cooperative.py:100-125)."""
    T = env.cfg.engine.num_types
    H, W = env.h, env.w
    B = state.batch
    t = (state.utype.long() - 1).clamp(0, T - 1).reshape(B, H * W)
    if isinstance(player, torch.Tensor):      # one player an env
        obs = torch.where((player == 1).reshape(-1, 1, 1, 1),
                          env.observation(state, 1),
                          env.observation(state, 0))
    else:
        obs = env.observation(state, player)
    obs = obs.to(F32).reshape(B, -1) / 10.0
    xs, ys = iota(H, W, state.device)
    pos = torch.stack([xs.reshape(-1).to(F32) / W,
                       ys.reshape(-1).to(F32) / H], -1)     # [HW, 2]
    cell_in = torch.cat([
        obs[:, None, :].expand(B, H * W, obs.shape[1]),
        pos[None].expand(B, H * W, 2),
        torch.nn.functional.one_hot(t, T).to(F32)], -1)
    out = torch.zeros((B, H * W, dims[-1]), dtype=F32, device=state.device)
    for ti in range(T):
        out = torch.where((t == ti)[..., None],
                          logits_net(genomes[ti], cell_in, dims, rank), out)
    return out


def cooperative_act(env: GridnetEnv, state: State, player,
                    nets: torch.Tensor) -> torch.Tensor:
    """K14c: the gridnet action int32 ``[B, H, W, 7]`` of ``player`` (an
    int or int32 ``[B]``) from the networks' output ``nets``."""
    if env.engine._use_kernel(nets):
        return KN.COOPERATIVE_ACT(env.cfg.engine, state, player, nets)
    return cooperative_act_plain(env, state, player, nets)


def cooperative_act_plain(env: GridnetEnv, state: State, player,
                          nets: torch.Tensor) -> torch.Tensor:
    cfg = env.cfg.engine
    eng = env.engine
    dev = state.device
    T, R = cfg.num_types, cfg.max_range
    D = 2 * R + 1
    B, H, W = state.utype.shape
    me = as_player(player, dev)
    t = (state.utype.long() - 1).clamp(0, T - 1)
    exists = state.utype > 0
    owner = state.owner.to(I32)
    mine = exists & (owner == me)
    enemy = exists & (owner >= 0) & (owner != me)
    idle = mine & ~state.busy
    resource = exists & eng.lut("is_resource", dev)[t]
    my_base = mine & eng.lut("is_stockpile", dev)[t]
    passable = (state.terrain == 0) & ~exists
    free_n = torch.stack([pull(passable, d, False) for d in range(4)], -1)
    bal = balance(state, player)[:, None, None]
    d_base = distance_field_plain(my_base, passable, H + W)

    tile = first_max(nets[..., :H * W]).reshape(B, H, W)
    typ = first_max(nets[..., H * W:]).reshape(B, H, W)
    tx, ty = tile % W, tile // W
    nullop = typ == T
    tgt_resource = resource.reshape(B, -1).gather(
        1, tile.reshape(B, -1)).reshape(B, H, W)
    tgt_enemy = enemy.reshape(B, -1).gather(
        1, tile.reshape(B, -1)).reshape(B, H, W)

    xs, ys = iota(H, W, dev)
    dx, dy = tx - xs, ty - ys
    man = dx.abs() + dy.abs()
    best_dir = torch.full((B, H, W), -1, dtype=I32, device=dev)
    best_gain = torch.zeros((B, H, W), dtype=torch.int64, device=dev)
    for d in _TIE:
        gain = man - ((dx - DIR_X[d]).abs() + (dy - DIR_Y[d]).abs())
        better = free_n[..., d] & (gain > best_gain)
        best_dir = torch.where(better, d, best_dir)
        best_gain = torch.where(better, gain, best_gain)
    can_step = best_dir >= 0
    adj_dir = torch.full((B, H, W), -1, dtype=I32, device=dev)
    for d, (ox, oy) in reversed(list(enumerate(zip(DIR_X, DIR_Y)))):
        adj_dir = torch.where((dx == ox) & (dy == oy), d, adj_dir)
    rng = eng.lut("attack_range", dev)[t]
    in_rng = (dx * dx + dy * dy <= rng * rng) & (man > 0)
    rel = ((R + dy) * D + (R + dx)).clamp(0, D * D - 1)

    carrying = state.carried > 0
    adj_base = torch.stack([pull(my_base, d, False) for d in range(4)], -1)
    nb = [pull(d_base, d, H + W) for d in range(4)]
    lim = torch.minimum(torch.stack(nb).amin(0),
                        torch.tensor(H + W, device=dev)) + 1
    mdir_b = torch.full((B, H, W), -1, dtype=I32, device=dev)
    for d in _TIE:
        closer = free_n[..., d] & (nb[d] < lim) & (mdir_b < 0)
        mdir_b = torch.where(closer, d, mdir_b)

    out = torch.zeros((B, H, W, 7), dtype=I32, device=dev)
    act = idle & ~nullop
    immobile = ~eng.lut("can_move", dev)[t]
    harvester = eng.lut("can_harvest", dev)[t]
    attacker = eng.lut("can_attack", dev)[t]
    move_t = torch.cat([eng.lut("can_move", dev),
                        torch.zeros(1, dtype=torch.bool, device=dev)])
    typ_movable = move_t[typ.clamp(0, T)]
    free_any = free_n.any(-1)
    tdir = free_n.to(torch.uint8).argmax(-1).to(I32)
    ptype = typ.clamp(0, T - 1)
    afford = bal >= eng.lut("cost", dev)[ptype]

    # 1. buildings train movable types (CooperativeAI.java:131-133)
    train = act & immobile & typ_movable & free_any & afford
    _set(out, train, PRODUCE, pdir=tdir, ptype=ptype)
    # 2. harvesters (:135-160)
    h = act & harvester & ~immobile
    h_res = h & tgt_resource & ~carrying
    _set(out, h_res & (adj_dir >= 0), HARVEST, hdir=adj_dir.clamp(min=0))
    _set(out, h_res & (adj_dir < 0) & can_step, MOVE, mdir=best_dir)
    h_ret = h & tgt_resource & carrying
    ret_dir = adj_base.to(torch.uint8).argmax(-1).to(I32)
    any_base = adj_base.any(-1)
    _set(out, h_ret & any_base, RETURN, rdir=ret_dir)
    _set(out, h_ret & ~any_base & (mdir_b >= 0), MOVE, mdir=mdir_b)
    h_atk = h & ~tgt_resource & tgt_enemy & attacker
    _set(out, h_atk & in_rng, ATTACK, rel=rel)
    _set(out, h_atk & ~in_rng & can_step, MOVE, mdir=best_dir)
    h_build = h & ~tgt_resource & ~tgt_enemy & ~typ_movable & free_any \
        & afford
    _set(out, h_build, PRODUCE, pdir=tdir, ptype=ptype)
    h_move = h & ~tgt_resource & ~tgt_enemy & typ_movable & can_step
    _set(out, h_move, MOVE, mdir=best_dir)
    # 3. movers (:161-173)
    m = act & ~harvester & ~immobile
    m_atk = m & tgt_enemy & attacker
    _set(out, m_atk & in_rng, ATTACK, rel=rel)
    _set(out, m_atk & ~in_rng & can_step, MOVE, mdir=best_dir)
    _set(out, m & ~tgt_enemy & can_step, MOVE, mdir=best_dir)
    return out


def default_genomes(env: GridnetEnv, hidden: int = 32, rank: int = 4,
                    seed: int = 0) -> torch.Tensor:
    """float32 ``[T, G]``: ``0.1 * randn`` from a CPU ``torch.Generator``
    seeded with ``seed``, on the env's device (fresh, unevolved nets; not
    JAX's draws)."""
    T = env.cfg.engine.num_types
    G = genome_size(cooperative_dims(env, hidden), rank)
    gen = torch.Generator().manual_seed(seed)
    return (0.1 * torch.randn((T, G), generator=gen)).to(env.device)


def cooperative_bot(env: GridnetEnv, genomes: Optional[torch.Tensor] = None,
                    hidden: int = 32, rank: int = 4,
                    seed: int = 0) -> Opponent:
    """CooperativeAI as a deterministic ``Opponent``: ``bot(state, player)
    -> int32 [B, H, W, 7]``.  ``genomes``: float32 ``[T, G]`` per-type
    SSVD genomes (``cooperative_genome_spec``; default
    ``default_genomes(seed)``)."""
    dims = cooperative_dims(env, hidden)
    if genomes is None:
        genomes = default_genomes(env, hidden, rank, seed)
    genomes = torch.as_tensor(genomes, dtype=F32, device=env.device)

    def bot(state: State, player, noise=None) -> torch.Tensor:
        nets = cooperative_nets(env, state, player, genomes, dims, rank)
        return cooperative_act(env, state, player, nets)

    bot.genomes = genomes
    bot.dims = dims
    return Opponent(bot)
