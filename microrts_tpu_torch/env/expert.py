"""Expert/simple action interface: 13 discrete macro actions per step.

A port of ``microrts_tpu.env.expert`` (JNIExpertAI's simple mode,
ai/AALL/JNIExpertAI.java:289-502, and its detailed mode :156-198) on
batched planes:
  0  no-op
  1  allocate one (random) worker to resource gathering
  2  pull all workers off gathering
  3-6  send all attackers to a random position in map quadrant 1-4
  7-10 train Worker / Light / Heavy / Ranged
  11 expand: build a Base near resources, far from the current base
  12 build a Barracks near a base, away from resources
plus the background behaviors: attackers auto-attack nearby enemies and
walk to their assigned quadrant positions; gathering workers run the
harvest loop.  The 13-slot legality mask mirrors actionMask (:242-288).

Unit roles persist across ticks in uid-indexed tables (uid % TABLE),
``ExpertRoles``, ``[B, TABLE]`` per env.  Macros are int32 ``[B]``, one per
env.  Randomness comes in as tensors: ``ExpertNoise`` holds the macro's
draws (JAX's ``k_alloc`` uniform and ``k_quad`` randints), and
``DetailedNoise`` the detailed mode's Gumbel noise itself (JAX's
``gumbel(k_tile)``/``gumbel(k_type)``), so no float ``log`` differs
between the packages.

On CUDA tensors ``macro_to_gridnet`` is one launch of the ``expert_macro``
kernel per player (its BFS fields computed inside) and
``detailed_to_gridnet`` one of ``expert_detailed``; on CPU tensors, or
over an env built with ``plain=True``, the plain versions below run.

Places where parity with the JAX package is easy to lose:
- the quadrant one-hot scatters ``attacker`` to ``uid % TABLE`` with
  every non-attacker cell writing False to slot 0; XLA's CPU scatter
  keeps the last write, so slot 0 is the attacker flag of the last
  row-major cell whose scatter index is 0 (``_quad_onehot``);
- the allocation pick is the SUM of ``uid_mod`` over every cell at the
  maximum score, not an argmax; a sum past the table is dropped, as
  JAX's scatter drops an out-of-bounds index;
- the "first" producer or builder is the row-major ``cumsum == 1``;
- this module's ``_put`` writes only where no action is chosen yet (the
  first writer wins), unlike the DSL's, which overwrites;
- the attack scan walks offsets sorted by d2, a stable sort over dy-major,
  dx-minor generation;
- ``argmax(free_n)`` is 0 when no side is free.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .. import kernels as KN
from ..engine.kernel import as_player, balance, iota, pull, select_dir, shift
from ..engine.types import ATTACK, HARVEST, MOVE, PRODUCE, RETURN, State
from ..ops.fields import descend_direction_plain, distance_field_plain
from .gridnet import GridnetEnv

TABLE = 1024  # uid-role table capacity (uids wrap; games stay far below)
NUM_MACROS = 13
I32 = torch.int32


@dataclasses.dataclass
class ExpertRoles:
    """Per-env role tables, ``[B, TABLE]``."""
    harvester: torch.Tensor   # bool: uid -> allocated to gathering
    has_target: torch.Tensor  # bool: uid -> has a quadrant target
    tgt_x: torch.Tensor       # int32
    tgt_y: torch.Tensor       # int32

    FIELDS = ("harvester", "has_target", "tgt_x", "tgt_y")

    @classmethod
    def init(cls, batch: int, device) -> "ExpertRoles":
        z = torch.zeros((batch, TABLE), dtype=I32, device=device)
        f = torch.zeros((batch, TABLE), dtype=torch.bool, device=device)
        return cls(harvester=f, has_target=f.clone(), tgt_x=z,
                   tgt_y=z.clone())


class ExpertNoise(NamedTuple):
    """``macro_to_gridnet``'s draws for ``B`` envs: the allocation pick's
    uniforms float32 ``[B, H, W]`` (JAX: ``uniform(k_alloc, (H, W))``) and
    the quadrant target's offsets int32 ``[B]`` in ``[0, max(W//2, 1))``
    and ``[0, max(H//2, 1))`` (JAX: ``randint(k_quad)``,
    ``randint(fold_in(k_quad, 1))``)."""
    r: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor

    @classmethod
    def draw(cls, gen: torch.Generator, batch: int,
             env: GridnetEnv) -> "ExpertNoise":
        h, w, dev = env.h, env.w, env.device
        return cls(
            torch.rand((batch, h, w), generator=gen, device=dev),
            torch.randint(0, max(w // 2, 1), (batch,), generator=gen,
                          device=dev, dtype=I32),
            torch.randint(0, max(h // 2, 1), (batch,), generator=gen,
                          device=dev, dtype=I32))


class DetailedNoise(NamedTuple):
    """``detailed_to_gridnet``'s Gumbel noise for ``B`` envs: each cell's
    tile draw float32 ``[B, H, W, H*W]`` and type draw ``[B, H, W, T]``
    (JAX: ``gumbel(k_tile)``, ``gumbel(k_type)``)."""
    g_tile: torch.Tensor
    g_type: torch.Tensor

    @classmethod
    def draw(cls, gen: torch.Generator, batch: int,
             env: GridnetEnv) -> "DetailedNoise":
        h, w, dev = env.h, env.w, env.device
        T = env.cfg.engine.num_types

        def gumbel(shape):
            u = torch.rand(shape, generator=gen, device=dev)
            return -torch.log(-torch.log(u.clamp_min(1e-30)))
        return cls(gumbel((batch, h, w, h * w)), gumbel((batch, h, w, T)))


def _macro(macro, batch: int, device) -> torch.Tensor:
    m = torch.as_tensor(macro, dtype=I32, device=device)
    return m.expand(batch).contiguous() if m.dim() == 0 else m


class ExpertEnv:
    """Wraps a GridnetEnv: discrete 13-action interface for player control,
    compiling macro decisions into gridnet tensors on the env's device."""

    def __init__(self, env: GridnetEnv):
        self.env = env
        self.h, self.w = env.h, env.w
        self.cfg = env.cfg
        self.device = env.device

    def _lk(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.env.engine.lut(name, t.device)[t]

    def _use_kernel(self, t: torch.Tensor) -> bool:
        return self.env.engine._use_kernel(t)

    # ------------------------------------------------------------------
    def action_mask(self, state: State, roles: ExpertRoles,
                    player) -> torch.Tensor:
        """bool ``[B, 13]`` (JNIExpertAI.actionMask :242-288)."""
        cfg = self.cfg
        T = cfg.engine.num_types
        t = (state.utype.long() - 1).clamp(0, T - 1)
        mine = (state.utype > 0) & (state.owner == as_player(
            player, state.device))
        worker = mine & self._lk("can_harvest", t)
        base = mine & self._lk("is_stockpile", t)
        barracks = mine & (t == cfg.barracks_id)
        bal = balance(state, player)
        COST = cfg.engine.cost
        B = state.batch

        def afford(tid):
            if tid < 0:
                return torch.zeros(B, dtype=torch.bool, device=state.device)
            return bal >= COST[tid]

        def anyp(m):
            return m.flatten(1).any(1)

        any_worker = anyp(worker)
        any_attacker = anyp(mine & self._lk("can_attack", t))
        any_base = anyp(base)
        any_barracks = anyp(barracks)
        return torch.stack([
            torch.ones(B, dtype=torch.bool, device=state.device),
            any_worker, any_worker,
            any_attacker, any_attacker, any_attacker, any_attacker,
            afford(cfg.worker_id) & any_base,
            afford(cfg.light_id) & any_barracks,
            afford(cfg.heavy_id) & any_barracks,
            afford(cfg.ranged_id) & any_barracks,
            afford(cfg.base_id),
            afford(cfg.barracks_id),
        ], 1)

    # ------------------------------------------------------------------
    def macro_to_gridnet(self, state: State, roles: ExpertRoles, player,
                         macro, noise: ExpertNoise
                         ) -> Tuple[torch.Tensor, ExpertRoles]:
        """One macro per env (int32 ``[B]``) + the background behaviors
        for ``player`` (an int or int32 ``[B]``): (int32 ``[B, H, W, 7]``
        gridnet actions, the updated roles)."""
        if noise is None:
            raise ValueError("macro_to_gridnet: noise (ExpertNoise) missing")
        macro = _macro(macro, state.batch, state.device)
        if self._use_kernel(state.utype):
            act, tables = KN.EXPERT_MACRO(
                self.cfg, state, roles, player, macro, noise,
                scan_offsets(self.cfg.engine.max_range))
            return act, ExpertRoles(**tables)
        return self.macro_to_gridnet_plain(state, roles, player, macro,
                                           noise)

    def macro_to_gridnet_plain(self, state: State, roles: ExpertRoles,
                               player, macro: torch.Tensor,
                               noise: ExpertNoise
                               ) -> Tuple[torch.Tensor, ExpertRoles]:
        cfg = self.cfg
        H, W, T = self.h, self.w, cfg.engine.num_types
        B, dev = state.batch, state.device
        me = as_player(player, dev)
        m = macro.to(dev).reshape(B, 1, 1)
        t = (state.utype.long() - 1).clamp(0, T - 1)
        exists = state.utype > 0
        mine = exists & (state.owner == me)
        idle = mine & ~state.busy
        enemy = exists & (state.owner >= 0) & (state.owner != me)
        resource = exists & self._lk("is_resource", t)
        my_base = mine & self._lk("is_stockpile", t)
        my_barracks = mine & (t == cfg.barracks_id)
        worker = mine & self._lk("can_harvest", t)
        uid_mod = torch.where(exists, state.uid % TABLE, 0).long()
        flat_uid = uid_mod.reshape(B, -1)

        def role(table):
            return table.gather(1, flat_uid).reshape(B, H, W)

        harv_flag = role(roles.harvester) & worker
        attacker = mine & self._lk("can_attack", t) & ~harv_flag

        # ---- role updates from the macro
        # 1: allocate one random unflagged worker; the slot is the SUM of
        # the uids at the maximum (dropped when past the table)
        unflagged = worker & ~harv_flag
        score = torch.where(unflagged, noise.r, -1.0).reshape(B, -1)
        pick = (score == score.max(1, keepdim=True).values) \
            & unflagged.reshape(B, -1)
        slot = torch.where(pick, flat_uid, 0).sum(1)
        alloc = (macro == 1) & unflagged.reshape(B, -1).any(1) \
            & (slot < TABLE)
        new_harv = roles.harvester.clone()
        rows = alloc.nonzero().flatten()
        new_harv[rows, slot[rows]] = True
        # 2: pull all workers
        new_harv = torch.where((macro == 2)[:, None], False, new_harv)

        # 3-6: assign all attackers a random position in the quadrant
        quad = (macro - 3).clamp(0, 3)
        rx = noise.rx + (quad % 2) * (W // 2)
        ry = noise.ry + (quad // 2) * (H // 2)
        is_quad = ((macro >= 3) & (macro <= 6))[:, None]
        onehot = _quad_onehot(attacker, uid_mod)
        new_has_t = torch.where(is_quad, roles.has_target | onehot,
                                roles.has_target)
        new_tx = torch.where(is_quad & onehot, rx[:, None].to(I32),
                             roles.tgt_x)
        new_ty = torch.where(is_quad & onehot, ry[:, None].to(I32),
                             roles.tgt_y)
        roles = ExpertRoles(new_harv, new_has_t, new_tx, new_ty)

        # ---- compile per-unit gridnet actions
        passable = (state.terrain == 0) & ~exists
        free_n = torch.stack([pull(passable, d, False) for d in range(4)],
                             -1)
        any_free = free_n.any(-1)
        out = torch.zeros((B, H, W, 7), dtype=I32, device=dev)
        tdir = _first_true(free_n)

        def first_of(mask):
            return mask & (torch.cumsum(mask.reshape(B, -1).to(I32), 1)
                           .reshape(B, H, W) == 1)

        for mac, tid, producer in ((7, cfg.worker_id, my_base),
                                   (8, cfg.light_id, my_barracks),
                                   (9, cfg.heavy_id, my_barracks),
                                   (10, cfg.ranged_id, my_barracks)):
            if tid < 0:
                continue
            first = first_of(idle & producer & any_free)
            _put(out, (m == mac) & first, PRODUCE, pdir=tdir, ptype=tid)

        it = H + W
        d_res = distance_field_plain(resource, passable, it)
        d_base = distance_field_plain(my_base, passable, it)
        for mac, tid, zone in (
                (11, cfg.base_id, (d_res <= 3) & (d_base > 5)),
                (12, cfg.barracks_id, (d_base <= 5) & (d_res > 3))):
            if tid < 0:
                continue
            first_b = first_of(idle & worker & ~harv_flag)
            in_zone = first_b & zone & any_free
            _put(out, (m == mac) & in_zone, PRODUCE, pdir=tdir, ptype=tid)
            d_zone = distance_field_plain(zone & (state.utype == 0),
                                          passable, it)
            mdir = descend_direction_plain(d_zone, free_n)
            _put(out, (m == mac) & first_b & ~in_zone & (mdir >= 0), MOVE,
                 mdir=mdir)

        # ---- background: harvest-workers run the harvest loop
        hu = idle & harv_flag
        adj_res = torch.stack([pull(resource, d, False) for d in range(4)],
                              -1)
        adj_base = torch.stack([pull(my_base, d, False) for d in range(4)],
                               -1)
        carrying = state.carried > 0
        _put(out, hu & carrying & adj_base.any(-1), RETURN,
             rdir=_first_true(adj_base))
        mdir_b = descend_direction_plain(d_base, free_n)
        _put(out, hu & carrying & ~adj_base.any(-1) & (mdir_b >= 0), MOVE,
             mdir=mdir_b)
        _put(out, hu & ~carrying & adj_res.any(-1), HARVEST,
             hdir=_first_true(adj_res))
        mdir_r = descend_direction_plain(d_res, free_n)
        _put(out, hu & ~carrying & ~adj_res.any(-1) & (mdir_r >= 0), MOVE,
             mdir=mdir_r)

        # ---- background: attackers auto-attack in range, else walk to
        # their quadrant target (greedy axis descent) or the nearest enemy
        R = cfg.engine.max_range
        D = 2 * R + 1
        rng = self._lk("attack_range", t)
        best = torch.zeros((B, H, W), dtype=I32, device=dev)
        found = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
        for d2, dx, dy in scan_offsets(R):
            e_at = shift(enemy, -dx, -dy, fill=False) & (d2 <= rng * rng)
            best = torch.where(~found & e_at, (R + dy) * D + (R + dx), best)
            found = found | e_at
        au = idle & attacker & (out[..., 0] == 0)
        _put(out, au & found, ATTACK, rel=best)
        has_t = role(roles.has_target) & attacker
        xs, ys = iota(H, W, dev)
        gdir = greedy_dir(role(roles.tgt_x) - xs, role(roles.tgt_y) - ys,
                          free_n)
        d_enemy = distance_field_plain(enemy, passable, it)
        edir = descend_direction_plain(d_enemy, free_n)
        wdir = torch.where(has_t, gdir, edir)
        _put(out, au & ~found & (wdir >= 0) & (out[..., 0] == 0), MOVE,
             mdir=wdir)
        return out, roles

    # ------------------------------------------------------------------
    def step(self, state: State, roles0: ExpertRoles, roles1: ExpertRoles,
             macro0, macro1, noise0: ExpertNoise, noise1: ExpertNoise,
             **step_kw):
        """Both players driven by expert macros (self-play).  Returns
        (state', roles0', roles1', rewards float32 [B, 2, NR], done)."""
        a0, roles0 = self.macro_to_gridnet(state, roles0, 0, macro0, noise0)
        a1, roles1 = self.macro_to_gridnet(state, roles1, 1, macro1, noise1)
        state, rewards, done = self.env.step(state, a0, a1, **step_kw)
        return state, roles0, roles1, rewards, done

    def step_vs(self, state: State, roles: ExpertRoles, macro0, bot,
                noise: ExpertNoise, bot_noise=None, **step_kw):
        """Expert macros for player 0 against ``bot`` (a
        ``bots.scripted.Opponent``, reading ``bot_noise``), both acting on
        the same pre-step state as in JAX's ``step_vs`` (expert.py:283),
        then the self-play step.  Returns (state', roles', rewards float32
        [B, 2, NR], done)."""
        a0, roles = self.macro_to_gridnet(state, roles, 0, macro0, noise)
        a1 = bot(state, 1, bot_noise)
        state, rewards, done = self.env.step(state, a0, a1, **step_kw)
        return state, roles, rewards, done


def scan_offsets(R: int):
    """The attack scan's (d2, dx, dy), closest first: ``sorted`` by d2 (a
    stable sort) of the dy-major, dx-minor box, the centre left out
    (expert.py:233-235, dsl.py:388-390)."""
    offs = sorted(((dx * dx + dy * dy, dx, dy)
                   for dy in range(-R, R + 1) for dx in range(-R, R + 1)),
                  key=lambda z: z[0])
    return [o for o in offs if o[0] != 0]


def _first_true(b: torch.Tensor) -> torch.Tensor:
    """``argmax`` of a bool stack over its last axis: the first True, 0
    when none (JAX's argmax of an all-False row)."""
    return b.to(torch.uint8).argmax(-1).to(I32)


def _quad_onehot(attacker: torch.Tensor, uid_mod: torch.Tensor
                 ) -> torch.Tensor:
    """bool ``[B, TABLE]``: JAX's ``zeros(TABLE).at[where(attacker,
    uid_mod, 0)].set(attacker)``.  A slot k > 0 is set by any attacker of
    that uid; slot 0 gets the flag of the LAST row-major cell whose index
    is 0 (XLA's CPU scatter keeps the last write), False for a
    non-attacker."""
    B = attacker.shape[0]
    att = attacker.reshape(B, -1)
    idx = torch.where(att, uid_mod.reshape(B, -1), 0)
    out = torch.zeros((B, TABLE), dtype=torch.uint8, device=att.device)
    out = out.scatter_reduce_(1, idx, att.to(torch.uint8), reduce="amax") \
        .bool()
    cells = torch.arange(att.shape[1], device=att.device).expand_as(idx)
    last0 = torch.where(idx == 0, cells, -1).max(1).values
    out[:, 0] = att.gather(1, last0.clamp_min(0)[:, None])[:, 0] \
        & (last0 >= 0)
    return out


def greedy_dir(dx_: torch.Tensor, dy_: torch.Tensor,
               free_n: torch.Tensor) -> torch.Tensor:
    """Greedy axis descent toward a target ``(dx_, dy_)`` away: the larger
    axis first, the other as the fallback, each only onto a free side;
    -1 when neither (expert.py:246-258)."""
    prefer_x = dx_.abs() >= dy_.abs()
    dir_x = torch.where(dx_ > 0, 1, 3)
    dir_y = torch.where(dy_ > 0, 2, 0)
    want1 = torch.where(prefer_x & (dx_ != 0), dir_x,
                        torch.where(dy_ != 0, dir_y, -1))
    want2 = torch.where(prefer_x & (dy_ != 0), dir_y,
                        torch.where(dx_ != 0, dir_x, -1))

    def free_at(dsel):
        return select_dir(free_n, dsel.clamp(0, 3)) & (dsel >= 0)
    return torch.where(free_at(want1), want1,
                       torch.where(free_at(want2), want2, -1)).to(I32)


_COLS = dict(mdir=1, hdir=2, rdir=3, pdir=4, ptype=5, rel=6)


def _put(out: torch.Tensor, mask: torch.Tensor, atype: int, **cols) -> None:
    """Write ``atype`` and the given columns where ``mask`` holds and no
    action is chosen yet (macro priority order: the first writer wins;
    expert.py:292-301).  In place."""
    mask = mask & (out[..., 0] == 0)
    out[..., 0] = torch.where(mask, atype, out[..., 0])
    for name, val in cols.items():
        c = _COLS[name]
        out[..., c] = torch.where(mask, val, out[..., c])


def detailed_to_gridnet(ex: ExpertEnv, state: State, player,
                        type_logits: torch.Tensor, tile_logits: torch.Tensor,
                        noise: DetailedNoise) -> torch.Tensor:
    """JNIExpertAI detailed mode (expert.py:304-424): every idle unit
    samples a board tile from the shared tile policy (float32
    ``tile_logits`` ``[B, H, W]``, or ``[H, W]`` for every env) and a unit
    type from the type policy (``type_logits`` ``[B, T]`` or ``[T]``) by
    the argmax of logits + Gumbel noise, then dispatches.  Returns int32
    ``[B, H, W, 7]``."""
    if noise is None:
        raise ValueError("detailed_to_gridnet: noise (DetailedNoise) "
                         "missing")
    B, H, W = state.utype.shape
    T = ex.cfg.engine.num_types
    tile_logits = tile_logits.to(torch.float32).expand(
        B, H, W).contiguous()
    type_logits = type_logits.to(torch.float32).expand(B, T).contiguous()
    if ex._use_kernel(state.utype):
        return KN.EXPERT_DETAILED(ex.cfg.engine, state, player, type_logits,
                                  tile_logits, noise)
    return detailed_to_gridnet_plain(ex, state, player, type_logits,
                                     tile_logits, noise)


def detailed_to_gridnet_plain(ex: ExpertEnv, state: State, player,
                              type_logits: torch.Tensor,
                              tile_logits: torch.Tensor,
                              noise: DetailedNoise) -> torch.Tensor:
    cfg = ex.cfg
    B, H, W = state.utype.shape
    T = cfg.engine.num_types
    dev = state.device
    me = as_player(player, dev)
    t = (state.utype.long() - 1).clamp(0, T - 1)
    exists = state.utype > 0
    mine = exists & (state.owner == me)
    idle = mine & ~state.busy
    enemy = exists & (state.owner >= 0) & (state.owner != me)
    resource = exists & ex._lk("is_resource", t)
    my_base = mine & ex._lk("is_stockpile", t)
    passable = (state.terrain == 0) & ~exists
    free_n = torch.stack([pull(passable, d, False) for d in range(4)], -1)
    any_free = free_n.any(-1)

    # per-unit tile and type draws: argmax over logits + per-cell gumbel
    tidx = (tile_logits.reshape(B, 1, 1, H * W) + noise.g_tile).argmax(
        -1).to(I32)
    tx, ty = tidx % W, tidx // W
    tau = (type_logits.reshape(B, 1, 1, T) + noise.g_type).argmax(-1)

    def at_tile(plane):
        return plane.reshape(B, -1).gather(1, tidx.reshape(B, -1).long()
                                           ).reshape(B, H, W)

    tgt_enemy, tgt_res, tgt_own = at_tile(enemy), at_tile(resource), \
        at_tile(mine)
    tgt_empty = ~(tgt_enemy | tgt_res | tgt_own)
    can_move = ex.env.engine.lut("can_move", dev)
    tau_mobile = can_move[tau]
    harv_t = ex._lk("can_harvest", t)
    is_building = mine & ~harv_t & ~can_move[t]
    is_harv_unit = mine & harv_t
    is_other = mine & ~is_building & ~is_harv_unit

    out = torch.zeros((B, H, W, 7), dtype=I32, device=dev)
    tdir = _first_true(free_n)
    prod_row = ex.env.engine.lut("produces", dev)[t, tau]
    tau32 = tau.to(I32)
    _put(out, idle & is_building & tau_mobile & prod_row & any_free,
         PRODUCE, pdir=tdir, ptype=tau32)

    xs, ys = iota(H, W, dev)
    dx_, dy_ = tx - xs, ty - ys
    gdir = greedy_dir(dx_, dy_, free_n)
    R = cfg.engine.max_range
    D = 2 * R + 1
    rng = ex._lk("attack_range", t)
    in_range = (dx_ * dx_ + dy_ * dy_ <= rng * rng) & (tidx != ys * W + xs)
    rel = (R + dy_).clamp(0, D - 1) * D + (R + dx_).clamp(0, D - 1)
    can_atk_u = ex._lk("can_attack", t)

    hu = idle & is_harv_unit
    adj_res = torch.stack([pull(resource, d, False) for d in range(4)], -1)
    adj_base = torch.stack([pull(my_base, d, False) for d in range(4)], -1)
    carrying = state.carried > 0
    _put(out, hu & (tgt_empty | tgt_own) & (gdir >= 0), MOVE, mdir=gdir)
    _put(out, hu & tgt_res & carrying & adj_base.any(-1), RETURN,
         rdir=_first_true(adj_base))
    _put(out, hu & tgt_res & ~carrying & adj_res.any(-1), HARVEST,
         hdir=_first_true(adj_res))
    _put(out, hu & tgt_res & (gdir >= 0), MOVE, mdir=gdir)
    _put(out, hu & tgt_enemy & can_atk_u & in_range, ATTACK, rel=rel)
    _put(out, hu & tgt_enemy & (gdir >= 0), MOVE, mdir=gdir)
    _put(out, hu & ~tau_mobile & prod_row & any_free, PRODUCE, pdir=tdir,
         ptype=tau32)

    ou = idle & is_other
    _put(out, ou & (tgt_empty | tgt_own) & (gdir >= 0), MOVE, mdir=gdir)
    _put(out, ou & (tgt_enemy | tgt_res) & can_atk_u & in_range, ATTACK,
         rel=rel)
    _put(out, ou & tgt_enemy & (gdir >= 0), MOVE, mdir=gdir)
    return out
