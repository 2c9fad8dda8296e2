"""The rules engine on batched planes: legality masks, issue and cycle.

A port of ``microrts_tpu.engine.kernel`` (the Java hot loop re-designed as
plane ops, see that module's docstring for the exactness model).  Every
function here is the plain PyTorch version, batched over the leading axis
of ``[B, H, W]`` planes; ``issue``, ``issue_env`` and ``cycle`` dispatch
by device: CPU tensors (or an engine built with ``plain=True``) take the
plain version, CUDA tensors launch the hand-written kernels of
``microrts_tpu_torch.kernels``.

``issue`` is the full issueSafe: legality, cross-cycle position and
resource cancels against prior-tick assignments, and the same-tick
CANCEL_BOTH / CANCEL_RANDOM / CANCEL_ALTERNATING chains.  CANCEL_RANDOM's
coins are an input (bool ``[B, H, W, 4]``, indexed by the sorted claimant
slot, as the JAX package draws them from ``fold_in(key, order_ctr)``).
``issue_env`` is its fast path for candidates that came through the env
decode under full observation.  UTT v3's random damage draws one uniform
per attacker cell and cycle; the uniforms are an input of ``cycle``
(float32 ``[B, H, W]``, drawn in JAX from ``split(key)`` in ``cycle``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import kernels as KN
from .types import (ATTACK, DIR_X, DIR_Y, HARVEST, INF, MOVE, NONE, PRODUCE,
                    RETURN, Candidates, EngineConfig, State)

I32 = torch.int32


# ----------------------------------------------------------------------
# shift helpers (out-of-board cells read ``fill``)

def shift(p: torch.Tensor, dx: int, dy: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = p[..., y - dy, x - dx]."""
    if dx == 0 and dy == 0:
        return p
    h, w = p.shape[-2], p.shape[-1]
    out = torch.full_like(p, fill)
    if abs(dx) >= w or abs(dy) >= h:
        return out
    out[..., max(0, dy):h + min(0, dy), max(0, dx):w + min(0, dx)] = \
        p[..., max(0, -dy):h + min(0, -dy), max(0, -dx):w + min(0, -dx)]
    return out


def push(p: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """Move source-cell values to their direction-d target cell."""
    return shift(p, DIR_X[d], DIR_Y[d], fill)


def pull(p: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """Read, at each source cell, the value at its direction-d target."""
    return shift(p, -DIR_X[d], -DIR_Y[d], fill)


def select_dir(stack: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """stack[..., d] picked per cell by ``param``; a param outside 1..3
    picks direction 0, as the JAX package's unrolled select does."""
    d = torch.where((param >= 1) & (param <= 3), param, 0).long()
    return torch.gather(stack, -1, d.unsqueeze(-1)).squeeze(-1)


def sum2(x: torch.Tensor) -> torch.Tensor:
    """Sum over the two trailing axes, in int32."""
    return x.sum(dim=(-2, -1), dtype=I32)


def stack_b(planes) -> torch.Tensor:
    """Stack bool planes along a new last axis (read back with
    ``select_dir``)."""
    return torch.stack(list(planes), -1)


def sort4(keys: torch.Tensor, *payloads: torch.Tensor):
    """Sort 4 elements along the last axis by ``keys`` with the JAX
    package's 5-comparator network (kernel.py:125): a pair swaps only on
    a strict ``>``, so equal keys keep that network's order.  Returns
    (keys_sorted, *payloads_sorted)."""
    cols = [[a[..., k] for k in range(4)] for a in (keys,) + payloads]
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        swap = cols[0][i] > cols[0][j]
        for c in cols:
            c[i], c[j] = (torch.where(swap, c[j], c[i]),
                          torch.where(swap, c[i], c[j]))
    return tuple(torch.stack(c, -1) for c in cols)


def as_player(player, device=None):
    """``player`` as a value that compares against ``[B, H, W]`` planes:
    an int stays an int, a tensor of per-env players (int32 ``[B]``)
    becomes ``[B, 1, 1]``."""
    if isinstance(player, torch.Tensor):
        return player.to(device=device).reshape(-1, 1, 1)
    return int(player)


def balance(state, player) -> torch.Tensor:
    """int32 ``[B]``: ``player``'s (an int or int32 ``[B]``) stock."""
    if isinstance(player, torch.Tensor):
        return torch.where(player.to(state.device) == 1,
                           state.resources[:, 1], state.resources[:, 0])
    return state.resources[:, 1 if int(player) == 1 else 0]


def iota(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=I32, device=device),
                            torch.arange(w, dtype=I32, device=device),
                            indexing="ij")
    return xs, ys


class Engine:
    """The engine's functions closed over one ``EngineConfig``.

    ``plain=True`` makes ``issue``, ``issue_env`` and ``cycle`` run their
    plain PyTorch versions on any device (the kernels' oracle on the
    card)."""

    def __init__(self, cfg: EngineConfig, plain: bool = False):
        self.cfg = cfg
        self.plain = plain
        self.H, self.W, self.T = cfg.height, cfg.width, cfg.num_types
        self.R = cfg.max_range
        self._tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    # ------------------------------------------------------------------
    def lut(self, name: str, device) -> torch.Tensor:
        """UTT column ``name`` as a tensor on ``device`` (int32, or bool
        for flags; ``produces`` is ``[T, T]``)."""
        key = (name, torch.device(device))
        if key not in self._tables:
            vals = getattr(self.cfg, name)
            dt = torch.bool if isinstance(
                vals[0], bool) or name == "produces" else I32
            self._tables[key] = torch.tensor(vals, dtype=dt, device=device)
        return self._tables[key]

    def _tprop(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.lut(name, t.device)[t]

    def _ctx(self, state: State):
        """(type index int64 clipped to [0, T-1], exists)."""
        t = (state.utype.long() - 1).clamp(0, self.T - 1)
        return t, state.utype > 0

    def _use_kernel(self, t: torch.Tensor) -> bool:
        return not self.plain and t.device.type != "cpu"

    # ------------------------------------------------------------------
    # legality (Unit.getUnitActions, Unit.java:368-522: standing units
    # and terrain only)

    def _free_d(self, state: State) -> torch.Tensor:
        free = (state.terrain == 0) & (state.utype == 0)
        return torch.stack([pull(free, d, False) for d in range(4)], -1)

    def legal_masks(self, state: State, player) -> Dict[str, torch.Tensor]:
        """Per-cell legality planes for ``player`` (an int, or int32
        ``[B]``: one per env) (kernel.py:742-792): bool ``can_act
        [B,H,W]``, ``type [..,6]``, ``move``/``harvest``/``ret``/
        ``produce_dir [..,4]``, ``produce_type [..,T]``, ``produce_pair
        [..,4,T]`` and ``attack [..,(2R+1)^2]``."""
        t, exists = self._ctx(state)
        tp = self._tprop
        owner = state.owner.to(I32)
        me = as_player(player, state.device)
        can_act = exists & (owner == me) & ~state.busy
        is_res_n = exists & tp("is_resource", t)
        is_stock_n = exists & tp("is_stockpile", t)
        free_d = self._free_d(state)

        move_d = free_d & (can_act & tp("can_move", t))[..., None]
        harv_d = torch.stack([pull(is_res_n, d, False) for d in range(4)], -1) \
            & (can_act & tp("can_harvest", t) & (state.carried == 0))[..., None]
        ret_d = torch.stack([pull(is_stock_n, d, False)
                             & (pull(owner, d, -1) == me) for d in range(4)],
                            -1) \
            & (can_act & tp("can_harvest", t) & (state.carried > 0))[..., None]
        bal = balance(state, player)
        afford = bal[:, None] >= self.lut("cost", t.device)[None, :]  # [B,T]
        prod_row = self.lut("produces", t.device)[t]                  # [B,H,W,T]
        prod_pair = ((prod_row & afford[:, None, None, :]
                      & can_act[..., None])[..., None, :]
                     & free_d[..., :, None])                          # [B,H,W,4,T]
        prod_dir = prod_pair.any(-1)
        prod_type = prod_pair.any(-2)

        enemy = exists & (owner >= 0) & (owner != me)
        rng2 = tp("attack_range", t) ** 2
        atk_ok = can_act & tp("can_attack", t)
        R = self.R
        atk = torch.stack(
            [atk_ok & ((dx * dx + dy * dy) <= rng2)
             & shift(enemy, -dx, -dy, False)
             for dy in range(-R, R + 1) for dx in range(-R, R + 1)], -1)
        type_mask = torch.stack(
            [can_act, move_d.any(-1), harv_d.any(-1), ret_d.any(-1),
             prod_dir.any(-1), atk.any(-1)], -1)
        return dict(can_act=can_act, type=type_mask, move=move_d,
                    harvest=harv_d, ret=ret_d, produce_dir=prod_dir,
                    produce_type=prod_type, produce_pair=prod_pair,
                    attack=atk)

    # ------------------------------------------------------------------
    # issue (GameState.issueSafe :338-408, fast path)

    def validate(self, state: State, cand: Candidates) -> torch.Tensor:
        """Per cell: is this candidate legal for this unit?
        (Unit.canExecuteAction, kernel.py:216-275.)"""
        t, exists = self._ctx(state)
        tp = self._tprop
        me = state.owner.to(I32)
        is_res_n = exists & tp("is_resource", t)
        is_stock_n = exists & tp("is_stockpile", t)
        free_d = self._free_d(state)
        res_d = torch.stack([pull(is_res_n, d, False) for d in range(4)], -1)
        own_stock_d = torch.stack(
            [pull(is_stock_n, d, False) & (pull(me, d, -1) == me)
             for d in range(4)], -1)

        at, param = cand.atype, cand.aparam
        pt = cand.aptype.long().clamp(0, self.T - 1)
        legal_none = at == NONE
        legal_move = (at == MOVE) & tp("can_move", t) & select_dir(free_d, param)
        legal_harv = ((at == HARVEST) & tp("can_harvest", t)
                      & (state.carried == 0) & select_dir(res_d, param))
        legal_ret = ((at == RETURN) & tp("can_harvest", t)
                     & (state.carried > 0) & select_dir(own_stock_d, param))
        bal = torch.where(me == 1, state.resources[:, 1, None, None],
                          state.resources[:, 0, None, None])
        afford = tp("cost", pt) <= bal
        producible = self.lut("produces", t.device)[t, pt]
        legal_prod = ((at == PRODUCE) & producible & afford
                      & select_dir(free_d, param))

        xs, ys = iota(self.H, self.W, t.device)
        dxp = cand.atx - xs
        dyp = cand.aty - ys
        rng2 = tp("attack_range", t) ** 2
        occ = state.utype > 0
        R = self.R
        hit = torch.zeros_like(occ)
        for oy in range(-R, R + 1):
            for ox in range(-R, R + 1):
                d2 = ox * ox + oy * oy
                if d2 == 0 or d2 > R * R:
                    continue
                occ_t = shift(occ, -ox, -oy, False)
                own_t = shift(me, -ox, -oy, -1)
                hit = hit | ((dxp == ox) & (dyp == oy) & (d2 <= rng2)
                             & occ_t & (own_t >= 0) & (own_t != me))
        legal_atk = (at == ATTACK) & tp("can_attack", t) & hit
        return exists & (legal_none | legal_move | legal_harv | legal_ret
                         | legal_prod | legal_atk)

    def eta_of(self, state: State, cand: Candidates) -> torch.Tensor:
        """UnitAction.ETA (kernel.py:277-286; RETURN uses moveTime)."""
        t, _ = self._ctx(state)
        tp = self._tprop
        pt = cand.aptype.long().clamp(0, self.T - 1)
        at = cand.atype
        out = torch.zeros_like(at, dtype=I32)
        for code, val in ((ATTACK, tp("attack_time", t)),
                          (PRODUCE, tp("produce_time", pt)),
                          (RETURN, tp("move_time", t)),
                          (HARVEST, tp("harvest_time", t)),
                          (MOVE, tp("move_time", t)),
                          (NONE, cand.aparam.to(I32))):
            out = torch.where(at == code, val, out)
        return out

    def issue(self, state: State, cand: Candidates,
              coins: Optional[torch.Tensor] = None) -> State:
        """issueSafe (kernel.py:291-454): illegal actions become NONE(ETA
        of the attempt); a claim whose target a prior-tick MOVE/PRODUCE
        reserves, or a produce whose cost plus the player's largest
        prior-tick produce cost exceeds the stockpile, becomes NONE(-1);
        each cell's <= 4 claimants (new claims and surviving same-tick
        ones, in issue order) run the move-conflict chain of the UTT's
        policy.  ``coins`` (bool ``[B, H, W, 4]``, by sorted claimant slot)
        decides CANCEL_RANDOM's conflicts; that policy raises without
        them.  Returns a new State that shares the unchanged board
        planes."""
        if self._use_kernel(state.utype):
            return KN.ISSUE(self.cfg, state, cand, coins)
        return self.issue_plain(state, cand, coins)

    # the conflicts ``issue_plain`` counts: cross-cycle position and
    # resource cancels, and the chains' cancels of a new claim or of a
    # same-tick claim issued earlier (rewritten in place)
    ISSUE_CONFLICTS = ("xc_position", "xc_resource", "cancel_new",
                       "cancel_old")

    def issue_plain(self, state: State, cand: Candidates,
                    coins: Optional[torch.Tensor] = None,
                    counts: Optional[Dict[str, int]] = None) -> State:
        """``issue``'s plain version.  ``counts`` adds the cells of each
        kind in ``ISSUE_CONFLICTS``."""
        policy = self.cfg.move_conflict_policy
        if policy == 2 and coins is None:
            raise ValueError("issue: CANCEL_RANDOM needs coins")
        H, W, T = self.H, self.W, self.T
        t, exists = self._ctx(state)
        tp = self._tprop
        owner = state.owner.to(I32)
        sparam = state.aparam.to(I32)
        ignore = ~exists | state.busy | (cand.atype < 0) | (owner < 0)
        legal = self.validate(state, cand) & ~ignore
        eta_att = self.eta_of(state, cand)
        a_type = torch.where(legal, cand.atype, NONE)
        a_param = torch.where(legal, cand.aparam, eta_att)

        # cross-cycle conflicts against assignments of earlier ticks: only
        # the new action cancels, as NONE(-1) (GameState.java:298-317)
        claim = ((a_type == MOVE) | (a_type == PRODUCE)) & ~ignore
        claiming = state.busy & ((state.atype == MOVE)
                                 | (state.atype == PRODUCE))
        prior = state.atime < state.time[:, None, None]
        inflight = claiming & prior
        resv = torch.zeros_like(exists)
        for d in range(4):
            resv = resv | push(inflight & (sparam == d), d, False)
        tgt_resv = select_dir(stack_b(pull(resv, d, False) for d in range(4)),
                              cand.aparam)
        if_pcost = torch.where(
            state.busy & prior & (state.atype == PRODUCE),
            tp("cost", state.aptype.long().clamp(0, T - 1)), 0)
        max_if = [torch.where(owner == p, if_pcost, 0).amax((1, 2))
                  for p in (0, 1)]
        my_bal = torch.where(owner == 1, state.resources[:, 1, None, None],
                             state.resources[:, 0, None, None])
        my_max_if = torch.where(owner == 1, max_if[1][:, None, None],
                                max_if[0][:, None, None])
        new_cost = tp("cost", cand.aptype.long().clamp(0, T - 1))
        xc_pos = claim & tgt_resv
        res_xc = ((a_type == PRODUCE) & ~ignore
                  & (new_cost + my_max_if > my_bal))
        xc = xc_pos | res_xc
        a_type = torch.where(xc, NONE, a_type)
        a_param = torch.where(xc, -1, a_param)
        eta2 = torch.where(xc, -1, eta_att)
        claim = claim & ~xc

        # same-tick chains per target cell over <= 4 claimants (one per
        # neighbour: a new claim or a surviving same-tick one), keyed by
        # issue order
        st_exist = claiming & ~prior
        new_key = state.order_ctr[:, None, None] + cand.rank
        rk, et = [], []
        for d in range(4):
            n_d = claim & (cand.aparam == d)
            e_d = st_exist & (sparam == d)
            c_d = push(n_d | e_d, d, False)
            key_src = torch.where(n_d, new_key,
                                  torch.where(e_d, state.aorder, INF))
            eta_src = torch.where(n_d, eta2, torch.where(
                e_d, state.aticks.to(I32), 0))
            rk.append(torch.where(c_d, push(key_src, d), INF))
            et.append(torch.where(c_d, push(eta_src, d), 0))
        rk, et = torch.stack(rk, -1), torch.stack(et, -1)
        srcd = torch.arange(4, dtype=I32, device=rk.device).expand(rk.shape)
        rk_s, et_s, d_s = sort4(rk, et, srcd)
        zero = torch.zeros_like(rk_s[..., 0])
        live = zero - 1
        cancelled = [torch.zeros_like(exists)] * 4
        ndur = [zero] * 4
        nconf = zero
        for k in range(4):
            valid_k = rk_s[..., k] < INF
            conflict = valid_k & (live >= 0)
            et_live = zero
            for j in range(4):
                et_live = torch.where(live == j, et_s[..., j], et_live)
            dur = torch.minimum(et_live, et_s[..., k])
            if policy == 2:      # CANCEL_RANDOM
                c_new = conflict & coins[..., k]
                c_old = conflict & ~coins[..., k]
            elif policy == 3:    # CANCEL_ALTERNATING
                parity = torch.remainder(
                    state.cancel_ctr[:, None, None] + nconf, 2)
                c_new = conflict & (parity == 0)
                c_old = conflict & (parity == 1)
            else:                # CANCEL_BOTH
                c_new = c_old = conflict
            for j in range(4):
                hit_old = c_old & (live == j)
                cancelled[j] = cancelled[j] | hit_old
                ndur[j] = torch.where(hit_old, dur, ndur[j])
            cancelled[k] = cancelled[k] | c_new
            ndur[k] = torch.where(c_new, dur, ndur[k])
            live = torch.where(
                valid_k & ~conflict, k, torch.where(
                    c_old & ~c_new, k, torch.where(
                        c_new & ~c_old, live,
                        torch.where(conflict, -1, live))))
            nconf = nconf + conflict.to(I32)
        # sorted slots back to direction-of-origin planes
        cancel_d, ndur_d = [], []
        for d in range(4):
            acc = torch.zeros_like(exists)
            nd = torch.full_like(zero, -INF)
            for k in range(4):
                sel = (d_s[..., k] == d) & cancelled[k]
                acc = acc | sel
                nd = torch.where(sel, ndur[k], nd)
            cancel_d.append(acc)
            ndur_d.append(nd)
        cancel_at = stack_b(pull(cancel_d[d], d, False) for d in range(4))
        ndur_at = torch.stack([pull(ndur_d[d], d, -INF) for d in range(4)],
                              -1)
        cancel_new = select_dir(cancel_at, cand.aparam) & claim
        ndur_new = select_dir(ndur_at, cand.aparam)
        a_type = torch.where(cancel_new, NONE, a_type)
        a_param = torch.where(cancel_new, ndur_new, a_param)
        eta3 = torch.where(cancel_new, ndur_new, eta2)
        # a same-tick claim beaten in a chain is rewritten in place to
        # NONE(min) (GameState.java:291-293)
        cancel_old = select_dir(cancel_at, sparam) & st_exist
        ndur_old = select_dir(ndur_at, sparam)
        if counts is not None:
            for name, m in zip(self.ISSUE_CONFLICTS,
                               (xc_pos, res_xc, cancel_new, cancel_old)):
                counts[name] = counts.get(name, 0) + int(m.sum())

        put = ~ignore
        return state.replace(
            busy=state.busy | put,
            atype=torch.where(put, a_type, torch.where(
                cancel_old, NONE, state.atype.to(I32))),
            aparam=torch.where(put, a_param, torch.where(
                cancel_old, ndur_old, sparam)),
            atx=torch.where(put, cand.atx, state.atx.to(I32)),
            aty=torch.where(put, cand.aty, state.aty.to(I32)),
            aptype=torch.where(put, cand.aptype, state.aptype.to(I32)),
            aticks=torch.where(put, eta3, torch.where(
                cancel_old, ndur_old, state.aticks.to(I32))),
            aorder=torch.where(put, new_key, state.aorder),
            atime=torch.where(put, state.time[:, None, None], state.atime),
            order_ctr=state.order_ctr + 2 * H * W,
            cancel_ctr=state.cancel_ctr + (sum2(nconf) if policy == 3
                                           else 0),
        ).canon()

    def issue_env(self, state: State, cand: Candidates) -> State:
        """issueSafe for decode-vetted candidates (kernel.py:456-499):
        illegal actions become NONE(ETA of the attempt); every put cell
        gets ``aorder = order_ctr + rank``; ``order_ctr += 2*H*W``.
        Returns a new State that shares the unchanged board planes."""
        if self._use_kernel(state.utype):
            return KN.ISSUE_ENV(self.cfg, state, cand)
        return self.issue_env_plain(state, cand)

    def issue_env_plain(self, state: State, cand: Candidates) -> State:
        t, exists = self._ctx(state)
        ignore = ~exists | state.busy | (cand.atype < 0) | (state.owner < 0)
        legal = self.validate(state, cand) & ~ignore
        eta_att = self.eta_of(state, cand)
        a_type = torch.where(legal, cand.atype, NONE)
        a_param = torch.where(legal, cand.aparam, eta_att)
        put = ~ignore
        oc = state.order_ctr[:, None, None]
        return state.replace(
            busy=state.busy | put,
            atype=torch.where(put, a_type, state.atype.to(I32)),
            aparam=torch.where(put, a_param, state.aparam.to(I32)),
            atx=torch.where(put, cand.atx, state.atx.to(I32)),
            aty=torch.where(put, cand.aty, state.aty.to(I32)),
            aptype=torch.where(put, cand.aptype, state.aptype.to(I32)),
            aticks=torch.where(put, eta_att, state.aticks.to(I32)),
            aorder=torch.where(put, oc + cand.rank, state.aorder),
            atime=torch.where(put, state.time[:, None, None], state.atime),
            order_ctr=state.order_ctr + 2 * self.H * self.W,
        ).canon()

    # ------------------------------------------------------------------
    # cycle (GameState.cycle :553-571 + UnitAction.execute :338-465)

    def cycle(self, state: State, active: Optional[torch.Tensor] = None,
              u01: Optional[torch.Tensor] = None
              ) -> Tuple[State, torch.Tensor]:
        """One game tick (kernel.py:508-716); returns (state', gameover).
        With ``active`` (bool ``[B]``), the envs whose flag is off keep
        their state and read gameover False (the playouts' frozen lanes).
        ``u01`` (float32 ``[B, H, W]``, each attacker cell's uniform) draws
        UTT v3's damage, ``dmin + int(u01 * (dmax - dmin + 1))`` where
        ``dmax > dmin`` (kernel.py:536-545); a UTT with random damage
        needs it and one without refuses it."""
        if self._use_kernel(state.utype):
            return KN.CYCLE(self.cfg, state, active, u01)
        return self.cycle_plain(state, active, u01)

    def _check_u01(self, state: State, u01: Optional[torch.Tensor]) -> None:
        """Raise unless ``u01`` is what ``cycle`` needs: None under
        deterministic damage, else float32 ``[B, H, W]``."""
        if self.cfg.det_damage:
            if u01 is not None:
                raise ValueError("cycle: u01 given, but the UTT's damage is "
                                 "deterministic")
            return
        if u01 is None:
            raise ValueError("cycle: random damage (UTT v3) needs u01")
        shape = (state.batch, self.H, self.W)
        if u01.dtype != torch.float32 or tuple(u01.shape) != shape:
            raise ValueError(f"cycle: u01 must be float32 {shape}, got "
                             f"{u01.dtype} {tuple(u01.shape)}")

    def cycle_plain(self, state: State, active: Optional[torch.Tensor] = None,
                    u01: Optional[torch.Tensor] = None
                    ) -> Tuple[State, torch.Tensor]:
        self._check_u01(state, u01)
        new, done = self._cycle_plain(state, u01)
        if active is None:
            return new, done
        return state.select(active, new), done & active

    def _cycle_plain(self, state: State, u01: Optional[torch.Tensor]
                     ) -> Tuple[State, torch.Tensor]:
        H, W, T, R = self.H, self.W, self.T, self.R
        t, exists = self._ctx(state)
        tp = self._tprop
        dev = t.device
        s = state
        hp = s.hp.to(I32)
        carried = s.carried.to(I32)
        owner = s.owner.to(I32)
        aparam = s.aparam.to(I32)
        aorder = s.aorder
        ticks = torch.where(s.busy, s.aticks.to(I32) - 1, s.aticks.to(I32))
        comp = s.busy & (ticks <= 0)
        cm = comp & (s.atype == MOVE)
        ch = comp & (s.atype == HARVEST)
        cr = comp & (s.atype == RETURN)
        cp = comp & (s.atype == PRODUCE)
        ca = comp & (s.atype == ATTACK)
        inf = torch.full_like(aorder, INF)

        dep_order = torch.where(cm, aorder, INF)
        arr_order = inf
        for d in range(4):
            mvp = (cm | cp) & (aparam == d)
            arr_order = torch.minimum(arr_order, torch.where(
                push(mvp, d, False), push(aorder, d), INF))

        # attacks: order-filtered damage sums over the attack box
        dmg = tp("min_damage", t)
        if u01 is not None:
            dmax = tp("max_damage", t)
            dmg = torch.where(dmax > dmg, dmg + (u01 * (dmax - dmg + 1)).to(
                I32), dmg)
        xs, ys = iota(H, W, dev)
        dxp = s.atx.to(I32) - xs
        dyp = s.aty.to(I32) - ys
        q_d = [torch.where(push(cr & (aparam == d), d, False),
                           push(aorder, d), INF) for d in range(4)]
        z = torch.zeros_like(aorder)
        dmg_total, dmg_pre_dep, dmg_post_arr = z, z, z
        dmg_pre_ret = [z, z, z, z]
        for oy in range(-R, R + 1):
            for ox in range(-R, R + 1):
                if ox == 0 and oy == 0 or ox * ox + oy * oy > R * R:
                    continue
                sel = ca & (dxp == ox) & (dyp == oy)
                sp = shift(sel, ox, oy, False)
                sd = torch.where(sp, shift(torch.where(sel, dmg, 0), ox, oy), 0)
                so = torch.where(sp, shift(aorder, ox, oy), INF)
                dmg_total = dmg_total + sd
                dmg_pre_dep = dmg_pre_dep + torch.where(so < dep_order, sd, 0)
                dmg_post_arr = dmg_post_arr + torch.where(so > arr_order, sd, 0)
                for d in range(4):
                    dmg_pre_ret[d] = dmg_pre_ret[d] + torch.where(
                        so < q_d[d], sd, 0)

        # harvest: per-node 4-way depletion in issue order
        is_res_n = exists & tp("is_resource", t)
        hv_ok = ch & tp("can_harvest", t) & (carried == 0)
        harv_a = tp("harvest_amount", t)
        h_val = [push(hv_ok & (aparam == d), d, False) & is_res_n
                 for d in range(4)]
        h_ord = torch.stack([torch.where(h_val[d], push(aorder, d), INF)
                             for d in range(4)], -1)
        h_amt = torch.stack([torch.where(h_val[d], push(harv_a, d), 0)
                             for d in range(4)], -1)
        ho_s, perm = torch.sort(h_ord, dim=-1, stable=True)
        ha_s = torch.gather(h_amt, -1, perm)
        hd_s = perm.to(I32)
        prev = torch.cumsum(ha_s, -1, dtype=I32) - ha_s
        take_s = (ho_s < INF) & (carried[..., None] - prev > 0)
        node_taken = torch.where(take_s, ha_s, 0).sum(-1, dtype=I32)
        node_res = carried - node_taken
        node_removed = is_res_n & (node_taken > 0) & (node_res <= 0)
        got = torch.zeros_like(exists)
        amt_got = z
        for d in range(4):
            sel = (hd_s == d) & take_s
            got_d = sel.any(-1)
            mine_d = hv_ok & (aparam == d)
            got = got | (mine_d & pull(got_d, d, False))
            amt_got = amt_got + torch.where(
                mine_d, pull(torch.where(sel, ha_s, 0).amax(-1), d), 0)

        # returns: stockpile standing, not departing, alive at the return
        is_stock_n = exists & tp("is_stockpile", t)
        ret_valid = torch.zeros_like(exists)
        for d in range(4):
            rd = cr & (aparam == d) & (carried > 0)
            alive = is_stock_n & (hp > dmg_pre_ret[d]) & (dep_order > q_d[d])
            ret_valid = ret_valid | (rd & pull(alive, d, False))
        dep = [sum2(torch.where(ret_valid & (owner == p), carried, 0))
               for p in (0, 1)]

        # produce: pay at completion; newborn IDs by row-major prefix
        pcost = tp("cost", s.aptype.long().clamp(0, T - 1))
        spend = [sum2(torch.where(cp & (owner == p), pcost, 0)) for p in (0, 1)]
        cpi = cp.to(I32).reshape(-1, H * W)
        nb_rank = (torch.cumsum(cpi, 1, dtype=I32) - cpi).reshape(-1, H, W)
        n_born = cpi.sum(1, dtype=I32)

        mv_alive = cm & (hp - dmg_pre_dep > 0)
        hp_mid = hp - dmg_pre_dep

        # compose the next board
        standing = exists & ~cm
        hp_std = hp - dmg_total
        dead_std = standing & ~is_res_n & (hp_std <= 0) & (owner >= 0)
        dead_neutral = standing & (owner < 0) & ~is_res_n & (hp_std <= 0)
        keep = standing & ~dead_std & ~dead_neutral & ~node_removed

        utype_n = torch.where(keep, s.utype.to(I32), 0)
        owner_n = torch.where(keep, owner, -1)
        hp_n = torch.where(keep, hp_std, 0)
        uid_n = torch.where(keep, s.uid, 0)
        carried_keep = torch.where(got, amt_got,
                                   torch.where(ret_valid, 0, carried))
        carried_keep = torch.where(is_res_n, node_res, carried_keep)
        carried_n = torch.where(keep, carried_keep, 0)

        busy_n = s.busy & ~comp & keep
        atype_n = torch.where(busy_n, s.atype.to(I32), 0)
        aparam_n = torch.where(busy_n, aparam, 0)
        atx_n = torch.where(busy_n, s.atx.to(I32), 0)
        aty_n = torch.where(busy_n, s.aty.to(I32), 0)
        aptype_n = torch.where(busy_n, s.aptype.to(I32), 0)
        aticks_n = torch.where(busy_n, ticks, 0)
        aorder_n = torch.where(busy_n, aorder, 0)
        atime_n = torch.where(busy_n, s.atime, -1)

        for d in range(4):      # arrivals: movers
            at_dst = push(mv_alive & (aparam == d), d, False)
            hp_arr = push(hp_mid, d) - dmg_post_arr
            alive_dst = at_dst & (hp_arr > 0)
            utype_n = torch.where(alive_dst, push(s.utype.to(I32), d), utype_n)
            owner_n = torch.where(alive_dst, push(owner, d), owner_n)
            hp_n = torch.where(alive_dst, hp_arr, hp_n)
            carried_n = torch.where(alive_dst, push(carried, d), carried_n)
            uid_n = torch.where(alive_dst, push(s.uid, d), uid_n)

        hp_born_src = tp("hp", s.aptype.long().clamp(0, T - 1))
        for d in range(4):      # arrivals: newborns
            at_dst = push(cp & (aparam == d), d, False)
            hp_nb = push(hp_born_src, d) - dmg_post_arr
            alive_dst = at_dst & (hp_nb > 0)
            utype_n = torch.where(alive_dst, push(s.aptype.to(I32), d) + 1,
                                  utype_n)
            owner_n = torch.where(alive_dst, push(owner, d), owner_n)
            hp_n = torch.where(alive_dst, hp_nb, hp_n)
            carried_n = torch.where(alive_dst, 0, carried_n)
            uid_n = torch.where(alive_dst,
                                s.next_id[:, None, None] + push(nb_rank, d),
                                uid_n)

        resources_n = s.resources + torch.stack(
            [dep[0] - spend[0], dep[1] - spend[1]], -1)
        new = s.replace(
            utype=utype_n, owner=owner_n, hp=hp_n, carried=carried_n,
            uid=uid_n, busy=busy_n, atype=atype_n, aparam=aparam_n,
            atx=atx_n, aty=aty_n, aptype=aptype_n, aticks=aticks_n,
            aorder=aorder_n, atime=atime_n, time=s.time + 1,
            resources=resources_n, next_id=s.next_id + n_born).canon()
        return new, self.gameover(new)

    # ------------------------------------------------------------------
    def _counts(self, state: State):
        alive = state.utype > 0
        return (sum2(alive & (state.owner == 0)),
                sum2(alive & (state.owner == 1)))

    def gameover(self, state: State) -> torch.Tensor:
        """PhysicalGameState.gameover :361-387, bool [B]."""
        n0, n1 = self._counts(state)
        return ((n0 + n1) == 0) | ((n0 == 0) ^ (n1 == 0))

    def winner(self, state: State) -> torch.Tensor:
        """PhysicalGameState.winner :334-353, int32 [B] (-1 none/draw)."""
        n0, n1 = self._counts(state)
        return torch.where((n0 > 0) & (n1 == 0), 0,
                           torch.where((n1 > 0) & (n0 == 0), 1, -1)).to(I32)


def make_engine(cfg: EngineConfig, plain: bool = False) -> Engine:
    return Engine(cfg, plain)
