"""Gridnet RL environment on batched planes.

A port of ``microrts_tpu.env.gridnet`` (see its docstring for the Java
sources each function mirrors).  Every method takes and returns batched
tensors: states are ``[B, H, W]`` planes and gridnet actions are int32
``[B, H, W, 7]``.  ``decode``, ``masks``, the step's rewards, ``dones``,
``observation`` and ``observation_onehot`` dispatch by device like the
engine: CPU tensors (or ``plain=True``) take the plain version, CUDA
tensors launch the ``decode``, ``actor``, ``epilogue``, ``splice_obs``
and, under partial observability, ``po_state`` and ``obs_po`` kernels.

``partial_obs=True`` is the JAX package's PO branch (gridnet.py:357-378):
each player decodes with the in-flight claims of its fog-of-war view,
both issues are the full ``issue`` (hidden enemy reservations cancel at
issue), and observations are the 8 PO planes.  As in the JAX package, the
PO step ignores ``frame_skip`` and ``masks`` read the full state;
``step_vs`` has no PO branch.

Randomness enters as tensors, never from a global RNG: under UTT v3's
random damage each cycle reads float32 uniforms ``[B, H, W]`` and under
fog with CANCEL_RANDOM each issue reads bool coins ``[B, H, W, 4]``
(JAX draws both from ``State.key``).  ``advance``/``step``/``step_vs``
take them as ``u01``/``coins`` or draw them from a ``gen`` argument
(``draw_u01``, ``draw_coins``); an env that needs neither draws nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .. import kernels as KN
from ..engine import fog
from ..engine.kernel import as_player, balance, iota, make_engine
from ..engine.pgs import PhysicalGameState
from ..engine.types import (ATTACK, HARVEST, INF, MOVE, NONE, PRODUCE, RETURN,
                            Candidates, EngineConfig, State, resolve_device,
                            state_from_pgs)
from ..engine.utt import UnitTypeTable

I32 = torch.int32

REWARD_NAMES = (
    "winloss", "resourcegather", "produceworker", "producebuilding",
    "producecombat", "attack", "closertoenemybase", "closertoenemyunit",
)
PORTED_REWARDS = REWARD_NAMES


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    engine: EngineConfig
    max_produce_scan: int = 16
    reward_fns: Tuple[str, ...] = REWARD_NAMES[:6]
    # type-name ids for name-based rewards (-1 = absent in this UTT)
    worker_id: int = -1
    base_id: int = -1
    barracks_id: int = -1
    light_id: int = -1
    heavy_id: int = -1
    ranged_id: int = -1


class GridnetEnv:
    """Single-map gridnet env over a batch of states on ``device``.

    ``device`` defaults to CUDA, and a missing card raises; pass
    ``device="cpu"`` for the plain path.  ``plain=True`` runs the plain
    PyTorch versions of the kernels on any device (their oracle)."""

    def __init__(self, map_path: str, utt: Optional[UnitTypeTable] = None,
                 reward_fns: Sequence[str] = REWARD_NAMES[:6],
                 max_produce_scan: int = 16, partial_obs: bool = False,
                 frame_skip: int = 1, device="cuda", plain: bool = False,
                 pgs: Optional[PhysicalGameState] = None):
        """``pgs`` (a loaded map) stands in for ``map_path``'s file."""
        for name in reward_fns:
            if name not in REWARD_NAMES:
                raise ValueError(f"unknown reward fn {name!r}")
        self.device = resolve_device(device)
        self.partial_obs = partial_obs
        self.frame_skip = frame_skip
        self.utt = utt if utt is not None else UnitTypeTable(2)
        self.pgs0 = (pgs if pgs is not None
                     else PhysicalGameState.load(map_path, self.utt))
        self.h, self.w = self.pgs0.height, self.pgs0.width
        ecfg = EngineConfig.from_utt(self.utt, self.h, self.w)
        self.engine = make_engine(ecfg, plain)

        def tid(name):
            ut = self.utt.get_unit_type(name)
            return ut.ID if ut is not None else -1

        self.cfg = EnvConfig(
            engine=ecfg, max_produce_scan=max_produce_scan,
            reward_fns=tuple(reward_fns),
            worker_id=tid("Worker"), base_id=tid("Base"),
            barracks_id=tid("Barracks"), light_id=tid("Light"),
            heavy_id=tid("Heavy"), ranged_id=tid("Ranged"))
        self.init_state = state_from_pgs(self.pgs0, ecfg, 1, self.device)

    @property
    def num_rewards(self) -> int:
        return len(self.cfg.reward_fns)

    # ------------------------------------------------------------------
    # the engine's random inputs

    @property
    def random_damage(self) -> bool:
        """Every cycle draws damage uniforms (UTT v3)."""
        return not self.cfg.engine.det_damage

    @property
    def random_coins(self) -> bool:
        """Every step's two full issues draw CANCEL_RANDOM coins (fog of
        war and the CANCEL_RANDOM policy)."""
        return self.partial_obs and self.cfg.engine.move_conflict_policy == 2

    @property
    def needs_draws(self) -> bool:
        """The env's steps read draws: ``random_damage`` or
        ``random_coins``."""
        return self.random_damage or self.random_coins

    @property
    def step_cycles(self) -> int:
        """The cycles of one ``advance``: ``frame_skip``, 1 under fog."""
        return 1 if self.partial_obs else self.frame_skip

    def draw_u01(self, gen: torch.Generator, cycles: int,
                 batch: int) -> Optional[torch.Tensor]:
        """The damage uniforms of ``cycles`` cycles of ``batch`` envs,
        float32 ``[cycles, batch, H, W]`` from ``gen``; None (nothing
        drawn) under deterministic damage."""
        if not self.random_damage:
            return None
        return torch.rand((cycles, batch, self.h, self.w), generator=gen,
                          device=self.device)

    def draw_coins(self, gen: torch.Generator,
                   batch: int) -> Optional[torch.Tensor]:
        """The two issues' CANCEL_RANDOM coins of one step, bool ``[2,
        batch, H, W, 4]`` from ``gen``; None (nothing drawn) unless
        ``random_coins``."""
        if not self.random_coins:
            return None
        return torch.rand((2, batch, self.h, self.w, 4), generator=gen,
                          device=self.device) < 0.5

    def action_nvec(self):
        d = 2 * self.cfg.engine.max_range + 1
        return [6, 4, 4, 4, 4, self.cfg.engine.num_types, d * d]

    def reset(self, num_envs: int) -> State:
        return State(**{f: v.expand((num_envs,) + tuple(v.shape[1:])).clone()
                        for f, v in vars(self.init_state).items()})

    # ------------------------------------------------------------------
    def decode(self, state: State, actions: torch.Tensor, player,
               none_duration: Optional[int] = None,
               view: Optional[State] = None) -> Candidates:
        """PlayerAction.fromVectorAction + fillWithNones(gs, player, 1)
        for one player (an int, or int32 ``[B]``: one per env), against
        the in-flight claims and produce costs of ``state``
        (gridnet.py:139-343).  With ``none_duration``, every
        NONE candidate gets that parameter: the bot path's NONE(10)
        (ops/playout.py:81-86).  With ``view`` (the player's fog-of-war
        view of ``state``), the in-flight claims are the view's
        (gridnet.py:365-372); legality and the spend stay ``state``'s."""
        if self.engine._use_kernel(actions):
            return KN.DECODE(self.cfg, state, actions, player, none_duration,
                             view)
        return self.decode_plain(state, actions, player, none_duration, view)

    def decode_plain(self, state: State, actions: torch.Tensor,
                     player, none_duration: Optional[int] = None,
                     view: Optional[State] = None) -> Candidates:
        cfg = self.cfg.engine
        H, W, T = self.h, self.w, cfg.num_types
        R = cfg.max_range
        D = 2 * R + 1
        HW, L = H * W, H * W + 2 * W
        B = actions.shape[0]
        dev = actions.device
        cost = self.engine.lut("cost", dev)
        me = as_player(player, dev)
        claimed0 = self._inflight_claims(state if view is None else view)
        spent0 = self._inflight_spent(state, player)

        present = (state.utype > 0) & (state.owner == me) & ~state.busy
        a = actions.to(I32)
        at = a[..., 0]
        aparam = torch.where(at == NONE, -1, 0).to(I32)
        for code, comp in ((MOVE, 1), (HARVEST, 2), (RETURN, 3), (PRODUCE, 4)):
            aparam = torch.where(at == code, a[..., comp], aparam)
        aptype = a[..., 5].clamp(0, T - 1)
        xs, ys = iota(H, W, dev)
        rel = a[..., 6]
        atx = torch.where(at == ATTACK, xs + torch.remainder(rel, D) - R, 0)
        aty = torch.where(at == ATTACK,
                          ys + torch.div(rel, D, rounding_mode="floor") - R, 0)
        rank = (ys * W + xs).expand(B, H, W)
        cand_ok = present & (at >= 0) & (at < 6)

        # claims live in Java's FLAT position space, slot = W + pos + OFF
        is_claim = cand_ok & ((at == MOVE) | (at == PRODUCE))
        dparam = aparam.clamp(0, 3)
        off = torch.tensor((-W, 1, W, -1), dtype=I32, device=dev)
        slot = (W + rank + off[dparam.long()]).reshape(B, HW).long()
        rank_f = rank.reshape(B, HW)
        blocked0 = torch.gather(claimed0, 1, slot).reshape(B, H, W)
        is_claim = is_claim & ~blocked0
        is_move = is_claim & (at == MOVE)
        is_prod = is_claim & (at == PRODUCE)

        def slot_min(mask):
            buf = torch.full((B, L), INF, dtype=I32, device=dev)
            vals = torch.where(mask.reshape(B, HW), rank_f, INF)
            return buf.scatter_reduce(1, slot, vals, "amin")

        mrank = slot_min(is_move)
        mrank_own = torch.gather(mrank, 1, slot)
        pos_ok = is_prod.reshape(B, HW) & (rank_f < mrank_own)

        # produce budget over the first Kp pos-ok candidates in rank
        # (row-major) order, with the zero-skip and same-slot block
        Kp = self.cfg.max_produce_scan
        order = torch.cumsum(pos_ok.to(I32), 1) - 1
        in_scan = pos_ok & (order < Kp)
        idx = torch.where(in_scan, order, Kp).long()
        pcost = cost[aptype.long()].reshape(B, HW)
        c_k = torch.zeros((B, Kp + 1), dtype=I32, device=dev).scatter(
            1, idx, pcost)[:, :Kp]
        x_k = torch.full((B, Kp + 1), -1, dtype=torch.long,
                         device=dev).scatter(1, idx, slot)[:, :Kp]
        valid = torch.arange(Kp, device=dev)[None, :] < pos_ok.sum(1)[:, None]
        bal = balance(state, player)
        spent = spent0
        kept = torch.zeros((B, Kp), dtype=torch.bool, device=dev)
        for i in range(Kp):
            blocked = (kept[:, :i] & (x_k[:, :i] == x_k[:, i:i + 1])).any(1)
            res_ok = (spent == 0) | (spent + c_k[:, i] <= bal)
            keep_i = valid[:, i] & ~blocked & res_ok
            spent = spent + torch.where(keep_i, c_k[:, i], 0)
            kept[:, i] = keep_i
        kept_pad = torch.cat([kept, kept.new_zeros((B, 1))], 1)
        prod_kept = (in_scan & torch.gather(kept_pad, 1, idx)).reshape(B, H, W)

        prank_own = torch.gather(slot_min(prod_kept), 1, slot)
        move_kept = is_move & ((rank_f == mrank_own)
                               & (rank_f < prank_own)).reshape(B, H, W)
        keep = ((cand_ok & (at != MOVE) & (at != PRODUCE))
                | move_kept | prod_kept)
        pad = present & ~keep
        atype = torch.where(keep, at, torch.where(pad, NONE, -1)).to(I32)
        aparam = torch.where(keep, aparam, torch.where(pad, 1, 0)).to(I32)
        if none_duration is not None:
            aparam = torch.where(atype == NONE, int(none_duration), aparam)
        return Candidates(
            atype=atype, aparam=aparam,
            atx=atx.to(I32), aty=aty.to(I32), aptype=aptype.to(I32),
            rank=torch.where(keep, rank,
                             torch.where(pad, HW + rank, INF)).to(I32))

    def _inflight_claims(self, state: State) -> torch.Tensor:
        """Flat padded claim buffer bool ``[B, H*W + 2*W]`` of in-flight
        MOVE/PRODUCE targets (Java base_ru positions, row wrap kept)."""
        H, W = self.h, self.w
        B = state.batch
        inflight = state.busy & ((state.atype == MOVE)
                                 | (state.atype == PRODUCE))
        buf = torch.zeros((B, H * W + 2 * W), dtype=torch.bool,
                          device=state.device)
        for d, off in enumerate((-W, 1, W, -1)):
            s = W + off
            seg = (inflight & (state.aparam == d)).reshape(B, -1)
            buf[:, s:s + H * W] |= seg
        return buf

    def _inflight_spent(self, state: State, player) -> torch.Tensor:
        """int32 [B]: ``player``'s (an int or int32 ``[B]``) in-flight
        produce costs."""
        cost = self.engine.lut("cost", state.device)
        pt = state.aptype.long().clamp(0, self.cfg.engine.num_types - 1)
        pc = torch.where(state.busy & (state.atype == PRODUCE)
                         & (state.owner == as_player(player, state.device)),
                         cost[pt], 0)
        return pc.sum((1, 2), dtype=I32)

    # ------------------------------------------------------------------
    def step(self, state: State, a0: torch.Tensor, a1: torch.Tensor,
             coins=None, u01=None, gen: Optional[torch.Generator] = None):
        """Self-play step (JNIGridnetClientSelfPlay.gameStep :159-190):
        decode p0 -> issue -> decode p1 against the post-issue state ->
        issue -> cycle (``frame_skip`` times) -> rewards.  Returns
        (state', rewards float32 [B, 2, NR], done bool [B]).  ``coins``,
        ``u01`` and ``gen``: see ``advance``."""
        c0, c1, state2, done = self.advance(state, a0, a1, coins, u01, gen)
        return state2, self.rewards(state, c0, c1, state2), done

    def advance(self, state: State, a0: torch.Tensor, a1: torch.Tensor,
                coins=None, u01=None, gen: Optional[torch.Generator] = None):
        """The step up to its epilogue: (candidates p0, candidates p1,
        state after the cycles, gameover bool [B]).  Under partial
        observability: each player decodes with its view's claims, both
        issues are the full ``issue`` and one cycle (gridnet.py:357-378).
        ``u01`` (float32 ``[step_cycles, B, H, W]``, one slice a cycle)
        draws UTT v3's damage; ``coins`` (the two issues' bool ``[B, H, W,
        4]``, e.g. ``[2, B, H, W, 4]``) decide CANCEL_RANDOM's conflicts
        under fog.  What the env needs and is not given is drawn from
        ``gen``; without it, the engine raises."""
        eng = self.engine
        B = state.batch
        if gen is not None:
            if u01 is None:
                u01 = self.draw_u01(gen, self.step_cycles, B)
            if coins is None:
                coins = self.draw_coins(gen, B)

        def u(i):
            return None if u01 is None else u01[i]

        if self.partial_obs:
            k0, k1 = coins if coins is not None else (None, None)
            c0 = self.decode(state, a0, 0, view=self.po_view(state, 0))
            state1 = eng.issue(state, c0, k0)
            c1 = self.decode(state1, a1, 1, view=self.po_view(state1, 1))
            state2, done = eng.cycle(eng.issue(state1, c1, k1), u01=u(0))
            return c0, c1, state2, done
        c0 = self.decode(state, a0, 0)
        state1 = eng.issue_env(state, c0)
        c1 = self.decode(state1, a1, 1)
        state2 = eng.issue_env(state1, c1)
        state2, done = eng.cycle(state2, u01=u(0))
        for i in range(1, self.frame_skip):
            state2, d2 = eng.cycle(state2, u01=u(i))
            done = done | d2
        return c0, c1, state2, done

    def step_vs(self, state: State, a0: torch.Tensor, bot_fn, u01=None,
                gen: Optional[torch.Generator] = None):
        """Step with an external player-0 action and a scripted opponent
        (JNIGridnetClient.gameStep; gridnet.py:400-418 of the JAX
        package): ``a0`` is decoded and issued, ``bot_fn(state1, 1)`` (a
        gridnet action int32 ``[B, H, W, 7]``) is decoded against the
        post-issue state and issued, then one ``cycle`` (its damage
        uniforms ``u01`` float32 ``[1, B, H, W]``, or drawn from
        ``gen``).  Returns (state', player 0's rewards float32 [B, NR],
        done bool [B])."""
        eng = self.engine
        if u01 is None and gen is not None:
            u01 = self.draw_u01(gen, 1, state.batch)
        c0 = self.decode(state, a0, 0)
        state1 = eng.issue_env(state, c0)
        c1 = self.decode(state1, bot_fn(state1, 1), 1)
        state2, done = eng.cycle(eng.issue_env(state1, c1),
                                 u01=None if u01 is None else u01[0])
        return state2, self.rewards(state, c0, c1, state2)[:, 0], done

    def rewards(self, pre: State, c0: Candidates, c1: Candidates,
                after: State) -> torch.Tensor:
        """Both players' rewards float32 [B, 2, NR] of the step from
        ``pre`` to ``after`` with the decoded candidates ``c0``/``c1``."""
        if self.engine._use_kernel(after.utype):
            return KN.EPILOGUE(self.cfg, after, pre, c0, c1)[0]
        return self.rewards_plain(pre, c0, c1, after)

    def rewards_plain(self, pre: State, c0: Candidates, c1: Candidates,
                      after: State) -> torch.Tensor:
        return torch.stack([self._rewards(pre, c0, 0, after),
                            self._rewards(pre, c1, 1, after)], 1)

    # ------------------------------------------------------------------
    def po_view(self, state: State, player) -> State:
        """``player``'s (an int or int32 ``[B]``) fog-of-war view of
        ``state`` (engine/fog.py ``po_state``)."""
        return fog.po_state(state, player, self.cfg.engine,
                            plain=self.engine.plain)

    def observation(self, state: State, player: int) -> torch.Tensor:
        """GameState.getVectorObservation: int32 [B, 6, H, W] planes hp,
        carried, owner-relative, type+1, current action type, walls; under
        partial observability the 8 PO planes [B, 8, H, W] of the view
        (engine/fog.py ``observation_po``)."""
        if self.partial_obs:
            return fog.observation_po(state, player, self.cfg.engine,
                                      plain=self.engine.plain)
        if self.engine._use_kernel(state.utype):
            return KN.SPLICE_OBS(self.cfg.engine, state, obs=(player,))[1][0]
        return self.observation_plain(state, player)

    def observation_plain(self, state: State, player: int) -> torch.Tensor:
        if self.partial_obs:
            return fog.observation_po_plain(state, player, self.cfg.engine)
        exists = state.utype > 0
        owner = state.owner.to(I32)
        ownerp = torch.where(exists & (owner >= 0),
                             torch.remainder(owner + player, 2) + 1, 0)
        actp = torch.where(exists & state.busy, state.atype.to(I32), 0)
        return torch.stack([
            torch.where(exists, state.hp.to(I32), 0),
            torch.where(exists, state.carried.to(I32), 0),
            ownerp,
            torch.where(exists, state.utype.to(I32), 0),
            actp,
            state.terrain.to(I32),
        ], 1).to(I32)

    def observation_onehot(self, state: State, player: int) -> torch.Tensor:
        """Binarized observation float32 [B, H, W, 5+5+3+(T+1)+6] of
        planes 0-4 of ``observation`` (under partial observability, of
        the view)."""
        if self.engine._use_kernel(state.utype):
            if self.partial_obs:
                return KN.OBS_PO(self.cfg.engine, state, (player,),
                                 onehot=(0,), obs=False)[1][0]
            return KN.SPLICE_OBS(self.cfg.engine, state,
                                 onehot=(player,))[2][0]
        return self.observation_onehot_plain(state, player)

    def observation_onehot_plain(self, state: State,
                                 player: int) -> torch.Tensor:
        T = self.cfg.engine.num_types
        obs = self.observation_plain(state, player).long()
        oh = torch.nn.functional.one_hot
        return torch.cat([
            oh(obs[:, 0].clamp(0, 4), 5), oh(obs[:, 1].clamp(0, 4), 5),
            oh(obs[:, 2], 3), oh(obs[:, 3], T + 1), oh(obs[:, 4], 6),
        ], -1).to(torch.float32)

    def masks(self, state: State, player) -> torch.Tensor:
        """int32 [B, H, W, 1+6+4+4+4+4+T+(2R+1)^2] (JNIGridnetClient
        :60-99) of ``player``, an int or int32 ``[B]`` (one per env)."""
        if self.engine._use_kernel(state.utype):
            return KN.ACTOR(self.cfg.engine, state, player, masks=True)[1]
        return self.masks_plain(state, player)

    def masks_plain(self, state: State, player) -> torch.Tensor:
        m = self.engine.legal_masks(state, player)
        return torch.cat(
            [m["can_act"][..., None], m["type"], m["move"], m["harvest"],
             m["ret"], m["produce_dir"], m["produce_type"], m["attack"]],
            -1).to(I32)

    # ------------------------------------------------------------------
    def dones(self, state: State) -> torch.Tensor:
        """Per-reward-function done flags bool [B, NR]: winloss ->
        gameover; resourcegather -> no resource left; others False."""
        if self.engine._use_kernel(state.utype):
            return KN.EPILOGUE(self.cfg, state)[1]
        return self.dones_plain(state)

    def dones_plain(self, state: State) -> torch.Tensor:
        out = []
        for name in self.cfg.reward_fns:
            if name == "winloss":
                out.append(self.engine.gameover(state))
            elif name == "resourcegather":
                t = (state.utype.long() - 1).clamp(
                    0, self.cfg.engine.num_types - 1)
                node = (state.utype > 0) & self.engine.lut(
                    "is_resource", state.device)[t]
                out.append(~(node & (state.carried > 0)).any((1, 2)))
            else:
                out.append(torch.zeros(state.batch, dtype=torch.bool,
                                       device=state.device))
        return torch.stack(out, 1)

    # ------------------------------------------------------------------
    # rewards (ai/reward/*, from the decoded actions + pre/post states)

    def _rewards(self, pre: State, cand: Candidates, player: int,
                 after: State) -> torch.Tensor:
        """float32 [B, NR]."""
        acted = (cand.atype >= 0) & (pre.owner == player) & (pre.utype > 0)
        return torch.stack([self._reward_one(n, pre, cand, acted, player,
                                             after)
                            for n in self.cfg.reward_fns], 1)

    def _reward_one(self, name, pre, cand, acted, me, after):
        cfg = self.cfg
        f32 = torch.float32

        def count(m):
            return m.sum((1, 2), dtype=I32).to(f32)

        if name == "winloss":
            over = self.engine.gameover(after)
            won = self.engine.winner(after) == me
            return torch.where(over, torch.where(won, 1.0, -1.0),
                               0.0).to(f32)
        if name == "resourcegather":
            return count(acted & ((cand.atype == HARVEST)
                                  | (cand.atype == RETURN)))
        prod = acted & (cand.atype == PRODUCE)
        if name == "produceworker":
            return count(prod & (cand.aptype == cfg.worker_id))
        if name == "producebuilding":
            return count(prod & ((cand.aptype == cfg.base_id)
                                 | (cand.aptype == cfg.barracks_id)))
        if name == "producecombat":
            return count(prod & ((cand.aptype == cfg.light_id)
                                 | (cand.aptype == cfg.heavy_id)
                                 | (cand.aptype == cfg.ranged_id)))
        if name == "attack":
            # +1 per attack aimed at an enemy-occupied cell, -1 at an
            # own-occupied cell (pre-step board), targets within the range
            # disc (the JAX version scans the disc's offsets; here each
            # target is gathered once)
            R = cfg.engine.max_range
            H, W = self.h, self.w
            xs, ys = iota(H, W, cand.atx.device)
            dx, dy = cand.atx - xs, cand.aty - ys
            ok = (acted & (cand.atype == ATTACK) & (dx * dx + dy * dy <= R * R)
                  & (cand.atx >= 0) & (cand.atx < W)
                  & (cand.aty >= 0) & (cand.aty < H))
            idx = torch.where(ok, cand.aty * W + cand.atx, 0).reshape(
                pre.batch, -1).long()
            occ = torch.gather((pre.utype > 0).reshape(pre.batch, -1), 1, idx)
            own = torch.gather(pre.owner.reshape(pre.batch, -1), 1, idx)
            ok, occ, own = (t.reshape(ok.shape) for t in (ok, occ, own))
            pos = (ok & occ & (own == 1 - me)).sum((1, 2), dtype=I32)
            neg = (ok & occ & (own == me)).sum((1, 2), dtype=I32)
            return (pos - neg).to(f32)
        if name in ("closertoenemybase", "closertoenemyunit"):
            return self._closer_reward(name, pre, after, me)
        raise ValueError(f"unknown reward fn {name!r}")

    def _closer_reward(self, name, pre, after, me):
        """The drop in the least float32 Euclidean distance from ``me``'s
        mobile units (Worker, Light, Heavy, Ranged) to the first target in
        row-major order on the pre-step board (an enemy base, or any enemy
        unit), pre vs post step; 0 without a target or where either board
        has no mobile unit (gridnet.py:555-584)."""
        cfg = self.cfg
        H, W = self.h, self.w
        xs, ys = (v.to(torch.float32) for v in iota(H, W, pre.device))
        if name == "closertoenemybase":
            tgt = (pre.utype - 1 == cfg.base_id) & (pre.owner == 1 - me)
        else:
            tgt = (pre.utype > 0) & (pre.owner == 1 - me)
        flat = tgt.reshape(pre.batch, -1)
        has = flat.any(1)
        idx = flat.to(torch.uint8).argmax(1).to(I32)   # the first True
        bx = (idx % W).to(torch.float32)[:, None, None]
        by = (idx // W).to(torch.float32)[:, None, None]
        d = torch.sqrt((xs - bx) ** 2 + (ys - by) ** 2)

        def min_dist(state):
            t = state.utype - 1
            mobile = ((state.utype > 0) & (state.owner == me)
                      & ((t == cfg.worker_id) | (t == cfg.light_id)
                         | (t == cfg.heavy_id) | (t == cfg.ranged_id)))
            return torch.where(mobile, d, float("inf")).amin((1, 2))

        d_old, d_new = min_dist(pre), min_dist(after)
        r = torch.where(torch.isfinite(d_old) & torch.isfinite(d_new),
                        d_old - d_new, 0.0)
        return torch.where(has, r, 0.0).to(torch.float32)
