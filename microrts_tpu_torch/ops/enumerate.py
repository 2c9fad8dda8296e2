"""Lazy odometer enumeration of joint player actions, batched over lanes.

A port of ``microrts_tpu.ops.enumerate`` (see its docstring for the Java
source, ``rts/PlayerActionGenerator``, and the documented order-only
divergences).  The counter is one digit per cell; the digit selects the
k-th legal arm of the cell's arm catalog row (``ops.arms``) counted from
the top, NONE last.  One ``next_action`` walks every active lane's
odometer forward to its next joint action whose claims and produce costs
are consistent with the in-flight ones (``getNextAction``), or to
exhaustion.

Layout: the odometers and contexts of a batch are tables with a row axis,
``[B, R, ...]``, so that a search keeps one per stack row and addresses
row ``row[b]`` of lane ``b`` in place (``bots/minimax.py``); ``init``
gives ``R = 1``.  The legal arms are stored packed, ``NW = ceil(A / 32)``
int32 words a cell (arm ``a`` is bit ``a % 32`` of word ``a // 32``):
three words at A = 90, where a bool ``[HW, A]`` row would take 30x the
memory.  A cell's radix (``size``) and whether it acts (``acting``, arm 0
= NONE is legal exactly where the unit can act) are read off the words.

On CUDA tensors ``next_action`` is the ``enum_next`` kernel (K12e); CPU
tensors (or ``plain=True``) take the plain version beside it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as KN
from ..engine.types import State
from .arms import ArmSpace, arm_masks_packed, arm_space

I32 = torch.int32


class Odometer(NamedTuple):
    choice: torch.Tensor   # int32 [B, R, HW] digit per cell
    more: torch.Tensor     # bool [B, R]: the counter has not wrapped


class EnumCtx(NamedTuple):
    """Per-(state, player) context of an odometer row."""
    la: torch.Tensor        # int32 [B, R, HW, NW] legal arms, packed
    claimed0: torch.Tensor  # bool [B, R, L] in-flight claim slots (both)
    spent0: torch.Tensor    # int32 [B, R] in-flight produce spend (player)
    balance: torch.Tensor   # int32 [B, R] the player's resources


def pack_arms(la: torch.Tensor) -> torch.Tensor:
    """bool ``[..., A]`` -> int32 ``[..., ceil(A / 32)]`` (arm ``a`` is
    bit ``a % 32`` of word ``a // 32``)."""
    A = la.shape[-1]
    nw = (A + 31) // 32
    pad = torch.zeros(la.shape[:-1] + (nw * 32 - A,), dtype=torch.bool,
                      device=la.device)
    bits = torch.cat([la, pad], -1).reshape(la.shape[:-1] + (nw, 32))
    w = (bits.to(torch.int64) << torch.arange(32, device=la.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(I32)


def unpack_arms(words: torch.Tensor, A: int) -> torch.Tensor:
    """Inverse of ``pack_arms``: bool ``[..., A]``."""
    shift = torch.arange(32, device=words.device, dtype=I32)
    bits = (words[..., None] >> shift) & 1
    return bits.flatten(-2)[..., :A].bool()


def arm_tables(sp: ArmSpace, cost) -> tuple:
    """Static per-arm (claim direction, produce cost) tables, -1 / 0 =
    none (enumerate.py:64-76): MOVE dir k (arms 1-4) and PRODUCE dir k of
    type t (arm 13 + k*T + t) claim the target of direction k."""
    T, A = sp.num_types, sp.n_arms
    d = np.full(A, -1, np.int32)
    c = np.zeros(A, np.int32)
    for k in range(4):
        d[1 + k] = k
        for t in range(T):
            d[13 + k * T + t] = k
            c[13 + k * T + t] = cost[t]
    return d, c


def claim_slots(sp: ArmSpace, H: int, W: int, cost) -> tuple:
    """(slot int32 ``[HW, A]``: ``W + cell + OFF[dir]`` in the padded flat
    claim space of length ``L = HW + 2W``, L where the arm claims nothing
    or off-range; cost int32 ``[A]``), numpy.  Left and right wrap across
    rows, Java's row-wrap quirk, kept."""
    HW, L = H * W, H * W + 2 * W
    d, c = arm_tables(sp, cost)
    off = np.asarray((-W, 1, W, -1), np.int32)[np.maximum(d, 0)]
    cell = np.arange(HW, dtype=np.int32)[:, None]
    slot = np.where(d[None, :] >= 0, W + cell + off[None, :], L)
    slot = np.where((slot < 0) | (slot >= L), L, slot).astype(np.int32)
    return slot, c


def ctx_of(env, state: State, player, mask: torch.Tensor) -> EnumCtx:
    """The odometer context of ``player`` (an int or int32 ``[B]``) in
    ``state`` (enumerate.py:105-119), ``mask`` the env's packed mask of
    that player (``GridnetEnv.masks``): both players' in-flight claims,
    the player's own in-flight spend and balance.  ``R = 1``."""
    B = state.batch
    sp = arm_space(env)
    la = pack_arms(arm_masks_packed(sp, mask).reshape(B, -1, sp.n_arms))
    pl = torch.as_tensor(player, device=state.device).to(I32).expand(B)
    bal = torch.where(pl == 1, state.resources[:, 1], state.resources[:, 0])
    return EnumCtx(
        la=la[:, None], claimed0=env._inflight_claims(state)[:, None],
        spent0=env._inflight_spent(state, player)[:, None].to(I32),
        balance=bal[:, None].to(I32))


def make_enumerator(env):
    """``(init, next_action)`` for ``env``.

    ``init(state, player) -> (Odometer, EnumCtx)`` with ``R = 1``.

    ``next_action(od, ctx, row=None, active=None) -> (arms int32 [B, H,
    W] (-1 = no unit), valid bool [B], trips int32 [B])`` advances row
    ``row[b]`` (int32 ``[B]``, default 0) of every lane whose ``active``
    (bool ``[B]``, default all) is set, in place on ``od``; ``valid`` is
    False once the product is exhausted (getNextAction -> null) and on
    inactive lanes, whose arms are -1 and odometers untouched; ``trips``
    counts the odometer steps each lane took.  An env built with
    ``plain=True`` sends CUDA tensors to the plain version too."""
    sp = arm_space(env)
    H, W = env.h, env.w
    ecfg = env.cfg.engine
    slot_np, cost_np = claim_slots(sp, H, W, ecfg.cost)
    tables = {}

    def init(state: State, player):
        ctx = ctx_of(env, state, player, env.masks(state, player))
        B = state.batch
        return Odometer(
            choice=torch.zeros((B, 1, H * W), dtype=I32, device=state.device),
            more=torch.ones((B, 1), dtype=torch.bool,
                            device=state.device)), ctx

    def next_action(od: Odometer, ctx: EnumCtx, row=None, active=None):
        B, dev = od.choice.shape[0], od.choice.device
        if row is None:
            row = torch.zeros(B, dtype=I32, device=dev)
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=dev)
        if env.engine._use_kernel(od.choice):
            arms, valid, trips = KN.ENUM_NEXT(ecfg, sp, od, ctx, row,
                                              active)
        else:
            if dev not in tables:
                tables[dev] = (torch.from_numpy(slot_np).to(dev),
                               torch.from_numpy(cost_np).to(dev))
            arms, valid, trips = enum_next_plain(sp, od, ctx, row, active,
                                                 *tables[dev])
        return arms.reshape(B, H, W), valid, trips

    return init, next_action


def enum_next_plain(sp: ArmSpace, od: Odometer, ctx: EnumCtx,
                    row: torch.Tensor, active: torch.Tensor,
                    slot_arm: torch.Tensor, cost_arm: torch.Tensor):
    """The plain version of ``next_action`` (enumerate.py:121-197): the
    while loop runs until no lane is still walking; each trip is JAX's
    body (``_arms_of``, ``_consistency``, ``_increment``) on the walking
    lanes.  Returns (arms int32 [B, HW], valid, trips)."""
    A = sp.n_arms
    B, _, HW = od.choice.shape
    L = ctx.claimed0.shape[-1]
    dev = od.choice.device
    rows = torch.arange(B, device=dev)
    r = row.long()
    choice = od.choice[rows, r]
    more = od.more[rows, r]
    la = unpack_arms(ctx.la[rows, r], A)                   # [B, HW, A]
    acting = la[..., 0]
    size = la.sum(-1, dtype=I32).clamp(min=1)
    base = torch.cat([ctx.claimed0[rows, r],
                      torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    spent0 = ctx.spent0[rows, r][:, None]
    balance = ctx.balance[rows, r][:, None]
    la_rev = la.flip(-1)
    csum = la_rev.cumsum(-1, dtype=I32) - 1
    idx = torch.arange(HW, device=dev, dtype=I32).expand(B, HW)
    arms = torch.full((B, HW), -1, dtype=I32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    trips = torch.zeros(B, dtype=I32, device=dev)
    run = active & more
    while bool(run.any()):
        # _arms_of: the k-th legal arm counted from A-1 down
        kth = (csum == choice[..., None]) & la_rev
        a = (A - 1 - kth.to(torch.uint8).argmax(-1)).to(I32)
        a = torch.where(acting, a, -1)
        # _consistency: a claim shared with a later cell or in flight;
        # the suffix of produce costs over the balance
        ac = a.clamp(min=0).long()
        slot = torch.where(a >= 0, slot_arm[idx.long(), ac], L).long()
        cost = torch.where(a >= 0, cost_arm[ac], 0)
        last = torch.full((B, L + 1), -1, dtype=I32, device=dev)
        last.scatter_reduce_(1, slot, idx, "amax")
        pos_fail = (slot < L) & ((last.gather(1, slot) > idx)
                                 | base.gather(1, slot))
        acc = cost.flip(1).cumsum(1, dtype=I32).flip(1) + spent0
        res_fail = (cost > 0) & (acc > 0) & (acc > balance)
        fail_pos = torch.where(pos_fail | res_fail, idx, -1).amax(1)
        ok = fail_pos < 0
        p = torch.where(ok, 0, fail_pos)
        # _increment(p): bump the first digit >= p under its radix cap,
        # zero every digit below it; none left: all zero, more off
        bump = (idx >= p[:, None]) & (choice < size - 1)
        has = bump.any(1)
        first = torch.where(bump, idx, HW).amin(1)
        lim = torch.where(has, first, HW)[:, None]
        nc = torch.where(idx < lim, 0, torch.where(
            idx == torch.where(has, first, -1)[:, None], choice + 1, choice))
        choice = torch.where(run[:, None], nc, choice)
        more = torch.where(run, more & has, more)
        arms = torch.where(run[:, None], a, arms)
        found = torch.where(run, ok, found)
        trips += run.to(I32)
        run = run & more & ~found
    od.choice[rows, r] = torch.where(active[:, None], choice,
                                     od.choice[rows, r])
    od.more[rows, r] = torch.where(active, more, od.more[rows, r])
    return torch.where(found[:, None], arms, -1), found, trips


def enumerate_joint_actions(env, state: State, player, max_actions: int):
    """The first ``max_actions`` consistent joint actions of every lane in
    odometer order (enumerate.py:202-216): (arms int32 ``[B, K, H, W]``,
    valid bool ``[B, K]``)."""
    init, next_action = make_enumerator(env)
    od, ctx = init(state, player)
    arms, valid = [], []
    for _ in range(max_actions):
        a, v, _ = next_action(od, ctx)
        arms.append(a)
        valid.append(v)
    return torch.stack(arms, 1), torch.stack(valid, 1)
