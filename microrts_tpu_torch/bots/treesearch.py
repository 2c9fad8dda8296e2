"""Game-tree search with real trees: NaiveMCTS and UCT, arrays of nodes.

A port of ``microrts_tpu.bots.treesearch`` (see its docstring for the
Java sources and the semantics matched).  The tree of every game is a
fixed-budget structure of arrays with the games as the leading axis:
node ``i`` of game ``b`` keeps its ``State`` in row ``b * (N + 1) + i``
of a stacked ``State`` (``[B * (N + 1), H, W]`` planes), its scalars in
``[B, N + 1]`` tensors and its per-unit statistics in dense ``[B, N + 1,
H, W, A]`` tables over the arm catalog (``ops.arms``).  Row ``N`` is the
write scratch: a step that expands nothing writes there, as JAX's does.

One search iteration is a fixed-trip descent of ``max_depth + 2`` steps
for every game at once, a playout from the leaf and the propagation of
its value.  Each descent step runs, for every game, the env's mask for
the player to move (``actor``), the local bandits (``arm_sample``, K12b),
the decode and issue of the sampled joint action and the fast-forward to
the next decision point (``event_jump`` + ``cycle``), then one
``mcts_descend`` (K12c) that does the tree's bookkeeping in place: the
global bandit, the child lookup by exact arm-plane compare, the
expansion and the path, and copies the next node's state into a
per-game scratch ``State``.  ``mcts_backprop`` (K12d) credits the value
along the path.  CPU tensors (or an env built with ``plain=True``) take
the plain versions beside each kernel.

Randomness enters as tensors, one per use in JAX's key tree, drawn on
demand (``MCTSNoise``, ``UCTTreeNoise``): a decision's Gumbel noise at
the JAX defaults would be gigabytes.  Under UTT v3's random damage the
noise also draws each cycle's uniforms (``u01``): four a descent step's
advance and the playout's; JAX draws them from the states' keys.

``search`` takes a per-game iteration count (int32 ``[B]``): a game past
its count is not in the walk's ``live`` lanes, and the descent, the
propagation and the playout leave its tree as it is.
``naive_mcts_continuing`` (ContinuingNaiveMCTS) keeps each game's tree
across decisions and re-roots it in place at the node that matches the
real state (``mcts_reroot``, K12g).

``prior_fn`` makes it InformedNaiveMCTS (``informed_naive_mcts_bot``): a
descent step also runs the learned model's prior (``aim_predict``, K14a)
at the node, and the local bandits draw in ``arm_sample``'s informed
mode; the playouts run the model too, their Gumbel noise drawn through
the rollout ``Opponent``'s ``draw``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import kernels as KN
from ..engine.types import FIELD_DTYPES, State
from ..env.gridnet import GridnetEnv
from ..models.gridnet_policy import gumbel_noise
from ..ops import arms as AR
from ..ops.arms import (ArmSpace, arm_sample, arm_space, arms_to_action,
                        one_hot_arms)
from ..ops.playout import can_act, fast_forward, make_playout
from .believestate import StatefulBot
from .scripted import Opponent
from .search import _default_eval

I32 = torch.int32
F32 = torch.float32


def stacked_rows(states: State, n1: int, idx: torch.Tensor) -> State:
    """Row ``idx[b]`` (int32 ``[B]``) of every game ``b`` of a stacked
    ``State`` with ``n1`` rows a game (row ``b * n1 + i``): a ``State``
    ``[B]``."""
    r = (torch.arange(idx.shape[0], device=idx.device) * n1 + idx).long()
    return State(**{f: getattr(states, f).index_select(0, r)
                    for f in FIELD_DTYPES})


def node_states(tree, idx: torch.Tensor) -> State:
    """The states of node ``idx[b]`` (int32 ``[B]``) of every game ``b``:
    a ``State`` ``[B]``."""
    return stacked_rows(tree.states, tree.nplayer.shape[1], idx)


def _issue_player(env: GridnetEnv, s: State, action, player) -> State:
    """Issue one player's gridnet action (``player`` an int or int32
    ``[B]``): decode against the in-flight claims, then ``issue_env``.
    On decode-vetted candidates ``issue_env`` is the full ``issue``
    (engine/kernel.py:456-476 of the JAX package), which JAX's tree search
    calls here: tests/test_torch_issue.py
    ``test_issue_env_is_issue_on_decode_vetted_full_obs`` holds the two
    equal on the plain path and ``chip_smoke.py`` [4] the two kernels on
    the card."""
    return env.engine.issue_env(s, env.decode(s, action, player))


ADVANCE_EVENTS = 4


def _advance(env: GridnetEnv, s: State, max_wait: int = 512,
             u01: Optional[torch.Tensor] = None):
    """Advance to the next decision point or game end (NaiveMCTSNode.java
    :46-52) with four event steps (``u01``: their damage uniforms float32
    ``[4, B, H, W]``); a state still frozen after them is terminal.
    Returns (state, done bool ``[B]``)."""
    s, done = fast_forward(env, s, env.engine.gameover(s),
                           max_skip=max_wait, max_events=ADVANCE_EVENTS,
                           u01=u01)
    stuck = ~(can_act(s, 0) | can_act(s, 1))
    return s, done | (stuck & ~done)


def _f32(v) -> float:
    return float(np.float32(v))


# ======================================================================
# noise

class TreeStep(NamedTuple):
    """One NaiveMCTS descent step's draws for ``B`` games (JAX: ``k, k0,
    k1, k2, k3 = split(k, 5)``): the ``eps_g`` coin float32 ``[B]``
    (k0), the global bandit's random slot ``randint(k1, (), 0, m)`` for
    every ``m`` in 1..C, int32 ``[B, C]`` (read at ``max(nch, 1)``), the
    ``eps0`` coin ``[B]`` (k2) and the local bandits' Gumbels float32
    ``[B, H, W, A]`` (k3)."""
    coin_g: torch.Tensor
    pick_g: torch.Tensor
    coin0: torch.Tensor
    gumbel: torch.Tensor


class MCTSNoise:
    """NaiveMCTS's draws for one decision of ``B`` games, made on demand
    from ``gen``: ``step(it, d)`` (a ``TreeStep``) for descent step ``d``
    of iteration ``it``, then ``play(it)``, the playout's draws for ``B *
    n_eval`` lanes (JAX: ``kp``) by ``play_draw(gen, lanes)`` (the
    playout's ``draw``: RandomBiasedAI's uniforms float32
    ``[n_decisions, 2, lanes, H, W, 2]`` for the default rollout).  Under
    random damage,
    ``u01(cycles, lanes)``: the damage uniforms of the next ``cycles``
    cycles.  Calls must come in the search's order."""

    def __init__(self, env: GridnetEnv, gen: torch.Generator, batch: int,
                 n_children: int, play_draw: Callable, n_eval: int = 1):
        self.env, self.gen, self.batch = env, gen, batch
        self.C, self.n_eval = n_children, n_eval
        self.play_draw = play_draw
        self.sp = arm_space(env)

    def _u(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.env.device)

    def u01(self, cycles: int, lanes: int) -> torch.Tensor:
        return self.env.draw_u01(self.gen, cycles, lanes)

    def step(self, it: int, d: int) -> TreeStep:
        B, C, env = self.batch, self.C, self.env
        m = torch.arange(1, C + 1, device=env.device, dtype=F32)
        pick = torch.minimum((self._u(B, C) * m).to(I32),
                             (m - 1).to(I32))
        return TreeStep(self._u(B), pick, self._u(B), gumbel_noise(
            (B, env.h, env.w, self.sp.n_arms), self.gen, env.device))

    def play(self, it: int):
        return self.play_draw(self.gen, self.batch * self.n_eval)


class UCTTreeNoise:
    """``uct_tree_bot``'s draws for one decision of ``B`` games, made on
    demand from ``gen``: ``root()``, the root's K candidate draws float32
    Gumbels ``[B, K, H, W, A]`` (JAX: ``split(kc, K)``); ``step(it, d)``,
    the K candidate draws of the node a descent step may expand (JAX:
    ``split(kc2, K)``); ``play(it)`` and ``u01`` as ``MCTSNoise``'s."""

    def __init__(self, env: GridnetEnv, gen: torch.Generator, batch: int,
                 n_candidates: int, play_draw: Callable, n_eval: int = 1):
        self.env, self.gen, self.batch = env, gen, batch
        self.K, self.n_eval = n_candidates, n_eval
        self.play_draw = play_draw
        self.sp = arm_space(env)

    def root(self) -> torch.Tensor:
        env = self.env
        return gumbel_noise((self.batch, self.K, env.h, env.w,
                             self.sp.n_arms), self.gen, env.device)

    def step(self, it: int, d: int) -> torch.Tensor:
        return self.root()

    play = MCTSNoise.play
    u01 = MCTSNoise.u01


def _cycle_u01(env: GridnetEnv, noise, cycles: int, lanes: int):
    """``noise.u01(cycles, lanes)`` under random damage, else None (and
    nothing asked of ``noise``)."""
    return noise.u01(cycles, lanes) if env.random_damage else None


# ======================================================================
# the trees and one iteration's walk

@dataclasses.dataclass
class NaiveTree:
    """NaiveMCTS's trees of ``B`` games (``N`` nodes + the scratch row,
    ``C`` children a node)."""
    states: State            # [B * (N+1), ...] rows b * (N+1) + i
    nplayer: torch.Tensor    # i32 [B, N+1] player to move
    nterm: torch.Tensor      # bool [B, N+1]
    ndepth: torch.Tensor     # i32 [B, N+1]
    nacc: torch.Tensor       # f32 [B, N+1]
    nvis: torch.Tensor       # i32 [B, N+1]
    tacc: torch.Tensor       # f32 [B, N+1, H, W, A] per-unit arm values
    tvis: torch.Tensor       # i32 [B, N+1, H, W, A] per-unit arm visits
    children: torch.Tensor   # i32 [B, N+1, C]
    carms: torch.Tensor      # i8 [B, N+1, C, H, W] edge arm plane a child
    nchild: torch.Tensor     # i32 [B, N+1]
    nnodes: torch.Tensor     # i32 [B]

    FIELDS = ("nplayer", "nterm", "ndepth", "nacc", "nvis", "tacc", "tvis",
              "children", "carms", "nchild", "nnodes")


@dataclasses.dataclass
class UCTTree:
    """``uct_tree_bot``'s trees of ``B`` games (``K`` candidate joint
    actions a node)."""
    states: State            # [B * (N+1), ...]
    nplayer: torch.Tensor    # i32 [B, N+1]
    nterm: torch.Tensor      # bool [B, N+1]
    ndepth: torch.Tensor     # i32 [B, N+1]
    nvis: torch.Tensor       # i32 [B, N+1]
    acand: torch.Tensor      # i8 [B, N+1, K, H, W] candidate arm planes
    avis: torch.Tensor       # i32 [B, N+1, K]
    aacc: torch.Tensor       # f32 [B, N+1, K]
    achild: torch.Tensor     # i32 [B, N+1, K] child per candidate (-1)
    nnodes: torch.Tensor     # i32 [B]

    FIELDS = ("nplayer", "nterm", "ndepth", "nvis", "acand", "avis", "aacc",
              "achild", "nnodes")


@dataclasses.dataclass
class Walk:
    """One iteration's descent of every game: the node reached (``cur``),
    whether the leaf is found, the leaf, the path of nodes (``path`` i32
    ``[B, D+2]``, index ``D+1`` the scratch slot), the edge taken at each
    (NaiveMCTS: its arm plane, ``edge`` i8 ``[B, D+2, H, W]``; UCT: the
    candidate slot, i32 ``[B, D+2]``), the path's length, the player to
    move at ``cur``, and the states of ``cur`` and of the leaf (written
    by the descent).  ``live`` (bool ``[B]``, or None for every game) are
    the games this iteration runs: the others' trees and walks stay as
    they are."""
    cur: torch.Tensor
    found: torch.Tensor
    leaf: torch.Tensor
    path: torch.Tensor
    edge: torch.Tensor
    plen: torch.Tensor
    player: torch.Tensor
    st: State
    leaf_st: State
    live: Optional[torch.Tensor] = None


def _stack(state: State, n1: int) -> State:
    return State(**{f: getattr(state, f).repeat_interleave(n1, 0)
                    for f in FIELD_DTYPES})


def _walk(tree, root: State, D: int, edge: torch.Tensor,
          live: Optional[torch.Tensor] = None) -> Walk:
    B, dev = root.batch, root.device
    z = torch.zeros(B, dtype=I32, device=dev)
    return Walk(cur=z.clone(), found=torch.zeros(B, dtype=torch.bool,
                                                 device=dev),
                leaf=z.clone(),
                path=torch.full((B, D + 2), -1, dtype=I32, device=dev),
                edge=edge, plen=z.clone(), player=tree.nplayer[:, 0].clone(),
                st=root.clone(), leaf_st=root.clone(), live=live)


# ======================================================================
# K12c: one descent step; K12d: the propagation

def mcts_descend(env: GridnetEnv, tree: NaiveTree, w: Walk,
                 arms: torch.Tensor, st2: State, done2: torch.Tensor,
                 can_max: torch.Tensor, can_min: torch.Tensor,
                 sn: TreeStep, maxp: int, eps0: float, eps_g: float,
                 D: int) -> None:
    """One NaiveMCTS descent step (treesearch.py:300-381) of every game,
    in place on ``tree`` and ``w``: ``arms`` (int32 ``[B, H, W]``) is the
    local bandits' joint action at ``w.cur`` and ``st2``/``done2`` the
    state it leads to (the expansion candidate), ``can_max``/``can_min``
    whether either player can act there."""
    if env.engine._use_kernel(arms):
        KN.MCTS_DESCEND.naive(env.cfg.engine, tree, w, arms, st2, done2,
                              can_max, can_min, sn, maxp, _f32(eps0),
                              _f32(eps_g), D)
    else:
        mcts_descend_plain(tree, w, arms, st2, done2, can_max, can_min, sn,
                           maxp, eps0, eps_g, D)


def _lanes(w: Walk, rows: torch.Tensor) -> torch.Tensor:
    """The games whose tree a step may write (``w.live``'s)."""
    return rows if w.live is None else rows[w.live]


def _write_node(tree, sel, widx, cur, st2, can_max, can_min, done2, maxp):
    """The expansion's node writes of games ``sel`` (row ``widx``: N where
    nothing expands)."""
    n1 = tree.nplayer.shape[1]
    widx, cur = widx[sel], cur[sel]
    can_max, can_min, done2 = can_max[sel], can_min[sel], done2[sel]
    flat = (sel * n1 + widx).long()
    for f in FIELD_DTYPES:
        getattr(tree.states, f)[flat] = getattr(st2, f)[sel]
    depth = tree.ndepth[sel, cur] + 1
    tree.nplayer[sel, widx] = torch.where(can_max, maxp, 1 - maxp).to(I32)
    tree.nterm[sel, widx] = done2 | (~can_max & ~can_min)
    tree.ndepth[sel, widx] = depth


def _move_on(tree, w: Walk, rows, leaf_now, do_exp, leaf, cur) -> None:
    """The walk's next node, its player and the scratch states."""
    if w.live is not None:
        leaf_now = leaf_now & w.live
        leaf = torch.where(w.live, leaf, w.leaf)
        cur = torch.where(w.live, cur, w.cur)
    w.leaf_st = w.leaf_st.select(leaf_now & ~do_exp, w.st)
    w.cur = cur
    w.leaf = leaf
    w.found = w.found | leaf_now
    w.st = node_states(tree, cur)
    w.leaf_st = w.leaf_st.select(leaf_now & do_exp, node_states(tree, leaf))
    w.player = tree.nplayer[rows, cur]


def mcts_descend_plain(tree: NaiveTree, w: Walk, arms, st2, done2, can_max,
                       can_min, sn: TreeStep, maxp, eps0, eps_g, D) -> None:
    B, n1, C = tree.children.shape
    N = n1 - 1
    dev = arms.device
    rows = torch.arange(B, device=dev)
    cur, found = w.cur, w.found
    p = tree.nplayer[rows, cur]
    term = tree.nterm[rows, cur] | (tree.ndepth[rows, cur] >= D)
    nch = tree.nchild[rows, cur]

    # global MAB (selectFromAlreadySampledEpsilonGreedy)
    crow = tree.children[rows, cur]
    cvis = tree.nvis.gather(1, crow.clamp(min=0).long())
    cacc = tree.nacc.gather(1, crow.clamp(min=0).long())
    mean = cacc / cvis.clamp(min=1).to(F32)
    sgn = torch.where(p == maxp, 1.0, -1.0).to(F32)[:, None]
    slots = torch.arange(C, device=dev)
    score = torch.where(slots < nch[:, None], sgn * mean,
                        torch.tensor(float("-inf"), device=dev))
    rnd = sn.pick_g.gather(1, (nch.clamp(min=1) - 1).long()[:, None])[:, 0]
    gslot = torch.where(sn.coin_g < _f32(eps_g), rnd,
                        AR.first_max(score).to(I32)).long()
    gchild = crow[rows, gslot]
    crm = tree.carms[rows, cur]
    garms = crm[rows, gslot]
    use_global = (nch > 0) & (sn.coin0 >= _f32(eps0)) & ~term & ~found

    # child lookup by exact arm-plane compare (childrenMap)
    arms8 = arms.to(torch.int8)
    matches = (slots < nch[:, None]) & (crm == arms8[:, None]).flatten(
        2).all(2)
    matched = matches.any(1)
    mchild = crow[rows, matches.to(torch.uint8).argmax(1)]

    # expansion
    need_exp = ~found & ~term & ~use_global & ~matched
    room = (tree.nnodes < N) & (nch < C)
    do_exp = need_exp & room
    new_id = tree.nnodes.clone()
    widx = torch.where(do_exp, new_id, N)
    wcur = torch.where(do_exp, cur, N)
    slotc = nch.clamp(0, C - 1)
    sel = _lanes(w, rows)
    _write_node(tree, sel, widx, cur, st2, can_max, can_min, done2, maxp)
    tree.children[sel, wcur[sel], slotc[sel]] = new_id[sel]
    tree.carms[sel, wcur[sel], slotc[sel]] = arms8[sel]
    tree.nchild[sel, wcur[sel]] += 1
    tree.nnodes[sel] += do_exp[sel].to(I32)

    # bookkeeping: a path entry on every hop through an edge
    move_g = use_global
    move_m = ~found & ~term & ~use_global & matched
    hop = move_g | move_m | do_exp
    pidx = torch.where(hop, w.plen, D + 1)
    w.path[sel, pidx[sel]] = torch.where(hop, cur, -1)[sel]
    w.edge[sel, pidx[sel]] = torch.where(move_g[:, None, None], garms,
                                         arms8)[sel]
    w.plen[sel] += hop[sel].to(I32)
    stop = term | (need_exp & ~room)
    leaf_now = ~found & (stop | do_exp)
    leaf = torch.where(found, w.leaf, torch.where(
        do_exp, new_id, torch.where(stop, cur, w.leaf)))
    nxt = torch.where(move_g, gchild, torch.where(move_m, mchild, cur))
    nxt = torch.where(do_exp, new_id, nxt)
    _move_on(tree, w, rows, leaf_now, do_exp, leaf,
             torch.where(found, cur, nxt))


def uct_select(env: GridnetEnv, tree: UCTTree, w: Walk, maxp: int,
               c_uct: float, fpu: Optional[float]):
    """UCT's choice at ``w.cur`` (treesearch.py:680-700): unexplored
    candidates first (or the first-play urgency ``fpu``), else UCB1.
    Returns (slot int32 ``[B]``, the candidate's gridnet action int32
    ``[B, H, W, 7]``)."""
    if env.engine._use_kernel(tree.avis):
        return KN.MCTS_DESCEND.uct_select(arm_space(env), tree, w, maxp,
                                          _f32(c_uct), fpu)
    return uct_select_plain(arm_space(env), tree, w, maxp, c_uct, fpu)


def uct_select_plain(sp: ArmSpace, tree: UCTTree, w: Walk, maxp, c_uct,
                     fpu):
    B = tree.avis.shape[0]
    rows = torch.arange(B, device=tree.avis.device)
    cur = w.cur
    p = tree.nplayer[rows, cur]
    av = tree.avis[rows, cur]
    aa = tree.aacc[rows, cur]
    unex = av == 0
    avf = av.clamp(min=1).to(F32)
    mean = aa / avf
    mean = torch.where((p == maxp)[:, None], mean, -mean)
    one = torch.tensor(1.0, dtype=F32, device=av.device)
    lnv = torch.log(tree.nvis[rows, cur].clamp(min=1).to(F32) + one)
    expl = ((mean + one) * torch.tensor(0.5, device=av.device)
            + torch.tensor(_f32(c_uct), device=av.device)
            * torch.sqrt(lnv[:, None] / avf))
    if fpu is None:
        slot = torch.where(unex.any(1), unex.to(torch.uint8).argmax(1),
                           AR.first_max(expl))
    else:
        slot = AR.first_max(torch.where(
            unex, torch.tensor(_f32(fpu), device=av.device), expl))
    arms = tree.acand[rows, cur, slot].to(I32)
    return slot.to(I32), arms_to_action(sp, arms, plain=True)


def uct_descend(env: GridnetEnv, tree: UCTTree, w: Walk, slot, st2, done2,
                can_max, can_min, cands, maxp: int, D: int) -> None:
    """One UCT descent step (treesearch.py:702-741) of every game, in
    place: ``slot`` is ``uct_select``'s choice at ``w.cur``, ``st2`` the
    state its candidate leads to and ``cands`` (int32 ``[B, K, H, W]``)
    that state's candidate moves, stored where it expands."""
    if env.engine._use_kernel(slot):
        KN.MCTS_DESCEND.uct(env.cfg.engine, tree, w, slot, st2, done2,
                            can_max, can_min, cands, maxp, D)
    else:
        uct_descend_plain(tree, w, slot, st2, done2, can_max, can_min,
                          cands, maxp, D)


def uct_descend_plain(tree: UCTTree, w: Walk, slot, st2, done2, can_max,
                      can_min, cands, maxp, D) -> None:
    B, n1, K = tree.achild.shape
    N = n1 - 1
    rows = torch.arange(B, device=slot.device)
    cur, found = w.cur, w.found
    slot = slot.long()
    term = tree.nterm[rows, cur] | (tree.ndepth[rows, cur] >= D)
    child = tree.achild[rows, cur, slot]
    need_exp = ~found & ~term & (child < 0)
    room = tree.nnodes < N
    do_exp = need_exp & room
    new_id = tree.nnodes.clone()
    widx = torch.where(do_exp, new_id, N)
    wcur = torch.where(do_exp, cur, N)
    _write_node(tree, rows, widx, cur, st2, can_max, can_min, done2, maxp)
    tree.acand[rows, widx] = cands.to(torch.int8)
    tree.achild[rows, wcur, slot] = new_id
    tree.nnodes += do_exp.to(I32)

    hop = ~found & ~term & ((child >= 0) | do_exp)
    pidx = torch.where(hop, w.plen, D + 1)
    w.path[rows, pidx] = torch.where(hop, cur, -1)
    w.edge[rows, pidx] = slot.to(I32)
    w.plen = w.plen + hop.to(I32)
    leaf_now = ~found & (term | do_exp | (need_exp & ~room))
    leaf = torch.where(found, w.leaf, torch.where(
        do_exp, new_id, torch.where(leaf_now, cur, w.leaf)))
    nxt = torch.where(do_exp, new_id, torch.where(child >= 0, child, cur))
    _move_on(tree, w, rows, leaf_now, do_exp, leaf,
             torch.where(found | leaf_now, cur, nxt))


def mcts_backprop(env: GridnetEnv, tree, w: Walk, v: torch.Tensor) -> None:
    """Credit the playout value ``v`` (float32 ``[B]``) to the leaf and
    along the path, in place (NaiveMCTS treesearch.py:390-408: node and
    per-(cell, edge arm) statistics; UCT :748-760: node visits and the
    chosen candidate's).  Path slots past ``plen`` credit the scratch
    row, as JAX's do."""
    if env.engine._use_kernel(v):
        KN.MCTS_BACKPROP(tree, w, v)
    else:
        mcts_backprop_plain(arm_space(env), tree, w, v)


def mcts_backprop_plain(sp: ArmSpace, tree, w: Walk, v) -> None:
    B, n1 = tree.nplayer.shape
    N = n1 - 1
    rows = _lanes(w, torch.arange(B, device=v.device))
    v, leaf, plen = v[rows], w.leaf[rows], w.plen[rows]
    naive = isinstance(tree, NaiveTree)
    if naive:
        tree.nacc[rows, leaf] += v
    tree.nvis[rows, leaf] += 1
    for i in range(w.path.shape[1]):
        idx = torch.where(i < plen, w.path[rows, i], N)
        tree.nvis[rows, idx] += 1
        if naive:
            tree.nacc[rows, idx] += v
            oh = one_hot_arms(sp, w.edge[rows, i].to(I32))
            tree.tacc[rows, idx] += torch.where(
                oh, v[:, None, None, None], torch.zeros((), device=v.device))
            tree.tvis[rows, idx] += oh.to(I32)
        else:
            s = w.edge[rows, i].long()
            tree.avis[rows, idx, s] += 1
            tree.aacc[rows, idx, s] += v


# ======================================================================
# NaiveMCTS

def naive_mcts_bot(env: GridnetEnv, n_playouts: int = 64,
                   max_nodes: int = 96, max_children: int = 16,
                   max_depth: int = 10, playout_len: int = 100,
                   eps0: float = 0.4, eps_l: float = 0.3,
                   eps_g: float = 0.0, gamma: float = 0.99,
                   eval_fn: Optional[Callable] = None,
                   prior_fn: Optional[Callable] = None,
                   local_policy: str = "egreedy", ucb_c: float = 0.05,
                   rollout_bot: Optional[Callable] = None,
                   phase2: Optional[tuple] = None,
                   phase1_ratio: float = 0.5, n_eval: int = 1,
                   n_decisions: Optional[int] = None) -> Opponent:
    """NaiveMCTS (ai/mcts/naivemcts/NaiveMCTS.java) with per-unit CMAB
    tables and bounded trees, JAX's defaults (treesearch.py:137-168):
    ``n_playouts`` iterations a decision, ``local_policy`` "egreedy"
    (NaiveMCTS), "ucb" (MLPSMCTS) or "unit_uct" (UCTUnitActions),
    ``phase2`` the TwoPhase epsilons after ``phase1_ratio`` of the
    budget.  ``prior_fn(state, player, mask) -> float32 [B, H, W, A]``
    (``ml.pretrained.make_prior_fn``) makes the egreedy rule
    InformedNaiveMCTS's (treesearch.py:259-271); ``rollout_bot`` a
    function ``bot(state, player, noise)`` or an ``Opponent``, whose
    ``draw`` then makes the playouts' noise.  The returned ``Opponent``'s
    bot exposes ``init_tree``, ``search``, ``best_action`` and
    ``dims``."""
    if local_policy not in ("egreedy", "ucb", "unit_uct"):
        raise ValueError(f"unknown local_policy {local_policy!r}")
    H, W = env.h, env.w
    sp = arm_space(env)
    A = sp.n_arms
    N, C, D = max_nodes, max_children, max_depth
    # the prior applies to the egreedy rule only, as in the JAX package
    mode = ("informed" if prior_fn is not None and local_policy == "egreedy"
            else local_policy)
    playout = make_playout(env, playout_len, _default_eval(env, eval_fn),
                           gamma=gamma, rollout_bot=rollout_bot,
                           n_eval=n_eval, n_decisions=n_decisions)

    def init_tree(state: State, player: int) -> NaiveTree:
        B, dev = state.batch, state.device
        nplayer = torch.zeros((B, N + 1), dtype=I32, device=dev)
        nplayer[:, 0] = int(player)
        nterm = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
        nterm[:, 0] = env.engine.gameover(state)
        return NaiveTree(
            states=_stack(state, N + 1), nplayer=nplayer, nterm=nterm,
            ndepth=torch.zeros((B, N + 1), dtype=I32, device=dev),
            nacc=torch.zeros((B, N + 1), dtype=F32, device=dev),
            nvis=torch.zeros((B, N + 1), dtype=I32, device=dev),
            tacc=torch.zeros((B, N + 1, H, W, A), dtype=F32, device=dev),
            tvis=torch.zeros((B, N + 1, H, W, A), dtype=I32, device=dev),
            children=torch.full((B, N + 1, C), -1, dtype=I32, device=dev),
            carms=torch.full((B, N + 1, C, H, W), -1, dtype=torch.int8,
                             device=dev),
            nchild=torch.zeros((B, N + 1), dtype=I32, device=dev),
            nnodes=torch.ones(B, dtype=I32, device=dev))

    def epsilons(it: int):
        """(eps0, eps_l, eps_g, the greedy arm's weight 1 - eps_l) of
        iteration ``it``, rounded as JAX rounds them: a Python float's
        ``1 - eps_l`` in double, TwoPhase's in float32."""
        if phase2 is None:
            return eps0, eps_l, eps_g, _f32(1.0 - eps_l)
        e = (eps0, eps_l, eps_g) if it < int(n_playouts * phase1_ratio) \
            else phase2
        return e[0], e[1], e[2], float(np.float32(1.0)
                                       - np.float32(e[1]))

    def search(tree: NaiveTree, maxp: int, t0, noise: MCTSNoise,
               n_iters=None) -> NaiveTree:
        """Select/playout/propagate iterations on ``tree`` in place:
        ``n_iters`` of them (default ``n_playouts``), or ``n_iters[b]`` in
        game ``b`` (int32 ``[B]``)."""
        maxp = int(maxp)
        root = node_states(tree, torch.zeros_like(tree.nnodes))
        B = root.batch
        lanes = n_iters if isinstance(n_iters, torch.Tensor) else None
        n = (n_playouts if n_iters is None
             else int(lanes.max()) if lanes is not None else n_iters)
        for it in range(n):
            e0, el, eg, gw = epsilons(it)
            live = None if lanes is None else it < lanes
            w = _walk(tree, root, D, torch.full(
                (B, D + 2, H, W), -1, dtype=torch.int8, device=root.device),
                live)
            for d in range(D + 2):
                sn = noise.step(it, d)
                mask = env.masks(w.st, w.player)
                pri = (prior_fn(w.st, w.player, mask) if mode == "informed"
                       else None)
                arms, action = arm_sample(
                    sp, mask, sn.gumbel, mode,
                    (tree.tvis, tree.tacc, tree.nvis), w.cur, w.player,
                    maxp, el, gw, ucb_c, pri, plain=env.engine.plain)
                st1 = _issue_player(env, w.st, action, w.player)
                st2, done2 = _advance(env, st1, u01=_cycle_u01(
                    env, noise, ADVANCE_EVENTS, B))
                mcts_descend(env, tree, w, arms, st2, done2,
                             can_act(st2, maxp), can_act(st2, 1 - maxp), sn,
                             maxp, e0, eg, D)
            v = playout(w.leaf_st, maxp, t0, noise.play(it), live,
                        _cycle_u01(env, noise, playout.n_cycles, B * n_eval))
            mcts_backprop(env, tree, w, v)
        return tree

    def best_action(tree: NaiveTree) -> torch.Tensor:
        """Most-visited root child (getMostVisitedActionIdx)."""
        B = tree.nnodes.shape[0]
        rows = torch.arange(B, device=tree.nnodes.device)
        crow = tree.children[:, 0]
        vis = torch.where(
            torch.arange(C, device=crow.device) < tree.nchild[:, :1],
            tree.nvis.gather(1, crow.clamp(min=0).long()), -1)
        best = tree.carms[rows, 0, vis.argmax(1)].to(I32)
        act = arms_to_action(sp, best, plain=env.engine.plain)
        return torch.where((tree.nchild[:, 0] > 0)[:, None, None, None],
                           act, 0)

    def draw(gen: torch.Generator, batch: int) -> MCTSNoise:
        return MCTSNoise(env, gen, batch, C, playout.draw, n_eval)

    def bot(state: State, player: int, noise: MCTSNoise) -> torch.Tensor:
        tree = init_tree(state, player)
        search(tree, player, state.time, noise)
        return best_action(tree)

    bot.init_tree = init_tree
    bot.search = search
    bot.best_action = best_action
    bot.dims = (N, C, D)
    bot.n_playouts = n_playouts
    return Opponent(bot, draw)


def informed_naive_mcts_bot(env: GridnetEnv, model, **kw) -> Opponent:
    """InformedNaiveMCTS (ai/mcts/informedmcts/InformedNaiveMCTS.java,
    treesearch.py:777-794): NaiveMCTS whose per-unit exploration follows
    a learned unit-action distribution (``make_prior_fn``), and whose
    playouts play the same model (``pretrained_bayes_bot``,
    InformedNaiveMCTS.java:72-84) unless ``kw`` names a ``rollout_bot``
    (None: RandomBiasedAI, as JAX's ``model_playouts=False``).
    ``model``: a pretrained XML path or an ``ml.pretrained.PretrainedBayes``;
    defaults eps0 0.4, eps_l 0.3."""
    from ..ml.pretrained import (PretrainedBayes, load_pretrained,
                                 make_prior_fn, pretrained_bayes_bot)
    if not isinstance(model, PretrainedBayes):
        model = load_pretrained(model, env)
    kw.setdefault("eps0", 0.4)
    kw.setdefault("eps_l", 0.3)
    if "rollout_bot" not in kw:
        kw["rollout_bot"] = pretrained_bayes_bot(env, model)
    return naive_mcts_bot(env, prior_fn=make_prior_fn(env, model), **kw)


# ======================================================================
# tree reuse across moves (ContinuingAI / InterruptibleAI analog)

# the fields that must match for a node's state to BE the real state
# (treesearch.py:444): the port's states carry no key, and uid, the issue
# order and the id counters are left out as in the JAX package
MATCH_FIELDS = ("utype", "owner", "hp", "carried", "busy", "atype",
                "aparam", "atx", "aty", "aptype", "aticks", "time",
                "resources")


def node_matches(states: State, n1: int, s: State) -> torch.Tensor:
    """bool ``[B, n1]``: which node states of each game's stack (``n1``
    rows a game) equal ``s`` in ``MATCH_FIELDS`` (treesearch.py:449)."""
    B = s.batch
    ok = None
    for f in MATCH_FIELDS:
        a = getattr(states, f)
        a = a.reshape((B, n1) + a.shape[1:])
        b = getattr(s, f)[:, None]
        eq = (a == b).reshape(B, n1, -1).all(-1)
        ok = eq if ok is None else ok & eq
    return ok


def mcts_reroot(env: GridnetEnv, tree: NaiveTree, state: State, maxp: int,
                D: int, live: Optional[torch.Tensor] = None) -> None:
    """Re-root every game's tree in place at the most-visited node whose
    state matches the real ``state`` (``_reroot``, treesearch.py:507-564):
    the node and what it reaches over the children lists in ``D + 2``
    steps are compacted to rows 0.. in index order with their statistics
    (depths less the node's), the other rows become a fresh tree's, row
    0's state is ``state`` and its player the one who can act; a game with
    no match gets a fresh tree.  Games outside ``live`` (bool ``[B]``) are
    left as they are."""
    to_move = torch.where(can_act(state, maxp), maxp, 1 - maxp).to(I32)
    term = env.engine.gameover(state)
    if env.engine._use_kernel(tree.nvis):
        KN.REROOT(env.cfg.engine, tree, state, to_move, term, D, live)
    else:
        mcts_reroot_plain(tree, state, to_move, term, D, live)


def mcts_reroot_plain(tree: NaiveTree, state: State, to_move, term, D,
                      live=None) -> None:
    B, n1, C = tree.children.shape
    N = n1 - 1
    dev = tree.nvis.device
    idx = torch.arange(n1, device=dev)[None]
    valid = idx < tree.nnodes[:, None]
    match = node_matches(tree.states, n1, state) & valid
    score = torch.where(match, tree.nvis + 1, 0)
    m = score.argmax(1)
    found = match.any(1)

    # reachability from m through the children lists, D + 2 steps
    slots_ok = torch.arange(C, device=dev) < tree.nchild[..., None]
    child = torch.where(slots_ok, tree.children, -1)
    cc = child.clamp(0, N).long()
    adj = (torch.nn.functional.one_hot(cc, n1).bool()
           & (child >= 0)[..., None]).any(2)
    reach = idx == m[:, None]
    for _ in range(D + 2):
        reach = reach | (reach[:, :, None] & adj).any(1)
    reach = reach & valid

    # compact: m -> 0, the other reached rows -> 1.. in index order, the
    # rest onto N (whose own row N wins, as the last index)
    r2 = reach & (idx != m[:, None])
    new_idx = torch.where(idx == m[:, None], 0,
                          torch.where(r2, r2.cumsum(1), N))
    flat_cc = cc.flatten(1)
    remap = torch.where(
        (child >= 0) & reach.gather(1, flat_cc).reshape(child.shape),
        new_idx.gather(1, flat_cc).reshape(child.shape), -1)
    base_depth = tree.ndepth.gather(1, m[:, None])
    src = torch.full((B, n1), -1, dtype=torch.long, device=dev)
    src.scatter_(1, torch.where(reach, new_idx, N).long(),
                 torch.where(reach, idx, -1).expand(B, n1).long())
    src[:, N] = N
    take = src >= 0
    srcc = src.clamp(min=0)
    apply = found if live is None else found & live
    fresh = ~found if live is None else ~found & live

    def put(name, arr, fill, row0=None, rowN=None):
        """tree.<name> := the re-rooted table where found, a fresh one
        where not, in the games re-rooted."""
        old = getattr(tree, name)
        g = arr.gather(1, srcc.reshape((B, n1) + (1,) * (arr.dim() - 2))
                       .expand_as(arr))
        t = (take.reshape((B, n1) + (1,) * (arr.dim() - 2)))
        out = torch.where(t, g, torch.tensor(fill, dtype=old.dtype,
                                             device=dev))
        fr = torch.full_like(old, fill)
        if row0 is not None:
            out[:, 0] = row0
            fr[:, 0] = row0
        if rowN is not None:
            out[:, N] = rowN
        lane = (-1,) + (1,) * (old.dim() - 1)
        old.copy_(torch.where(apply.reshape(lane), out,
                              torch.where(fresh.reshape(lane), fr, old)))

    put("nplayer", tree.nplayer, 0, row0=to_move)
    put("nterm", tree.nterm, False, row0=term)
    put("ndepth", tree.ndepth - base_depth, 0)
    put("nacc", tree.nacc, 0.0)
    put("nvis", tree.nvis, 0)
    put("tacc", tree.tacc, 0.0)
    put("tvis", tree.tvis, 0)
    put("children", remap, -1, rowN=-1)
    put("carms", tree.carms, -1)
    put("nchild", tree.nchild, 0, rowN=0)
    nn = torch.where(apply, reach.sum(1, dtype=I32),
                     torch.where(fresh, 1, tree.nnodes)).to(I32)
    tree.nnodes.copy_(nn)
    # the node states: moved rows, the real state in the fresh rows and
    # in row 0 (row N keeps its own where found)
    rows = torch.arange(B, device=dev)[:, None] * n1
    gsrc = torch.where(take & apply[:, None], srcc, -1)
    gsrc[:, 0] = -1
    gsrc = torch.where(apply[:, None] | fresh[:, None], gsrc, idx)
    for f in FIELD_DTYPES:
        a = getattr(tree.states, f)
        new = torch.where(
            (gsrc >= 0).reshape((-1,) + (1,) * (a.dim() - 1)),
            a[(rows + gsrc.clamp(min=0)).flatten()],
            getattr(state, f).repeat_interleave(n1, 0))
        a.copy_(new)


def naive_mcts_continuing(env: GridnetEnv, per_frame: Optional[int] = None,
                          **kw) -> StatefulBot:
    """NaiveMCTS with tree reuse across consecutive decisions, the
    ContinuingAI / InterruptibleAI contract (treesearch.py:459-599, as a
    ``StatefulBot``): each step re-roots the tree it keeps at the node
    that matches the real state (``mcts_reroot``), searches ``n_playouts``
    more iterations, and plays the most-visited root child, or nothing
    on frames where only the opponent can act (the root then holds the
    opponent's moves, kept for the next re-root).  ``per_frame`` gives the
    anytime budget: ``clip(per_frame * frames elapsed, per_frame, cap)``
    iterations in each game, ``cap`` being ``kw``'s ``n_playouts`` or 100,
    and the memory ``(tree, last decision time)``."""
    base = naive_mcts_bot(env, **kw)
    b = base.bot
    N, C, D = b.dims
    cap = kw.get("n_playouts", 100)

    def fresh(state: State, maxp: int) -> NaiveTree:
        t = b.init_tree(state, maxp)
        t.nplayer[:, 0] = torch.where(can_act(state, maxp), maxp, 1 - maxp)
        return t

    def init(state: State, player):
        t = fresh(state, int(player))
        return t if per_frame is None else (t, state.time.clone())

    def step(state: State, mem, player, noise, live=None):
        maxp = int(player)
        tree = mem if per_frame is None else mem[0]
        mcts_reroot(env, tree, state, maxp, D, live)
        if per_frame is None:
            n = None if live is None else torch.where(live, b.n_playouts, 0)
        else:
            dt = (state.time - mem[1]).clamp(min=1)
            n = (dt * per_frame).clamp(per_frame, cap).to(I32)
            if live is not None:
                n = torch.where(live, n, 0)
        b.search(tree, maxp, state.time, noise,
                 n_iters=None if n is None else n.to(I32))
        act = b.best_action(tree)
        act = torch.where(can_act(state, maxp)[:, None, None, None], act, 0)
        if per_frame is None:
            return act, tree
        t = state.time if live is None else torch.where(live, state.time,
                                                        mem[1])
        return act, (tree, t.clone())

    bot = StatefulBot(init=init, step=step, draw=base.draw)
    bot.base = base
    return bot


def uct_unit_actions_bot(env: GridnetEnv, ucb_c: float = 0.05,
                         **kw) -> Opponent:
    """UCTUnitActions (ai/mcts/uct/UCTUnitActions.java): tree levels
    decide one unit at a time (treesearch.py:797-805)."""
    kw.setdefault("eps0", 1.0)
    kw.setdefault("eps_g", 0.0)
    kw.setdefault("max_depth", 10)
    return naive_mcts_bot(env, local_policy="unit_uct", ucb_c=ucb_c, **kw)


def mlps_mcts_bot(env: GridnetEnv, ucb_c: float = 0.05, **kw) -> Opponent:
    """MLPSMCTS (ai/mcts/mlps/MLPSMCTS.java): the naive tree with the
    per-unit UCB1 local rule and no global-MAB step
    (treesearch.py:808-817)."""
    kw.setdefault("eps0", 1.0)
    kw.setdefault("eps_g", 0.0)
    return naive_mcts_bot(env, local_policy="ucb", ucb_c=ucb_c, **kw)


# ======================================================================
# UCT with tree growth (DownsamplingUCT move sets)

def uct_tree_bot(env: GridnetEnv, n_playouts: int = 64,
                 max_nodes: int = 96, n_candidates: int = 8,
                 max_depth: int = 8, playout_len: int = 100,
                 c_uct: float = 0.7, gamma: float = 0.99,
                 eval_fn: Optional[Callable] = None,
                 fpu: Optional[float] = None, n_eval: int = 1,
                 n_decisions: Optional[int] = None) -> Opponent:
    """UCT over K uniformly sampled candidate joint actions a node with
    real tree growth (ai/mcts/uct/DownsamplingUCT.java, treesearch.py
    :620-771); ``fpu`` gives UCTFirstPlayUrgency."""
    H, W = env.h, env.w
    sp = arm_space(env)
    N, K, D = max_nodes, n_candidates, max_depth
    playout = make_playout(env, playout_len, _default_eval(env, eval_fn),
                           gamma=gamma, n_eval=n_eval,
                           n_decisions=n_decisions)
    plain = env.engine.plain

    def sample_cands(s: State, p, gumbel: torch.Tensor) -> torch.Tensor:
        """K uniform draws over the legal arms: int32 ``[B, K, H, W]``."""
        return arm_sample(sp, env.masks(s, p), gumbel, "uniform",
                          plain=plain)[0]

    def init_tree(state: State, player: int, gumbel) -> UCTTree:
        B, dev = state.batch, state.device
        nplayer = torch.zeros((B, N + 1), dtype=I32, device=dev)
        nplayer[:, 0] = int(player)
        nterm = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
        nterm[:, 0] = env.engine.gameover(state)
        acand = torch.full((B, N + 1, K, H, W), -1, dtype=torch.int8,
                           device=dev)
        acand[:, 0] = sample_cands(state, int(player), gumbel)
        return UCTTree(
            states=_stack(state, N + 1), nplayer=nplayer, nterm=nterm,
            ndepth=torch.zeros((B, N + 1), dtype=I32, device=dev),
            nvis=torch.zeros((B, N + 1), dtype=I32, device=dev),
            acand=acand,
            avis=torch.zeros((B, N + 1, K), dtype=I32, device=dev),
            aacc=torch.zeros((B, N + 1, K), dtype=F32, device=dev),
            achild=torch.full((B, N + 1, K), -1, dtype=I32, device=dev),
            nnodes=torch.ones(B, dtype=I32, device=dev))

    def search(tree: UCTTree, maxp: int, t0, noise: UCTTreeNoise) -> UCTTree:
        root = node_states(tree, torch.zeros_like(tree.nnodes))
        B = root.batch
        for it in range(n_playouts):
            w = _walk(tree, root, D, torch.zeros((B, D + 2), dtype=I32,
                                                 device=root.device))
            for d in range(D + 2):
                slot, action = uct_select(env, tree, w, maxp, c_uct, fpu)
                st1 = _issue_player(env, w.st, action, w.player)
                st2, done2 = _advance(env, st1, u01=_cycle_u01(
                    env, noise, ADVANCE_EVENTS, B))
                can_max, can_min = can_act(st2, maxp), can_act(st2, 1 - maxp)
                cands = sample_cands(
                    st2, torch.where(can_max, maxp, 1 - maxp).to(I32),
                    noise.step(it, d))
                uct_descend(env, tree, w, slot, st2, done2, can_max,
                            can_min, cands, maxp, D)
            v = playout(w.leaf_st, maxp, t0, noise.play(it),
                        u01=_cycle_u01(env, noise, playout.n_cycles,
                                       B * n_eval))
            mcts_backprop(env, tree, w, v)
        return tree

    def best_action(tree: UCTTree) -> torch.Tensor:
        """Most-visited root candidate."""
        av = tree.avis[:, 0]
        rows = torch.arange(av.shape[0], device=av.device)
        best = tree.acand[rows, 0, av.argmax(1)].to(I32)
        act = arms_to_action(sp, best, plain=plain)
        return torch.where((av > 0).any(1)[:, None, None, None], act, 0)

    def draw(gen: torch.Generator, batch: int) -> UCTTreeNoise:
        return UCTTreeNoise(env, gen, batch, K, playout.draw, n_eval)

    def bot(state: State, player: int, noise: UCTTreeNoise) -> torch.Tensor:
        maxp = int(player)
        tree = init_tree(state, maxp, noise.root())
        search(tree, maxp, state.time, noise)
        return best_action(tree)

    bot.init_tree = init_tree
    bot.search = search
    bot.best_action = best_action
    bot.dims = (N, K, D)
    return Opponent(bot, draw)
