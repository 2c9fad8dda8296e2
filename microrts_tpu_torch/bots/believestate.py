"""Believe-state search under partial observability: BS1/BS2/BS3 wrappers
(port of ``microrts_tpu.bots.believestate``; see its docstring for the Java
sources, the believe rules and the documented divergences).

The believe memory of ``B`` games is a ``BelieveMem`` of ``[B, H, W]``
planes (believed enemy unit type, hp and uid), the enemy types ever seen
``[B, T]`` and the observer's previous view and visibility.  A stateful
bot is ``init(state, player) -> mem`` and ``step(state, mem, player,
noise, live=None) -> (action, mem)``; ``draw(gen, B)`` makes the noise
its inner bot reads (the port's bots take their uniforms as inputs).

Each tick's view and visibility are the ``po_state`` kernel's (K11b,
``engine/fog.py``).  The memory rules, the initial memory and the
sampled world's overlay are one launch of the ``believe_update`` kernel
(K13) on CUDA tensors; CPU tensors (or an env built with ``plain=True``)
take ``believe_update_plain``, which follows the JAX package's order
operation by operation.  ``play_matches_stateful`` is the lockstep game
loop of two stateful bots (believestate.py:348-408).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from .. import kernels as KN
from ..engine import fog
from ..engine.kernel import pull, shift
from ..engine.types import ATTACK, MOVE, State
from ..env.gridnet import GridnetEnv
from .scripted import Opponent

I32 = torch.int32
INFERRED_UID = 1 << 20   # the sampled world's uid of an inferred unit
# the rules counted by ``believe_update_plain(..., counts=)``
RULES = ("remembered", "moved_to_fog", "forgotten_by_uid", "inferred",
         "relocated", "dropped", "forgotten")


@dataclasses.dataclass
class BelieveMem:
    """The believe memories of ``B`` games (believestate.py:59)."""
    b_utype: torch.Tensor    # i32 [B, H, W] believed enemy type + 1, 0 none
    b_hp: torch.Tensor       # i32 [B, H, W]
    b_uid: torch.Tensor      # i32 [B, H, W] real uid, 0 for inferred units
    seen_type: torch.Tensor  # bool [B, T] enemy types ever observed
    prev: State              # the observer's previous view
    prev_vis: torch.Tensor   # bool [B, H, W] its previous visibility

    PLANES = ("b_utype", "b_hp", "b_uid", "seen_type", "prev_vis")

    def select(self, mask: torch.Tensor, other: "BelieveMem") -> "BelieveMem":
        """Per game: ``other`` where ``mask[b]`` else ``self``."""
        out = {}
        for f in self.PLANES:
            a = getattr(self, f)
            m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
            out[f] = torch.where(m, getattr(other, f), a)
        return BelieveMem(prev=self.prev.select(mask, other.prev), **out)


@dataclasses.dataclass
class StatefulBot:
    """The stateful-bot protocol (believestate.py:68): memory rides across
    frames explicitly.  ``step(state, mem, player, noise, live=None)``
    returns (gridnet action int32 ``[B, H, W, 7]``, the new memory); with
    ``live`` (bool ``[B]``) the games outside it keep their memory (the
    game loop's finished lanes).  ``draw(gen, B)`` is the noise of one
    step."""
    init: Callable
    step: Callable
    draw: Callable = lambda gen, batch: None


def stateless(opponent: Opponent) -> StatefulBot:
    """An ``Opponent`` as a stateful bot without memory."""
    return StatefulBot(
        init=lambda s, p: None,
        step=lambda s, m, p, noise, live=None: (opponent(s, p, noise), None),
        draw=opponent.draw)


def spiral_offsets(radius: int) -> List[Tuple[int, int]]:
    """Outward counterclockwise spiral, Java's order
    (BS3_NaiveMCTS.getClosestNotObservableLocationNear:374-411): start one
    step down, lengths 1,1,2,2,3,3..., turn dx,dy -> dy,-dx
    (believestate.py:80)."""
    offs, x, y = [], 0, 0
    dx, dy, length, j, first = 0, 1, 1, 0, True
    while max(abs(x), abs(y)) <= radius or length <= 2 * radius:
        x, y = x + dx, y + dy
        if abs(x) <= radius and abs(y) <= radius and (x, y) != (0, 0):
            offs.append((x, y))
        j += 1
        if j == length:
            j = 0
            if not first:
                length += 1
            first = not first
            dx, dy = dy, -dx
        if length > 2 * radius + 2:
            break
    seen, out = set(), []
    for o in offs:
        if o not in seen:
            seen.add(o)
            out.append(o)
    return out


def producers(cfg) -> List[int]:
    """Each type's producer type: the first that produces it, -1 for none
    (BS3:265 ``producedBy.get(0)``)."""
    out = [-1] * cfg.num_types
    for t in range(cfg.num_types):
        for p in range(cfg.num_types):
            if cfg.produces[p][t]:
                out[t] = p
                break
    return out


def targeted_by_attack(view: State, cfg) -> torch.Tensor:
    """bool ``[B, H, W]``: the cells some unit of ``view`` is attacking
    (``wasUnderAttack``, BS3:361-371; believestate.py:108): the attackers
    within ``max(attack_range)`` of each cell whose target is the cell."""
    R = max(cfg.attack_range)
    H, W = view.utype.shape[1:]
    ys, xs = torch.meshgrid(torch.arange(H, device=view.device),
                            torch.arange(W, device=view.device),
                            indexing="ij")
    attacking = (view.utype > 0) & view.busy & (view.atype == ATTACK)
    atx, aty = view.atx.to(I32), view.aty.to(I32)
    out = torch.zeros_like(attacking)
    for oy in range(-R, R + 1):
        for ox in range(-R, R + 1):
            if ox == 0 and oy == 0:
                continue
            src = shift(attacking, ox, oy, False)
            tx = shift(atx, ox, oy, -1)
            ty = shift(aty, ox, oy, -1)
            out = out | (src & (tx == xs) & (ty == ys))
    return out


def _relocate(bel, need, vis, free, spiral, counts=None):
    """Move each ``need`` unit of ``bel`` (believed type, hp, uid) to the
    first cell along the spiral that is unobservable, free and believed
    empty; unresolved units drop (believestate.py:179-213).  Each offset's
    shift is a bijection, so two units never claim one cell."""
    b_t, b_h, b_u = bel
    un_t = torch.where(need, b_t, 0)
    un_h = torch.where(need, b_h, 0)
    un_u = torch.where(need, b_u, 0)
    b_t = torch.where(need, 0, b_t)
    b_h = torch.where(need, 0, b_h)
    b_u = torch.where(need, 0, b_u)
    for ox, oy in spiral:
        if not bool((un_t > 0).any()):
            break     # nothing left to place: the rest changes nothing
        tgt_ok = ~vis & free & (b_t == 0)
        cand_t = shift(un_t, ox, oy, 0)
        place = (cand_t > 0) & tgt_ok
        b_t = torch.where(place, cand_t, b_t)
        b_h = torch.where(place, shift(un_h, ox, oy, 0), b_h)
        b_u = torch.where(place, shift(un_u, ox, oy, 0), b_u)
        resolved = shift(place, -ox, -oy, False)
        un_t = torch.where(resolved, 0, un_t)
        un_h = torch.where(resolved, 0, un_h)
        un_u = torch.where(resolved, 0, un_u)
        if counts is not None:
            counts["relocated"] += int(place.sum())
    return b_t, b_h, b_u


def believe_init_plain(state: State, view: State, vis: torch.Tensor,
                       player: int, cfg) -> BelieveMem:
    """setInitialBelieveState (BS3:144-159; believestate.py:152): every
    opponent unit unobservable at the start is remembered, and its type
    counts as seen."""
    hidden = (state.utype > 0) & (state.owner == 1 - player) & ~vis
    seen = torch.stack([(hidden & (state.utype == t + 1)).any((1, 2))
                        for t in range(cfg.num_types)], 1)
    return BelieveMem(
        b_utype=torch.where(hidden, state.utype.to(I32), 0),
        b_hp=torch.where(hidden, state.hp.to(I32), 0),
        b_uid=torch.where(hidden, state.uid, 0),
        seen_type=seen, prev=view, prev_vis=vis)


def believe_update_plain(mem: BelieveMem, state: State, view: State,
                         vis: torch.Tensor, player: int, cfg, level: int,
                         spiral, counts: Optional[dict] = None
                         ) -> BelieveMem:
    """updateBelieveState (BS3:224-340; believestate.py:215-323) for the
    observer ``player`` whose view and visibility of ``state`` are
    ``view``/``vis``; ``counts`` (a dict of ``RULES``) adds the cells each
    rule changed."""
    c = counts if counts is not None else dict.fromkeys(RULES, 0)
    opp = 1 - player
    T = cfg.num_types
    prev = mem.prev
    b_t, b_h, b_u = mem.b_utype, mem.b_hp, mem.b_uid
    seen = mem.seen_type.clone()

    now_enemy = (view.utype > 0) & (view.owner == opp)
    now_free = (state.terrain == 0) & ~(view.utype > 0)
    prev_enemy = (prev.utype > 0) & (prev.owner == opp)

    if level >= 2:
        # units that vanished from view (BS3:228-254)
        gone = prev_enemy & now_free
        moving = prev.busy & (prev.atype == MOVE)
        tgt_unobs = torch.zeros_like(vis)
        for d in range(4):
            tgt_unobs = tgt_unobs | ((prev.aparam == d)
                                     & pull(~vis, d, False))
        moved_to_fog = gone & moving & tgt_unobs
        attacked = targeted_by_attack(prev, cfg)
        static_lost = gone & ~moving & ~vis & ~attacked
        remember = (moved_to_fog | static_lost) & (b_t == 0)
        b_t = torch.where(remember, prev.utype.to(I32), b_t)
        b_h = torch.where(remember, prev.hp.to(I32), b_h)
        b_u = torch.where(remember, prev.uid, b_u)
        c["remembered"] += int(remember.sum())
        c["moved_to_fog"] += int((moved_to_fog & remember).sum())

        # forget believed units whose real unit re-appeared (BS3:289-306):
        # match by uid anywhere on the board
        vis_uids = torch.where(now_enemy, view.uid, 0).flatten(1)
        hit = ((vis_uids[:, None, :] == b_u.flatten(1)[:, :, None])
               & (vis_uids[:, None, :] > 0)).any(2).reshape(b_u.shape)
        for_uid = (b_u > 0) & hit
        b_t = torch.where(for_uid, 0, b_t)
        b_h = torch.where(for_uid, 0, b_h)
        b_u = torch.where(for_uid, 0, b_u)
        c["forgotten_by_uid"] += int(for_uid.sum())

    if level >= 3:
        # inference of unseen producers (BS3:256-277), types in order:
        # seen[t] is updated as the loop goes, and read as seen[pt]
        prod = producers(cfg)
        B, H, W = b_t.shape
        new_inf = torch.zeros_like(b_t)
        for t in range(T):
            pt = prod[t]
            if pt < 0:
                continue
            now_t = now_enemy & (view.utype == t + 1)
            any_t = now_t.any((1, 2))
            need_inf = (any_t & ~seen[:, t] & ~seen[:, pt]
                        & ~(now_enemy & (view.utype == pt + 1)).any((1, 2)))
            # the seed: the first sighted unit of type t in row-major order
            pos = now_t.flatten(1).to(torch.uint8).argmax(1)
            seed = ((torch.arange(H * W, device=b_t.device)[None]
                     == pos[:, None]).reshape(B, H, W)
                    & need_inf[:, None, None])
            new_inf = torch.where(seed & (new_inf == 0), pt + 1, new_inf)
            seen[:, t] = seen[:, t] | any_t
        c["inferred"] += int((new_inf > 0).sum())
        if spiral:
            hp = torch.tensor(cfg.hp, dtype=I32, device=b_t.device)
            inf_hp = torch.where(new_inf > 0,
                                 hp[(new_inf - 1).clamp(min=0).long()], 0)
            b_t, b_h, b_u = _relocate(
                (torch.where(new_inf > 0, new_inf, b_t),
                 torch.where(new_inf > 0, inf_hp, b_h),
                 torch.where(new_inf > 0, 0, b_u)),
                new_inf > 0, vis, now_free, spiral, c)

        # forget inferred units (uid 0) once their type is seen
        # (BS3:279-287)
        for t in range(T):
            t_vis = (now_enemy & (view.utype == t + 1)).any((1, 2))
            drop = (b_t == t + 1) & (b_u == 0) & t_vis[:, None, None]
            b_t = torch.where(drop, 0, b_t)
            b_h = torch.where(drop, 0, b_h)
            c["dropped"] += int(drop.sum())

        # relocate believed units on observed cells (BS3:174-194, :308-334)
        bad = (b_t > 0) & vis
        b_t, b_h, b_u = _relocate((b_t, b_h, b_u), bad, vis, now_free,
                                  spiral, c)
    else:
        # BS2: a believed unit on an observed cell is wrong and forgotten;
        # BS1: initial buildings only, forgotten when their cell is
        # observed free
        bad = (b_t > 0) & vis
        if level == 1:
            bad = bad & now_free
        b_t = torch.where(bad, 0, b_t)
        b_h = torch.where(bad, 0, b_h)
        b_u = torch.where(bad, 0, b_u)
        c["forgotten"] += int(bad.sum())
    return BelieveMem(b_utype=b_t, b_hp=b_h, b_uid=b_u, seen_type=seen,
                      prev=view, prev_vis=vis)


def sample_world_plain(state: State, view: State, mem: BelieveMem,
                       player: int) -> State:
    """The believed units overlaid onto the view where its cell is free
    (sampleWorld, BS3:169-222; believestate.py:325); inferred units get
    uid ``1 << 20``."""
    free = (state.terrain == 0) & (view.utype == 0)
    put = free & (mem.b_utype > 0)
    return view.replace(
        utype=torch.where(put, mem.b_utype, view.utype.to(I32)),
        owner=torch.where(put, 1 - player, view.owner.to(I32)),
        hp=torch.where(put, mem.b_hp, view.hp.to(I32)),
        uid=torch.where(put, torch.where(mem.b_uid > 0, mem.b_uid,
                                         INFERRED_UID), view.uid),
    ).canon()


def believe_state_bot(env: GridnetEnv, inner: Opponent, *, level: int = 3,
                      spiral_r: int = 6) -> StatefulBot:
    """Wrap a full-observability bot (an ``Opponent``) into a believe-state
    PO bot (believestate.py:130): ``level`` 1 = BS1 (remember the units
    hidden at the start, never update), 2 = BS2 (last-known positions), 3
    = BS3 (inference and relocation)."""
    if level not in (1, 2, 3):
        raise ValueError(f"level must be 1, 2 or 3, got {level}")
    cfg = env.cfg.engine
    spiral = spiral_offsets(min(spiral_r, max(env.h, env.w) - 1))
    producer = producers(cfg)
    plain = env.engine.plain

    def view_vis(state: State, player: int):
        if fog._use_kernel(state, plain):
            return KN.PO_STATE(cfg, state, player)
        vis = fog.visibility_plain(state, player, cfg)
        return fog._view(state, player, vis), vis

    def kernel(state, view, vis, player, mem=None):
        planes, world = KN.BELIEVE(cfg, level, spiral, producer, state, view,
                                   vis, player, mem)
        return (BelieveMem(prev=view, prev_vis=vis, **planes),
                None if world is None else view.replace(**world))

    def init(state: State, player) -> BelieveMem:
        player = int(player)
        view, vis = view_vis(state, player)
        if env.engine._use_kernel(state.utype):
            return kernel(state, view, vis, player)[0]
        return believe_init_plain(state, view, vis, player, cfg)

    def update(state: State, mem: BelieveMem, player: int,
               counts: Optional[dict] = None):
        """(the new memory, the sampled world) of ``state``; ``counts``
        (plain path only) adds the cells each rule touched."""
        view, vis = view_vis(state, player)
        if env.engine._use_kernel(state.utype):
            if counts is not None:
                raise ValueError("believe_update: rule counts are kept on "
                                 "the plain path only")
            return kernel(state, view, vis, player, mem)
        mem = believe_update_plain(mem, state, view, vis, player, cfg, level,
                                   spiral, counts)
        return mem, sample_world_plain(state, view, mem, player)

    def step(state: State, mem: BelieveMem, player, noise,
             live: Optional[torch.Tensor] = None):
        player = int(player)
        new, world = update(state, mem, player)
        if live is not None:
            new = mem.select(live, new)
        return inner(world, player, noise), new

    bot = StatefulBot(init=init, step=step, draw=inner.draw)
    bot.update, bot.inner, bot.level = update, inner, level
    return bot


def play_matches_stateful(env: GridnetEnv, bot0: StatefulBot,
                          bot1: StatefulBot, n_games: int,
                          max_cycles: int = 2000, seed: int = 0,
                          chunk: Optional[int] = None,
                          noise: Optional[Callable] = None):
    """Lockstep stateful games (believestate.py:348): each frame
    ``fast_forward`` coasts to the next decision frame, the lanes finished
    there take their winner, both bots step on every lane (the finished
    lanes' memories are kept), the env steps and finished lanes are frozen
    by select.  ``noise(frame, player)`` stands in for each bot's
    ``draw`` from a generator seeded with ``seed``, and ``noise(frame,
    None)`` for the frame's engine draws (``eval.tournament.FrameDraws``)
    where the env needs them.  ``chunk`` (default
    ``eval.tournament.CHUNK``) is the interval between the host's checks
    that every lane is done.  Returns (winners int32 ``[n_games]``: 0, 1
    or -1, the final State, the frames run)."""
    from ..eval.tournament import CHUNK, _generator, frame_draws, frame_step
    if chunk is None:
        chunk = CHUNK
    eng, dev = env.engine, env.device
    gen = _generator(env, seed) if noise is None else None
    s = env.reset(n_games)
    m0, m1 = bot0.init(s, 0), bot1.init(s, 1)
    done = torch.zeros(n_games, dtype=torch.bool, device=dev)
    winner = torch.full((n_games,), -1, dtype=I32, device=dev)
    frame = 0
    draws = env.needs_draws
    while frame < max_cycles:
        for _ in range(min(chunk, max_cycles - frame)):
            fd = None
            if draws:
                fd = (noise(frame, None) if noise
                      else frame_draws(env, gen, n_games))
            advance, s, d_ff = frame_step(env, s, done, max_cycles, fd)
            winner = torch.where(done, winner, torch.where(
                d_ff, eng.winner(s), -1))
            done = done | d_ff | (s.time >= max_cycles)
            nz0 = noise(frame, 0) if noise else bot0.draw(gen, n_games)
            nz1 = noise(frame, 1) if noise else bot1.draw(gen, n_games)
            a0, m0 = bot0.step(s, m0, 0, nz0, live=~done)
            a1, m1 = bot1.step(s, m1, 1, nz1, live=~done)
            s2, done2 = advance(s, a0, a1)
            winner = torch.where(done, winner, torch.where(
                done2, eng.winner(s2), -1))
            s = s2.select(done, s)
            done = done | done2
            frame += 1
        if bool(done.all()):
            break
    return winner, s, frame

