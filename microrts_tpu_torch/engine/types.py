"""Batched device state for the port's engine.

The JAX package keeps one env per ``State`` and batches with ``vmap``; here
every field carries the batch as its leading axis: board and assignment
planes are ``[B, H, W]``, ``resources`` is ``[B, 2]`` and the other scalars
are ``[B]``.  Planes keep the narrow storage types of ``FIELD_DTYPES``
(the same as ``microrts_tpu.engine.types``); arithmetic runs in int32 and
every function that returns a ``State`` stores back with ``canon()``.

The JAX ``State.key`` field has no counterpart: randomness enters the port
as tensors made by the caller.  Of the engine, CANCEL_RANDOM's coins are
such an input of ``Engine.issue`` (bool ``[B, H, W, 4]``, drawn in JAX
from ``fold_in(key, order_ctr)``), and UTT v3's damage uniforms one of
``Engine.cycle`` (float32 ``[B, H, W]``, drawn in JAX from ``split(key)``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .pgs import PhysicalGameState
from .utt import UnitTypeTable

# Action types (UnitAction.java:29-59)
NONE = 0
MOVE = 1
HARVEST = 2
RETURN = 3
PRODUCE = 4
ATTACK = 5

# Directions (UnitAction.java:68-100); offsets in (dx, dy)
DIR_X = (0, 1, 0, -1)
DIR_Y = (-1, 0, 1, 0)

INF = 1 << 30

# Canonical per-field storage types (microrts_tpu.engine.types.FIELD_DTYPES).
FIELD_DTYPES = dict(
    terrain=torch.int8, utype=torch.int8, owner=torch.int8,
    hp=torch.int16, carried=torch.int16, uid=torch.int32,
    busy=torch.bool, atype=torch.int8, aparam=torch.int16,
    atx=torch.int16, aty=torch.int16, aptype=torch.int8,
    aticks=torch.int16, aorder=torch.int32, atime=torch.int32,
    time=torch.int32, resources=torch.int32, next_id=torch.int32,
    order_ctr=torch.int32, cancel_ctr=torch.int32,
)
PLANES = ("terrain", "utype", "owner", "hp", "carried", "uid", "busy",
          "atype", "aparam", "atx", "aty", "aptype", "aticks", "aorder",
          "atime")


@dataclasses.dataclass
class State:
    """A batch of env states: ``[B, H, W]`` planes and ``[B]`` scalars
    (``resources`` ``[B, 2]``).  Field meanings follow
    ``microrts_tpu.engine.types.State``."""

    terrain: torch.Tensor    # 0 free / 1 wall
    utype: torch.Tensor      # 0 = no unit, else type_id + 1
    owner: torch.Tensor      # -1 neutral/none, 0/1 players
    hp: torch.Tensor
    carried: torch.Tensor    # carried resources (units) / remaining (nodes)
    uid: torch.Tensor
    busy: torch.Tensor
    atype: torch.Tensor
    aparam: torch.Tensor     # direction / NONE duration
    atx: torch.Tensor
    aty: torch.Tensor
    aptype: torch.Tensor
    aticks: torch.Tensor
    aorder: torch.Tensor     # global issue order (LinkedHashMap order)
    atime: torch.Tensor      # issue time
    time: torch.Tensor
    resources: torch.Tensor
    next_id: torch.Tensor
    order_ctr: torch.Tensor
    cancel_ctr: torch.Tensor

    def canon(self) -> "State":
        """Store every field in its canonical type (wrapping like an
        integer cast), as the JAX package's ``State.canon`` does."""
        return self.replace(**{
            name: getattr(self, name).to(dt)
            for name, dt in FIELD_DTYPES.items()
            if getattr(self, name).dtype != dt})

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.utype.device

    @property
    def batch(self) -> int:
        return self.utype.shape[0]

    def clone(self) -> "State":
        return State(**{f: getattr(self, f).clone() for f in FIELD_DTYPES})

    def select(self, mask: torch.Tensor, other: "State") -> "State":
        """Per env: ``other`` where ``mask[b]`` else ``self``.  ``other``
        may have batch 1 (broadcast)."""
        out = {}
        for f in FIELD_DTYPES:
            a = getattr(self, f)
            m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
            out[f] = torch.where(m, getattr(other, f), a)
        return State(**out)

    def equal(self, other: "State") -> Tuple[bool, str]:
        """Exact equality of every field; returns (ok, first differing
        field name or "")."""
        for f in FIELD_DTYPES:
            if not torch.equal(getattr(self, f), getattr(other, f)):
                return False, f
        return True, ""


@dataclasses.dataclass
class Candidates:
    """One tick's decoded candidate actions per cell, int32 ``[B, H, W]``
    planes.  ``rank`` is the within-tick issue order; cells without a
    candidate have ``atype = -1`` and ``rank = INF``."""

    atype: torch.Tensor
    aparam: torch.Tensor
    atx: torch.Tensor
    aty: torch.Tensor
    aptype: torch.Tensor
    rank: torch.Tensor

    FIELDS = ("atype", "aparam", "atx", "aty", "aptype", "rank")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static ruleset + shape: the UTT (UnitTypeTable.java:104-289)
    flattened to tuples (a copy of the JAX package's ``EngineConfig``)."""

    height: int
    width: int
    num_types: int
    cost: Tuple[int, ...]
    hp: Tuple[int, ...]
    min_damage: Tuple[int, ...]
    max_damage: Tuple[int, ...]
    attack_range: Tuple[int, ...]
    produce_time: Tuple[int, ...]
    move_time: Tuple[int, ...]
    attack_time: Tuple[int, ...]
    harvest_time: Tuple[int, ...]
    return_time: Tuple[int, ...]
    harvest_amount: Tuple[int, ...]
    sight_radius: Tuple[int, ...]
    is_resource: Tuple[bool, ...]
    is_stockpile: Tuple[bool, ...]
    can_harvest: Tuple[bool, ...]
    can_move: Tuple[bool, ...]
    can_attack: Tuple[bool, ...]
    produces: Tuple[Tuple[bool, ...], ...]  # [T, T] producer -> producible
    move_conflict_policy: int = 1           # CANCEL_BOTH

    @property
    def max_range(self) -> int:
        return max((r for r, c in zip(self.attack_range, self.can_attack) if c),
                   default=1)

    @property
    def barracks_like(self) -> Tuple[int, ...]:
        """Military-producing buildings, the learned models' "have
        barracks" feature (FeatureGeneratorSimple.java:43): immobile,
        non-stockpile, non-resource producers."""
        return tuple(i for i in range(self.num_types)
                     if not self.can_move[i] and not self.is_stockpile[i]
                     and not self.is_resource[i] and any(self.produces[i]))

    @property
    def det_damage(self) -> bool:
        """Damage is deterministic (UTT v1/v2): min == max for every type."""
        return all(mn == mx for mn, mx in zip(self.min_damage,
                                              self.max_damage))

    @classmethod
    def from_utt(cls, utt: UnitTypeTable, height: int, width: int) -> "EngineConfig":
        def tup(name):
            return tuple(int(v) for v in getattr(utt, name))

        def btup(name):
            return tuple(bool(v) for v in getattr(utt, name))

        return cls(
            height=height, width=width, num_types=utt.num_types,
            cost=tup("cost"), hp=tup("hp"),
            min_damage=tup("min_damage"), max_damage=tup("max_damage"),
            attack_range=tup("attack_range"), produce_time=tup("produce_time"),
            move_time=tup("move_time"), attack_time=tup("attack_time"),
            harvest_time=tup("harvest_time"), return_time=tup("return_time"),
            harvest_amount=tup("harvest_amount"), sight_radius=tup("sight_radius"),
            is_resource=btup("is_resource"), is_stockpile=btup("is_stockpile"),
            can_harvest=btup("can_harvest"), can_move=btup("can_move"),
            can_attack=btup("can_attack"),
            produces=tuple(tuple(bool(v) for v in row)
                           for row in utt.produces_mask),
            move_conflict_policy=int(utt.move_conflict_resolution_strategy),
        )


# ----------------------------------------------------------------------
# Host <-> device conversion

def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device must exist: the
    port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def state_from_pgs(pgs: PhysicalGameState, cfg: EngineConfig, batch: int,
                   device, time: int = 0) -> State:
    """``batch`` copies of a host map snapshot (no in-flight actions)."""
    h, w = cfg.height, cfg.width
    if (pgs.height, pgs.width) != (h, w):
        raise ValueError(f"map is {pgs.height}x{pgs.width}, config {h}x{w}")
    d = {f: np.zeros((h, w), np.int32) for f in PLANES}
    d["owner"][:] = -1
    d["atime"][:] = -1
    d["terrain"] = np.asarray(pgs.terrain, np.int32).reshape(h, w)
    for u in pgs.units:
        d["utype"][u.y, u.x] = u.type_id + 1
        d["owner"][u.y, u.x] = u.player
        d["hp"][u.y, u.x] = u.hitpoints
        d["carried"][u.y, u.x] = u.resources
        d["uid"][u.y, u.x] = u.ID
    d["busy"] = np.zeros((h, w), bool)
    res = np.zeros(2, np.int32)
    for p in pgs.players:
        res[p.ID] = p.resources
    d.update(time=np.int32(time), resources=res,
             next_id=np.int32(max((u.ID for u in pgs.units), default=-1) + 1),
             order_ctr=np.int32(0), cancel_ctr=np.int32(0))
    one = state_from_numpy(d, device)
    return State(**{f: getattr(one, f).expand(
        (batch,) + tuple(getattr(one, f).shape[1:])).contiguous()
        for f in FIELD_DTYPES})


def state_from_numpy(leaves: Dict[str, np.ndarray], device="cpu") -> State:
    """The JAX package's ``State`` leaves (numpy arrays, batched ``[B, ...]``
    or one env) as a port ``State``.  The JAX ``key`` leaf, if present, is
    dropped (see the module docstring)."""
    single = np.asarray(leaves["utype"]).ndim == 2
    out = {}
    for f, dt in FIELD_DTYPES.items():
        a = np.asarray(leaves[f])
        if single:
            a = a[None]
        out[f] = torch.from_numpy(np.array(a)).to(
            device=device, dtype=dt)
    return State(**out)


def snapshot(state: State, env: int = 0):
    """Order-free comparable fingerprint of env ``env`` of the batch
    (types.py:226-239 of the JAX package): the sorted (owner, type,
    x, y, carried, hp) of its units and the two players' resources."""
    utype, owner, carried, hp = (
        getattr(state, f)[env].cpu().numpy()
        for f in ("utype", "owner", "carried", "hp"))
    ys, xs = np.nonzero(utype > 0)
    units = [(int(owner[y, x]), int(utype[y, x]) - 1, int(x), int(y),
              int(carried[y, x]), int(hp[y, x])) for y, x in zip(ys, xs)]
    return (tuple(sorted(units)),
            tuple(int(v) for v in state.resources[env].cpu().numpy()))


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """Batched numpy leaves of ``state``, keyed like the JAX ``State``
    (without ``key``)."""
    return {f: getattr(state, f).cpu().numpy() for f in FIELD_DTYPES}
