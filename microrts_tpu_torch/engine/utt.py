"""Unit type table: the ruleset of microRTS.

A copy of ``microrts_tpu.engine.utt`` without its JSON/XML serialization:
the builtin versions are built in code (UnitTypeTable.java:104-289), and
the table is a struct-of-arrays the engine turns into tensor lookups.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Version constants (UnitTypeTable.java:26-41)
EMPTY_TYPE_TABLE = -1
VERSION_ORIGINAL = 1
VERSION_ORIGINAL_FINETUNED = 2
VERSION_NON_DETERMINISTIC = 3

# Move-conflict resolution policies (UnitTypeTable.java:46-57)
MOVE_CONFLICT_RESOLUTION_CANCEL_BOTH = 1
MOVE_CONFLICT_RESOLUTION_CANCEL_RANDOM = 2
MOVE_CONFLICT_RESOLUTION_CANCEL_ALTERNATING = 3


@dataclasses.dataclass
class UnitType:
    """Stats of one unit type (UnitType.java:18-110 field-for-field)."""

    name: str = ""
    ID: int = 0
    cost: int = 1
    hp: int = 1
    min_damage: int = 1
    max_damage: int = 1
    attack_range: int = 1
    produce_time: int = 10
    move_time: int = 10
    attack_time: int = 10
    harvest_time: int = 10
    return_time: int = 10
    harvest_amount: int = 1
    sight_radius: int = 0
    is_resource: bool = False
    is_stockpile: bool = False
    can_harvest: bool = False
    can_move: bool = False
    can_attack: bool = False
    produces: List[str] = dataclasses.field(default_factory=list)
    produced_by: List[str] = dataclasses.field(default_factory=list)


class UnitTypeTable:
    """The ruleset.  Holds UnitType records plus derived dense arrays.

    Array attributes (all ``np.int32`` of shape [T] unless noted) are consumed
    by the engine as constant lookup tables:
      cost, hp, min_damage, max_damage, attack_range, produce_time, move_time,
      attack_time, harvest_time, return_time, harvest_amount, sight_radius,
      is_resource, is_stockpile, can_harvest, can_move, can_attack  (bool[T]),
      produces_mask (bool[T, T]: producer type -> producible type).
    """

    def __init__(self, version: int = VERSION_ORIGINAL,
                 move_conflict_resolution_strategy: int = MOVE_CONFLICT_RESOLUTION_CANCEL_BOTH):
        self.unit_types: List[UnitType] = []
        self.move_conflict_resolution_strategy = move_conflict_resolution_strategy
        if version != EMPTY_TYPE_TABLE:
            self._build_version(version)
            self._finalize()

    # ------------------------------------------------------------------
    def _build_version(self, version: int) -> None:
        """Builtin rulesets, mirroring UnitTypeTable.setUnitTypeTable
        (UnitTypeTable.java:104-289)."""
        v = version
        add = self.add_unit_type

        add(UnitType(name="Resource", is_resource=True, sight_radius=0))

        add(UnitType(
            name="Base", cost=10, hp=10,
            produce_time=250 if v == VERSION_ORIGINAL else 200,
            is_stockpile=True, sight_radius=5))

        add(UnitType(
            name="Barracks", cost=5, hp=4,
            produce_time=200 if v == VERSION_ORIGINAL else 100,
            sight_radius=3))

        wk_min, wk_max = (1, 1) if v != VERSION_NON_DETERMINISTIC else (0, 2)
        add(UnitType(
            name="Worker", cost=1, hp=1, min_damage=wk_min, max_damage=wk_max,
            attack_range=1, produce_time=50, move_time=10, attack_time=5,
            harvest_time=20, return_time=10, can_harvest=True, can_move=True,
            can_attack=True, sight_radius=3))

        li_min, li_max = (2, 2) if v != VERSION_NON_DETERMINISTIC else (1, 3)
        add(UnitType(
            name="Light", cost=2, hp=4, min_damage=li_min, max_damage=li_max,
            attack_range=1, produce_time=80, move_time=8, attack_time=5,
            can_move=True, can_attack=True, sight_radius=2))

        he_min, he_max = (4, 4) if v != VERSION_NON_DETERMINISTIC else (0, 6)
        if v == VERSION_ORIGINAL:
            he_move, he_hp, he_cost = 12, 4, 2
        else:
            he_move, he_hp, he_cost = 10, 8, 3
        add(UnitType(
            name="Heavy", cost=he_cost, hp=he_hp, min_damage=he_min,
            max_damage=he_max, attack_range=1, produce_time=120,
            move_time=he_move, attack_time=5, can_move=True, can_attack=True,
            sight_radius=2))

        ra_min, ra_max = (1, 1) if v != VERSION_NON_DETERMINISTIC else (1, 2)
        add(UnitType(
            name="Ranged", cost=2, hp=1, min_damage=ra_min, max_damage=ra_max,
            attack_range=3, produce_time=100, move_time=10, attack_time=5,
            can_move=True, can_attack=True, sight_radius=3))

        # Production graph (UnitTypeTable.java:283-288)
        self._link("Base", "Worker")
        self._link("Barracks", "Light")
        self._link("Barracks", "Heavy")
        self._link("Barracks", "Ranged")
        self._link("Worker", "Base")
        self._link("Worker", "Barracks")

    def _link(self, producer: str, produced: str) -> None:
        self.get_unit_type(producer).produces.append(produced)
        self.get_unit_type(produced).produced_by.append(producer)

    # ------------------------------------------------------------------
    def add_unit_type(self, ut: UnitType) -> None:
        ut.ID = len(self.unit_types)
        self.unit_types.append(ut)

    def get_unit_type(self, key) -> Optional[UnitType]:
        if isinstance(key, int):
            return self.unit_types[key]
        for ut in self.unit_types:
            if ut.name == key:
                return ut
        return None

    @property
    def num_types(self) -> int:
        return len(self.unit_types)

    # ------------------------------------------------------------------
    def _finalize(self) -> None:
        """Compute the dense struct-of-arrays view."""
        T = len(self.unit_types)
        for field in ("cost", "hp", "min_damage", "max_damage", "attack_range",
                      "produce_time", "move_time", "attack_time",
                      "harvest_time", "return_time", "harvest_amount",
                      "sight_radius"):
            setattr(self, field,
                    np.array([getattr(ut, field) for ut in self.unit_types],
                             dtype=np.int32))
        for field in ("is_resource", "is_stockpile", "can_harvest",
                      "can_move", "can_attack"):
            setattr(self, field,
                    np.array([getattr(ut, field) for ut in self.unit_types],
                             dtype=np.bool_))
        pm = np.zeros((T, T), dtype=np.bool_)
        for ut in self.unit_types:
            for name in ut.produces:
                pm[ut.ID, self.get_unit_type(name).ID] = True
        self.produces_mask = pm

    def __repr__(self):
        return (f"UnitTypeTable({[ut.name for ut in self.unit_types]}, "
                f"crs={self.move_conflict_resolution_strategy})")
