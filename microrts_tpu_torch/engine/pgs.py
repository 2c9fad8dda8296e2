"""Physical game state: the map (terrain + players + units), host side.

Mirrors ``rts/PhysicalGameState.java`` (load :65-76, fromXML :614-700, RLE
terrain :546-607).  This is the *host* representation used for map
loading; the batched device representation lives in ``types.py``.  A copy
of the map-loading part of ``microrts_tpu.engine.pgs``.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from .utt import UnitTypeTable

TERRAIN_NONE = 0
TERRAIN_WALL = 1


@dataclasses.dataclass
class HostUnit:
    """One unit instance (rts/units/Unit.java fields :23-58)."""
    ID: int
    player: int          # -1 = neutral (resources)
    type_id: int
    x: int
    y: int
    resources: int = 0
    hitpoints: int = 0


@dataclasses.dataclass
class HostPlayer:
    ID: int
    resources: int


class PhysicalGameState:
    """Host-side map container; ``units`` preserves Java's LinkedList order
    (append on creation), which defines iteration order everywhere."""

    def __init__(self, width: int, height: int, terrain: Optional[np.ndarray] = None):
        self.width = width
        self.height = height
        self.terrain = (terrain if terrain is not None
                        else np.zeros(width * height, dtype=np.int8))
        self.players: List[HostPlayer] = []
        self.units: List[HostUnit] = []

    # ------------------------------------------------------------------
    def get_unit_at(self, x: int, y: int) -> Optional[HostUnit]:
        for u in self.units:
            if u.x == x and u.y == y:
                return u
        return None

    def add_unit(self, u: HostUnit) -> None:
        if self.get_unit_at(u.x, u.y) is not None:
            raise ValueError(f"PhysicalGameState.add_unit: occupied cell ({u.x},{u.y})")
        self.units.append(u)

    # ------------------------------------------------------------------
    # XML IO (PhysicalGameState.java:614-756; maps/*.xml format)

    @classmethod
    def from_xml(cls, elem: ET.Element, utt: UnitTypeTable) -> "PhysicalGameState":
        width = int(elem.get("width"))
        height = int(elem.get("height"))
        terrain_text = (elem.find("terrain").text or "").strip()
        terrain = terrain_from_string(terrain_text, width * height)
        pgs = cls(width, height, terrain)
        for p_e in elem.find("players"):
            pgs.players.append(HostPlayer(ID=int(p_e.get("ID")),
                                          resources=int(p_e.get("resources", 0))))
        for u_e in elem.find("units"):
            ut = utt.get_unit_type(u_e.get("type"))
            if ut is None:
                raise ValueError(f"unknown unit type {u_e.get('type')!r} in map")
            u = HostUnit(
                ID=int(u_e.get("ID")), player=int(u_e.get("player")),
                type_id=ut.ID, x=int(u_e.get("x")), y=int(u_e.get("y")),
                resources=int(u_e.get("resources", 0)),
                hitpoints=int(u_e.get("hitpoints", ut.hp)))
            if pgs.get_unit(u.ID) is not None:
                raise ValueError(f"repeated unit ID {u.ID} in map")
            pgs.add_unit(u)
        return pgs

    def get_unit(self, ID: int) -> Optional[HostUnit]:
        for u in self.units:
            if u.ID == ID:
                return u
        return None

    @classmethod
    def load(cls, path: str, utt: UnitTypeTable) -> "PhysicalGameState":
        return cls.from_xml(ET.parse(path).getroot(), utt)


def terrain_from_string(text: str, n: int) -> np.ndarray:
    """Decode either the plain 0/1 digit string or the RLE 'A'/'B' compressed
    form (PhysicalGameState.getTerrainFromUnknownString + uncompressTerrain
    :546-607)."""
    if any(c in "AB" for c in text):
        return uncompress_terrain_rle(text)
    arr = np.frombuffer(text.encode(), dtype=np.uint8) - ord("0")
    if arr.size != n:
        raise ValueError(f"terrain length {arr.size} != {n}")
    return arr.astype(np.int8)


def uncompress_terrain_rle(text: str) -> np.ndarray:
    out: List[int] = []
    counter = ""
    for ch in text:
        if ch in "AB":
            if counter:
                out.extend([out[-1]] * (int(counter) - 1))
                counter = ""
            out.append(0 if ch == "A" else 1)
        else:
            counter += ch
    if counter:
        out.extend([out[-1]] * (int(counter) - 1))
    return np.array(out, dtype=np.int8)
