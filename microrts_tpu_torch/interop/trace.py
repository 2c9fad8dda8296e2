"""Replay traces: read the reference's zipped-XML trace format.

A copy of the reading half of ``microrts_tpu.interop.trace``
(``trace_from_xml``, ``load_trace``), with its own ``UnitAction`` record
and the trace's ``<rts.units.UnitTypeTable>`` parsed into the port's
``UnitTypeTable``.  Format per ``rts/Trace.java`` (:30-176) /
``rts/TraceEntry.java``: a ``<rts.Trace>`` root holding the unit type
table and ``<rts.TraceEntry time="t">`` elements, each with a full
PhysicalGameState snapshot and the ``<action unitID=..><UnitAction
../></action>`` issued at that time.
"""

from __future__ import annotations

import dataclasses
import io
import xml.etree.ElementTree as ET
import zipfile
from typing import List, Optional, Tuple

from ..engine.pgs import PhysicalGameState
from ..engine.utt import (EMPTY_TYPE_TABLE,
                          MOVE_CONFLICT_RESOLUTION_CANCEL_BOTH, UnitType,
                          UnitTypeTable)

TYPE_NONE = 0
DIRECTION_NONE = -1


@dataclasses.dataclass
class UnitAction:
    """One durative action (UnitAction.java): ``parameter`` is a
    direction (or the duration of a NONE), ``x, y`` an attack's target,
    ``unit_type`` the produced type id."""
    type: int = TYPE_NONE
    parameter: int = DIRECTION_NONE
    x: int = 0
    y: int = 0
    unit_type: Optional[int] = None


@dataclasses.dataclass
class TraceEntry:
    time: int
    pgs: PhysicalGameState
    actions: List[Tuple[int, UnitAction]]  # (unitID, action), recorded order


@dataclasses.dataclass
class Trace:
    utt: UnitTypeTable
    entries: List[TraceEntry]


def utt_from_xml(elem: ET.Element) -> UnitTypeTable:
    """The ``<rts.units.UnitTypeTable>`` element of a trace
    (UnitTypeTable.java:391-406)."""
    utt = UnitTypeTable(EMPTY_TYPE_TABLE)
    utt.move_conflict_resolution_strategy = int(
        elem.get("moveConflictResolutionStrategy",
                 MOVE_CONFLICT_RESOLUTION_CANCEL_BOTH))

    def b(v):
        return str(v).lower() == "true"
    for ut_e in elem:
        utt.unit_types.append(UnitType(
            name=ut_e.get("name"), ID=int(ut_e.get("ID", 0)),
            cost=int(ut_e.get("cost", 1)), hp=int(ut_e.get("hp", 1)),
            min_damage=int(ut_e.get("minDamage", 1)),
            max_damage=int(ut_e.get("maxDamage", 1)),
            attack_range=int(ut_e.get("attackRange", 1)),
            produce_time=int(ut_e.get("produceTime", 10)),
            move_time=int(ut_e.get("moveTime", 10)),
            attack_time=int(ut_e.get("attackTime", 10)),
            harvest_time=int(ut_e.get("harvestTime", 10)),
            return_time=int(ut_e.get("returnTime", 10)),
            harvest_amount=int(ut_e.get("harvestAmount", 1)),
            sight_radius=int(ut_e.get("sightRadius", 0)),
            is_resource=b(ut_e.get("isResource", "false")),
            is_stockpile=b(ut_e.get("isStockpile", "false")),
            can_harvest=b(ut_e.get("canHarvest", "false")),
            can_move=b(ut_e.get("canMove", "false")),
            can_attack=b(ut_e.get("canAttack", "false")),
            produces=[c.get("type") for c in ut_e if c.tag == "produces"],
            produced_by=[c.get("type") for c in ut_e
                         if c.tag == "producedBy"]))
    utt._finalize()
    return utt


def _action_from_xml(e: ET.Element, utt: UnitTypeTable) -> UnitAction:
    ua = UnitAction(int(e.get("type", TYPE_NONE)))
    p = e.get("parameter")
    ua.parameter = int(p) if p is not None else DIRECTION_NONE
    x, y = e.get("x"), e.get("y")
    if x is not None:
        ua.x = int(x)
    if y is not None:
        ua.y = int(y)
    ut = e.get("unitType")
    if ut is not None:
        ua.unit_type = utt.get_unit_type(ut).ID
    return ua


def trace_from_xml(root: ET.Element) -> Trace:
    utt = utt_from_xml(root.find("rts.units.UnitTypeTable"))
    entries: List[TraceEntry] = []
    for te in root.find("entries"):
        t = int(te.get("time"))
        pgs = PhysicalGameState.from_xml(te.find("rts.PhysicalGameState"),
                                         utt)
        actions: List[Tuple[int, UnitAction]] = []
        acts_e = te.find("actions")
        if acts_e is not None:
            for a_e in acts_e:
                actions.append((int(a_e.get("unitID")), _action_from_xml(
                    a_e.find("UnitAction"), utt)))
        entries.append(TraceEntry(t, pgs, actions))
    return Trace(utt, entries)


def load_trace(path: str) -> Trace:
    """Load a trace from a .zip (the reference zips one XML inside) or
    .xml."""
    if path.endswith(".zip"):
        data = open(path, "rb").read()
        try:
            with zipfile.ZipFile(io.BytesIO(data)) as z:
                text = z.read(z.namelist()[0]).decode("utf-8",
                                                      errors="replace")
        except zipfile.BadZipFile:
            # several reference "zips" are plain XML files
            text = data.decode("utf-8", errors="replace")
    else:
        text = open(path, "r", encoding="utf-8", errors="replace").read()
    return trace_from_xml(ET.fromstring(text))
