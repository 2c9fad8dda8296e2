"""Asset root resolution for maps.

Relative asset paths (e.g. ``"maps/8x8/basesWorkers8x8.xml"``) resolve
against, in order, ``$MICRORTS_ASSETS`` (a colon-separated list of roots)
and the package's own ``assets/`` directory.  Absolute or existing paths
pass through untouched.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List

BUNDLED = Path(__file__).resolve().parent.parent / "assets"


def asset_roots() -> List[Path]:
    roots: List[Path] = []
    env = os.environ.get("MICRORTS_ASSETS")
    if env:
        roots.extend(Path(p) for p in env.split(":") if p)
    roots.append(BUNDLED)
    return roots


def asset_path(rel: str) -> str:
    """Resolve a relative asset path to an absolute file path."""
    p = Path(rel)
    if p.is_absolute() or p.exists():
        return str(p)
    for root in asset_roots():
        cand = root / rel
        if cand.exists():
            return str(cand)
    raise FileNotFoundError(
        f"asset {rel!r} not found under any root "
        f"({[str(r) for r in asset_roots()]}); set $MICRORTS_ASSETS")
