"""The rule that decides ``correct`` from the numbers compared: each
beside its limit."""
from __future__ import annotations

import math
from typing import Dict


def judged(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number inside its limit (a number that is not finite is
    not)."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
