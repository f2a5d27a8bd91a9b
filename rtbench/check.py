"""The comparison that decides ``correct``: readings against the limits
of ``limits/<workload>.json`` (each reading must not exceed its limit)."""

from __future__ import annotations

from typing import NamedTuple


class Reading(NamedTuple):
    name: str
    value: float


def judge(readings: list, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}); a reading without a limit,
    or a limit without a reading, is not correct."""
    out = {r.name: {"value": r.value, "limit": limits.get(r.name)}
           for r in readings}
    for name, lim in limits.items():
        out.setdefault(name, {"value": None, "limit": lim})
    ok = all(v["value"] is not None and v["limit"] is not None
             and v["value"] <= v["limit"] for v in out.values())
    return ok, out


def lines(checked: dict) -> list:
    """One line a reading, for standard error."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checked.items()]
