"""Seconds per pass assembly (``engine/results.assemble``: the DUOT audit,
staleness and violations, then the bill), from the harness's host-clock
span around each completed pass's assembly in the window."""


def read(rec):
    s = rec["spans"].get("assemble") or []
    return sum(s) / len(s) if s else None
