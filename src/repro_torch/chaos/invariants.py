"""Post-run causal-invariant checks over a chaos run's result (port of
``repro.chaos.invariants``).  A run passes when every check holds;
breaches come back as human-readable strings (empty = clean)."""

from __future__ import annotations

from typing import Any

from repro_torch.core.consistency import ConsistencyLevel

__all__ = ["check_invariants"]


def check_invariants(
    result: dict[str, Any],
    level: ConsistencyLevel,
    *,
    crashed: bool,
) -> list[str]:
    """All causal and accounting invariants a chaos run must satisfy.

    * **No protocol violations under guarded levels**: a session-guarded
      or timed level reports a zero violation rate whatever the nemesis
      did (a crash may cost staleness and traffic, never correctness).
      The audit severity is graded and small but nonzero even on a clean
      run, so it is reported, not gated.
    * **Recovery traffic iff a crash happened**: ``recovery_gb`` is
      positive exactly when the schedule held a crash, and the crash and
      rejoin counters agree.
    * **Sane accounting**: rates in ``[0, 1]``, no negative cost line.
    """
    breaches: list[str] = []
    guarded = level.is_session_guarded or level.is_timed

    viol = float(result.get("violation_rate", 0.0))
    if guarded and viol > 0:
        breaches.append(f"{level.value}: violation_rate={viol} (expected 0)")

    stale = float(result.get("staleness_rate", 0.0))
    if not 0.0 <= stale <= 1.0:
        breaches.append(f"staleness_rate={stale} out of [0, 1]")

    rec = result.get("recovery")
    if crashed:
        if rec is None:
            breaches.append("schedule crashed but result has no recovery block")
        else:
            if rec["crashes"] < 1:
                breaches.append(f"crashes={rec['crashes']} (expected >= 1)")
            if rec["rejoins"] < 1:
                breaches.append(f"rejoins={rec['rejoins']} (expected >= 1)")
            if rec["recovery_gb"] <= 0.0:
                breaches.append(
                    f"recovery_gb={rec['recovery_gb']} (expected > 0 "
                    "after a crash)"
                )
    elif rec is not None and rec["recovery_gb"] > 0.0:
        breaches.append(f"recovery_gb={rec['recovery_gb']} > 0 without a crash")

    for key, value in result.get("cost", {}).items():
        if isinstance(value, (int, float)) and value < 0:
            breaches.append(f"cost[{key}]={value} negative")
    return breaches
