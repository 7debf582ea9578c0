"""Result assembly for the flat epoch engine (port of
``repro.engine.results.assemble_flat``)."""

from __future__ import annotations

from repro_torch.engine.config import EngineConfig


def _severity(config: EngineConfig, store, st) -> float:
    if not config.audit:
        return 0.0
    return float(store.audit(st, delta=store.delta or 0).severity)


def assemble_flat(config: EngineConfig, prep: dict) -> dict[str, float]:
    out = prep["out"]
    st = out["st"]
    n_reads = int(out["reads"])
    n_reads_f = max(1, n_reads)
    return {
        "staleness_rate": float(int(out["stale"])) / n_reads_f,
        "violation_rate": float(int(out["viol"])) / n_reads_f,
        "severity": _severity(config, prep["store"], st),
        "n_reads": n_reads,
        "dropped_writes": int(st.cluster.pend_dropped),
    }

