"""The observability plane (port of ``repro.obs``):

  * :mod:`repro_torch.obs.metrics` — the metric registry whose histogram
    and counter state rides the engine's carry;
  * :mod:`repro_torch.obs.trace`   — host-side span tracing of the engine
    lifecycle (Chrome trace-event JSON + JSONL);
  * :mod:`repro_torch.obs.report`  — per-run report rendering and the
    ``python -m repro_torch.obs.report`` CLI.

Only the registry is imported eagerly: ``engine.config`` needs
:class:`ObsConfig` before the engine (which ``trace`` and ``report``
build on) exists."""

from repro_torch.obs.metrics import (  # noqa: F401
    COUNTERS,
    PERCENTILES,
    HostHistogram,
    MetricSpec,
    ObsConfig,
    build_metrics,
    host_percentile,
    summarize,
)
