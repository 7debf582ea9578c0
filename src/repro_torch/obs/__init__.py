"""The observability plane (port of ``repro.obs``): the metric registry
of :mod:`repro_torch.obs.metrics`.  The span tracer (``obs.trace``) and
the report renderer (``obs.report``) are not ported yet."""

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
