"""The observability plane (port of ``repro.obs``, the metric registry;
the span tracer and the report renderer are not ported yet)."""
