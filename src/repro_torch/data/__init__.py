"""Synthetic training data (port of ``repro.data``)."""

from repro_torch.data.synthetic import DataConfig, batch_at, extra_inputs

__all__ = ["DataConfig", "batch_at", "extra_inputs"]
