"""Replicated checkpoints under consistency levels (port of
``repro.checkpoint``)."""

from repro_torch.checkpoint.store import CheckpointStore, SessionToken

__all__ = ["CheckpointStore", "SessionToken"]
