"""Seconds per local step (``train_step.local_step``: each pod's forward,
backward and AdamW), from the harness's host-clock spans over the window,
each ending in a synchronize."""


def read(rec):
    s = rec["spans"].get("local_step") or []
    return sum(s) / len(s) if s else None
