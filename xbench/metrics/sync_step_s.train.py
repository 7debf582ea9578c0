"""Seconds per sync step (``train_step.sync_step``: a local step, then the
sync engine's int8 merge and its store bookkeeping), from the harness's
host-clock spans over the window; less ``local_step_s.train``, the
merge's cost."""


def read(rec):
    s = rec["spans"].get("sync_step") or []
    return sum(s) / len(s) if s else None
