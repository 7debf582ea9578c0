"""Op ingest's share of its roofline: the least time B.1 (``op_ingest``)
and the clock chain (``vclock_chain``) could take on the traced rounds'
batches, from the benchmark's own count of their bytes and operations,
over the device time of those kernels by name (percent)."""

from lib import peaks, trace

KERNELS = ("ingest_small_kernel", "ingest_pass", "chain_small_kernel", "chain_seg_kernel",
           "level_plan_kernel", "level_exec_kernel")


def read(rec):
    t = rec["trace"]
    shape = rec["shape"]
    widths = shape.get("widths") or []
    if t is None or not widths:
        return None
    spent = sum(e - s for name, s, e in t["device"]
                if trace.short_name(name).startswith(KERNELS)) / 1e6
    if spent <= 0:
        return None
    bound = sum(peaks.op_ingest_bound_s(b) + peaks.vclock_chain_bound_s(
        b, shape["clients"], shape["replicas"]) for b in widths)
    return 100.0 * bound / spent
