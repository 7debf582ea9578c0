"""The device's idle share of the traced window (percent): one less the
union of its operations' intervals over the window's length."""

from lib import trace


def read(rec):
    t = rec["trace"]
    if t is None or not t["device"]:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(t) / trace.window_seconds(t))
