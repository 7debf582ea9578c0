"""The traced run's records: the harness's own spans on the host clock,
and the device's activity from ``torch.profiler``.

Spans are ``record_function`` ranges that the drivers open around the
calls into each layer (``round``, ``assemble``, ``local_step``,
``sync_step``) in the traced part of the measured window.  Both the ranges
and the device operations (kernels, copies, fills) come out of one
profiler session, on one timeline.
"""

from __future__ import annotations

import contextlib
import time

LABELS = ("round", "assemble", "local_step", "sync_step")


class Spans:
    """Host-clock durations per label over the whole window, and the
    ``record_function`` ranges of the traced part."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self._rf = None

    def trace(self, on: bool) -> None:
        if on:
            import torch

            self._rf = torch.profiler.record_function
        else:
            self._rf = None

    @contextlib.contextmanager
    def __call__(self, label: str):
        t0 = time.perf_counter()
        if self._rf is None:
            yield
        else:
            with self._rf(label):
                yield
        self.seconds.setdefault(label, []).append(time.perf_counter() - t0)


class Profiler:
    """One profiler session over a part of the window (CPU ranges and the
    device's activity), started and stopped on a synchronized device."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.record = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.spans.trace(True)
        self.active = True

    def stop(self) -> None:
        """End the session on a synchronized device; its events are read
        by :meth:`read`, after the window."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.spans.trace(False)
        self.prof.__exit__(None, None, None)
        self.active = False

    def read(self) -> None:
        if self.prof is not None and self.record is None:
            self.record = read_events(self.prof)
            self.prof = None

    active = False


def read_events(prof) -> dict:
    """``{"device": [(name, start_us, end_us)], "ranges": [(label, start_us,
    end_us)], "window_us": (start, end)}`` of one finished session: the
    traced window runs from its first event to its last (the session starts
    and stops on a synchronized device)."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    for e in prof.events():
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if name in LABELS or name.startswith("ProfilerStep"):
                continue
            device.append((name, start, end))
        elif name in LABELS:
            ranges.append((name, start, end))
    every = device + ranges
    window = (min(e[1] for e in every), max(e[2] for e in every)) if every else None
    return {"device": sorted(device, key=lambda d: d[1]), "ranges": ranges,
            "window_us": window}


def short_name(name: str) -> str:
    """A device operation's name without its argument list, at most 160
    characters."""
    body = name.replace("(anonymous namespace)::", "")
    return (body.split("(")[0].strip() or body)[:160]


def busy_intervals(device: list, window: tuple) -> list[tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the window."""
    lo, hi = window
    out: list[list[float]] = []
    for _, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(record: dict) -> float:
    return sum(e - s for s, e in busy_intervals(record["device"], record["window_us"])) / 1e6


def window_seconds(record: dict) -> float:
    lo, hi = record["window_us"]
    return (hi - lo) / 1e6


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost harness range the host was in."""
    total: dict[str, float] = {}
    for name, s, e in record["device"]:
        name = short_name(name)
        total[name] = total.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = record["window_us"]
    busy = busy_intervals(record["device"], record["window_us"])
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        inside = [r for r in record["ranges"] if r[1] <= mid <= r[2]]
        label = min(inside, key=lambda r: r[2] - r[1])[0] if inside else "window"
        named.append([label, (e - s) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
