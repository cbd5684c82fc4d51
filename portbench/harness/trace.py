"""The device trace of a measured window, from torch.profiler.

`Tracer` profiles the host (the benchmark's own spans, `span`, and
nothing else there) and the card (kernels, copies, sets) over the
window. `Trace` holds what the
readers need: the device operations as (name, start_ns, end_ns), the
benchmark's spans as (name, start_ns, end_ns), and the window.
`DeviceClock` records the card alone over a whole window, in every run,
for an end-to-end metric of device time. Every device number comes from
the card's own timestamps; nothing here is a host-clock estimate of
device time.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[str, int, int]

# spans the drivers open around the calls into each layer carry this
# prefix, so the trace tells them from the program's own annotations
SPAN_PREFIX = "bench."
# the span a driver opens around its measured loop
WINDOW = "window"


@contextlib.contextmanager
def span(name: str, on: bool = True):
    """A benchmark span around a call into a layer (a torch.profiler
    record_function, so the trace's host timeline holds it); nothing when
    off."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def wrap(obj, attr: str, name: str) -> None:
    """Replace obj.attr (a bound method or a function attribute) by the
    same call inside `span(name)`, on this instance only."""
    fn = getattr(obj, attr)

    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    setattr(obj, attr, spanned)


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """The length of the union of (start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _ns(event, what: str) -> int:
    getter = getattr(event, f"{what}_ns", None)
    if getter is not None:
        return int(getter())
    return int(getattr(event, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Trace:
    device_ops: List[Interval]
    spans: List[Interval]
    window: Tuple[int, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def ops(self, names: Sequence[str] = ()) -> List[Interval]:
        """Device operations whose name holds any of names (all when
        names is empty)."""
        if not names:
            return self.device_ops
        return [op for op in self.device_ops
                if any(n in op[0] for n in names)]

    def op_seconds(self, names: Sequence[str] = ()) -> float:
        return sum(e - s for _, s, e in self.ops(names)) / 1e9

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        return union_ns((s, e) for _, s, e in self.device_ops) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The device's idle intervals inside the window."""
        out, cursor = [], self.window[0]
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if self.window[1] > cursor:
            out.append((cursor, self.window[1]))
        return out

    def host_at(self, t: int) -> str:
        """The innermost benchmark span open at t on the host, or
        'outside spans'."""
        best = None
        for name, s, e in self.spans:
            if s <= t <= e and (best is None or s >= best[1]):
                best = (name, s, e)
        return best[0][len(SPAN_PREFIX):] if best else "outside spans"

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device operations that took most time (summed by name) and
        the idle time by what the host was doing, each at most n."""
        by_name: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        idle: Dict[str, float] = {}
        for s, e in self.gaps():
            where = self.host_at((s + e) // 2)
            idle[where] = idle.get(where, 0.0) + (e - s) / 1e9
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def from_events(events: Iterable, window: Tuple[int, int]) -> Trace:
    """A Trace from kineto events (torch.profiler's raw events) inside
    the window: device operations are the events on the card that are not
    projections of host annotations."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for ev in events:
        s = _ns(ev, "start")
        e = s + max(_ns(ev, "duration"), 0)
        if e < window[0] or s > window[1]:
            continue
        name = ev.name()
        if ev.device_type() == cuda:
            device.append((name, max(s, window[0]), min(e, window[1])))
        else:
            host.append((name, s, e))
    annotations = {name for name, _, _ in host}
    spans = [iv for iv in host if iv[0].startswith(SPAN_PREFIX)]
    ops = [iv for iv in device if iv[0] not in annotations]
    return Trace(ops, spans, window)


class Tracer:
    """torch.profiler's kineto tracer over one window: the card's
    operations (CUPTI) and, on the host, only the benchmark's own spans
    (record_function's user scope). The program's host operators are not
    recorded: recording each of them would slow the host-bound program
    that the trace measures. `start` and `stop` bracket the window;
    `trace()` reads it."""

    def __init__(self):
        import torch
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, _ExperimentalConfig)

        self._activities = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            self._activities.add(ProfilerActivity.CUDA)
        # no shapes, memory, stacks, flops or modules
        self._config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                      False, False, False,
                                      _ExperimentalConfig())
        self._results = None

    def start(self) -> None:
        import torch
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import RecordScope

        _prepare_profiler(self._config, self._activities)
        _enable_profiler(self._config, self._activities,
                         {RecordScope.USER_SCOPE})
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def stop(self) -> None:
        """Ends the window, after a synchronise."""
        import torch
        from torch._C._autograd import _disable_profiler

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._results = _disable_profiler()

    def trace(self) -> Trace:
        """The window is the driver's `span(WINDOW)`, the measured loop."""
        import torch

        events = list(self._results.events())
        cuda = torch.autograd.DeviceType.CUDA
        marks = [ev for ev in events if ev.name() == SPAN_PREFIX + WINDOW
                 and ev.device_type() != cuda]
        if len(marks) != 1:
            raise RuntimeError(f"{len(marks)} window spans in the trace")
        s = _ns(marks[0], "start")
        return from_events(events, (s, s + _ns(marks[0], "duration")))


class DeviceClock:
    """The card's busy time over a whole measured window, for an
    end-to-end metric read in every run: CUPTI records the card's
    operations (kernels, copies, sets) and nothing of the host. The
    profiler keeps its records in a buffer of bounded size (a 10 s trace
    of the training cell, 348,000 operations, is known to fit whole), so
    the driver calls `tick()` after each unit of work and every
    `lap_every` units the record is read, reduced to its busy time and
    dropped, and a new one opens: laps of the same work on every host.
    Each record opens and closes on a synchronise, so no operation lies
    in two. `warm()` belongs in set-up: the first start initialises
    CUPTI. `ops` counts the operations recorded, to be held against the
    work's own count.
    """

    def __init__(self, lap_every: int):
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, _ExperimentalConfig)

        self._activities = {ProfilerActivity.CUDA}
        self._config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                      False, False, False,
                                      _ExperimentalConfig())
        self.lap_every = lap_every
        self.busy_ns = 0
        self.ops = 0
        self.laps = 0
        self._units = 0

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def start(self) -> None:
        import torch
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import RecordScope

        torch.cuda.synchronize()
        _prepare_profiler(self._config, self._activities)
        _enable_profiler(self._config, self._activities,
                         {RecordScope.USER_SCOPE})
        self._units = 0

    def tick(self) -> None:
        self._units += 1
        if self._units >= self.lap_every:
            self.stop()
            self.start()

    def stop(self) -> None:
        """Closes the record after a synchronise and adds its busy time."""
        import torch
        from torch._C._autograd import _disable_profiler

        torch.cuda.synchronize()
        events = _disable_profiler().events()
        cuda = torch.autograd.DeviceType.CUDA
        spans = [(ev.start_ns(), ev.start_ns() + max(ev.duration_ns(), 0))
                 for ev in events if ev.device_type() == cuda]
        self.busy_ns += union_ns(spans)
        self.ops += len(spans)
        self.laps += 1

    def warm(self) -> None:
        self.start()
        self.stop()
        self.busy_ns = self.ops = self.laps = 0
