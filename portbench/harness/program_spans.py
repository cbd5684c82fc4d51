"""The card's idle time under the program's own spans.

The program keeps its spans on the host's wall clock (`time.time_ns`),
the clock torch.profiler converts its events to, so they lie on the
trace's timeline beside the card's operations: a span's idle time is the
trace's gaps (`Trace.gaps`) inside the union of the spans of that name.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from portbench.harness.trace import Interval


def in_window(trace, spans: Iterable[Interval]) -> List[Interval]:
    """The spans that overlap the trace's window, cut to it."""
    lo, hi = trace.window
    return [(name, max(s, lo), min(e, hi)) for name, s, e in spans
            if e > lo and s < hi]


def _merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_under(trace, spans: Iterable[Interval], name: str) -> float:
    """Seconds of the card's idle time inside the spans called name."""
    under = _merged((s, e) for n, s, e in in_window(trace, spans)
                    if n == name)
    gaps, i, idle = trace.gaps(), 0, 0
    for s, e in under:
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            idle += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return idle / 1e9


def span_count(trace, spans: Iterable[Interval], name: str) -> int:
    """The spans called name in the trace's window."""
    return sum(n == name for n, _, _ in in_window(trace, spans))


def idle_ms_per(trace, spans: Iterable[Interval], name: str,
                per: str) -> Optional[float]:
    """Milliseconds of idle time under the spans called name for each span
    called per; None when the window holds no span called per."""
    spans = list(spans)
    n = span_count(trace, spans, per)
    if not n:
        return None
    return 1e3 * idle_under(trace, spans, name) / n
