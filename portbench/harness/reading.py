"""What the per-layer metrics' readers share: the device trace of the
run's record (refused without a card: no CPU run gives a device number),
the idle share and a kernel's roofline share."""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

from portbench.work.peaks import bound_s, require_card


def device_trace(record: dict):
    """The run's device trace, None when the run was not traced; raises
    without a card."""
    trace = record.get("trace")
    if trace is None:
        return None
    require_card()
    return trace


def idle_share(trace) -> Optional[float]:
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def roofline_share(trace, kernels: Sequence[str],
                   work: Iterable[Tuple[float, float]],
                   exclude: Sequence[str] = ()) -> Optional[float]:
    """100 x the least time of the launches' (operations, bytes) over the
    device time of the kernels whose names hold one of `kernels` and none
    of `exclude`; None when the trace holds none of them."""
    seconds = sum(e - s for name, s, e in trace.ops(kernels)
                  if not any(x in name for x in exclude)) / 1e9
    if seconds <= 0:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in work) / seconds
