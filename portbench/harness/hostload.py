"""What the host did over a measured window, reported beside each run's
result so that a slow run shows its cause: the process's CPU time, the
machine's CPU load and steal time (`/proc/stat`, where it can be read),
the CPU clock, the process's peak resident memory, and the window's work
by quarters (a rate that falls inside the window shows there).

`Window()` opens at the window's start; the driver calls `mark(amount)`
after each unit of work and `close()` at the end.
"""
from __future__ import annotations

import os
import resource
import time
from typing import List, Optional, Tuple


def _proc_stat() -> Optional[Tuple[int, int, int]]:
    """(total, idle, steal) jiffies of all CPUs (steal 0 where the line
    has no such field), None where unreadable."""
    try:
        with open("/proc/stat") as f:
            vals = [int(v) for v in f.readline().split()[1:9]]
        return (sum(vals), sum(vals[3:5]),
                vals[7] if len(vals) > 7 else 0) if len(vals) >= 4 else None
    except (OSError, ValueError):
        return None


def _cpu_mhz() -> Optional[float]:
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        return sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError, IndexError):
        return None


class Window:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.cpu0 = os.times()
        self.stat0 = _proc_stat()
        self.marks: List[Tuple[float, float]] = []

    def mark(self, amount: float) -> None:
        self.marks.append((time.perf_counter() - self.t0, float(amount)))

    def close(self) -> dict:
        wall = time.perf_counter() - self.t0
        cpu1, stat1 = os.times(), _proc_stat()
        out = {"wall_s": wall,
               "process_cpu_s": (cpu1.user + cpu1.system)
               - (self.cpu0.user + self.cpu0.system),
               "cpus": os.cpu_count(), "cpu_mhz": _cpu_mhz(),
               "rss_peak_bytes": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024,
               "work_by_quarter": self.by_quarter(wall)}
        if self.stat0 and stat1:
            total = stat1[0] - self.stat0[0]
            if total > 0:
                out["machine_busy_share"] = \
                    1.0 - (stat1[1] - self.stat0[1]) / total
                out["steal_share"] = (stat1[2] - self.stat0[2]) / total
        return out

    def by_quarter(self, wall: float) -> List[float]:
        """The work whose unit ended in each quarter of the window."""
        q = [0.0] * 4
        for t, amount in self.marks:
            q[min(int(4 * t / wall), 3) if wall > 0 else 3] += amount
        return q
