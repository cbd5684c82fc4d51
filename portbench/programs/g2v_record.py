"""What the program under test records of itself (the port's
`utils/profiling`): its spans, each (name, start_ns, end_ns) on the
host's wall clock, the clock torch.profiler converts its host and device
events to, and its counters. A port that records neither gives none, and
a reader of them then finds nothing to read."""


def _profiling():
    from gesture2vec_tpu_torch.utils import profiling

    return profiling


def spans() -> list:
    """The spans the program closed while a profiler was on."""
    read = getattr(_profiling(), "spans", None)
    return [] if read is None else read()


def counters() -> dict:
    """The program's counters, over the whole process."""
    read = getattr(_profiling(), "counters", None)
    return {} if read is None else read()
