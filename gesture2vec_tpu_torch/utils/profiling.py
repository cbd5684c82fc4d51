"""Profiling and tracing utilities (the port's copy of the JAX package's
`utils/profiling.py`, on `torch.profiler`).

  trace(dir)     - context manager around torch.profiler.profile (CPU
                   activities, and CUDA activities when a card is
                   present); writes a Chrome trace into dir that opens in
                   Perfetto or chrome://tracing, and in TensorBoard's
                   profiler plugin (the file is named as
                   `torch.profiler.tensorboard_trace_handler` names it).
  StageTimer     - named wall-clock stages with device sync, for
                   pipeline-level breakdowns (ingest/teacher/train/infer).
  annotate(name) - torch.profiler.record_function, so custom stages show
                   up inside the trace.
"""
from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from typing import Any, Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


def annotate(name: str) -> torch.profiler.record_function:
    return torch.profiler.record_function(name)


def _cuda_devices(obj: Any, found: set) -> set:
    """The CUDA devices of the tensors in obj (nested lists, tuples and
    dicts)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def _synchronize(outs: list) -> None:
    """Waits for the devices of the tensors handed to the sink; without
    any, for the current CUDA device when this process uses one. CPU
    tensors need no wait: CPU operators return when they are done."""
    if outs:
        for dev in _cuda_devices(outs, set()):
            torch.cuda.synchronize(dev)
    elif torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulating named stage timer with device synchronization.

    A CUDA launch returns before its kernel runs. With sync on, a stage
    waits on entry for the work queued before it and on exit for its own,
    so device compute is billed to the stage that queued it. To wait on
    the devices of particular tensors, hand the stage its OUTPUT tensors
    via the yielded sink:

        with timer.stage("encode") as done:
            z = encode_fn(x)
            done(z)

    The stage exit then runs `torch.cuda.synchronize()` on each CUDA
    device those tensors live on (CPU tensors are ready when the operator
    returns). A stage without a sink call synchronizes the current CUDA
    device when this process has initialised CUDA, and waits for nothing
    on the CPU. `torch.cuda.synchronize()` waits for every stream of the
    device, so unlike JAX's effects barrier it does wait for pure
    computations; work on another card is waited for only through the
    sink.
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        outs: list = []
        if self.sync:
            _synchronize([])
        t0 = time.perf_counter()
        yield outs.append
        if self.sync:
            _synchronize(outs)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n} calls, "
                         f"{total / n * 1e3:.1f}ms avg")
        return "\n".join(lines)
