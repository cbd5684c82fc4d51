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
  annotate(name) - a span: while a profiler is on, a
                   torch.profiler.record_function named "g2v.<name>", so
                   the stage shows up inside the trace on the profiler's
                   clock, nested under the spans open on the calling
                   thread; the span is also kept in `spans()`. With no
                   profiler on it is one shared null context (well under
                   a microsecond).
  spans()        - the spans closed while a profiler was on, oldest first,
                   each (name, start_ns, end_ns) on the host's wall clock
                   (`time.time_ns`, the clock torch.profiler converts its
                   events to), the last SPAN_LOG of them: an in-process
                   reader lays them against a profiler's device events.
  count(name, n) - adds n to a counter; counters() returns a copy of them
                   all. Counters always count.

The program's spans, on the calling thread:
  g2v.gen.call            generate_batch / generate, the whole call
    g2v.gen.windows       the host's word windowing and the H2D copy
    g2v.gen.noise         a sampled decode's Gumbel noise, drawn on the
                          host and copied to the device
    g2v.gen.encode        the text encoder over every window
    g2v.gen.token_loop    the token decode (window by window, or one shot)
      g2v.gen.token_window  one window of the carried decode
    g2v.gen.tokens_to_host  the tokens' copy to the host
    g2v.gen.rollout       the chunk decoder's rollout (`_decode_chunks`)
    g2v.gen.dae           the DAE's decode of the latents
    g2v.gen.unnormalize   the gather of each row's real frames and their
                          unnormalise, on the device
    g2v.gen.frames_to_host  their copy to the host (pinned from a card)
  g2v.step                a trainer's `train/optim.Step` call
    g2v.step.forward / g2v.step.backward / g2v.step.optim
  g2v.feed.wait           `utils/prefetch`: the consumer waiting for a batch
The counters (decode mode): gen.chunks_rolled, the chunks each rollout
rolls out (B x N, padding included), and gen.chunks_real, the chunks whose
frames generate_batch and generate return (the audio generator's and the
streaming steps' rollouts count as rolled only). Every copy of frames to
the host: gen.frames_copied, the frames (rows of pose_dim) it moves;
generate_batch and generate: gen.frames_returned, the frames they return.
Every token decode:
gen.token_positions_computed, the decoder positions it computes, and
gen.token_positions_read, those its choices read (25 and 5 a row of a
window for the transformer, which re-runs its 5-slot buffer a token; 5
and 5 for the GRU decoders).
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, Iterator, List, Tuple

import torch

SPAN_PREFIX = "g2v."
# spans kept for spans(): some 200 calls of 32 transcripts up to 30 min
# long (~315 spans each), or 13,000 train steps (5 each)
SPAN_LOG = 65536

_OFF = contextlib.nullcontext()
_spans: "collections.deque[Tuple[str, int, int]]" = collections.deque(
    maxlen=SPAN_LOG)
_counts: Dict[str, int] = {}
_count_lock = threading.Lock()


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


class _Span:
    """record_function("g2v.<name>") that also keeps its interval."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name
        self._rf = torch.profiler.record_function(self.name)

    def __enter__(self) -> "_Span":
        self._t0 = time.time_ns()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        _spans.append((self.name, self._t0, time.time_ns()))
        return False


def annotate(name: str):
    """The span "g2v.<name>" while a profiler is on, else a null
    context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def spans() -> List[Tuple[str, int, int]]:
    return list(_spans)


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    with _count_lock:
        return dict(_counts)


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
