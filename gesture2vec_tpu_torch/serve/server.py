"""HTTP serving with transparent micro-batching.

Port of the JAX package's `serve/server.py`, with the same endpoints,
status codes and JSON fields. Concurrent /generate requests queue for up
to `batch_window_s`; the collector drains up to `max_batch` of them and
one GestureGenerator.generate_batch call serves the group, so their
chunks share one chunk-decoder launch.

Endpoints (stdlib http.server, a thread per connection):
  GET  /healthz   -> JSON {ok, requests, batches, batched_requests, ...}
  POST /generate  -> request JSON:
                       {"words": [[word, start_s, end_s], ...],
                        "duration_s": <float, optional>,
                        "format": "bvh" | "json"}
                     response: BVH text (format=bvh, the default when an
                     exporter is configured) or JSON with the motion
                     (base64 float32) and the gesture tokens.
  POST /stream    -> the same request JSON (always json); a chunked
                     NDJSON response, one line per window as soon as its
                     motion is ready ({"window", "t0_s", "t1_s",
                     "frames_shape", "frames_b64", "dtype", "tokens"}),
                     then {"done": true, "windows": N}. Streams bypass
                     the request batcher. In decode mode every stream's
                     window steps go through one StreamStepBatcher
                     (infer/streaming.py): the due windows of up to
                     stream_batch concurrent streams run as one batched
                     step, and a lone stream's step runs at once. Exemplar
                     mode shares one unbatched window step.
"""
from __future__ import annotations

import base64
import contextlib
import json
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


def nearest_rank(values: List[float], q: float) -> float:
    """Nearest-rank percentile over a list (q in [0, 1]): the one
    definition used for the server's /healthz latencies and for
    client-side latencies, so both are computed alike."""
    s = sorted(values)
    return s[min(int(q * (len(s) - 1) + 0.5), len(s) - 1)]


@dataclass
class _Pending:
    words: List[List]
    duration_s: float
    done: threading.Event = field(default_factory=threading.Event)
    cancelled: threading.Event = field(default_factory=threading.Event)
    result: Optional[Tuple[np.ndarray, np.ndarray]] = None
    error: Optional[str] = None


class QueueFullError(Exception):
    """Backpressure: the pending queue is at capacity (HTTP 429)."""


class BatchingWorker:
    """Collects concurrent generation requests into one generate_batch.

    The collector thread blocks for the first request, then waits up to
    batch_window_s for more (at most max_batch) before it runs them. A
    single request takes `generate` (the same output as a batch of one).

    Backpressure: the queue holds 4 * max_batch requests; submit raises
    QueueFullError at once when it is full (the handler answers 429). A
    submit that times out marks its request cancelled, and the collector
    drops it instead of generating for a client that gave up.

    mesh (`parallel/mesh.make_mesh` with a "dp" axis) goes to each fused
    batch's `GestureGenerator.generate_batch(mesh=)`: in the server's
    one process the rows run whole on its card (`parallel/mesh`).
    """

    LATENCY_WINDOW = 1024   # last-N reservoir for p50/p99
    DEFAULT_MAX_BATCH = 32

    def __init__(self, generator, max_batch: int = DEFAULT_MAX_BATCH,
                 batch_window_s: float = 0.05, mesh=None):
        self.generator = generator
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.mesh = mesh
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "cancelled": 0, "rejected": 0, "streams": 0,
                      "stream_windows": 0}
        # handler threads and the collector both count
        self._stats_lock = threading.Lock()
        self._latencies: "deque[float]" = deque(maxlen=self.LATENCY_WINDOW)
        self._lat_lock = threading.Lock()
        self._q: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=4 * max_batch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def latency_stats(self) -> Dict[str, float]:
        """p50/p99 request latency (enqueue -> result ready, seconds) over
        the last LATENCY_WINDOW completed requests."""
        with self._lat_lock:
            lats = list(self._latencies)
        if not lats:
            return {"latency_n": 0}
        return {"latency_n": len(lats),
                "latency_p50_s": round(nearest_rank(lats, 0.50), 4),
                "latency_p99_s": round(nearest_rank(lats, 0.99), 4)}

    def submit(self, words: List[List], duration_s: float,
               timeout_s: float = 120.0) -> Tuple[np.ndarray, np.ndarray]:
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        req = _Pending(words=words, duration_s=duration_s)
        t0 = time.monotonic()
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.count("rejected")
            raise QueueFullError("pending queue full") from None
        if self._stop.is_set() and not req.done.is_set():
            # shutdown raced this enqueue past close()'s drain and the
            # collector is gone: fail now instead of at the timeout
            req.error = req.error or "server shutting down"
            req.done.set()
        if not req.done.wait(timeout_s):
            req.cancelled.set()
            self.count("cancelled")
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        with self._lat_lock:
            self._latencies.append(time.monotonic() - t0)
        return req.result

    def close(self) -> None:
        """Stop the collector and fail every still-queued request at once
        (its submitter would otherwise wait out its whole timeout)."""
        self._stop.set()
        self._thread.join(timeout=5)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = "server shutting down"
            req.done.set()

    # ------------------------------------------------------------ internal
    def _drain(self, first: _Pending) -> List[_Pending]:
        batch = [first]
        t0 = time.monotonic()
        while len(batch) < self.max_batch:
            remaining = self.batch_window_s - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return [r for r in batch if not r.cancelled.is_set()]

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """The batch padded to a power of two (capped), as the window
        count is bucketed inside generate_batch: the chunk decoder then
        sees a few batch sizes, not every count of requests."""
        return min(1 << (n - 1).bit_length(), cap)

    def _batchable(self, req: _Pending) -> bool:
        """A request's output must not depend on the server's load. The
        port's generate_batch decodes each transcript as `generate` does
        (the same window-carry decode a row, one chunk-decoder launch for
        all rows), so requests fuse, whether or not the decode takes the
        kernel. chunk_continuity requests run alone, as in the JAX
        package. (Exemplar picks and sampled noise are random draws from
        the generator's stream, so they vary with the order of requests
        in any configuration; greedy token sequences do not.)"""
        return not getattr(self.generator, "chunk_continuity", False)

    def _dispatch(self, batch: List[_Pending]) -> None:
        self.count("batches")
        try:
            if len(batch) == 1:
                batch[0].result = self.generator.generate(
                    batch[0].words, batch[0].duration_s)
            else:
                self.count("batched_requests", len(batch))
                n_pad = self._bucket(len(batch), self.max_batch)
                reqs = list(batch) + [batch[-1]] * (n_pad - len(batch))
                results = self.generator.generate_batch(
                    [r.words for r in reqs],
                    [r.duration_s for r in reqs], mesh=self.mesh)
                for r, res in zip(batch, results):
                    r.result = res
        except Exception as e:  # surface per request, keep serving
            logging.exception("generation batch failed")
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
        for r in batch:
            r.done.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = self._drain(first)
            if not batch:
                continue
            self.count("requests", len(batch))
            fuse, solo = [], []
            for r in batch:
                (fuse if self._batchable(r) else solo).append(r)
            if len(fuse) > 1:
                self._dispatch(fuse)
            else:
                solo = fuse + solo
            for r in solo:
                self._dispatch([r])


class _StreamPrograms:
    """The shared window step, built once on the first /stream request.

    Decode mode puts every stream behind one StreamStepBatcher: the due
    windows of up to batch_max concurrent streams run as one batched
    step, and a stream runs its steps inside `session()`, so that a lone
    stream's step does not wait for peers. Exemplar mode (host picks
    mid-step) takes the plain shared step."""

    def __init__(self, generator, batch_max: int = 16,
                 batch_window_s: float = 0.01):
        self._generator = generator
        self._batch_max = max(int(batch_max), 1)
        self._batch_window_s = batch_window_s
        self._lock = threading.Lock()
        self._step = None
        self.batcher = None

    def get(self):
        with self._lock:
            if self._step is None:
                from gesture2vec_tpu_torch.infer.streaming import (
                    StreamStepBatcher, build_streaming_step)
                if self._generator.mode == "decode":
                    self.batcher = StreamStepBatcher(
                        self._generator, max_batch=self._batch_max,
                        window_s=self._batch_window_s)
                    self._step = self.batcher.step
                else:
                    self._step = build_streaming_step(self._generator)
            return self._step

    def session(self):
        """The context a stream runs its steps in (after `get`)."""
        if self.batcher is None:
            return contextlib.nullcontext()
        return self.batcher.session()

    def close(self) -> None:
        with self._lock:
            if self.batcher is not None:
                self.batcher.close()


def make_handler(worker: BatchingWorker, stream_programs: _StreamPrograms,
                 export_bvh: Optional[Callable[[np.ndarray], str]] = None,
                 request_timeout_s: float = 120.0):
    """export_bvh: frames -> BVH text (None disables format=bvh).
    request_timeout_s bounds a request's wait for generation."""

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (/stream) needs HTTP/1.1; every other response
        # sends Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            logging.debug("serve: " + fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: Dict[str, Any]) -> None:
            self._send(code, json.dumps(obj).encode(),
                       "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                sb = stream_programs.batcher
                extra = ({"stream_batches": sb.stats["batches"],
                          "stream_batched_calls":
                              sb.stats["batched_calls"]}
                         if sb is not None else {})
                self._send_json(200, {"ok": True, **worker.stats,
                                      **worker.latency_stats(), **extra})
            else:
                self._send_json(404, {"error": "not found"})

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data
                             + b"\r\n")

        def _parse_words(self):
            """The request parsing of /generate and /stream; sends the
            400 itself and returns None on bad input."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                words = payload["words"]
                if not isinstance(words, list) or not all(
                        isinstance(w, (list, tuple)) and len(w) >= 3
                        for w in words):
                    raise ValueError(
                        "words must be a list of [word, start_s, end_s]")
                words = [[str(w[0]), float(w[1]), float(w[2])]
                         for w in words]
                duration = float(payload.get(
                    "duration_s", words[-1][2] if words else 6.0))
                return words, duration, payload
            except (KeyError, ValueError, TypeError, IndexError,
                    json.JSONDecodeError) as e:
                self._send_json(400, {"error": f"bad request: {e}"})
                return None

        def _post_stream(self):
            parsed = self._parse_words()
            if parsed is None:
                return
            words, duration, _ = parsed
            from gesture2vec_tpu_torch.infer.streaming import \
                StreamingGestureSession
            sess = StreamingGestureSession(worker.generator,
                                           step=stream_programs.get())
            worker.count("streams")
            unit = sess.unit
            n_windows = max(int(np.ceil(duration / unit)), 1)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            sess.push(words, now_s=0.0)       # register the transcript
            with stream_programs.session():
                try:
                    for w in range(n_windows):
                        frames, tokens = sess.finish((w + 1) * unit)[0]
                        line = json.dumps({
                            "window": w, "t0_s": w * unit,
                            "t1_s": (w + 1) * unit,
                            "frames_shape": list(frames.shape),
                            "frames_b64": base64.b64encode(
                                np.asarray(frames, np.float32)
                                .tobytes()).decode(),
                            "dtype": "float32",
                            "tokens": np.asarray(tokens).reshape(-1)
                            .tolist()})
                        self._write_chunk(line.encode() + b"\n")
                        worker.count("stream_windows")
                    self._write_chunk(json.dumps(
                        {"done": True, "windows": n_windows}).encode()
                        + b"\n")
                except Exception as e:  # mid-stream failure: an error
                    logging.exception("stream failed")  # line, then the
                    self._write_chunk(json.dumps(       # last chunk
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                        + b"\n")
            self.wfile.write(b"0\r\n\r\n")

        def do_POST(self):
            if self.path == "/stream":
                self._post_stream()
                return
            if self.path != "/generate":
                self._send_json(404, {"error": "not found"})
                return
            parsed = self._parse_words()
            if parsed is None:
                return
            words, duration, payload = parsed
            fmt = payload.get("format", "bvh" if export_bvh else "json")
            if fmt not in ("bvh", "json"):
                self._send_json(400,
                                {"error": f"bad request: unknown format "
                                          f"{fmt!r}"})
                return
            # refuse before generating for a request that cannot be
            # answered
            if fmt == "bvh" and export_bvh is None:
                self._send_json(400, {"error": "no exporter configured"})
                return
            try:
                frames, tokens = worker.submit(
                    words, duration, timeout_s=request_timeout_s)
            except QueueFullError:
                self._send_json(429, {"error": "server overloaded"})
                return
            except TimeoutError:
                self._send_json(503, {"error": "generation timed out"})
                return
            except RuntimeError as e:
                self._send_json(500, {"error": str(e)})
                return
            if fmt == "bvh":
                try:
                    body = export_bvh(frames).encode()
                except Exception as e:  # exporter failure -> 500, not a
                    logging.exception("BVH export failed")  # closed socket
                    self._send_json(500, {"error": f"export failed: {e}"})
                    return
                self._send(200, body, "text/plain")
            else:
                self._send_json(200, {
                    "frames_shape": list(frames.shape),
                    "frames_b64": base64.b64encode(
                        np.asarray(frames, np.float32).tobytes()).decode(),
                    "dtype": "float32",
                    "tokens": np.asarray(tokens).reshape(-1).tolist(),
                })

    return Handler


class _Server(ThreadingHTTPServer):
    # concurrent streams connect at once; past the stdlib's listen backlog
    # of 5 their connections wait out a TCP retry
    request_queue_size = 128
    worker: BatchingWorker
    stream_programs: _StreamPrograms

    def server_close(self) -> None:
        """Close the socket, the request worker and the stream batcher."""
        super().server_close()
        self.worker.close()
        self.stream_programs.close()


def serve(generator, host: str = "127.0.0.1", port: int = 8008,
          export_bvh: Optional[Callable[[np.ndarray], str]] = None,
          max_batch: int = BatchingWorker.DEFAULT_MAX_BATCH,
          batch_window_s: float = 0.05,
          mesh=None,
          request_timeout_s: float = 120.0,
          stream_batch: int = 16,
          stream_batch_window_s: float = 0.01) -> ThreadingHTTPServer:
    """Build and return the server (the caller runs serve_forever() and,
    when done, shutdown() and server_close(), which also stops the
    request worker and the stream batcher). stream_batch caps the
    concurrent /stream window steps run as one batched step (decode
    mode; 1 runs each step alone), stream_batch_window_s bounds how long
    a due step waits for its peers. mesh splits the fused /generate
    batches over its dp axis (`BatchingWorker`)."""
    # bind first: an EADDRINUSE must not leak a running collector thread
    httpd = _Server((host, port), BaseHTTPRequestHandler)
    httpd.worker = BatchingWorker(generator, max_batch=max_batch,
                                  batch_window_s=batch_window_s, mesh=mesh)
    httpd.stream_programs = _StreamPrograms(
        generator, batch_max=stream_batch,
        batch_window_s=stream_batch_window_s)
    httpd.RequestHandlerClass = make_handler(
        httpd.worker, httpd.stream_programs, export_bvh, request_timeout_s)
    return httpd
