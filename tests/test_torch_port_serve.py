"""PyTorch port vs the JAX package: the serving layer (micro-batching
worker, HTTP endpoints, the serve command) and the kernel layer under
handler threads.

The same seeded numpy weights go through the JAX GestureGenerator (made by
`bench.build_generator` at small widths, weights perturbed) and the port's
(compat/from_jax), both in decode mode on the CPU. A fused batch must
give each request what its own `generate` gives: tokens identical,
frames within 1e-5 (fp32, sums in another order). Every socket read and
join has a timeout, and every server is shut down in `finally`.
"""
import base64
import contextlib
import dataclasses
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
from gesture2vec_tpu_torch.serve.server import (BatchingWorker,
                                                QueueFullError, nearest_rank,
                                                serve)
from gesture2vec_tpu_torch.text.vocab import Vocab

ATOL = 1e-5
HID, REP, K, DIM, NF, SENT, FPS, MAXW = 16, 8, 32, 12, 4, 24, 20, 10
N_WORDS, WORDEMBED, VOCAB_WORDS = 60, 12, 40
UNIT = SENT / FPS   # 1.2 s windows


def perturb(tree, rng, scale=0.3):
    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _words(duration_s, seed=0):
    rng = np.random.default_rng(seed)
    starts = np.linspace(0.1, duration_s - 0.5, int(2.5 * duration_s))
    return [[f"word{rng.integers(VOCAB_WORDS + 10)}", float(s),
             float(s + 0.3)] for s in starts]


# three requests of 6, 3 and 2 windows: one fused batch pads them to the
# 8-window bucket of the longest
REQUESTS = [(_words(7.0), 7.0), (_words(3.5, 1), 3.5), (_words(2.0, 2), 2.0)]


@pytest.fixture(scope="module")
def jax_gen():
    from bench import build_generator

    g = build_generator(hid=HID, rep=REP, k=K, dim=DIM, n_frames=NF,
                        sent_len=SENT, n_words=N_WORDS, max_words=MAXW,
                        wordembed=WORDEMBED, vocab_words=VOCAB_WORDS,
                        fps=FPS, mode="decode")
    rng = np.random.default_rng(7)
    return dataclasses.replace(
        g, t2t_variables=perturb(_np(g.t2t_variables), rng),
        seq_variables=perturb(_np(g.seq_variables), rng),
        dae_variables=perturb(_np(g.dae_variables), rng),
        pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32))


def _vocab():
    v = Vocab("bench")
    for i in range(VOCAB_WORDS):
        v.index_word(f"word{i}")
    return v


def _port(g, **kw):
    return generator_from_jax(
        g.t2t_variables, g.seq_variables, g.dae_variables, _vocab(),
        g.pose_mean, g.pose_std, n_frames=NF, sentence_frame_length=SENT,
        fps=FPS, max_words=MAXW, device="cpu", mode="decode", seed=0, **kw)


@pytest.fixture(scope="module")
def port_gen(jax_gen):
    return _port(jax_gen)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


def _concurrently(fn, n, timeout=60):
    """fn(i) on n threads; the results in order."""
    out = [None] * n
    errors = []

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _fused(worker):
    """The three REQUESTS submitted together to a worker whose window
    holds them all: their results, in order."""
    return _concurrently(lambda i: worker.submit(*REQUESTS[i],
                                                 timeout_s=60), 3)


def test_worker_fuses_and_matches_solo_and_jax(jax_gen, port_gen):
    """Three concurrent requests run as one generate_batch (bucket 4, one
    padding row); each equals its solo `generate` and what the JAX
    package's worker answers for the same words."""
    from gesture2vec_tpu.serve.server import BatchingWorker as JaxWorker

    w = BatchingWorker(port_gen, max_batch=8, batch_window_s=1.0)
    try:
        got = _fused(w)
        assert {k: w.stats[k] for k in ("requests", "batches",
                                        "batched_requests")} == \
            {"requests": 3, "batches": 1, "batched_requests": 3}
    finally:
        w.close()
    jw = JaxWorker(jax_gen, max_batch=8, batch_window_s=1.0)
    try:
        want = _fused(jw)
        assert jw.stats["batches"] == 1
    finally:
        jw.close()
    for (words, d), g_, w_ in zip(REQUESTS, got, want):
        assert g_[0].shape == (int(np.ceil(d / UNIT)) * SENT, DIM)
        _assert_same(g_, port_gen.generate(words, d))
        _assert_same(g_, w_)


def test_continuity_requests_run_alone(jax_gen):
    """chunk_continuity requests are not fused (as in the JAX package)."""
    gen = _port(jax_gen, chunk_continuity=True)
    w = BatchingWorker(gen, max_batch=8, batch_window_s=1.0)
    try:
        got = _fused(w)
        assert w.stats["batches"] == 3 and w.stats["batched_requests"] == 0
    finally:
        w.close()
    for (words, d), g_ in zip(REQUESTS, got):
        _assert_same(g_, gen.generate(words, d))


# -- HTTP --------------------------------------------------------------------
@contextlib.contextmanager
def _serving(gen, **kw):
    httpd = serve(gen, port=0, **kw)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1], httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _post(port, path, obj, timeout=60):
    """(status, body) of a POST; an HTTP error status is returned, not
    raised."""
    data = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _frames(obj):
    return np.frombuffer(base64.b64decode(obj["frames_b64"]),
                         np.float32).reshape(obj["frames_shape"])


def _stream_windows(body):
    lines = [json.loads(ln) for ln in body.splitlines() if ln]
    return lines[:-1], lines[-1]


def test_http_generate_json_bvh_and_healthz(port_gen):
    words, d = REQUESTS[0]
    with _serving(port_gen, batch_window_s=0.02,
                  export_bvh=lambda f: f"HIERARCHY\n# {f.shape}") as (port,
                                                                     _):
        code, body = _post(port, "/generate", {"words": words,
                                               "duration_s": d,
                                               "format": "json"})
        assert code == 200
        out = json.loads(body)
        assert out["dtype"] == "float32"
        _assert_same((_frames(out), np.asarray(out["tokens"], np.int32)),
                     port_gen.generate(words, d))
        code, body = _post(port, "/generate", {"words": words,
                                               "duration_s": d})
        assert code == 200
        assert body.decode() == f"HIERARCHY\n# {(6 * SENT, DIM)}"
        health = _get(port, "/healthz")
        assert health["ok"] and health["requests"] == 2
        assert health["batches"] == 2 and health["batched_requests"] == 0
        assert health["latency_n"] == 2
        assert 0.0 < health["latency_p50_s"] <= health["latency_p99_s"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nothing")
        assert e.value.code == 404


def test_http_bad_requests(port_gen):
    """Malformed word triples, an unknown format and bvh without an
    exporter give 400, on /generate and /stream."""
    with _serving(port_gen) as (port, httpd):
        for bad in ({"words": [["hi", 0.1]]}, {"words": "abc"},
                    {"words": _words(2.0), "duration_s": None},
                    {"words": _words(2.0), "format": "exr"},
                    {"words": _words(2.0), "format": "bvh"},
                    {"nothing": []}, b"{not json"):
            code, body = _post(port, "/generate", bad)
            assert code == 400, bad
            assert json.loads(body)["error"]
        assert _post(port, "/stream", {"words": "nope"})[0] == 400
        assert httpd.worker.stats["requests"] == 0


def test_http_stream_matches_generate_and_jax(jax_gen, port_gen):
    """/stream's NDJSON windows, concatenated, equal /generate of the same
    request and the JAX package's server's /stream; /healthz counts the
    stream and its windows."""
    from gesture2vec_tpu.serve.server import serve as jax_serve

    words, d = REQUESTS[1]
    req = {"words": words, "duration_s": d}
    with _serving(port_gen, batch_window_s=0.02) as (port, _):
        code, body = _post(port, "/stream", req)
        assert code == 200
        windows, done = _stream_windows(body)
        code, gen_body = _post(port, "/generate", {**req, "format": "json"})
        assert code == 200
        health = _get(port, "/healthz")
    assert done == {"done": True, "windows": 3}
    assert [w["window"] for w in windows] == [0, 1, 2]
    assert [(w["t0_s"], w["t1_s"]) for w in windows] == \
        [(i * UNIT, (i + 1) * UNIT) for i in range(3)]
    got = (np.concatenate([_frames(w) for w in windows]),
           np.concatenate([w["tokens"] for w in windows]).astype(np.int32))
    out = json.loads(gen_body)
    _assert_same(got, (_frames(out), np.asarray(out["tokens"], np.int32)))
    assert (health["streams"], health["stream_windows"]) == (1, 3)

    httpd = jax_serve(jax_gen, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, jax_body = _post(httpd.server_address[1], "/stream", req)
    finally:
        httpd.shutdown()
        httpd.worker.close()
        httpd.server_close()
        t.join(timeout=10)
    assert code == 200
    jax_windows, jax_done = _stream_windows(jax_body)
    assert jax_done == done
    assert [{k: v for k, v in w.items() if k != "frames_b64"}
            for w in windows] == [{k: v for k, v in w.items()
                                   if k != "frames_b64"}
                                  for w in jax_windows]
    for w, jw in zip(windows, jax_windows):
        np.testing.assert_allclose(_frames(w), _frames(jw), atol=ATOL)


def test_http_streams_through_the_batcher(port_gen):
    """Three concurrent /stream requests with stream_batch 4: each equals
    its unbatched stream, and /healthz reports the batcher's batches."""
    with _serving(port_gen, stream_batch=4,
                  stream_batch_window_s=0.5) as (port, _):
        bodies = _concurrently(lambda i: _post(
            port, "/stream", {"words": REQUESTS[i][0],
                              "duration_s": REQUESTS[i][1]}), 3)
        health = _get(port, "/healthz")
    assert health["stream_batches"] >= 1
    assert health["stream_batched_calls"] >= 2
    for (words, d), (code, body) in zip(REQUESTS, bodies):
        assert code == 200
        windows, done = _stream_windows(body)
        assert done["windows"] == len(windows) == int(np.ceil(d / UNIT))
        got = (np.concatenate([_frames(w) for w in windows]),
               np.concatenate([w["tokens"] for w in windows])
               .astype(np.int32))
        _assert_same(got, port_gen.generate(words, d))


def test_http_lone_stream_does_not_wait_for_peers(port_gen):
    """A lone /stream goes through the stream-step batcher (decode mode,
    the default cap) and runs each step at once: a 30 s collection
    window is never waited out."""
    words, d = REQUESTS[0]
    with _serving(port_gen, stream_batch_window_s=30.0) as (port, httpd):
        t0 = time.monotonic()
        code, body = _post(port, "/stream", {"words": words,
                                             "duration_s": d})
        secs = time.monotonic() - t0
        health = _get(port, "/healthz")
        assert httpd.stream_programs.batcher.max_batch == 16
    assert code == 200 and secs < 20
    windows, done = _stream_windows(body)
    assert done == {"done": True, "windows": 6}
    assert (health["stream_batches"], health["stream_batched_calls"]) == \
        (6, 0)
    _assert_same((np.concatenate([_frames(w) for w in windows]),
                  np.concatenate([w["tokens"] for w in windows])
                  .astype(np.int32)), port_gen.generate(words, d))


# -- backpressure, cancellation, shutdown ------------------------------------
class _GatedGen:
    """A generator whose calls signal entry and wait for an explicit
    release, so the tests synchronise on events instead of sleeps."""

    chunk_continuity = False

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def _one(self):
        return np.zeros((4, 3), np.float32), np.zeros(2, np.int32)

    def _gate(self):
        self.entered.set()
        assert self.release.wait(30)
        self.release.clear()
        self.entered.clear()

    def generate(self, words, duration_s):
        self._gate()
        return self._one()

    def generate_batch(self, transcripts, durations_s):
        self._gate()
        return [self._one() for _ in transcripts]


def _wait(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def test_backpressure_429_and_cancellation():
    gen = _GatedGen()
    with _serving(gen, max_batch=1, batch_window_s=0.01,
                  export_bvh=None) as (port, httpd):
        w = httpd.worker
        threads = [threading.Thread(target=lambda: w.submit([], 1.0, 30),
                                    daemon=True) for _ in range(5)]
        threads[0].start()                  # the one in generate
        assert gen.entered.wait(10)
        for t in threads[1:]:               # the queue's 4 places
            t.start()
        assert _wait(w._q.full)
        with pytest.raises(QueueFullError):
            w.submit([], 1.0)
        code, body = _post(port, "/generate", {"words": _words(2.0),
                                               "format": "json"})
        assert (code, json.loads(body)) == (429, {"error":
                                                  "server overloaded"})
        assert w.stats["rejected"] == 2
        # drain: each release lets one request through
        for _ in range(5):
            gen.release.set()
            assert _wait(lambda: not gen.release.is_set())
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert _wait(lambda: w.stats["requests"] == 5)
        # a submit that times out is cancelled and never generated
        t = threading.Thread(target=lambda: w.submit([], 1.0, 30),
                             daemon=True)
        t.start()
        assert gen.entered.wait(10)
        with pytest.raises(TimeoutError):
            w.submit([], 1.0, timeout_s=0.05)
        assert w.stats["cancelled"] == 1
        gen.release.set()
        t.join(timeout=10)
        assert _wait(lambda: w._q.empty() and not gen.entered.is_set())
        time.sleep(0.3)                     # a collector pass or more
        assert w.stats["requests"] == 6
        gen.release.set()


def test_close_fails_queued_requests_fast():
    gen = _GatedGen()
    w = BatchingWorker(gen, max_batch=1, batch_window_s=0.01)
    errors = []

    def call():
        try:
            w.submit([], 1.0, timeout_s=30.0)
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=call, daemon=True)
               for _ in range(3)]
    threads[0].start()
    assert gen.entered.wait(10)
    for t in threads[1:]:
        t.start()
    assert _wait(lambda: w._q.qsize() == 2)
    t0 = time.monotonic()
    # close while the first request is generating, then let it finish:
    # the collector stops after it and the two queued requests fail
    closer = threading.Thread(target=w.close)
    closer.start()
    assert _wait(w._stop.is_set)
    gen.release.set()
    for t in threads + [closer]:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads + [closer])
    assert time.monotonic() - t0 < 10
    assert errors == ["server shutting down"] * 2
    with pytest.raises(RuntimeError, match="shutting down"):
        w.submit([], 1.0)


def test_bucket_and_nearest_rank():
    from gesture2vec_tpu.serve.server import BatchingWorker as JaxWorker
    from gesture2vec_tpu.serve.server import nearest_rank as jax_rank

    cases = [(n, cap) for cap in (1, 8, 16, 32) for n in range(1, cap + 1)]
    assert [BatchingWorker._bucket(n, c) for n, c in cases] == \
        [JaxWorker._bucket(n, c) for n, c in cases]
    assert [BatchingWorker._bucket(n, 16) for n in (2, 3, 5, 9, 16)] == \
        [2, 4, 8, 16, 16]
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        v = rng.random(n).tolist()
        for q in (0.0, 0.5, 0.99, 1.0):
            assert nearest_rank(v, q) == jax_rank(v, q)
    assert nearest_rank([3.0, 1.0, 2.0], 0.5) == 2.0


# -- the serve command ---------------------------------------------------------
def test_serve_cli_refuses_mesh_and_needs_a_card(monkeypatch, tmp_path):
    from gesture2vec_tpu_torch.cli import serve as cli

    args = ["t2t.bin", "dae.bin", "vq.bin", "--store", str(tmp_path),
            "--pipeline", "pipe.json"]
    # --mesh, once refused, is read: the command fails only at the empty
    # store, and a mesh the cards cannot hold raises before any file
    with pytest.raises(FileNotFoundError):
        cli.main(args + ["--mesh", "dp=2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        cli.main(args + ["--mesh", "dp=2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args + ["--device", "cuda"])
    parser = cli.build_parser()
    assert parser.parse_args(args).mode == "decode"
    assert parser.parse_args(args).device == "cuda"


# -- the kernel layer under threads --------------------------------------------
def test_concurrent_load_builds_once(monkeypatch, tmp_path):
    """Eight threads ask for one kernel library at once: one build, one
    load, the same library for all."""
    from gesture2vec_tpu_torch.ops import build

    builds, lib = [], tmp_path / "lib.so"

    def build_all():
        builds.append(threading.get_ident())
        time.sleep(0.2)                     # a slow nvcc
        lib.write_bytes(b"")

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    monkeypatch.setattr(build, "build_all", build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    got = _concurrently(lambda i: build.load("chunk_decoder"), 8)
    assert len(builds) == 1
    assert all(g is got[0] for g in got)


def test_launch_counts_under_threads(monkeypatch):
    """count_launch from 16 threads with a short switch interval: no
    count is lost."""
    from gesture2vec_tpu_torch.ops.build import count_launch
    from gesture2vec_tpu_torch.ops.decoder_kernel import fused_chunk_decode

    monkeypatch.setattr(fused_chunk_decode, "launches", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _concurrently(lambda i: [count_launch(fused_chunk_decode)
                                 for _ in range(2000)], 16)
    finally:
        sys.setswitchinterval(interval)
    assert fused_chunk_decode.launches == 16 * 2000
