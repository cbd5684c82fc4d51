"""PyTorch port vs the JAX package: streaming sessions and the stream-step
batcher.

The same seeded numpy weights go through the JAX GestureGenerator (made by
`bench.build_generator` at small widths, weights perturbed) and the port's
(compat/from_jax). Both packages' StreamingGestureSession get the same
words in three pushes and a finish. Tokens must be identical, frames
within 1e-5 (fp32 on both sides, sums in another order). Exemplar picks
come from the generators' numpy streams, which both consume in the same
order, so they are identical too.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
from gesture2vec_tpu_torch.infer.streaming import (StreamingGestureSession,
                                                   StreamStepBatcher,
                                                   build_streaming_step)
from gesture2vec_tpu_torch.text.vocab import Vocab

ATOL = 1e-5
HID, REP, K, DIM, NF, SENT, FPS, MAXW = 16, 8, 32, 12, 4, 24, 20, 10
N_WORDS, WORDEMBED, VOCAB_WORDS = 60, 12, 40
N_STEPS = SENT // NF
UNIT = SENT / FPS   # 1.2 s windows
DURATION = 7.0      # 6 windows


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


def _vocab():
    v = Vocab("bench")
    for i in range(VOCAB_WORDS):
        v.index_word(f"word{i}")
    return v


_BASE = {}


def _jax_base(model):
    """An exemplar-mode JAX generator at small widths with perturbed
    weights and a 300-window bank: the TCN Part d ("tcn") or the
    recommended recipe's 4-stage stage-conditional transformer over a
    4-stage residual-VQ tokenizer ("recipe"). One per model, shared by the
    tests of this file."""
    if model not in _BASE:
        from bench import build_generator

        extra = {} if model == "tcn" else dict(
            token_stages=4, stage_conditional=True, t2t_arch="transformer")
        g = build_generator(hid=HID, rep=REP, k=K, dim=DIM, n_frames=NF,
                            sent_len=SENT, n_words=N_WORDS, max_words=MAXW,
                            wordembed=WORDEMBED, vocab_words=VOCAB_WORDS,
                            fps=FPS, mode="exemplar", bank_windows=300,
                            **extra)
        rng = np.random.default_rng(7)
        _BASE[model] = dataclasses.replace(
            g, t2t_variables=perturb(_np(g.t2t_variables), rng),
            seq_variables=perturb(_np(g.seq_variables), rng),
            dae_variables=perturb(_np(g.dae_variables), rng),
            pose_mean=rng.normal(size=DIM).astype(np.float32),
            pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32))
    return _BASE[model]


def _jax_gen(model="tcn", mode="decode", **kw):
    return dataclasses.replace(_jax_base(model), mode=mode, **kw)


def _port(model="tcn", mode="decode", device="cpu", **kw):
    g = _jax_base(model)
    return generator_from_jax(
        g.t2t_variables, g.seq_variables, g.dae_variables, _vocab(),
        g.pose_mean, g.pose_std, n_frames=NF, sentence_frame_length=SENT,
        fps=FPS, max_words=MAXW, latent_bank=g.latent_bank, device=device,
        mode=mode, seed=0, **kw)


def _stream_all(sess, words, duration_s, chunks=3):
    """Words in `chunks` pushes (each at its last word's end), then
    finish: (frames, tokens) of all windows, concatenated."""
    out = []
    n = len(words)
    for i in range(chunks):
        upto = (i + 1) * n // chunks
        out += sess.push(words[:upto], words[upto - 1][2])
    out += sess.finish(duration_s)
    return (np.concatenate([f for f, _ in out]),
            np.concatenate([t for _, t in out]))


_JAX_STREAMS = {}


def _jax_stream(model, mode, **kw):
    """The JAX package's own session over _words(DURATION) (one per
    configuration: each compiles its window program)."""
    from gesture2vec_tpu.infer.streaming import \
        StreamingGestureSession as JaxSession

    key = (model, mode, tuple(sorted(kw.items())))
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = _stream_all(
            JaxSession(_jax_gen(model, mode, **kw)), _words(DURATION),
            DURATION)
    return _JAX_STREAMS[key]


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


# (model, mode, the JAX generator's options, the port's options)
CASES = {
    "greedy": ("tcn", "decode", {}, {}),
    "chunk_continuity": ("tcn", "decode", {"chunk_continuity": True},
                         {"chunk_continuity": True}),
    "soft_decode": ("tcn", "decode", {"soft_decode": 1.0},
                    {"soft_decode": 1.0}),
    # the port's beam of width 1 against JAX's greedy stream
    "beam1_is_greedy": ("tcn", "decode", {}, {"beam_width": 1}),
    "beam3": ("tcn", "decode", {"beam_width": 3}, {"beam_width": 3}),
    "exemplar_uniform": ("tcn", "exemplar", {}, {}),
    "exemplar_continuity": ("tcn", "exemplar", {"exemplar_continuity": True},
                            {"exemplar_continuity": True}),
    "recipe_greedy": ("recipe", "decode", {}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax(case):
    model, mode, jax_kw, port_kw = CASES[case]
    want = _jax_stream(model, mode, **jax_kw)
    port = _port(model, mode, **port_kw)
    got = _stream_all(StreamingGestureSession(port), _words(DURATION),
                      DURATION)
    assert got[1].shape == (6 * N_STEPS,)
    assert got[0].shape == (6 * SENT, DIM)
    _assert_same(got, want)
    assert len(np.unique(got[1])) > 3


def test_recipe_stage0_policy_primary_tokens_are_greedy():
    """The recipe's chain with stage0_temperature 0 and temperature 1.5:
    the primary tokens are the greedy ones (JAX's greedy stream), only the
    residual stages sample, so the frames move."""
    greedy = _jax_stream("recipe", "decode")
    port = _port("recipe", temperature=1.5, stage0_temperature=0.0)
    frames, toks = _stream_all(StreamingGestureSession(port),
                               _words(DURATION), DURATION)
    np.testing.assert_array_equal(toks, greedy[1])
    assert np.isfinite(frames).all()
    assert np.abs(frames - greedy[0]).max() > 1e-3


@pytest.mark.parametrize("case", ["greedy", "chunk_continuity",
                                  "soft_decode", "exemplar_continuity",
                                  "recipe_greedy"])
def test_stream_equals_generate(case):
    """The streamed windows, concatenated, are the port's own `generate`
    on the same words (the batch path cut at window boundaries)."""
    model, mode, _, kw = CASES[case]
    got = _stream_all(StreamingGestureSession(_port(model, mode, **kw)),
                      _words(DURATION), DURATION)
    _assert_same(got, _port(model, mode, **kw).generate(_words(DURATION),
                                                        DURATION))


def test_incremental_emission():
    """A window is emitted once its range has ended; finish() emits the
    rest; words pushed later still reach future windows."""
    words = _words(DURATION)
    sess = StreamingGestureSession(_port())
    assert sess.push(words[:2], now_s=1.0) == []            # window 0 open
    first = sess.push(words[:4], now_s=UNIT)                # window 0 done
    assert len(first) == 1
    frames0, toks0 = first[0]
    assert toks0.shape == (N_STEPS,) and toks0.dtype == np.int32
    assert frames0.shape == (SENT, DIM)
    assert sess.push(words, now_s=2 * UNIT + 0.5) != []     # window 1
    rest = sess.finish(DURATION)
    assert len(rest) == 4 and all(np.isfinite(f).all() for f, _ in rest)
    assert sess.finish(DURATION) == []


def test_decode_overlap_raises_as_jax():
    from gesture2vec_tpu.infer.streaming import \
        build_streaming_step as jax_build

    with pytest.raises(ValueError) as want:
        jax_build(_jax_gen(decode_overlap=2))
    with pytest.raises(ValueError) as got:
        build_streaming_step(_port(decode_overlap=2))
    assert str(got.value) == str(want.value)


# -- the stream-step batcher --------------------------------------------------
def _unbatched(gen, transcripts):
    out = {}
    for name, words in transcripts.items():
        sess = StreamingGestureSession(gen)
        sess.push(words, now_s=0.0)
        out[name] = sess.finish(DURATION)
    return out


@pytest.mark.parametrize("kw", [{}, {"chunk_continuity": True}])
def test_batcher_matches_unbatched(kw):
    """Three sessions on threads through one batcher (bucket 4, one row
    of padding) give their unbatched windows; carries never mix."""
    gen = _port(**kw)
    transcripts = {"a": _words(DURATION), "b": _words(DURATION, 1),
                   "c": _words(DURATION)[:4]}
    want = _unbatched(gen, transcripts)
    batcher = StreamStepBatcher(gen, max_batch=4, window_s=0.2)
    got, threads = {}, []
    try:
        def drive(name):
            sess = StreamingGestureSession(gen, step=batcher.step)
            sess.push(transcripts[name], now_s=0.0)
            got[name] = sess.finish(DURATION)

        threads = [threading.Thread(target=drive, args=(n,))
                   for n in transcripts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert sorted(got) == sorted(transcripts)
        for name in transcripts:
            assert len(got[name]) == len(want[name]) == 6
            for (f, t), (wf, wt) in zip(got[name], want[name]):
                np.testing.assert_array_equal(t, wt)
                np.testing.assert_allclose(f, wf, atol=ATOL)
        assert batcher.stats["calls"] == 18
        assert batcher.stats["batched_calls"] >= 2
    finally:
        batcher.close()


@pytest.mark.parametrize("sessions", [1, 3])
def test_batcher_waits_only_for_live_sessions(sessions):
    """Sessions that step inside `batcher.session()` never wait out the
    collection window (30 s here): the collector runs a batch once every
    live session's step is in, and a lone session's step at once. Each
    session still gets its unbatched windows."""
    gen = _port()
    transcripts = {i: _words(DURATION, i) for i in range(sessions)}
    want = _unbatched(gen, transcripts)
    batcher = StreamStepBatcher(gen, max_batch=4, window_s=30.0)
    got, threads = {}, []
    try:
        def drive(name):
            with batcher.session():
                sess = StreamingGestureSession(gen, step=batcher.step)
                sess.push(transcripts[name], now_s=0.0)
                got[name] = sess.finish(DURATION)

        threads = [threading.Thread(target=drive, args=(n,))
                   for n in transcripts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in threads)
        for name in transcripts:
            for (f, t), (wf, wt) in zip(got[name], want[name]):
                np.testing.assert_array_equal(t, wt)
                np.testing.assert_allclose(f, wf, atol=ATOL)
        assert batcher.stats["calls"] == 6 * sessions
        assert batcher._live == 0
    finally:
        batcher.close()


def test_batcher_close_unblocks_and_refuses_exemplar():
    """close(): the batch the collector already holds still runs, a step
    after close raises; an exemplar generator is refused."""
    gen = _port()
    batcher = StreamStepBatcher(gen, max_batch=4, window_s=30.0)
    sess = StreamingGestureSession(gen, step=batcher.step)
    sess.push(_words(DURATION), now_s=0.0)
    out = {}
    t = threading.Thread(target=lambda: out.update(res=sess.finish(UNIT)))
    t.start()
    assert batcher.collecting.wait(timeout=60), "step never reached the " \
        "batch window"
    batcher.close()
    t.join(timeout=60)
    assert not t.is_alive(), "caller stayed blocked through close()"
    assert len(out["res"]) == 1 and np.isfinite(out["res"][0][0]).all()
    with pytest.raises(RuntimeError, match="batcher closed"):
        batcher.step(None, None, None, None, [None])
    with pytest.raises(ValueError, match="decode mode"):
        StreamStepBatcher(_port(mode="exemplar"))


# -- on the card ------------------------------------------------------------
def _http_stream(port, words, duration_s):
    """(frames, tokens) of a POST /stream, its windows concatenated."""
    import base64
    import json
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/stream", data=json.dumps(
            {"words": words, "duration_s": duration_s}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        lines = [json.loads(ln) for ln in r.read().splitlines() if ln]
    assert lines[-1] == {"done": True, "windows": len(lines) - 1}
    return (np.concatenate([np.frombuffer(base64.b64decode(
        w["frames_b64"]), np.float32).reshape(w["frames_shape"])
        for w in lines[:-1]]),
        np.concatenate([w["tokens"] for w in lines[:-1]]).astype(np.int32))


def _torch_generator(device):
    """A decode-mode generator of the port's own modules at this file's
    widths, weights random from a seed (no JAX model: the card's machine
    has no flax)."""
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from gesture2vec_tpu_torch.models.text2token import Text2Token

    with torch.random.fork_rng(devices=[]), torch.no_grad():
        torch.manual_seed(7)
        models = (Text2Token(n_words=N_WORDS, n_tokens=K, hidden_size=HID,
                             n_layers=2, n_steps=N_STEPS,
                             word_embed_size=WORDEMBED),
                  SeqDecoder(rep_dim=REP, hidden_size=HID, n_layers=2,
                             n_frames=NF, n_codes=K), DAE(DIM, REP))
        for m in models:
            for p in m.parameters():
                p.add_(0.5 * torch.randn(p.shape))
    return GestureGenerator(
        t2t_model=models[0], seq_decoder=models[1], dae_model=models[2],
        vocab=_vocab(), pose_mean=np.zeros(DIM, np.float32),
        pose_std=np.ones(DIM, np.float32), n_frames=NF,
        sentence_frame_length=SENT, fps=FPS, max_words=MAXW, mode="decode",
        device=device)


@pytest.mark.gpu
def test_threaded_sessions_on_card():
    """Sessions on four threads on the card: alone, through the batcher,
    and as /stream requests to serve() with and without stream batching.
    Each equals the card's `generate` on its words (tokens identical,
    frames within 1e-4: the chunk decoder runs them at other batch
    sizes, whose tiles sum in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the chunk-decoder kernel has no CPU "
                    "mode)")
    from gesture2vec_tpu_torch.serve.server import serve

    gen = _torch_generator("cuda")
    transcripts = {i: _words(DURATION, i) for i in range(4)}
    want = {i: gen.generate(w, DURATION) for i, w in transcripts.items()}

    def on_threads(run):
        got = {}
        threads = [threading.Thread(target=lambda i=i: got.update(
            {i: run(i)})) for i in transcripts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert sorted(got) == sorted(transcripts)
        for i in transcripts:
            np.testing.assert_array_equal(got[i][1], want[i][1])
            np.testing.assert_allclose(got[i][0], want[i][0], atol=1e-4)

    batcher = StreamStepBatcher(gen, max_batch=4, window_s=0.05)
    try:
        for step in (None, batcher.step):
            on_threads(lambda i, step=step: _stream_all(
                StreamingGestureSession(gen, step=step), transcripts[i],
                DURATION))
    finally:
        batcher.close()
    for stream_batch in (1, 4):
        httpd = serve(gen, port=0, stream_batch=stream_batch)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            on_threads(lambda i: _http_stream(httpd.server_address[1],
                                              transcripts[i], DURATION))
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=10)
