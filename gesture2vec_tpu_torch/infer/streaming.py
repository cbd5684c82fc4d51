"""Streaming text -> gesture inference: motion window by window as the
words arrive.

Port of the JAX package's `infer/streaming.py` (StreamingGestureSession,
build_streaming_step, StreamStepBatcher, and for speech
AudioStreamingGestureSession and build_audio_streaming_step). A live
avatar gets its words with the speech, so a session
takes the words seen so far and gives the motion of every window that
is complete, with the batch path's cross-window teacher seed (and, with
chunk_continuity, its seed frame) carried from one push to the next.

The streamed window is the batch path cut at window boundaries, not a
copy of it: the step calls GestureGenerator._predict_windows with the
carried seed and _decode_chunks with the carried frame, so a streamed
decode equals `generate` on the same words. The step runs over a leading
batch of sessions: a session calls it with one row, and the
StreamStepBatcher stacks the due rows of many sessions into one call
(one chunk-decoder launch for all of them). Each row keeps its own mask,
seed, carry and Gumbel noise, so a row's result does not depend on the
rows beside it.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class StreamingGestureSession:
    """Incremental generation over one transcript.

    Built from a configured GestureGenerator (mode, decode policy and
    seed are honoured). Typical use::

        sess = StreamingGestureSession(gen)
        for words_so_far, now_s in live_captions():
            for frames, tokens in sess.push(words_so_far, now_s):
                play(frames)                      # one window
        for frames, tokens in sess.finish(total_duration_s):
            play(frames)

    push(words, now_s) emits every window whose time range ends by now_s;
    finish(duration_s) emits the rest up to the batch path's
    ceil(duration_s / window) windows. Words for windows already emitted
    are ignored (they are in the past).
    """

    def __init__(self, generator, step=None):
        g = self.gen = generator
        self.unit = g.sentence_frame_length / g.fps
        self.n_steps = g.n_steps
        self._next_window = 0
        self._seed = torch.zeros((self.n_steps,), dtype=torch.long,
                                 device=g.device)
        # decode mode: the seed frame of the next chunk (used with
        # chunk_continuity); exemplar mode: the previous pick, -1 = none
        if g.mode == "exemplar":
            self._prev_last = np.int32(-1)
        else:
            self._prev_last = torch.zeros((g.seq_decoder.rep_dim,),
                                          dtype=torch.float32,
                                          device=g.device)
        self._words: List[List] = []
        # a step shared by many sessions (build_streaming_step(gen) or a
        # StreamStepBatcher's step)
        self._step = step or build_streaming_step(g)

    def push(self, words: List[List], now_s: float
             ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Feed the words seen so far (cumulative [[word, start_s, end_s],
        ...]) and the stream time. Returns one (frames, tokens) pair per
        newly completed window (time range <= now_s), possibly none."""
        self._words = list(words)
        out = []
        while (self._next_window + 1) * self.unit <= now_s + 1e-9:
            out.append(self._emit(self._next_window))
            self._next_window += 1
        return out

    def finish(self, duration_s: Optional[float] = None
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Emit the remaining windows up to ceil(duration_s / unit)
        (default: the last word's end), as the batch path counts them."""
        if duration_s is None:
            duration_s = self._words[-1][2] if self._words else self.unit
        n_windows = max(int(np.ceil(duration_s / self.unit)), 1)
        out = []
        while self._next_window < n_windows:
            out.append(self._emit(self._next_window))
            self._next_window += 1
        return out

    def _emit(self, w: int) -> Tuple[np.ndarray, np.ndarray]:
        g = self.gen
        ids, length = g._window_word_ids(self._words, w * self.unit,
                                         (w + 1) * self.unit)
        # one draw from the generator's numpy stream per window (none when
        # greedy), as the JAX session draws its window key
        generator = g._next_generator()
        frames, toks, seed, prev = self._step(
            torch.from_numpy(ids[None]).to(g.device),
            torch.tensor([length], device=g.device), self._seed[None],
            self._prev_last[None], [generator])
        self._seed, self._prev_last = seed[0], prev[0]
        return g._frames(frames[0]), toks[0].to(torch.int32).cpu().numpy()


def build_streaming_step(g):
    """The per-window step of a GestureGenerator, over a leading batch of
    B sessions: (word_ids (B, max_words), length (B,), seed_tokens
    (B, n_steps), prev_last, generators) -> (frames (B, window frames,
    pose_dim) normalised, tokens (B, n_steps), next_seed (B, n_steps),
    next_prev_last). prev_last is (B, rep_dim) on the device in decode
    mode and the previous picks (B,) in numpy in exemplar mode;
    generators holds each row's noise generator (None when greedy)."""
    if g.mode == "decode" and g.decode_overlap:
        raise ValueError("decode_overlap is not supported by the "
                         "streaming session (the crossfade needs "
                         "the next chunk's head before emitting); "
                         "use chunk_continuity for streamed decode")

    def predict(word_ids, length, seed_tokens,
                generators: Sequence[Optional[torch.Generator]]):
        noise = None
        if generators[0] is not None:
            # each row's noise from its own generator, drawn on the host
            noise = torch.cat([g._noise(r, (1, 1)) for r in generators])
        return g._predict_windows(word_ids[:, None], length[:, None], noise,
                                  seed=seed_tokens)

    if g.mode == "decode":
        continuity = bool(g.chunk_continuity)

        @torch.inference_mode()
        def step(word_ids, length, seed_tokens, prev_last, generators):
            pred = predict(word_ids, length, seed_tokens, generators)
            latents = g._decode_chunks(pred,
                                       prev_last if continuity else None)
            B, T = latents.shape[:2]
            frames = g.dae_model.decode(latents.flatten(0, 1)).reshape(
                B, T, -1)
            return (frames, pred["tokens"], pred["next_seed"],
                    latents[:, -1] if continuity else prev_last)

        return step

    # exemplar mode: tokens on the device, picks on the host, then the
    # bank gather and DAE decode
    bank = g._exemplars

    @torch.inference_mode()
    def step(word_ids, length, seed_tokens, prev_last, generators):
        pred = predict(word_ids, length, seed_tokens, generators)
        toks = pred["tokens"].to(torch.int32).cpu().numpy()
        last = np.array(prev_last, np.int32).reshape(-1)
        picks = []
        for b, t in enumerate(toks):
            if g.exemplar_continuity:
                picks.append(bank.pick_indices_continuity(
                    t, prev_pick=int(last[b])))
                last[b] = picks[-1][-1]
            else:
                picks.append(bank.pick_indices(t))
        frames = g._exemplar_decode(np.concatenate(picks))
        return (frames.reshape(len(toks), -1, frames.shape[-1]),
                pred["tokens"], pred["next_seed"], last)

    return step


class StreamStepBatcher:
    """Continuous batching of concurrent streaming sessions (decode mode):
    the due window steps of live sessions run as one batched step, so one
    chunk-decoder launch serves them all. `step` has the signature of
    build_streaming_step(gen)'s step for one row
    (StreamingGestureSession(gen, step=batcher.step)): calls queue for up
    to `window_s`; the collector stacks up to `max_batch` of them on the
    device, pads to a power-of-two bucket with copies of row 0 (their
    results are dropped; the buckets bound the chunk batches the kernel
    sees) and runs the step once. Each caller gets the result of its own
    unbatched step: rows never mix. A stream that runs its steps inside
    `session()` is counted live, and the collector stops waiting as soon
    as every live stream's step is in: a lone stream's step runs at once.

    Decode mode only: the exemplar step picks on the host between two
    device calls, so an exemplar generator is refused."""

    _WAKE = object()    # a session ended: the collector re-reads _want

    def __init__(self, generator, max_batch: int = 16,
                 window_s: float = 0.01):
        if generator.mode != "decode":
            raise ValueError("StreamStepBatcher supports decode mode "
                             "only (the exemplar step retrieves on "
                             "host mid-step)")
        self.gen = generator
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self.stats = {"calls": 0, "batches": 0, "batched_calls": 0}
        self._base_step = build_streaming_step(generator)
        self._live = 0
        self._live_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # set while the collector holds a batch open in its window (a
        # synchronisation point for shutdown tests and diagnostics)
        self.collecting = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the collector (a batch it already holds still runs) and
        fail every caller still queued."""
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=5)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and item is not self._WAKE:
                item[0]["error"] = RuntimeError("batcher closed")
                item[0]["done"].set()

    @contextlib.contextmanager
    def session(self):
        """Count one live stream while the block runs: the collector
        waits for no more steps than there are live streams."""
        with self._live_lock:
            self._live += 1
        try:
            yield
        finally:
            with self._live_lock:
                self._live -= 1
            self._q.put(self._WAKE)

    def _want(self) -> int:
        """The batch the collector waits for: every live stream (no
        stream counted: the cap), at most max_batch."""
        return min(self._live or self.max_batch, self.max_batch)

    def step(self, word_ids, length, seed_tokens, prev_last, generators):
        """The arguments and results of build_streaming_step(gen)'s step
        for one row; blocks until the batch holding this call ran."""
        if self._stop.is_set():
            raise RuntimeError("batcher closed")
        slot = {"done": threading.Event()}
        self._q.put((slot, (word_ids, length, seed_tokens, prev_last,
                            generators)))
        slot["done"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _run(self) -> None:
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                return
            if first is self._WAKE:
                continue
            batch = [first]
            self.collecting.set()
            deadline = time.monotonic() + self.window_s
            stopping = False
            while len(batch) < self._want():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    # the shutdown sentinel mid-collection: run the batch
                    # already collected, then exit
                    stopping = True
                    break
                if item is not self._WAKE:
                    batch.append(item)
            try:
                self._execute(batch)
            except Exception as e:  # deliver the failure to every caller
                for slot, _ in batch:
                    slot["error"] = e
                    slot["done"].set()
            self.collecting.clear()
            if stopping:
                return

    def _execute(self, batch) -> None:
        n = len(batch)
        self.stats["calls"] += n
        self.stats["batches"] += 1
        if n == 1:
            slot, args = batch[0]
            slot["result"] = self._base_step(*args)
            slot["done"].set()
            return
        self.stats["batched_calls"] += n
        rows = [args for _, args in batch]
        rows += [rows[0]] * (self._bucket(n) - n)
        word_ids, length, seed, prev = (torch.cat([r[i] for r in rows])
                                        for i in range(4))
        # the padding rows draw from row 0's generator after row 0 has
        # drawn; a session draws a fresh generator every window
        generators = [gen for r in rows for gen in r[4]]
        outs = self._base_step(word_ids, length, seed, prev, generators)
        for i, (slot, _) in enumerate(batch):
            slot["result"] = tuple(o[i:i + 1] for o in outs)
            slot["done"].set()


class AudioStreamingGestureSession:
    """Incremental speech -> gesture over one live audio stream, from a
    configured AudioGestureGenerator: push the waveform captured so far
    (cumulative mono float at audio_sr; with fusion "both" also the
    words so far) and get the motion of every window it completes, with
    the teacher seed (and in exemplar mode the continuity pick) carried
    from window to window. Its windows are `generate`'s on the same audio
    under greedy and beam decodes; a sampled window draws its own
    generator from the numpy stream (as the JAX session draws a key per
    window), and the rollout takes no decode_overlap (as in JAX). One
    step (`build_audio_streaming_step`) may serve many sessions; they
    run one window at a time (the JAX package batches no audio
    streams)."""

    def __init__(self, generator, step=None):
        g = self.gen = generator
        self.unit = g.sentence_frame_length / g.fps
        self.n_steps = g.n_steps
        self._next_window = 0
        self._seed = torch.zeros((1, self.n_steps), dtype=torch.long,
                                 device=g.device)
        self._prev_pick = np.int32(-1)
        self._audio = np.zeros((0,), np.float32)
        self._words: List[List] = []
        self._step = step or build_audio_streaming_step(g)

    def push(self, audio: np.ndarray, now_s: Optional[float] = None,
             words: Optional[List[List]] = None
             ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """audio: the cumulative waveform so far; now_s defaults to its
        length. Returns one (frames, tokens) per newly completed window."""
        self._audio = np.asarray(audio, np.float32)
        if words is not None:
            self._words = list(words)
        if now_s is None:
            now_s = len(self._audio) / self.gen.audio_sr
        out = []
        while (self._next_window + 1) * self.unit <= now_s + 1e-9:
            out.append(self._emit(self._next_window))
            self._next_window += 1
        return out

    def finish(self, duration_s: Optional[float] = None
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The remaining windows up to ceil(duration_s / window) (default:
        the audio's length), as `generate` counts them."""
        if duration_s is None:
            duration_s = len(self._audio) / self.gen.audio_sr
        n_windows = max(int(np.ceil(duration_s / self.unit)), 1)
        out = []
        while self._next_window < n_windows:
            out.append(self._emit(self._next_window))
            self._next_window += 1
        return out

    def _emit(self, w: int) -> Tuple[np.ndarray, np.ndarray]:
        g = self.gen
        samples = g.window_seconds * g.audio_sr
        seg = self._audio[w * samples:(w + 1) * samples]
        enc_in = g.encoder_inputs(seg, 1, self._shifted_words(w))
        frames, toks, self._seed, self._prev_pick = self._step(
            enc_in, self._seed, self._prev_pick, g._next_generator())
        return g._frames(frames), toks.to(torch.int32).cpu().numpy()

    def _shifted_words(self, w: int) -> Optional[List[List]]:
        """The words with times relative to window w's start (fusion
        "both"), so that window 0 of the encoder inputs is window w."""
        if self.gen.fusion != "both":
            return None
        t0 = w * self.unit
        return [[word, s - t0, e - t0] for word, s, e in self._words]


def build_audio_streaming_step(g):
    """The per-window step of an AudioGestureGenerator: (encoder inputs of
    one window (`encoder_inputs(seg, 1, words)`), seed_tokens (1,
    n_steps), prev_pick, generator or None) -> (frames (window frames,
    pose_dim) normalised, tokens (n_steps,), next_seed, next prev_pick).
    Shared by any number of sessions."""

    @torch.inference_mode()
    def step(enc_in, seed_tokens, prev_pick, generator):
        pred = g._predict(enc_in, g._noise(generator, (1, 1)),
                          seed=seed_tokens)
        toks = pred["tokens"][0]
        if g.mode == "decode":
            latents = g._decode_chunks(pred, overlap=0)[0]
            return (g.dae_model.decode(latents), toks, pred["next_seed"],
                    prev_pick)
        t = toks.to(torch.int32).cpu().numpy()
        if g.exemplar_continuity:
            picks = g._exemplars.pick_indices_continuity(
                t, prev_pick=int(prev_pick))
            prev_pick = np.int32(picks[-1])
        else:
            picks = g._exemplars.pick_indices(t)
        return g._exemplar_decode(picks), toks, pred["next_seed"], prev_pick

    return step
