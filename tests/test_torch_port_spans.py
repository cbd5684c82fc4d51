"""The port's own spans and counters (`utils/profiling`), on the CPU at
small widths: the names and the nesting `generate_batch` records under a
profiler, a step's phases in order, the feed's wait, the spans' log on the
profiler's clock, nothing entered with no profiler on, and the rollout's
chunk counters."""
import contextlib

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.utils import profiling

H, K, WORDS, EMB, POSE, LATENT, MAX_WORDS = 16, 32, 60, 12, 9, 4, 8
N_POSES, SENTENCE = 20, 120
DURATIONS = [6.0, 13.0, 20.0]   # 1, 3 and 4 windows: a bucket of 4
GEN_SPANS = {"g2v.gen.call", "g2v.gen.windows", "g2v.gen.encode",
             "g2v.gen.token_loop", "g2v.gen.token_window",
             "g2v.gen.rollout", "g2v.gen.dae", "g2v.gen.tokens_to_host",
             "g2v.gen.frames_to_host", "g2v.gen.unnormalize"}


def _generator():
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from gesture2vec_tpu_torch.models.text2token import Text2Token
    from gesture2vec_tpu_torch.text.vocab import Vocab

    torch.manual_seed(0)
    t2t = Text2Token(n_words=WORDS, n_tokens=K, hidden_size=H, n_layers=2,
                     n_steps=SENTENCE // N_POSES, n_pre_poses=2,
                     word_embed_size=EMB, encoder_type="tcn",
                     use_attention=True)
    seq = SeqDecoder(LATENT, H, 2, N_POSES, K, n_pre_poses=1,
                     conditioned=True)
    vocab = Vocab("spans")
    for i in range(WORDS - 4):
        vocab.index_word(f"w{i}")
    return GestureGenerator(
        t2t_model=t2t, seq_decoder=seq, dae_model=DAE(POSE, LATENT),
        vocab=vocab, pose_mean=np.zeros(POSE, np.float32),
        pose_std=np.ones(POSE, np.float32), n_frames=N_POSES,
        sentence_frame_length=SENTENCE, fps=20, max_words=MAX_WORDS,
        mode="decode", window_carry=True, device="cpu")


def _transcripts():
    rng = np.random.default_rng(3)
    return [[[f"w{rng.integers(WORDS - 4)}", t, t + 0.3]
             for t in np.arange(0.0, d, 0.5)] for d in DURATIONS]


def _windows():
    unit = SENTENCE / 20
    return [int(np.ceil(d / unit)) for d in DURATIONS]


def _train_step():
    from gesture2vec_tpu_torch.models.seq_ae import SeqVQAutoencoder
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.optim import Adam
    from gesture2vec_tpu_torch.train.seq_ae_trainer import TrainStep

    torch.manual_seed(0)
    model = SeqVQAutoencoder(rep_dim=LATENT, hidden_size=H, n_layers=2,
                             n_frames=6, vq_components=K, n_pre_poses=1,
                             vq_variant="gssoft", conditioned=True,
                             vq_flatten="per_sample", encoder_arch="bigru",
                             use_vae=False, dropout_rate=0.0, use_vq=True)
    model.train()
    opt = Adam(model.parameters(), 5e-4)
    config = load_config({"batch_size": 4, "learning_rate": 5e-4,
                          "hidden_size": H, "n_layers": 2})
    return TrainStep(config, model, opt)


@contextlib.contextmanager
def _profiled():
    """torch.profiler's kineto profiler on the CPU, recording the
    record_function scopes (as a trace of the benchmark does); yields the
    list that gets the g2v.* events, (name, start_ns, end_ns, thread),
    in order of their start."""
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, RecordScope,
                                    _ExperimentalConfig)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    activities = {ProfilerActivity.CPU}
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    events: list = []
    try:
        yield events
    finally:
        results = _disable_profiler()
    events.extend(sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
          e.start_thread_id()) for e in results.events()
         if e.name().startswith("g2v.")), key=lambda e: e[1]))


def _inside(event, events, name):
    """The events called name that hold event, on its thread."""
    return [e for e in events if e[0] == name and e[3] == event[3]
            and e[1] <= event[1] and event[2] <= e[2]]


def test_generate_batch_records_its_spans_nested_under_the_call():
    gen, transcripts = _generator(), _transcripts()
    with _profiled() as events:
        gen.generate_batch(transcripts, DURATIONS)
    assert {e[0] for e in events} == GEN_SPANS
    calls = [e for e in events if e[0] == "g2v.gen.call"]
    assert len(calls) == 1
    windows = [e for e in events if e[0] == "g2v.gen.token_window"]
    assert len(windows) == 4          # the bucket of the longest transcript
    for w in windows:
        (loop,) = _inside(w, events, "g2v.gen.token_loop")
        assert _inside(loop, events, "g2v.gen.call") == calls
    assert all(_inside(e, events, "g2v.gen.call") == calls for e in events)


def test_generate_records_the_same_stages():
    gen, transcripts = _generator(), _transcripts()
    with _profiled() as events:
        gen.generate(transcripts[1], DURATIONS[1])
    names = [e[0] for e in events]
    assert set(names) == GEN_SPANS
    assert names.count("g2v.gen.token_window") == 4


def test_a_train_step_records_its_phases_in_order():
    step = _train_step()
    batch = torch.randn(4, 6, LATENT)
    with _profiled() as events:
        step(batch, 0.0)
    assert [e[0] for e in events] == [
        "g2v.step", "g2v.step.forward", "g2v.step.backward",
        "g2v.step.optim"]
    for e in events[1:]:
        assert _inside(e, events, "g2v.step") == events[:1]
    assert all(a[2] <= b[1] for a, b in zip(events[1:], events[2:]))


def test_the_feed_records_its_wait():
    from gesture2vec_tpu_torch.utils.prefetch import prefetch

    with _profiled() as events:
        got = list(prefetch([np.ones((2, 3), np.float32)] * 3, "cpu"))
    assert len(got) == 3
    # three batches and the end, on the consumer's thread
    assert [e[0] for e in events] == ["g2v.feed.wait"] * 4


def test_the_span_log_lies_on_the_profilers_clock():
    """Each kept span encloses the profiler's own record of it: the
    profiler's events and the log share one clock."""
    gen, transcripts = _generator(), _transcripts()
    before = len(profiling.spans())
    with _profiled() as events:
        gen.generate_batch(transcripts, DURATIONS)
    log = profiling.spans()[before:]
    assert sorted(n for n, _, _ in log) == sorted(e[0] for e in events)
    slack = 50_000                     # ns: the two clocks' reading error
    for name, s, e, _ in events:
        assert any(n == name and ls - slack <= s and e <= le + slack
                   for n, ls, le in log), (name, s, e)


def test_without_a_profiler_no_record_function_is_entered(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("x") is profiling.annotate("y")
    before = len(profiling.spans())
    _generator().generate_batch(_transcripts(), DURATIONS)
    _train_step()(torch.randn(4, 6, LATENT), 0.0)
    assert len(profiling.spans()) == before


@pytest.mark.parametrize("mode", ["generate_batch", "generate"])
def test_the_chunk_counters_count_rolled_and_returned_chunks(mode):
    gen, transcripts = _generator(), _transcripts()
    n_steps = SENTENCE // N_POSES
    before = profiling.counters()
    if mode == "generate_batch":
        out = gen.generate_batch(transcripts, DURATIONS)
        rolled = len(DURATIONS) * max(_windows()) * n_steps
        real = sum(_windows()) * n_steps
    else:
        out = [gen.generate(transcripts[2], DURATIONS[2])]
        rolled = real = _windows()[2] * n_steps
    after = profiling.counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert delta("gen.chunks_rolled") == rolled
    assert delta("gen.chunks_real") == real
    assert real * N_POSES == sum(len(frames) for frames, _ in out)


def test_count_adds_and_counters_returns_a_copy():
    before = profiling.counters().get("test.count", 0)
    profiling.count("test.count")
    profiling.count("test.count", 4)
    got = profiling.counters()
    got["test.count"] = -1
    assert profiling.counters()["test.count"] == before + 5
