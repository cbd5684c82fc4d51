"""The frames' way to the host (`ChunkSynthesis._frames`), on the CPU at
small widths: each row's real frames, gathered and unnormalised on the
device, equal bitwise the old path's (`unnormalize` over the host copy
of the padded frames, sliced after), in the statistics' dtype; a
decode-mode `generate_batch` returns the old path's arrays and copies no
frame it does not return; and the benchmark's reader of the two
counters. The pinned copy from the card is held against the old path in
`test_torch_port_host_copy_gpu.py`."""
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.data.datasets import unnormalize
from gesture2vec_tpu_torch.utils import profiling

H, K, WORDS, EMB, POSE, LATENT, MAX_WORDS = 16, 32, 60, 12, 9, 4, 8
N_POSES, SENTENCE = 20, 120
N_STEPS = SENTENCE // N_POSES
DURATIONS = [6.0, 13.0, 20.0]   # 1, 3 and 4 windows: a bucket of 4


def _stats(dtype):
    """Pose statistics whose std has entries below the clip."""
    rng = np.random.default_rng(7)
    mean = rng.normal(0.0, 3.0, POSE).astype(dtype)
    std = rng.uniform(0.001, 2.0, POSE).astype(dtype)
    std[:2] = [0.0, 0.005]
    return mean, std


def _generator(stats_dtype=np.float32):
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from gesture2vec_tpu_torch.models.text2token import Text2Token
    from gesture2vec_tpu_torch.text.vocab import Vocab

    torch.manual_seed(0)
    t2t = Text2Token(n_words=WORDS, n_tokens=K, hidden_size=H, n_layers=2,
                     n_steps=N_STEPS, n_pre_poses=2, word_embed_size=EMB,
                     encoder_type="tcn", use_attention=True)
    seq = SeqDecoder(LATENT, H, 2, N_POSES, K, n_pre_poses=1,
                     conditioned=True)
    vocab = Vocab("host_copy")
    for i in range(WORDS - 4):
        vocab.index_word(f"w{i}")
    mean, std = _stats(stats_dtype)
    return GestureGenerator(
        t2t_model=t2t, seq_decoder=seq, dae_model=DAE(POSE, LATENT),
        vocab=vocab, pose_mean=mean, pose_std=std, n_frames=N_POSES,
        sentence_frame_length=SENTENCE, fps=20, max_words=MAX_WORDS,
        mode="decode", device="cpu")


def _transcripts(seed=3):
    rng = np.random.default_rng(seed)
    return [[[f"w{rng.integers(WORDS - 4)}", t, t + 0.3]
             for t in np.arange(0.0, d, 0.5)] for d in DURATIONS]


def _delta(before, name):
    return profiling.counters().get(name, 0) - before.get(name, 0)


def _same_bits(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case,stats_dtype", [
    ("random", np.float32), ("one_window_and_full_bucket", np.float32),
    ("random", np.float64), ("no_rows", np.float32),
    ("no_rows", np.float64)])
def test_the_real_rows_come_back_as_the_old_path_gave_them(case,
                                                           stats_dtype):
    gen = _generator(stats_dtype)
    B, T = 5, 4 * SENTENCE
    frames = torch.randn(B, T, POSE, generator=torch.Generator()
                         .manual_seed(11)) * 4.0
    want = unnormalize(frames.numpy(), gen.pose_mean, gen.pose_std)
    assert want.dtype == stats_dtype
    before = profiling.counters()
    if case == "no_rows":
        assert _same_bits(gen._frames(frames), want)
        assert _same_bits(gen._frames(frames[1]), want[1])
        assert _delta(before, "gen.frames_copied") == B * T + T
        return
    rows = np.random.default_rng(5).integers(1, T + 1, B).tolist()
    if case == "one_window_and_full_bucket":
        rows[1], rows[3] = SENTENCE, T
    got = gen._frames(frames, rows)
    assert got.shape == (sum(rows), POSE)
    bounds = np.cumsum([0] + rows)
    for b, n in enumerate(rows):
        assert _same_bits(got[bounds[b]: bounds[b + 1]], want[b, :n]), b
    assert _delta(before, "gen.frames_copied") == sum(rows)


def test_generate_batch_returns_the_old_paths_arrays_and_copies_no_more():
    gen = _generator()
    seen = []
    decode = gen.dae_model.decode

    def observed(latents):
        out = decode(latents)
        seen.append(out)
        return out

    gen.dae_model.decode = observed
    before = profiling.counters()
    result = gen.generate_batch(_transcripts(), DURATIONS)
    (padded,) = seen
    B = len(DURATIONS)
    old = unnormalize(padded.reshape(B, -1, POSE).numpy(), gen.pose_mean,
                      gen.pose_std)
    real = 0
    for b, (motion, tokens) in enumerate(result):
        n = len(tokens) * N_POSES
        assert _same_bits(motion, old[b, :n]), b
        real += n
    assert real == sum(int(np.ceil(d / 6.0)) for d in DURATIONS) * SENTENCE
    assert old.shape[1] * B > real          # the bucket pads some rows
    assert _delta(before, "gen.frames_copied") == \
        _delta(before, "gen.frames_returned") == real
    assert _delta(before, "gen.chunks_real") * N_POSES == real
    motion, _ = gen.generate(_transcripts()[2], DURATIONS[2])
    assert _delta(before, "gen.frames_copied") == \
        _delta(before, "gen.frames_returned") == real + len(motion)


def _bench_trace():
    from portbench.harness.trace import Trace

    return Trace([], [], (0, 100))


@pytest.mark.parametrize("counts,want", [
    ({"gen.frames_copied": 336000, "gen.frames_returned": 336000}, 100.0),
    # a copy of the padded frames: 336,000 real of 32 x 304 x 120
    ({"gen.frames_copied": 1167360, "gen.frames_returned": 336000},
     28.782894736842106),
    ({"gen.frames_copied": 336000}, 0.0),
    ({}, None),
    ({"gen.chunks_rolled": 10, "gen.chunks_real": 3}, None),
])
def test_the_host_copy_yield_reads_the_counters(counts, want, monkeypatch):
    from portbench.harness import registry
    from portbench.programs import g2v_record

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(g2v_record, "counters", lambda: dict(counts))
    reader = registry.metric("infer.host_copy_yield")
    got = reader.read({"trace": _bench_trace()})
    assert got == (None if want is None else pytest.approx(want))


def test_the_host_copy_yield_gives_none_untraced_or_without_counters(
        monkeypatch):
    from portbench.harness import registry

    reader = registry.metric("infer.host_copy_yield")
    assert reader.read({"trace": None}) is None
    assert reader.read({}) is None
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert reader.read({"trace": _bench_trace()}) is None


def test_the_host_copy_yield_entry():
    import json
    from pathlib import Path

    bench = json.loads((Path(__file__).resolve().parent.parent
                        / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "infer.host_copy_yield"]
    assert entry == {"name": "infer.host_copy_yield", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "infer", "moves": "frames_per_s",
                     "workloads": ["gen_batch.paper", "gen_batch.recipe"]}
