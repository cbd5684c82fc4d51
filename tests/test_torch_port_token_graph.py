"""The carried token decode's window function and when its CUDA graph
engages, on the CPU at small widths: the staged window loop gives the
tokens and logits of the loop it replaced, the masks of all windows made
at once equal each window's own, the eligibility predicate refuses every
case it must, the paths it refuses count their windows and no replay, and
the benchmark's reader of the counters. The replay itself is held against
the window function on the card (`test_torch_port_token_graph_gpu.py`)."""
import types

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.utils import profiling

H, K, WORDS, EMB, POSE, LATENT, MAX_WORDS = 16, 32, 60, 12, 9, 4, 8
N_POSES, SENTENCE = 20, 120
N_STEPS = SENTENCE // N_POSES
DURATIONS = [6.0, 13.0, 20.0]   # 1, 3 and 4 windows: a bucket of 4
GRAPH_COUNTERS = ("gen.token_graph_replays", "gen.token_graph_captures")


def _generator(arch="gru", **options):
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from gesture2vec_tpu_torch.models.text2token import Text2Token
    from gesture2vec_tpu_torch.models.transformer import \
        TransformerText2Token
    from gesture2vec_tpu_torch.text.vocab import Vocab

    torch.manual_seed(0)
    if arch == "transformer":
        t2t = TransformerText2Token(
            n_words=WORDS, n_tokens=K, hidden_size=H, n_layers=2,
            n_steps=N_STEPS, n_pre_poses=2, word_embed_size=EMB, n_heads=2,
            dropout_rate=0.0)
    else:
        t2t = Text2Token(n_words=WORDS, n_tokens=K, hidden_size=H,
                         n_layers=2, n_steps=N_STEPS, n_pre_poses=2,
                         word_embed_size=EMB, encoder_type="tcn",
                         use_attention=True)
    seq = SeqDecoder(LATENT, H, 2, N_POSES, K, n_pre_poses=1,
                     conditioned=True)
    vocab = Vocab("graph")
    for i in range(WORDS - 4):
        vocab.index_word(f"w{i}")
    return GestureGenerator(
        t2t_model=t2t, seq_decoder=seq, dae_model=DAE(POSE, LATENT),
        vocab=vocab, pose_mean=np.zeros(POSE, np.float32),
        pose_std=np.ones(POSE, np.float32), n_frames=N_POSES,
        sentence_frame_length=SENTENCE, fps=20, max_words=MAX_WORDS,
        mode="decode", device="cpu", **options)


def _transcripts():
    rng = np.random.default_rng(3)
    return [[[f"w{rng.integers(WORDS - 4)}", t, t + 0.3]
             for t in np.arange(0.0, d, 0.5)] for d in DURATIONS]


def _inputs(B=3, W=5, S=MAX_WORDS, seed=1):
    """enc_outs (S, B, W, H), dec_hidden (L, B, W, H), lengths (B, W)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(S, B, W, H, generator=g),
            torch.randn(2, B, W, H, generator=g),
            torch.randint(1, S + 1, (B, W), generator=g))


def _loop_before(gen, enc_outs, dec_hidden, seed, mask_of, gumbel):
    """The window loop the staged one replaced: each window decoded on
    its slices, its mask made in the loop, its seed a new tensor."""
    B, W = enc_outs.shape[1:3]
    if seed is None:
        seed = torch.zeros((B, gen.n_steps), dtype=torch.long)
    n_pre = gen.token_model.n_pre
    per_window = []
    for w in range(W):
        res = gen._decode_windows(
            enc_outs[:, :, w], dec_hidden[:, :, w], seed, mask_of(w),
            None if gumbel is None else gumbel[:, w])
        per_window.append(res)
        seed = torch.zeros_like(seed)
        if n_pre:
            seed[:, :n_pre] = res["tokens"][:, -n_pre:]
    return {k: torch.stack([r[k] for r in per_window], dim=1)
            for k in ("tokens", "logits")}, seed


def _delta(before, name):
    return profiling.counters().get(name, 0) - before.get(name, 0)


@pytest.mark.parametrize("arch,policy", [("gru", "greedy"),
                                         ("gru", "sampled"),
                                         ("transformer", "greedy")])
def test_the_staged_window_loop_gives_the_loop_it_replaced(arch, policy):
    options = {"temperature": 0.8, "top_k": 5} if policy == "sampled" \
        else {}
    gen = _generator(arch, **options)
    enc_outs, dec_hidden, lengths = _inputs()
    B, W = lengths.shape
    masks = torch.arange(MAX_WORDS) < lengths[:, :, None]
    gumbel = gen._noise(gen._next_generator(), (B, W))
    assert (gumbel is None) == (policy == "greedy")
    seed = torch.randint(0, K, (B, N_STEPS))
    with torch.inference_mode():
        want, want_seed = _loop_before(
            gen, enc_outs, dec_hidden, seed,
            lambda w: torch.arange(MAX_WORDS)[None, :] < lengths[:, w, None],
            gumbel)
        seed_in = seed.clone()
        got, got_seed = gen._decode_carried(enc_outs, dec_hidden, seed,
                                            masks, gumbel)
    assert torch.equal(seed, seed_in)      # the caller's seed is not carried
    assert set(got) == {"tokens", "logits"}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_seed, want_seed)


def test_the_masks_of_all_windows_equal_each_windows_own(monkeypatch):
    gen = _generator()
    seen = {}
    carried = gen._decode_carried

    def observed(enc_outs, dec_hidden, seed, masks, gumbel):
        seen["masks"] = masks
        return carried(enc_outs, dec_hidden, seed, masks, gumbel)

    monkeypatch.setattr(gen, "_decode_carried", observed)
    g = torch.Generator().manual_seed(2)
    word_ids = torch.randint(1, WORDS, (2, 4, MAX_WORDS), generator=g)
    lengths = torch.randint(1, MAX_WORDS + 1, (2, 4), generator=g)
    with torch.inference_mode():
        gen._predict_windows(word_ids, lengths)
    positions = torch.arange(MAX_WORDS)
    masks = seen["masks"]
    assert masks.shape == (2, 4, MAX_WORDS) and masks.dtype == torch.bool
    for w in range(4):
        assert torch.equal(masks[:, w],
                           positions[None, :] < lengths[:, w, None])


def test_the_window_function_writes_its_outputs_and_carries_the_seed():
    gen = _generator()
    enc_outs, dec_hidden, lengths = _inputs(W=1)
    seed = torch.randint(0, K, (3, N_STEPS))
    bufs = {"enc_outs": enc_outs[:, :, 0].clone(),
            "dec_hidden": dec_hidden[:, :, 0].clone(),
            "mask": torch.arange(MAX_WORDS) < lengths[:, 0, None],
            "seed": seed.clone()}
    seed_buf = bufs["seed"]
    with torch.inference_mode():
        want = gen._decode_windows(enc_outs[:, :, 0], dec_hidden[:, :, 0],
                                   seed, bufs["mask"], None)
        gen._token_window(bufs)
    assert bufs["seed"] is seed_buf        # written over in place
    assert torch.equal(bufs["tokens"], want["tokens"])
    assert torch.equal(bufs["logits"], want["logits"])
    assert torch.equal(seed_buf[:, :2], want["tokens"][:, -2:])
    assert not seed_buf[:, 2:].any()


class _Model:
    """A token model's attributes the predicate reads."""

    def __init__(self, training=False):
        self.training = training


@pytest.mark.parametrize("case", ["cpu", "training", "grad", "beam",
                                  "one_window"])
def test_the_graph_predicate_refuses(case):
    from gesture2vec_tpu_torch.infer.text2gesture import ChunkSynthesis

    gen = ChunkSynthesis()
    gen._beam = 4 if case == "beam" else 0
    gen.token_model = _Model(training=case == "training")
    enc_outs = torch.zeros(1) if case == "cpu" \
        else types.SimpleNamespace(is_cuda=True)
    W = 1 if case == "one_window" else 16
    with torch.set_grad_enabled(case == "grad"):
        assert not gen._token_graph_ok(enc_outs, W)
    # the same generator passes once the refused condition is lifted
    gen._beam = 0
    gen.token_model = _Model()
    with torch.no_grad():
        assert gen._token_graph_ok(types.SimpleNamespace(is_cuda=True), 2)


@pytest.mark.parametrize("arch", ["gru", "transformer", "audio"])
def test_the_predicate_takes_each_token_model_in_eval_mode(arch):
    from gesture2vec_tpu_torch.infer.text2gesture import ChunkSynthesis
    from gesture2vec_tpu_torch.models.audio2token import Audio2Token

    gen = ChunkSynthesis()
    gen._beam = 0
    gen.token_model = Audio2Token(n_tokens=K, hidden_size=H, n_layers=2,
                                  n_steps=N_STEPS) if arch == "audio" \
        else _generator(arch).token_model
    on_card = types.SimpleNamespace(is_cuda=True)
    gen.token_model.eval()
    with torch.no_grad():
        assert gen._token_graph_ok(on_card, 2)
        gen.token_model.train()
        assert not gen._token_graph_ok(on_card, 2)


def test_the_graph_bound_holds_every_row_count_a_server_runs():
    from gesture2vec_tpu_torch.infer.text2gesture import _TOKEN_GRAPHS
    from gesture2vec_tpu_torch.serve.server import BatchingWorker

    cap = BatchingWorker.DEFAULT_MAX_BATCH
    # fused batches of 2 .. cap requests, and single requests (`generate`)
    rows = {BatchingWorker._bucket(n, cap) for n in range(2, cap + 1)}
    assert len(rows | {1}) <= _TOKEN_GRAPHS


@pytest.mark.parametrize("path", ["greedy", "sampled", "beam",
                                  "one_window", "transformer", "training",
                                  "no_carry"])
def test_the_eager_paths_count_windows_and_no_replay(path):
    options = {"sampled": {"temperature": 0.8},
               "beam": {"beam_width": 3},
               "no_carry": {"window_carry": False}}.get(path, {})
    gen = _generator("transformer" if path == "transformer" else "gru",
                     **options)
    before = profiling.counters()
    if path == "one_window":
        gen.generate(_transcripts()[0], DURATIONS[0])
        windows = 1
    elif path == "training":
        gen.token_model.train()
        enc_outs, dec_hidden, lengths = _inputs()
        with torch.no_grad():
            gen._decode_carried(enc_outs, dec_hidden, None, None, None)
        windows = lengths.shape[1]
    else:
        gen.generate_batch(_transcripts(), DURATIONS)
        windows = 0 if path == "no_carry" else 4   # the bucket of 4
    assert _delta(before, "gen.token_windows") == windows
    for name in GRAPH_COUNTERS:
        assert _delta(before, name) == 0, name


def test_token_windows_counts_each_carried_call():
    gen = _generator()
    before = profiling.counters()
    gen.generate_batch(_transcripts(), DURATIONS)
    gen.generate(_transcripts()[2], DURATIONS[2])
    assert _delta(before, "gen.token_windows") == 4 + 4


def _bench_trace():
    from portbench.harness.trace import Trace

    return Trace([], [], (0, 100))


@pytest.mark.parametrize("counts,want", [
    ({"gen.token_windows": 608, "gen.token_graph_replays": 608}, 100.0),
    ({"gen.token_windows": 608}, 0.0),
    ({"gen.token_windows": 8, "gen.token_graph_replays": 6}, 75.0),
    ({}, None),
    ({"gen.chunks_rolled": 10, "gen.chunks_real": 3}, None),
])
def test_the_token_graph_share_reads_the_counters(counts, want,
                                                  monkeypatch):
    from portbench.harness import registry
    from portbench.programs import g2v_record

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(g2v_record, "counters", lambda: dict(counts))
    reader = registry.metric("infer.token_graph_share")
    got = reader.read({"trace": _bench_trace()})
    assert got == (None if want is None else pytest.approx(want))


def test_the_token_graph_share_gives_none_untraced_or_without_counters(
        monkeypatch):
    from portbench.harness import registry

    reader = registry.metric("infer.token_graph_share")
    assert reader.read({"trace": None}) is None
    assert reader.read({}) is None
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert reader.read({"trace": _bench_trace()}) is None


def test_the_token_graph_share_entry():
    import json
    from pathlib import Path

    bench = json.loads((Path(__file__).resolve().parent.parent
                        / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "infer.token_graph_share"]
    assert entry == {"name": "infer.token_graph_share", "unit": "%",
                     "better": "higher", "source": "program_counter",
                     "layer": "infer", "moves": "frames_per_s",
                     "workloads": ["gen_batch.paper", "gen_batch.recipe"]}
