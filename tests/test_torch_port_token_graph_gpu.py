"""The carried token decode replayed as a CUDA graph, on the card at the
widths of the paper's configuration (B = 32 rows, S = 48 words, H = 200,
K = 512 codes, L = 2 layers): the replay's tokens and logits equal the
window function's run eagerly, bitwise, greedy and sampled from the same
Gumbel noise, at W = 16 and W = 304, for the GRU token model and the
transformer; a generator on a card that is not the current one replays
there (with two cards or more); a second call answers its own inputs and
leaves the first call's answer alone; one window and beam search run
eagerly; the cache keeps at most its bound of graphs; the counters read
what ran; and the card's time a window, eager against replay, is printed.
Run on the card with
`python3 -m pytest -s -m gpu tests/test_torch_port_token_graph_gpu.py`."""
import json
import subprocess
import time

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

B, S, H, K, L, N_STEPS, WORDS = 32, 48, 200, 512, 2, 6, 100


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured and "
                    "replayed only there")
    return torch.device("cuda")


def _generator(device, arch="gru", **options):
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
            n_words=WORDS, n_tokens=K, hidden_size=H, n_layers=L,
            n_steps=N_STEPS, n_pre_poses=2, word_embed_size=32, n_heads=4)
    else:
        t2t = Text2Token(n_words=WORDS, n_tokens=K, hidden_size=H,
                         n_layers=L, n_steps=N_STEPS, n_pre_poses=2,
                         word_embed_size=32, encoder_type="tcn",
                         use_attention=True)
        with torch.no_grad():
            # spread the attention (its v starts at zero) and the logits
            for p in t2t.decoder_step.parameters():
                p.normal_(0.0, 0.1)
    vocab = Vocab("graph")
    for i in range(WORDS - 4):
        vocab.index_word(f"w{i}")
    return GestureGenerator(
        t2t_model=t2t, seq_decoder=SeqDecoder(40, H, L, 20, K,
                                              n_pre_poses=1,
                                              conditioned=True),
        dae_model=DAE(135, 40), vocab=vocab,
        pose_mean=np.zeros(135, np.float32),
        pose_std=np.ones(135, np.float32), n_frames=20,
        sentence_frame_length=120, fps=20, max_words=S, mode="decode",
        use_fused_decoder=False, device=device, **options)


def _inputs(device, W, seed, rows=B):
    """enc_outs (S, rows, W, H), dec_hidden (L, rows, W, H), masks
    (rows, W, S), the first window's seed (rows, n_steps)."""
    g = torch.Generator(device=device).manual_seed(seed)
    lengths = torch.randint(1, S + 1, (rows, W), generator=g, device=device)
    return (torch.randn(S, rows, W, H, generator=g, device=device),
            torch.randn(L, rows, W, H, generator=g, device=device),
            torch.arange(S, device=device) < lengths[:, :, None],
            torch.randint(0, K, (rows, N_STEPS), generator=g, device=device))


def _eager(gen, enc_outs, dec_hidden, masks, seed, gumbel):
    """The window function called directly, window after window."""
    W = enc_outs.shape[2]
    bufs = {"seed": seed.clone()}
    outs = {}
    for w in range(W):
        bufs["enc_outs"] = enc_outs[:, :, w].contiguous()
        bufs["dec_hidden"] = dec_hidden[:, :, w].contiguous()
        if masks is not None:
            bufs["mask"] = masks[:, w].contiguous()
        if gumbel is not None:
            bufs["gumbel"] = gumbel[:, w].contiguous()
        gen._token_window(bufs)
        for k in ("tokens", "logits"):
            if k in bufs:
                outs.setdefault(k, []).append(bufs[k].clone())
    return {k: torch.stack(v, dim=1) for k, v in outs.items()}, bufs["seed"]


class _Counted:
    def __init__(self):
        self.before = profiling.counters()

    def __getitem__(self, name):
        return profiling.counters().get(name, 0) - self.before.get(name, 0)


def _replay_equals_window_function(gen, device, W, seed_of_inputs):
    enc_outs, dec_hidden, masks, seed = _inputs(device, W, seed_of_inputs)
    gumbel = gen._noise(gen._next_generator(), (B, W))
    with torch.inference_mode():
        want, want_seed = _eager(gen, enc_outs, dec_hidden, masks, seed,
                                 gumbel)
        counted = _Counted()
        got, got_seed = gen._decode_carried(enc_outs, dec_hidden, seed,
                                            masks, gumbel)
    torch.cuda.synchronize(device)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_seed, want_seed)
    # a replay that did nothing would give every window window 0's tokens
    assert (got["tokens"] != got["tokens"][:, :1]).any()
    assert counted["gen.token_windows"] == W
    assert counted["gen.token_graph_replays"] == W
    assert counted["gen.token_graph_captures"] == 1


@pytest.mark.parametrize("arch,policy,W", [
    ("gru", "greedy", 16), ("gru", "sampled", 16), ("gru", "greedy", 304),
    ("transformer", "greedy", 16), ("transformer", "sampled", 16)])
def test_the_replay_equals_the_window_function(card, arch, policy, W):
    options = {"temperature": 0.8, "top_k": 50} if policy == "sampled" \
        else {}
    _replay_equals_window_function(_generator(card, arch, **options), card,
                                   W, 1)


def test_a_generator_on_another_card_replays_there(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the generator sits on one that is "
                    "not the current one")
    other = torch.device("cuda", (torch.cuda.current_device() + 1)
                         % torch.cuda.device_count())
    _replay_equals_window_function(_generator(other), other, 16, 3)
    assert torch.cuda.current_device() != other.index


def test_a_second_call_answers_its_own_words(card):
    gen = _generator(card)
    g = torch.Generator(device=card).manual_seed(5)
    calls = [(torch.randint(1, WORDS, (B, 16, S), generator=g, device=card),
              torch.randint(1, S + 1, (B, 16), generator=g, device=card))
             for _ in range(2)]
    with torch.inference_mode():
        counted = _Counted()
        first = gen._predict_windows(*calls[0])
        kept = {k: v.clone() for k, v in first.items()}
        second = gen._predict_windows(*calls[1])
        for (word_ids, lengths), got in zip(calls, (first, second)):
            enc_outs, dec_hidden = gen.t2t_model.encode_text(
                word_ids.reshape(B * 16, S), lengths.reshape(B * 16))
            want, want_seed = _eager(
                gen, enc_outs.reshape(S, B, 16, H),
                dec_hidden.reshape(L, B, 16, H),
                torch.arange(S, device=card) < lengths[:, :, None],
                torch.zeros((B, N_STEPS), dtype=torch.long, device=card),
                None)
            assert torch.equal(got["tokens"], want["tokens"].reshape(B, -1))
            assert torch.equal(got["next_seed"], want_seed)
    torch.cuda.synchronize()
    assert not torch.equal(first["tokens"], second["tokens"])
    for k in kept:       # the second call left the first call's answer
        assert torch.equal(first[k], kept[k]), k
    assert counted["gen.token_graph_captures"] == 1
    assert counted["gen.token_graph_replays"] == 32
    assert counted["gen.token_windows"] == 32


@pytest.mark.parametrize("path", ["one_window", "beam"])
def test_one_window_and_beam_run_eagerly(card, path):
    gen = _generator(card, **({"beam_width": 3} if path == "beam" else {}))
    W = 1 if path == "one_window" else 16
    enc_outs, dec_hidden, masks, seed = _inputs(card, W, 2)
    with torch.inference_mode():
        counted = _Counted()
        got, _ = gen._decode_carried(enc_outs, dec_hidden, seed, masks,
                                     None)
        assert counted["gen.token_windows"] == W
        assert counted["gen.token_graph_replays"] == 0
        assert counted["gen.token_graph_captures"] == 0
        assert not gen._token_graphs
        want, _ = _eager(gen, enc_outs, dec_hidden, masks, seed, None)
    assert torch.equal(got["tokens"], want["tokens"])


def test_the_cache_keeps_at_most_its_bound(card):
    from gesture2vec_tpu_torch.infer.text2gesture import _TOKEN_GRAPHS

    gen = _generator(card)
    counted = _Counted()
    with torch.inference_mode():
        for rows in range(1, _TOKEN_GRAPHS + 3):
            enc_outs, dec_hidden, masks, seed = _inputs(card, 2, rows, rows)
            got, _ = gen._decode_carried(enc_outs, dec_hidden, seed, masks,
                                         None)
            want, _ = _eager(gen, enc_outs, dec_hidden, masks, seed, None)
            assert torch.equal(got["tokens"], want["tokens"])
            assert len(gen._token_graphs) == min(rows, _TOKEN_GRAPHS)
        assert counted["gen.token_graph_captures"] == _TOKEN_GRAPHS + 2
        # the most recent shape is kept: no capture
        gen._decode_carried(enc_outs, dec_hidden, seed, masks, None)
        # the first was dropped: captured again
        enc_outs, dec_hidden, masks, seed = _inputs(card, 2, 1, 1)
        gen._decode_carried(enc_outs, dec_hidden, seed, masks, None)
    assert counted["gen.token_graph_captures"] == _TOKEN_GRAPHS + 3
    assert len(gen._token_graphs) == _TOKEN_GRAPHS
    assert counted["gen.token_graph_replays"] == \
        counted["gen.token_windows"] == 2 * (_TOKEN_GRAPHS + 4)


def test_the_card_time_a_window_eager_against_replay(card):
    """At W = 304, in turns (eager, replay, replay, eager), per window:
    the card's timeline between CUDA events around the call and the
    host's time to issue it; and one window's replay back to back, the
    card's own time for a window. Printed as one JSON line (-s)."""
    W = 304
    gen = _generator(card)
    enc_outs, dec_hidden, masks, seed = _inputs(card, W, 4)
    runs = {"eager": lambda: _eager(gen, enc_outs, dec_hidden, masks, seed,
                                    None),
            "replay": lambda: gen._decode_carried(enc_outs, dec_hidden,
                                                  seed, masks, None)}

    def per_window(run, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        host = time.perf_counter() - t0
        end.synchronize()
        return start.elapsed_time(end) / n, host * 1e3 / n

    readings = {"eager": [], "replay": []}
    with torch.inference_mode():
        runs["replay"]()                                # the capture
        for path in ("eager", "replay", "replay", "eager"):
            readings[path].append(per_window(runs[path], W))
        (graph, _), = gen._token_graphs.values()

        def replays():
            for _ in range(W):
                graph.replay()
        replay_card_ms, _ = per_window(replays, W)
    card_name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(json.dumps({
        "card": card_name[:1], "windows": W,
        **{f"{path}_{what}_ms": [round(r[i], 4) for r in rs]
           for path, rs in readings.items()
           for i, what in enumerate(("timeline", "host"))},
        "replay_card_ms": round(replay_card_ms, 4)}))
    assert max(r[0] for r in readings["replay"]) < \
        min(r[0] for r in readings["eager"])
