"""The plain reference against the port's plain path (the kernels' plain
versions on the CPU), at small widths: the paper configuration's
generation and the Part-b step, end to end through the drivers and piece by piece.
The reference follows the program's tokens, so agreement is a gap of 0
and float differences of fp32 rounding."""
import numpy as np
import pytest
import torch

from conftest import SMALL_GEN, SMALL_TRAIN, small_run


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_generation_matches_the_port(seed):
    _, out = small_run("gen_batch.paper", seed=seed)
    r = out["readings"]
    assert r["mismatch"] == 0
    assert r["token_gap"] <= 1e-5
    assert r["latent_err"] <= 1e-5 and r["frame_err"] <= 1e-5


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7])
def test_part_b_step_matches_the_port(seed):
    _, out = small_run("train_b.paper", seed=seed)
    r = out["readings"]
    assert r["loss_err"] <= 1e-6
    assert r["grad_err"] <= 1e-5 and r["update_err"] <= 1e-4


def _small(name, small):
    from portbench.harness import registry

    cfg = registry.config(name)
    cfg.update(small)
    return cfg


def test_chunk_rollout_matches_the_port_decoder():
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from portbench.harness import weights as wts
    from portbench.reference import g2v as ref

    cfg = _small("g2v_paper", SMALL_GEN)
    W = wts.group(wts.make(ref.weight_spec(cfg), 9, "cpu"), "seq")
    seq = SeqDecoder(cfg["dae_latent"], cfg["hidden_size"],
                     cfg["n_layers"], cfg["n_poses"], cfg["codes"],
                     stages=cfg["tokenizer_stages"])
    seq.load_state_dict(W, strict=True)
    seq.eval()
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg["codes"], (11,), generator=g)
    with torch.no_grad():
        hid = seq.token_hidden(tok, None)
        want = seq.rollout(hid, torch.zeros(11, cfg["dae_latent"]))
        got = ref.rollout(cfg, W, ref.chunk_hidden(cfg, W, tok))
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)


def test_window_words_match_the_port_windows():
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from portbench.reference import g2v as ref

    cfg = _small("g2v_paper", SMALL_GEN)
    rng = np.random.default_rng(4)
    words = ref.transcript(rng, 37.0, cfg["n_words"], 2.5)

    class Vocab:
        def words_to_ids(self, ws):
            return [1] + [4 + int(w[1:]) for w in ws] + [2]

    gen = GestureGenerator.__new__(GestureGenerator)
    gen.vocab, gen.max_words, gen.text_context_s = Vocab(), 8, 0.0
    gen.sentence_frame_length, gen.fps, gen.device = 120, 20, "cpu"
    ids, lengths, wins = gen._windows([words], [37.0])
    want_ids, want_len = ref.window_words(cfg, words, 37.0)
    assert wins == [want_ids.shape[0]]
    assert np.array_equal(ids[0, :wins[0]].numpy(), want_ids)
    assert np.array_equal(lengths[0, :wins[0]].numpy(), want_len)


def test_part_b_loss_matches_the_port_step():
    from gesture2vec_tpu_torch.models.layers import dropout_generator
    from portbench.programs import g2v as program
    from portbench.harness import weights as wts
    from portbench.reference import train_b as ref

    cfg = _small("g2v_paper", SMALL_TRAIN)
    spec = ref.weight_spec(cfg)
    W = wts.make(spec, 6, "cpu")
    model, opt, step = program.train_step(cfg, W, "cpu")
    x = torch.from_numpy(ref.corpus(np.random.default_rng(6), 8, 6, 4))
    g = torch.Generator().manual_seed(6)
    state = g.get_state()
    with dropout_generator(g):
        got, _ = step.loss(x)
    g2 = torch.Generator()
    g2.set_state(state)
    want = ref.loss_of(cfg, {n: W[n] for n in ref.leaf_names(spec)}, x, g2)
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6 * abs(want)
