"""PyTorch port vs the JAX package: exemplar mode, generate_batch and the
inference entry point.

Exemplar picks come from a numpy stream that both packages consume in
the same order (one integer per sampled request, then the picks), so
with the same seed the picks are identical; frames (the DAE decode of
the picked windows' latents) agree within 1e-5. The checkpoint files,
the clip store and the latent bank of the last tests are written by the
JAX package and read by the port's `cli/_common.build_generator`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.cli._common import build_generator
from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
from gesture2vec_tpu_torch.infer.exemplar import ExemplarBank
from gesture2vec_tpu_torch.text.vocab import Vocab

ATOL = 1e-5
HID, REP, K, DIM, NF, SENT, FPS, MAXW = 16, 8, 32, 12, 4, 24, 20, 10
N_WORDS, WORDEMBED, VOCAB_WORDS = 60, 12, 40
N_STEPS = SENT // NF


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


@pytest.fixture(scope="module")
def jax_gen():
    """An exemplar-mode JAX generator at small widths (perturbed weights,
    a 300-window bank of random latents)."""
    from bench import build_generator as bench_generator

    g = bench_generator(hid=HID, rep=REP, k=K, dim=DIM, n_frames=NF,
                        sent_len=SENT, n_words=N_WORDS, max_words=MAXW,
                        wordembed=WORDEMBED, vocab_words=VOCAB_WORDS,
                        fps=FPS, mode="exemplar", bank_windows=300)
    rng = np.random.default_rng(7)
    return dataclasses.replace(
        g, t2t_variables=perturb(_np(g.t2t_variables), rng),
        seq_variables=perturb(_np(g.seq_variables), rng),
        dae_variables=perturb(_np(g.dae_variables), rng),
        pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32))


def _port(g, mode="decode", **kw):
    return generator_from_jax(
        g.t2t_variables, g.seq_variables, g.dae_variables, _vocab(),
        g.pose_mean, g.pose_std, n_frames=NF, sentence_frame_length=SENT,
        fps=FPS, max_words=MAXW, latent_bank=g.latent_bank, device="cpu",
        mode=mode, **kw)


def _assert_same(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


def test_mode_defaults_to_exemplar_like_jax(jax_gen):
    """A generator built without `mode` is in exemplar mode on both sides:
    without a bank both refuse it, with one the port gives JAX's exemplar
    frames."""
    from gesture2vec_tpu.infer.text2gesture import GestureGenerator as JaxGen

    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator

    assert GestureGenerator.mode == JaxGen.mode == "exemplar"
    fields = {f.name: getattr(jax_gen, f.name)
              for f in dataclasses.fields(JaxGen)
              if f.init and f.name != "mode"}
    with pytest.raises(AssertionError, match="latent bank"):
        JaxGen(**{**fields, "latent_bank": None})
    args = (jax_gen.t2t_variables, jax_gen.seq_variables,
            jax_gen.dae_variables, _vocab(), jax_gen.pose_mean,
            jax_gen.pose_std)
    kw = dict(n_frames=NF, sentence_frame_length=SENT, fps=FPS,
              max_words=MAXW, device="cpu")
    with pytest.raises(ValueError, match="latent bank"):
        generator_from_jax(*args, **kw)
    port = generator_from_jax(*args, latent_bank=jax_gen.latent_bank, **kw)
    assert port.mode == "exemplar"
    _assert_same(JaxGen(**fields).generate(_words(7.0), 7.0),
                 port.generate(_words(7.0), 7.0))


def test_picks_match_jax_with_unpopulated_tokens(rng):
    """Uniform picks and continuity chains, two calls each, from one
    shared stream; tokens 3, 7 and 30 have no window and take their
    nearest populated code."""
    from gesture2vec_tpu.infer.exemplar import ExemplarBank as JaxBank

    populated = np.setdiff1d(np.arange(K), [3, 7, 30])
    bank = {"tokens": rng.choice(populated, 80).astype(np.int32),
            "dae_latents": rng.normal(size=(80, NF, REP)).astype(np.float32)}
    codebook = rng.normal(size=(K, 2 * HID)).astype(np.float32)
    jb = JaxBank(bank, K, codebook, np.random.default_rng(5))
    pb = ExemplarBank(bank, K, codebook, np.random.default_rng(5))
    tokens = np.array([3, 0, 7, 7, 12, 30, 3, 5, 1, 2], np.int64)
    for _ in range(2):
        np.testing.assert_array_equal(pb.pick_indices(tokens),
                                      jb.pick_indices(tokens))
        np.testing.assert_array_equal(pb.pick_indices_continuity(tokens),
                                      jb.pick_indices_continuity(tokens))
    np.testing.assert_array_equal(
        pb.pick_indices_continuity(tokens, prev_pick=11),
        jb.pick_indices_continuity(tokens, prev_pick=11))
    picks = pb.pick_indices(tokens)
    assert not np.isin(bank["tokens"][picks], [3, 7, 30]).any()


@pytest.mark.parametrize("continuity", [False, True])
def test_exemplar_generate_matches_jax(jax_gen, continuity):
    """Two successive requests from one generator each side: the second
    request's picks continue the stream."""
    jg = dataclasses.replace(jax_gen, exemplar_continuity=continuity)
    port = _port(jax_gen, mode="exemplar", exemplar_continuity=continuity)
    for duration, seed in ((7.0, 0), (3.0, 1)):
        want = jg.generate(_words(duration, seed), duration)
        got = port.generate(_words(duration, seed), duration)
        _assert_same(want, got)
        assert got[0].shape == (int(np.ceil(duration / 1.2)) * SENT, DIM)


def test_exemplar_sampled_top_k_1_shares_the_stream(jax_gen):
    """A sampled request draws its integer before the picks: at top_k 1
    the tokens are the greedy ones, and the picks still match JAX's
    only if that draw is made, in the same place."""
    options = dict(temperature=2.0, top_k=1)
    jg = dataclasses.replace(jax_gen, **options)
    port = _port(jax_gen, mode="exemplar", **options)
    greedy = _port(jax_gen, mode="exemplar")
    for _ in range(2):
        want = jg.generate(_words(7.0), 7.0)
        got = port.generate(_words(7.0), 7.0)
        _assert_same(want, got)
    assert np.abs(greedy.generate(_words(7.0), 7.0)[0]
                  - port.generate(_words(7.0), 7.0)[0]).max() > 1e-3


def test_exemplar_sampled_matches_jax_under_its_noise(jax_gen, monkeypatch):
    """Temperature 1 over the full vocabulary: the port is fed the noise
    of every categorical draw of the JAX request (recorded in order by a
    callback), and its tokens and picks equal JAX's over two requests."""
    from gesture2vec_tpu.models import text2token as jax_t2t

    draws = []
    orig = jax_t2t.sample_logits

    def recording(logits, temperature, top_k, key):
        g = jax.random.gumbel(key, logits.shape, logits.dtype)
        jax.debug.callback(lambda x: draws.append(np.asarray(x)), g,
                           ordered=True)
        return orig(logits, temperature, top_k, key)

    monkeypatch.setattr(jax_t2t, "sample_logits", recording)
    jg = dataclasses.replace(jax_gen, temperature=1.0)
    port = _port(jax_gen, mode="exemplar", temperature=1.0)
    greedy_tokens = _port(jax_gen, mode="exemplar").generate(
        _words(7.0), 7.0)[1]
    for _ in range(2):
        draws.clear()
        want = jg.generate(_words(7.0), 7.0)
        jax.effects_barrier()
        W = len(draws) // (N_STEPS - 1)
        noise = torch.from_numpy(np.stack(draws).reshape(
            1, W, N_STEPS - 1, 1, K))
        port._noise = lambda generator, windows: noise
        got = port.generate(_words(7.0), 7.0)
        _assert_same(want, got)
        assert (got[1] != greedy_tokens).any()


@pytest.mark.parametrize("window_carry,options", [
    (True, {}), (False, {}), (True, {"chunk_continuity": True}),
    (False, {"decode_overlap": 2, "soft_decode": 1.0}),
    (True, {"beam_width": 3})])
def test_generate_batch_decode_matches_jax(jax_gen, window_carry, options):
    """Three transcripts of different lengths in one batch: against JAX's
    generate_batch and against the port's own per-transcript generate."""
    words = [_words(7.0), _words(3.0, 1), _words(2.0, 2)]
    durations = [7.0, 3.0, 2.0]
    jg = dataclasses.replace(jax_gen, mode="decode",
                             window_carry=window_carry, **options)
    want = jg.generate_batch(words, durations)
    port = _port(jax_gen, window_carry=window_carry, **options)
    got = port.generate_batch(words, durations)
    assert len(got) == 3
    for w, g_, ws, d in zip(want, got, words, durations):
        _assert_same(w, g_)
        _assert_same(port.generate(ws, d), g_)


@pytest.mark.parametrize("continuity", [False, True])
def test_generate_batch_exemplar_matches_jax(jax_gen, continuity):
    """One vectorised pick over the concatenated tokens, or one chain per
    transcript; tokens as each transcript's own generate gives them."""
    words = [_words(7.0), _words(3.0, 1)]
    jg = dataclasses.replace(jax_gen, exemplar_continuity=continuity)
    port = _port(jax_gen, mode="exemplar", exemplar_continuity=continuity)
    want = jg.generate_batch(words, 5.0)
    got = port.generate_batch(words, 5.0)
    single = _port(jax_gen, mode="exemplar")
    for w, g_, ws in zip(want, got, words):
        _assert_same(w, g_)
        np.testing.assert_array_equal(g_[1], single.generate(ws, 5.0)[1])


# -- the inference entry point on JAX-written files -----------------------
@pytest.fixture(scope="module")
def files(tmp_path_factory, jax_gen):
    """JAX-written checkpoints (the generator's weights), a clip store
    whose words cover the vocabulary, and the bank as an npz."""
    from gesture2vec_tpu.data.store import ClipStoreWriter
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        save_latent_dataset

    root = tmp_path_factory.mktemp("infer")
    rng = np.random.default_rng(3)
    w = ClipStoreWriter(str(root / "store"))
    for i in range(2):
        w.add_clip(f"vid{i}", rng.normal(size=(30, DIM)),
                   words=[[f"word{j}", 0.1 * j, 0.1 * j + 0.05]
                          for j in range(i, VOCAB_WORDS, 2)])
    w.set_stats(jax_gen.pose_mean, jax_gen.pose_std)
    w.finish()
    vocab = JaxVocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    g = jax_gen
    common = dict(model="seq2seq", hidden_size=HID, n_layers=2,
                  dropout_prob=0.2, epochs=1, batch_size=8, n_poses=NF,
                  autoencoder_vq=True, autoencoder_vq_components=K,
                  random_seed=0)
    out = {"store": str(root / "store"), "bank": str(root / "bank.npz")}
    save_latent_dataset(out["bank"], g.latent_bank)
    for name, lang in (("t2t", vocab.state_dict()), ("t2t_nolang", None)):
        out[name] = str(root / f"{name}.bin")
        checkpoints.save_checkpoint(
            out[name], config=load_config(dict(
                name="t", sentence_frame_length=SENT, n_pre_poses=2,
                autoencoder_att=True, wordembed_dim=WORDEMBED,
                motion_resampling_framerate=FPS, **common)),
            epoch=1, params=g.t2t_variables["params"], lang_model=lang,
            extra={"batch_stats": g.t2t_variables["batch_stats"],
                   "n_words": N_WORDS}, kind="text2embedding")
    out["dae"] = str(root / "dae.bin")
    checkpoints.save_checkpoint(
        out["dae"], config=load_config(dict(
            name="d", model="DAE", hidden_size=REP, input_motion_dim=DIM,
            random_seed=0)), epoch=1, params=g.dae_variables["params"],
        pose_dim=DIM, kind="DAE")
    out["vq"] = str(root / "vq.bin")
    checkpoints.save_checkpoint(
        out["vq"], config=load_config(dict(
            name="s", rep_learning_dim=REP, n_pre_poses=1, **common)),
        epoch=1, params=g.seq_variables["params"], pose_dim=REP,
        extra={"batch_stats": g.seq_variables["batch_stats"],
               "parity": False}, kind="autoencoder_vq")
    return out


@pytest.mark.parametrize("t2t,mode,policy", [
    ("t2t", "exemplar", {"exemplar_continuity": True}),
    ("t2t", "decode", {"temperature": 2.0, "top_k": 1}),
    ("t2t_nolang", "decode", {})])
def test_build_generator_matches_jax(files, t2t, mode, policy):
    """The three checkpoints and the bank through both packages' entry
    points; without a lang_model the vocabulary comes from the store's
    words (other ids than the checkpoint's vocabulary: tokens differ)."""
    from gesture2vec_tpu.cli._common import build_generator as jax_build
    from gesture2vec_tpu.data.store import ClipStore as JaxStore

    from gesture2vec_tpu_torch.data.store import ClipStore

    bank = files["bank"] if mode == "exemplar" else None
    jg, jcfg = jax_build(files[t2t], files["dae"], files["vq"],
                         JaxStore(files["store"]), mode=mode,
                         latent_bank_path=bank, **policy)
    pg, pcfg = build_generator(files[t2t], files["dae"], files["vq"],
                               ClipStore(files["store"]), mode=mode,
                               latent_bank_path=bank, device="cpu", **policy)
    assert (pg.n_frames, pg.sentence_frame_length, pg.fps) == \
        (jg.n_frames, jg.sentence_frame_length, jg.fps) == (NF, SENT, FPS)
    assert pg.vocab.word2index == jg.vocab.word2index
    assert pcfg["text_encoder"] == jcfg.extras.get("text_encoder", "tcn")
    for _ in range(2):
        _assert_same(jg.generate(_words(7.0), 7.0),
                     pg.generate(_words(7.0), 7.0))


def test_vocab_state_and_build_vocab_match_jax():
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.text.vocab import build_vocab as jax_build_vocab

    from gesture2vec_tpu_torch.text.vocab import build_vocab

    lists = [["we", "talk", "today"], ["today", "is", "we"], ["new"]]
    jv, pv = jax_build_vocab("c", lists), build_vocab("c", lists)
    probe = ["we", "is", "new", "unseen", "today"]
    assert pv.words_to_ids(probe) == jv.words_to_ids(probe)
    assert pv.word2count == jv.word2count
    back = JaxVocab.from_state_dict(pv.state_dict())
    assert back.words_to_ids(probe) == jv.words_to_ids(probe)
    again = Vocab.from_state_dict(jv.state_dict())
    assert again.words_to_ids(probe) == jv.words_to_ids(probe)
    assert again.n_words == jv.n_words == 4 + 5
