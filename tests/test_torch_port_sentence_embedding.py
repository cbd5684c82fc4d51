"""PyTorch port vs the JAX package: `text/sentence_embedding` (the
reference's GPT-3 hook) and the `sentence_emb` slot of
`data/sentence.build_sentence_dataset`.

The seven cases of tests/test_sentence_embedding.py, each run through
both packages' providers on the same inputs and held against JAX's
outputs: vectors bit for bit (HashedNGramProvider's FNV-style fold and
`np.random.default_rng` draws included), the same live calls, the same
cache files read by either package. Then the Part-d sentence dataset of
both packages on one store and the same DAE and tokenizer weights (from
one JAX init, small widths): tokens and word ids identical, poses and
sentence embeddings equal.
"""
import pickle

import numpy as np
import pytest

from gesture2vec_tpu_torch.text import sentence_embedding as pse

SENTENCES = ("the quick brown fox", "the quick brown dog",
             "completely unrelated words here", "", "  spaced   out  ",
             "Ünïcödé wörds ok", "fox")


def _jse():
    from gesture2vec_tpu.text import sentence_embedding as jse
    return jse


def test_constant_provider_matches_reference_stub():
    """The committed GPT_3_caller returns the scalar 1 before any work
    (ref: data_preprocessor.py:459-461); ConstantProvider is that, in
    both packages, at any dim and value."""
    jse = _jse()
    for kw in ({}, {"dim": 4, "value": 2.5}):
        got = pse.ConstantProvider(**kw).embed_sentence("anything at all")
        want = jse.ConstantProvider(**kw).embed_sentence("anything at all")
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pse.ConstantProvider().embed_sentence("x"), np.ones(1, np.float32))


@pytest.mark.parametrize("dim,seed", [(256, 3), (1024, 0), (7, 11)])
def test_hashed_provider_bit_identical_to_jax(dim, seed):
    """The same (dim, seed, text) gives JAX's vector bit for bit, one
    sentence at a time and through embed_batch; the properties JAX's test
    asserts hold: deterministic, unit norm, overlap closer than
    disjoint, the empty sentence zero."""
    jse = _jse()
    p, j = pse.HashedNGramProvider(dim, seed), \
        jse.HashedNGramProvider(dim, seed)
    for s in SENTENCES:
        got, want = p.embed_sentence(s), j.embed_sentence(s)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), s
    assert p.embed_batch(SENTENCES).tobytes() == \
        j.embed_batch(SENTENCES).tobytes()
    a = p.embed_sentence("the quick brown fox")
    np.testing.assert_array_equal(
        a, pse.HashedNGramProvider(dim, seed).embed_sentence(
            "the quick brown fox"))
    assert abs(float(np.linalg.norm(a)) - 1.0) < 1e-5
    if dim >= 256:
        assert float(a @ p.embed_sentence("the quick brown dog")) > \
            float(a @ p.embed_sentence("completely unrelated words here"))
    assert float(np.linalg.norm(p.embed_sentence(""))) == 0.0


def test_api_provider_adapts_and_validates():
    """Both packages' ApiProvider call the user's function once a
    sentence, return its float32 vector and refuse a wrong width with
    ValueError."""
    jse = _jse()
    for mod in (pse, jse):
        calls = []

        def fake(s, calls=calls):
            calls.append(s)
            return [0.5] * 8

        out = mod.ApiProvider(fake, dim=8).embed_sentence("hi")
        assert out.shape == (8,) and out.dtype == np.float32
        assert calls == ["hi"]
        with pytest.raises(ValueError, match="dim 2"):
            mod.ApiProvider(lambda s: [1.0, 2.0], dim=8).embed_sentence("x")


def test_cached_provider_lookup_then_call(tmp_path):
    """Reference semantics (ref: inference_text2embedding_GENEA.py:57-68):
    scan the cache, call the live provider only on a miss; the port's
    saved cache warms JAX's provider and JAX's the port's, with no live
    call for a cached sentence."""
    jse = _jse()
    paths = {}
    for name, mod in (("port", pse), ("jax", jse)):
        calls = []
        inner = mod.ApiProvider(lambda s, c=calls: (c.append(s) or
                                                    np.arange(4) + len(s)),
                                dim=4)
        paths[name] = str(tmp_path / f"{name}.npz")
        p = mod.CachedProvider(inner, paths[name])
        e1 = p.embed_sentence("hello world")
        np.testing.assert_array_equal(p.embed_sentence("hello world"), e1)
        assert calls == ["hello world"]
        p.embed_sentence("other")
        p.save()
        assert p.n_cached == 2
    for reader, path in ((jse, paths["port"]), (pse, paths["jax"])):
        calls2 = []
        inner = reader.ApiProvider(lambda s: calls2.append(s) or
                                   np.zeros(4), dim=4)
        p2 = reader.CachedProvider(inner, path)
        assert p2.n_cached == 2
        np.testing.assert_array_equal(
            p2.embed_sentence("hello world"),
            np.arange(4, dtype=np.float32) + 11)
        assert calls2 == []
    with pytest.raises(ValueError, match="no cache path"):
        pse.CachedProvider(pse.ConstantProvider()).save()


def test_save_load_cache_roundtrip(tmp_path):
    """save_cache / load_cache: each package reads what the other
    writes, the same texts and float32 vectors."""
    jse = _jse()
    cache = {"a b": np.array([1.0, 2.0], np.float32),
             "c": np.array([3.0, 4.0], np.float32)}
    for writer, reader in ((pse, jse), (jse, pse), (pse, pse)):
        path = str(tmp_path / "c.npz")
        writer.save_cache(path, cache)
        loaded = reader.load_cache(path)
        assert set(loaded) == {"a b", "c"}
        for k, v in cache.items():
            assert loaded[k].dtype == np.float32
            np.testing.assert_array_equal(loaded[k], v)
    pse.save_cache(str(tmp_path / "e.npz"), {})
    assert pse.load_cache(str(tmp_path / "e.npz")) == \
        jse.load_cache(str(tmp_path / "e.npz")) == {}


def test_import_reference_gpt_cache(tmp_path):
    """A reference-format .gpt pickle ({sample_words_list,
    GPT_3_Embedding_list}) converts into the same cache dict as JAX's,
    usable as a CachedProvider warm start."""
    jse = _jse()
    gpt = str(tmp_path / "transcript.gpt")
    with open(gpt, "wb") as f:
        pickle.dump({"sample_words_list": ["hello there", "bye"],
                     "GPT_3_Embedding_list": [[0.1] * 6,
                                              np.full((1, 6), 0.2)]}, f)
    cache, want = pse.import_reference_gpt_cache(gpt), \
        jse.import_reference_gpt_cache(gpt)
    assert set(cache) == set(want) == {"hello there", "bye"}
    for k in want:
        assert cache[k].shape == (6,) and cache[k].dtype == np.float32
        assert cache[k].tobytes() == want[k].tobytes()
    path = str(tmp_path / "c.npz")
    pse.save_cache(path, cache)
    p = pse.CachedProvider(pse.ConstantProvider(dim=6), path)
    np.testing.assert_allclose(p.embed_sentence("bye"),
                               np.full(6, 0.2, np.float32))


def test_sentence_dataset_gets_embedding_slot(rng, tmp_path):
    """build_sentence_dataset fills the GPT3_Embedding batch slot (ref:
    lmdb_data_loader.py:67-119) when a provider is passed: the port's
    dataset beside JAX's on one store, with the DAE and tokenizer built
    from the same JAX init - every array equal (tokens and ids exactly),
    "sentence_emb" (N, 32) bit for bit; without a provider the slot is
    absent, as in JAX."""
    import jax

    from gesture2vec_tpu.data.sentence import \
        build_sentence_dataset as jax_build
    from gesture2vec_tpu.data.store import ClipStore as JaxStore
    from gesture2vec_tpu.data.store import ClipStoreWriter
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.dae_trainer import (init_state as dae_init,
                                                   make_frame_model)
    from gesture2vec_tpu.train.optim import make_optimizer
    from gesture2vec_tpu.train.seq_ae_trainer import (init_state as sq_init,
                                                      make_seq_ae)

    from gesture2vec_tpu_torch.compat.from_jax import (frame_model_from_jax,
                                                       seq_ae_from_jax)
    from gesture2vec_tpu_torch.data.sentence import build_sentence_dataset
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.text.vocab import Vocab

    d, flen = 18, 24
    root = str(tmp_path / "store")
    w = ClipStoreWriter(root)
    words = [[f"w{i}", i * 0.2, i * 0.2 + 0.15] for i in range(40)]
    w.add_clip("c0", rng.normal(size=(96, d)).astype(np.float32),
               words=words)
    w.set_stats(np.zeros(d), np.ones(d))
    w.finish()
    jvocab, vocab = JaxVocab("t"), Vocab("t")
    for word, *_ in words:
        jvocab.index_word(word)
        vocab.index_word(word)

    opt = make_optimizer(1e-3)
    dae_cfg = load_config(dict(name="d", model="DAE", hidden_size=8,
                               input_motion_dim=d, epochs=1,
                               batch_size=4, random_seed=0))
    dae = make_frame_model(dae_cfg)
    dae_vars = {"params": dae_init(dae_cfg, dae, jax.random.PRNGKey(0),
                                   opt).params}
    sq_cfg = load_config(dict(name="s", model="seq2seq", hidden_size=12,
                              n_layers=2, dropout_prob=0.0, epochs=1,
                              batch_size=4, rep_learning_dim=8,
                              n_poses=8, n_pre_poses=1,
                              autoencoder_vq=True,
                              autoencoder_vq_components=8,
                              random_seed=0))
    seq = make_seq_ae(sq_cfg)
    sst = sq_init(sq_cfg, seq, jax.random.PRNGKey(1), opt)
    seq_vars = jax.tree_util.tree_map(np.asarray, {
        "params": sst.params, "batch_stats": sst.batch_stats})
    dae_vars = jax.tree_util.tree_map(np.asarray, dae_vars)
    kw = dict(sentence_frame_length=flen, stride=flen, n_frames=8, fps=20,
              max_words=16)

    want = jax_build(JaxStore(root), jvocab, dae_model=dae,
                     dae_variables=dae_vars, seq_model=seq,
                     seq_variables=seq_vars,
                     sentence_embedding=_jse().HashedNGramProvider(
                         dim=32, seed=1), **kw)
    port_dae = frame_model_from_jax(dae_vars, motion_dim=d, latent_dim=8)
    port_seq = seq_ae_from_jax(seq_vars, n_frames=8, n_pre_poses=1)
    got = build_sentence_dataset(
        ClipStore(root), vocab, dae_model=port_dae, seq_model=port_seq,
        sentence_embedding=pse.HashedNGramProvider(dim=32, seed=1), **kw)
    n = got["word_ids"].shape[0]
    assert n > 0 and sorted(got) == sorted(want)
    assert got["sentence_emb"].shape == (n, 32)
    assert got["sentence_emb"].dtype == np.float32
    assert np.isfinite(got["sentence_emb"]).all()
    for key in ("word_ids", "lengths", "tokens", "sentence_emb"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    np.testing.assert_allclose(got["poses"], np.asarray(want["poses"]),
                               rtol=0, atol=1e-6)
    plain = build_sentence_dataset(ClipStore(root), vocab,
                                   dae_model=port_dae, seq_model=port_seq,
                                   **kw)
    assert "sentence_emb" not in plain
    np.testing.assert_array_equal(plain["tokens"], got["tokens"])
