"""PyTorch port vs the JAX package: the decode policies and the GRU text
encoder.

Same seeded numpy weights go through the JAX GestureGenerator (the
bench.py builder at small widths, weights perturbed) and the port's
(compat/from_jax). Token ids, stage ids and beams' ids are exactly equal;
floats within 1e-5 (fp32 on both sides, sums in another order). The
random streams of the two packages differ, so sampling is held exactly
by feeding the port the JAX package's own Gumbel draws: `sample_logits`
directly, and whole decodes by recording, through an ordered callback,
the noise of every categorical draw the JAX decode makes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import (generator_from_jax,
                                                   text2token_from_jax)
from gesture2vec_tpu_torch.models import text2token as port_t2t
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


def _t2t_cfg(token_stages=1, stage_conditional=False, encoder="tcn"):
    from gesture2vec_tpu.train.config import load_config

    return load_config(dict(
        name="t", model="seq2seq", hidden_size=HID, n_layers=2,
        dropout_prob=0.2, epochs=1, batch_size=8, sentence_frame_length=SENT,
        n_poses=NF, n_pre_poses=2, autoencoder_vq=True,
        autoencoder_vq_components=K, autoencoder_att=True,
        wordembed_dim=WORDEMBED, random_seed=0, token_stages=token_stages,
        stage_conditional=stage_conditional,
        extras={"text_encoder": encoder}))


_GENS = {}


def jax_gen(token_stages=1, stage_conditional=False, encoder="tcn"):
    """A decode-mode JAX generator at small widths with perturbed weights
    (one per model variant, shared by the tests of this file)."""
    key = (token_stages, stage_conditional, encoder)
    if key in _GENS:
        return _GENS[key]
    from bench import build_generator
    from gesture2vec_tpu.train.optim import make_optimizer
    from gesture2vec_tpu.train.text2token_trainer import (init_state,
                                                          make_text2token)

    g = build_generator(hid=HID, rep=REP, k=K, dim=DIM, n_frames=NF,
                        sent_len=SENT, n_words=N_WORDS, max_words=MAXW,
                        wordembed=WORDEMBED, vocab_words=VOCAB_WORDS,
                        fps=FPS, mode="decode", token_stages=token_stages,
                        stage_conditional=stage_conditional)
    t2t, t2t_vars = g.t2t_model, g.t2t_variables
    if encoder != "tcn":
        t2t = make_text2token(_t2t_cfg(token_stages, stage_conditional,
                                       encoder), N_WORDS)
        st = init_state(t2t, jax.random.PRNGKey(2), make_optimizer(1e-3),
                        max_words=MAXW)
        t2t_vars = {"params": st.params, "batch_stats": st.batch_stats}
    rng = np.random.default_rng(7)
    seq_vars = perturb(_np(g.seq_variables), rng)
    _GENS[key] = dataclasses.replace(
        g, t2t_model=t2t, t2t_variables=perturb(_np(t2t_vars), rng),
        seq_variables=seq_vars, dae_variables=perturb(_np(g.dae_variables),
                                                      rng),
        pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32))
    return _GENS[key]


def _port(g, mode="decode", **kw):
    return generator_from_jax(
        g.t2t_variables, g.seq_variables, g.dae_variables, _vocab(),
        g.pose_mean, g.pose_std, n_frames=NF, sentence_frame_length=SENT,
        fps=FPS, max_words=MAXW, device="cpu", mode=mode, **kw)


def _both(g, duration=7.0, port_kw=None, **kw):
    """(JAX (frames, tokens), port (frames, tokens)) for one request under
    the same options."""
    want = dataclasses.replace(g, **kw).generate(_words(duration), duration)
    got = _port(g, **{**kw, **(port_kw or {})}).generate(_words(duration),
                                                       duration)
    return want, got


def _assert_same(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


class _NoiseRecorder:
    """Records, in order, the Gumbel noise of every categorical draw the
    JAX decode makes (jax.random.categorical(key, lg) is argmax(lg +
    gumbel(key, lg.shape)), which test_sample_logits_matches_jax pins)."""

    def __init__(self, monkeypatch):
        from gesture2vec_tpu.models import text2token as jax_t2t

        self.draws = []
        orig = jax_t2t.sample_logits

        def recording(logits, temperature, top_k, key):
            g = jax.random.gumbel(key, logits.shape, logits.dtype)
            jax.debug.callback(lambda x: self.draws.append(np.asarray(x)),
                               g, ordered=True)
            return orig(logits, temperature, top_k, key)

        monkeypatch.setattr(jax_t2t, "sample_logits", recording)

    def noise(self, B, stages, primary=True, cond=False):
        """The draws as the port's noise (B, n_steps - 1, stages, K).
        Per step the JAX decode draws the primary token (when sampled),
        then the residual stages: one draw for all of them, or one each
        along the stage chain."""
        jax.effects_barrier()
        per_step = int(primary) + (0 if stages == 1 else
                                   stages - 1 if cond else 1)
        assert len(self.draws) == per_step * (N_STEPS - 1)
        g = np.zeros((B, N_STEPS - 1, stages, K), np.float32)
        it = iter(self.draws)
        for t in range(N_STEPS - 1):
            if primary:
                g[:, t, 0] = next(it)
            if stages > 1 and cond:
                for s in range(1, stages):
                    g[:, t, s] = next(it)
            elif stages > 1:
                g[:, t, 1:] = next(it)
        return torch.from_numpy(g)


def _text_batch(rng, B=5):
    lengths = rng.integers(1, MAXW + 1, size=B).astype(np.int32)
    lengths[:2] = (1, MAXW)
    ids = rng.integers(4, N_WORDS, size=(B, MAXW)).astype(np.int32)
    ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
    return ids, lengths


def _encoded(g, rng, B=5):
    """A text batch encoded by the JAX model: (ids, lengths, enc_outs,
    dec_hidden, mask) as numpy, with the batch-max mask."""
    ids, lengths = _text_batch(rng, B)
    m = g.t2t_model
    eo, dh = m.apply(g.t2t_variables, jnp.asarray(ids), jnp.asarray(lengths),
                     method=m.encode_text)
    return ids, lengths, np.array(eo), np.array(dh), \
        np.arange(MAXW) < lengths.max()


# -- sample_logits ---------------------------------------------------------
@pytest.mark.parametrize("top_k", [0, 1, 3])
def test_sample_logits_matches_jax(rng, top_k):
    """Injected jax.random.gumbel noise; row 0 ties two logits at the
    top_k-th value, and both stay in the draw (lax.top_k + `<`)."""
    from gesture2vec_tpu.models.text2token import sample_logits

    logits = rng.normal(size=(64, 10)).astype(np.float32)
    if top_k:
        order = np.argsort(-logits[0])
        logits[0, order[top_k]] = logits[0, order[top_k - 1]]
    key = jax.random.PRNGKey(top_k)
    want = np.asarray(sample_logits(jnp.asarray(logits), 0.7, top_k, key))
    g = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape)))
    lg = torch.from_numpy(logits)
    got = port_t2t.sample_logits(lg, 0.7, top_k, g).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1
    kept = torch.isfinite(port_t2t.decision_scores(lg, 0.7, top_k, g))
    assert kept[0].sum().item() == (top_k + 1 if top_k else 10)


# -- sampled decodes ----------------------------------------------------------
@pytest.mark.parametrize("stages,cond,stage0", [
    (1, False, -1.0), (4, False, -1.0), (4, True, -1.0), (4, False, 0.0),
    (4, True, 0.0)])
def test_sampled_decode_matches_jax(rng, monkeypatch, stages, cond, stage0):
    """Text2Token.decode_tokens at temperature 1, top_k 5, under the JAX
    decode's own noise: ids and stage ids equal. stage0_temperature 0
    keeps the primary ids greedy while the stages sample."""
    g = jax_gen(stages, cond)
    ids, lengths, eo, dh, mask = _encoded(g, rng)
    m = g.t2t_model
    seed = np.zeros((len(ids), N_STEPS), np.int32)
    seed[:, 0] = rng.integers(0, K, len(ids))
    rec = _NoiseRecorder(monkeypatch)
    want = m.apply(g.t2t_variables, jnp.asarray(eo), jnp.asarray(dh),
                   jnp.asarray(seed), train=False, enc_mask=jnp.asarray(mask),
                   method=m.decode_tokens, temperature=1.0, top_k=5,
                   stage0_temperature=stage0,
                   rngs={"sample": jax.random.PRNGKey(3)})
    noise = rec.noise(len(ids), stages, primary=stage0 < 0, cond=cond)
    port = text2token_from_jax(g.t2t_variables, n_steps=N_STEPS)
    with torch.no_grad():
        got = port.decode_tokens(
            torch.from_numpy(eo), torch.from_numpy(dh),
            torch.from_numpy(seed).long(), torch.from_numpy(mask),
            temperature=1.0, top_k=5, stage0_temperature=stage0,
            gumbel=noise)
        greedy = port.decode_tokens(
            torch.from_numpy(eo), torch.from_numpy(dh),
            torch.from_numpy(seed).long(), torch.from_numpy(mask))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL)
    if stages > 1:
        np.testing.assert_array_equal(got["stage_tokens"].numpy(),
                                      np.asarray(want["stage_tokens"]))
        assert (got["stage_tokens"] != greedy["stage_tokens"]).any()
    primary_greedy = torch.equal(got["tokens"], greedy["tokens"])
    assert primary_greedy == (stage0 == 0.0)


def test_sampled_decode_needs_noise():
    port = text2token_from_jax(jax_gen().t2t_variables, n_steps=N_STEPS)
    with pytest.raises(ValueError, match="Gumbel"):
        port.decode_tokens(torch.zeros(MAXW, 1, HID), torch.zeros(2, 1, HID),
                           torch.zeros(1, N_STEPS, dtype=torch.long),
                           temperature=1.0)


@pytest.mark.parametrize("stages,options", [
    (1, dict(temperature=2.0, top_k=1)),
    (4, dict(temperature=1.0, stage0_temperature=0.0))])
def test_greedy_limits_of_sampled_generate(stages, options):
    """top_k 1 at any temperature is the greedy decode; stage0 0 keeps
    the primary ids greedy under sampled stages (the frames then differ)."""
    g = jax_gen(stages)
    want, _ = _both(g)
    port = _port(g, **options)
    frames, toks = port.generate(_words(7.0), 7.0)
    np.testing.assert_array_equal(toks, want[1])
    if stages == 1:
        np.testing.assert_allclose(frames, want[0], atol=ATOL)
    else:
        assert np.abs(frames - want[0]).max() > 1e-3
    # one integer drawn from the numpy stream per sampled request
    assert port._rng.bit_generator.state != \
        np.random.default_rng(0).bit_generator.state


# -- beam search ---------------------------------------------------------
@pytest.mark.parametrize("stages", [(1, False), (4, True)])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_beam_decode_matches_jax(rng, width, stages):
    """Ids, stage ids and the best beam's logprob; width 1 is the greedy
    decode."""
    g = jax_gen(*stages)
    ids, lengths, eo, dh, mask = _encoded(g, rng)
    m = g.t2t_model
    seed = np.zeros((len(ids), N_STEPS), np.int32)
    seed[:, :2] = rng.integers(0, K, (len(ids), 2))
    want = m.apply(g.t2t_variables, jnp.asarray(eo), jnp.asarray(dh),
                   jnp.asarray(seed), beam_width=width,
                   enc_mask=jnp.asarray(mask), method=m.beam_decode)
    port = text2token_from_jax(g.t2t_variables, n_steps=N_STEPS)
    args = (torch.from_numpy(eo), torch.from_numpy(dh),
            torch.from_numpy(seed).long())
    with torch.no_grad():
        got = port.beam_decode(*args, beam_width=width,
                               enc_mask=torch.from_numpy(mask))
        greedy = port.decode_tokens(*args, torch.from_numpy(mask))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["logprob"].numpy(),
                               np.asarray(want["logprob"]), atol=ATOL)
    if stages[0] > 1:
        np.testing.assert_array_equal(got["stage_tokens"].numpy(),
                                      np.asarray(want["stage_tokens"]))
    if width == 1:
        assert torch.equal(got["tokens"], greedy["tokens"])


@pytest.mark.parametrize("window_carry", [True, False])
def test_beam_generate_matches_jax(window_carry):
    want, got = _both(jax_gen(), beam_width=4, window_carry=window_carry)
    _assert_same(want, got)


# -- residual stages, soft decode, chunk transitions -----------------------
@pytest.mark.parametrize("window_carry", [True, False])
@pytest.mark.parametrize("cond", [False, True])
def test_multi_stage_generate_matches_jax(cond, window_carry):
    """A 4-stage Part d over a 4-stage residual-VQ tokenizer: each chunk's
    hidden is the sum of the stage rows it predicts."""
    g = jax_gen(4, cond)
    want, got = _both(g, window_carry=window_carry)
    _assert_same(want, got)
    stage0_only = _port(g, window_carry=window_carry)
    stage0_only.t2t_model.token_stages = 1
    assert np.abs(stage0_only.generate(_words(7.0), 7.0)[0]
                  - got[0]).max() > 1e-3


@pytest.mark.parametrize("stages,soft", [(1, 1.0), (1, 1e-6), (4, 1.0)])
def test_soft_decode_matches_jax(stages, soft):
    g = jax_gen(stages)
    want, got = _both(g, soft_decode=soft)
    _assert_same(want, got)
    hard = _port(g).generate(_words(7.0), 7.0)[0]
    if soft < 1e-3:
        np.testing.assert_allclose(got[0], hard, atol=ATOL)
    else:
        assert np.abs(got[0] - hard).max() > 1e-3


@pytest.mark.parametrize("fused", [True, False])
def test_decode_overlap_matches_jax(fused):
    """Frames outside the blend regions are bit-identical to the
    unblended decode's."""
    g = jax_gen()
    b = 2
    want, got = _both(g, decode_overlap=b, port_kw=dict(
        use_fused_decoder=fused))
    _assert_same(want, got)
    plain = _port(g, use_fused_decoder=fused).generate(_words(7.0), 7.0)[0]
    chunks, plain_chunks = got[0].reshape(-1, NF, DIM), \
        plain.reshape(-1, NF, DIM)
    np.testing.assert_array_equal(chunks[0], plain_chunks[0])
    np.testing.assert_array_equal(chunks[1:, b:], plain_chunks[1:, b:])
    assert (chunks[1:, :b] != plain_chunks[1:, :b]).all(axis=-1).any()


@pytest.mark.parametrize("fused,soft", [(True, 0.0), (False, 0.0),
                                        (True, 1.0)])
def test_chunk_continuity_matches_jax(fused, soft):
    want, got = _both(jax_gen(), chunk_continuity=True, soft_decode=soft,
                      port_kw=dict(use_fused_decoder=fused))
    _assert_same(want, got)


# -- the GRU text encoder -------------------------------------------------
@pytest.mark.parametrize("use_kernel", [True, False])
def test_masked_bigru_matches_jax(rng, use_kernel):
    """Ragged lengths, including 1 and the full length: outputs zero past
    each length, the reverse direction starting at each sequence's last
    step, last hiddens frozen there. On the CPU both routes take the
    plain recurrence."""
    from gesture2vec_tpu.models.gru import MaskedBiGRU as JaxMasked

    from gesture2vec_tpu_torch.compat.from_jax import _gru
    from gesture2vec_tpu_torch.models.gru import MaskedBiGRU

    T, B, IN, H = 9, 6, 7, 11
    xs = rng.normal(size=(T, B, IN)).astype(np.float32)
    lengths = np.array([1, T, 4, 2, 7, T], np.int32)
    jm = JaxMasked(hidden_size=H, n_layers=2)
    params = perturb(_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(xs),
                                 jnp.asarray(lengths))), rng)
    out_j, h_j = jm.apply(params, jnp.asarray(xs), jnp.asarray(lengths))
    tm = MaskedBiGRU(IN, H, 2)
    _gru(tm, params["params"])
    tm.use_kernel = use_kernel
    with torch.no_grad():
        out_t, h_t = tm(torch.from_numpy(xs), torch.from_numpy(lengths))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    assert (out_t[1:, 0] == 0).all() and (out_t[:, 1] != 0).all()


def test_gru_text2token_matches_jax(rng):
    """encoder_type="gru": the encoding (directions summed; the decoder
    hidden is [l0_fwd, l0_bwd]) and the greedy tokens."""
    g = jax_gen(encoder="gru")
    m = g.t2t_model
    ids, lengths = _text_batch(rng, B=7)
    targets = rng.integers(0, K, size=(7, N_STEPS)).astype(np.int32)
    eo_j, dh_j = m.apply(g.t2t_variables, jnp.asarray(ids),
                         jnp.asarray(lengths), method=m.encode_text)
    res_j = m.apply(g.t2t_variables, jnp.asarray(ids), jnp.asarray(lengths),
                    jnp.asarray(targets), train=False)
    port = text2token_from_jax(g.t2t_variables, n_steps=N_STEPS)
    assert port.encoder_type == "gru"
    with torch.no_grad():
        ids_t, len_t = torch.from_numpy(ids).long(), \
            torch.from_numpy(lengths).long()
        eo_t, dh_t = port.encode_text(ids_t, len_t)
        res_t = port(ids_t, len_t, torch.from_numpy(targets).long())
    np.testing.assert_allclose(eo_t.numpy(), np.asarray(eo_j), atol=ATOL)
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), atol=ATOL)
    np.testing.assert_array_equal(res_t["tokens"].numpy(),
                                  np.asarray(res_j["tokens"]))
    assert len(np.unique(res_t["tokens"].numpy()[:, 2:])) > 1


@pytest.mark.parametrize("window_carry", [True, False])
def test_gru_encoder_generate_matches_jax(window_carry):
    want, got = _both(jax_gen(encoder="gru"), window_carry=window_carry)
    _assert_same(want, got)


# -- exclusive options -------------------------------------------------------
@pytest.mark.parametrize("options,match", [
    (dict(beam_width=4, temperature=1.0), "mutually exclusive"),
    (dict(soft_decode=1.0, mode="exemplar"), "decode mode"),
    (dict(soft_decode=1.0, beam_width=3), "beam search"),
    (dict(decode_overlap=2, chunk_continuity=True), "mutually exclusive")])
def test_exclusive_options_raise_like_jax(options, match):
    g = jax_gen()
    bank = {"dae_latents": np.zeros((4, NF, REP), np.float32),
            "tokens": np.arange(4, dtype=np.int32)}
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(g, latent_bank=bank, **options)
    with pytest.raises(ValueError, match=match):
        _port(g, latent_bank=bank, **options)


# -- the kernels at the shapes of these paths, on the card ---------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.gpu
def test_gru_kernel_at_text_encoder_shapes_on_card():
    """T=48 (the word window), H=200, batches of 1, 16, 303 and 304
    windows (303 is no multiple of the 20-row cluster tile)."""
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    H = 200
    w = (torch.rand(3 * H, H, device="cuda", generator=g) * 2 - 1) / H ** .5
    b = (torch.rand(3 * H, device="cuda", generator=g) * 2 - 1) / H ** .5
    for B in (1, 16, 303, 304):
        xp = torch.randn(48, B, 3 * H, device="cuda", generator=g)
        h0 = torch.zeros(B, H, device="cuda")
        ys, h = gk.gru_sequence(xp, h0, w, b)
        ys_p, h_p = gk.gru_sequence_plain(xp, h0, w, b)
        torch.cuda.synchronize()
        assert (ys - ys_p).abs().max().item() < 1e-4
        assert (h - h_p).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_chunk_decoder_at_overlap_and_continuity_shapes_on_card():
    """n_steps 24 (20-frame chunks and a 4-frame overlap) at the 60 s
    request's 96 chunks, and one chunk at a time (B=1)."""
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk

    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    H, D = 200, 40

    def u(*shape):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) \
            / H ** .5

    w = dk.FoldedDecoder(u(H, D), 1 + 0.1 * torch.randn(
        H, device="cuda", generator=g), u(H),
        *[t for _ in range(2) for t in (u(3 * H, H), u(3 * H, H), u(3 * H),
                                        u(3 * H))], u(D, H), u(D))
    for B, n in ((96, 24), (1, 20), (1, 24)):
        x0 = torch.randn(B, D, device="cuda", generator=g)
        h0 = torch.randn(2, B, H, device="cuda", generator=g)
        ys = dk.fused_chunk_decode(x0, h0, w, n)
        ref = dk.fused_chunk_decode_plain(x0, h0, w, n)
        torch.cuda.synchronize()
        assert ys.shape == (n, B, D)
        assert (ys - ref).abs().max().item() < 1e-4
