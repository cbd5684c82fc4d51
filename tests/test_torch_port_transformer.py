"""PyTorch port vs the JAX package: the transformer Part d (`t2t_arch:
transformer`, the recommended recipe's) and the transformer chunk encoder
(`seq_arch: transformer`).

Both packages get the same seeded numpy weights (a JAX init, perturbed)
and inputs, at H=32, 4 heads, 2 layers, 12 codes and 10-word sentences.
Floats agree within 1e-5; token ids, stage ids and beams' ids are equal.
Sampled decodes are fed the JAX decode's own Gumbel noise, recorded in
order by a callback: in the stage-conditional mode JAX draws for every
position of the buffer at each step, and the port reads the slice at
position t - 1, the only one the rollout uses.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat import from_jax as fj
from gesture2vec_tpu_torch.models import transformer as port_tf
from gesture2vec_tpu_torch.models.seq_encoder import TransformerSeqEncoder
from gesture2vec_tpu_torch.models.text2token import choose_step
from gesture2vec_tpu_torch.text.vocab import Vocab

ATOL = 1e-5
HID, HEADS, L, K, MAXW = 32, 4, 2, 12, 10
REP, DIM, NF, SENT, FPS = 8, 12, 4, 24, 20
N_WORDS, WORDEMBED, VOCAB_WORDS = 60, 12, 40
N_STEPS = SENT // NF


def perturb(tree, rng, scale=0.1):
    """Moves every weight by N(0, scale): at H=32 a transformer's inits are
    ~0.18, so activations stay of order 1."""
    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


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


def _text_batch(rng, B=5):
    """Ragged sentences, one of length 1 and one of the full length."""
    lengths = rng.integers(1, MAXW + 1, size=B).astype(np.int32)
    lengths[:2] = (1, MAXW)
    ids = rng.integers(4, N_WORDS, size=(B, MAXW)).astype(np.int32)
    ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
    return ids, lengths


def _init(module, *args, **kw):
    """A JAX module's variables (numpy), initialised as one compiled
    program."""
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "dropout": jax.random.fold_in(key, 1),
            "reparam": jax.random.fold_in(key, 2)}
    return _np(jax.jit(lambda r, *a: module.init(r, *a, **kw))(rngs, *args))


def _apply(module, variables, *args, **kw):
    """module.apply as one compiled program (kw static: method, flags,
    rngs)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def _cfg(**kw):
    from gesture2vec_tpu.train.config import load_config

    return load_config(dict(
        model="seq2seq", hidden_size=HID, n_layers=L, dropout_prob=0.2,
        epochs=1, batch_size=8, n_poses=NF, autoencoder_vq=True,
        autoencoder_vq_components=K, random_seed=0, **kw))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


_T2T = {}


def _t2t(stages=1, cond=False, n_pre=2):
    """(JAX TransformerText2Token, its perturbed variables, the port's
    model from them), one init per stage variant."""
    from gesture2vec_tpu.models.transformer import TransformerText2Token

    m = TransformerText2Token(
        n_words=N_WORDS, n_tokens=K, hidden_size=HID, n_layers=L,
        n_steps=N_STEPS, n_pre_poses=n_pre, dropout=0.2,
        word_embed_size=WORDEMBED, n_heads=HEADS, token_stages=stages,
        stage_conditional=cond)
    if (stages, cond) not in _T2T:
        ids, lengths = _text_batch(np.random.default_rng(1))
        _T2T[stages, cond] = perturb(_init(
            m, jnp.asarray(ids), jnp.asarray(lengths),
            jnp.zeros((len(ids), N_STEPS), jnp.int32)),
            np.random.default_rng(7))
    variables = _T2T[stages, cond]
    port = fj.transformer_text2token_from_jax(
        variables, n_steps=N_STEPS, n_pre_poses=n_pre, n_heads=HEADS)
    return m, variables, port


# -- the modules ------------------------------------------------------------
def _mha(rng, masked):
    from gesture2vec_tpu.models.transformer import MHA

    B, Tq, Tk = 4, 5, 7
    q = rng.normal(size=(B, Tq, HID)).astype(np.float32)
    kv = rng.normal(size=(B, Tk, HID)).astype(np.float32)
    mask = None
    if masked:   # a length-1 row, a full one, a fully masked one
        lengths = np.array([1, Tk, 3, 0])
        mask = (np.arange(Tk)[None, :] < lengths[:, None])[:, None, None, :]
    jm = MHA(HID, HEADS)
    params = perturb(_init(jm, q, kv, mask), rng)
    want = _apply(jm, params, q, kv, mask)
    tm = port_tf.MHA(HID, HEADS)
    for proj in "qkvo":
        fj._dense(getattr(tm, proj), params["params"][proj])
    got = tm(_t(q), _t(kv), None if mask is None else _t(mask, torch.bool))
    if masked:
        w = got[1].detach().numpy()
        assert (w[0, :, 1:] == 0).all()
        np.testing.assert_allclose(w[3], 1.0 / Tk, atol=1e-7)
    return got, want


def _block(rng, cross):
    from gesture2vec_tpu.models.transformer import Block

    B, T, S = 3, 5, 7
    x = rng.normal(size=(B, T, HID)).astype(np.float32)
    causal = np.tril(np.ones((T, T), bool))[None, None]
    enc = rng.normal(size=(B, S, HID)).astype(np.float32)
    em = (np.arange(S)[None, :] < np.array([1, S, 4])[:, None])[
        :, None, None, :]
    kw = dict(enc=enc, enc_mask=em) if cross else {}
    jb = Block(HID, HEADS, 0.0, cross=cross)
    params = perturb(_init(jb, x, causal, **kw), rng)
    y, w = _apply(jb, params, x, causal, **kw)
    tb = port_tf.Block(HID, HEADS, cross=cross)
    fj._block(tb, params["params"])
    got = tb(_t(x), _t(causal, torch.bool), *(
        (_t(enc), _t(em, torch.bool)) if cross else ()))
    assert (got[1] is None) == (not cross)
    return [got[0]] + ([got[1]] if cross else []), \
        [y] + ([w] if cross else [])


def _text_encoder(rng):
    m, variables, port = _t2t()
    ids, lengths = _text_batch(rng)
    want = _apply(m, variables, jnp.asarray(ids), jnp.asarray(lengths),
                  method=lambda mod, i, n: mod.encoder(i, n))
    got = port.encoder(_t(ids, torch.long), _t(lengths, torch.long))
    return got, want


def _token_decoder(rng, stages, cond):
    m, variables, port = _t2t(stages, cond)
    B, S = 5, MAXW
    buf = rng.integers(0, K, size=(B, N_STEPS - 1)).astype(np.int32)
    enc = rng.normal(size=(B, S, HID)).astype(np.float32)
    em = np.arange(S)[None, :] < np.array([1, S, 3, 6, 2])[:, None]
    want = _apply(m, variables, jnp.asarray(buf), jnp.asarray(enc),
                  jnp.asarray(em),
                  method=lambda mod, b, e, k: mod.decoder(b, e, k))
    logits, cross_w, out = port.decoder(_t(buf, torch.long), _t(enc),
                                        _t(em, torch.bool))
    got = [logits, cross_w]
    if stages > 1:
        best, slg, stok = choose_step(port.decoder, logits, out, 0.0, 0,
                                      -1.0, None)
        got.append(slg)
        if cond:
            np.testing.assert_array_equal(best.numpy(), np.asarray(want[3]))
            np.testing.assert_array_equal(stok.numpy(), np.asarray(want[4]))
    return got, list(want[:len(got)])


def _seq_encoder(rng):
    from gesture2vec_tpu.models.seq_encoder import \
        TransformerSeqEncoder as JaxEncoder

    T, B = 8, 5
    xs = rng.normal(size=(T, B, REP)).astype(np.float32)
    je = JaxEncoder(hidden_size=HID, n_layers=L, dropout=0.0)
    params = perturb(_init(je, jnp.asarray(xs)), rng)["params"]
    want = _apply(je, {"params": params}, jnp.asarray(xs))
    te = TransformerSeqEncoder(REP, HID, L)
    fj._dense(te.in_layer, params["in_layer"])
    fj._fill_blocks(te, params)
    fj._dense(te.hidden_proj, params["hidden_proj"])
    return te(_t(xs)), want


_MODULES = {
    "mha": lambda rng: _mha(rng, False),
    "mha_masked": lambda rng: _mha(rng, True),
    "block": lambda rng: _block(rng, False),
    "block_cross": lambda rng: _block(rng, True),
    "text_encoder": _text_encoder,
    "token_decoder": lambda rng: _token_decoder(rng, 1, False),
    "token_decoder_stages": lambda rng: _token_decoder(rng, 4, False),
    "token_decoder_chain": lambda rng: _token_decoder(rng, 4, True),
    "seq_encoder": _seq_encoder}


@pytest.mark.parametrize("case", list(_MODULES))
def test_module_matches_jax(rng, case):
    """MHA (masked: a length-1 row attends to one position, a fully masked
    row uniformly), Block, the text encoder, the token decoder (stage
    heads independent and chained, greedy) and the chunk encoder."""
    with torch.no_grad():
        got, want = _MODULES[case](rng)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        _close(g, w)


# -- whole decodes ------------------------------------------------------------
def _compare_decode(got, want):
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    for k in ("logits", "attentions", "stage_logits"):
        assert (k in got) == (k in want)
        if k in want:
            _close(got[k], want[k])
    if "stage_tokens" in want:
        np.testing.assert_array_equal(got["stage_tokens"].numpy(),
                                      np.asarray(want["stage_tokens"]))


@pytest.mark.parametrize("stages,cond,n_pre", [
    (1, False, 0), (1, False, 2), (4, False, 1), (4, True, 1)])
def test_greedy_decode_matches_jax(rng, stages, cond, n_pre):
    """Encode + decode with each sentence's own mask, teacher prefixes of
    0, 1 and 2 tokens (0 clamps to 1: the seed is always in the buffer)."""
    m, variables, port = _t2t(stages, cond, n_pre)
    ids, lengths = _text_batch(rng)
    targets = rng.integers(0, K, size=(len(ids), N_STEPS)).astype(np.int32)
    want = _apply(m, variables, jnp.asarray(ids), jnp.asarray(lengths),
                  jnp.asarray(targets), train=False)
    args = (_t(ids, torch.long), _t(lengths, torch.long),
            _t(targets, torch.long))
    with torch.no_grad():
        got = port(*args)
    _compare_decode(got, want)
    assert len(np.unique(got["tokens"].numpy()[:, 2:])) > 1
    if n_pre == 0:
        with torch.no_grad():
            clamped = _t2t(stages, cond, 1)[2](*args)
        assert torch.equal(got["tokens"], clamped["tokens"])


class _NoiseRecorder:
    """Records, in order, the Gumbel noise of every categorical draw the
    JAX decode makes (jax.random.categorical(key, lg) is argmax(lg +
    gumbel(key, lg.shape))), from the Part-d module and the stage chain."""

    def __init__(self, monkeypatch):
        from gesture2vec_tpu.models import text2token as jax_t2t
        from gesture2vec_tpu.models import transformer as jax_tf

        self.draws = []
        orig = jax_t2t.sample_logits

        def recording(logits, temperature, top_k, key):
            g = jax.random.gumbel(key, logits.shape, logits.dtype)
            jax.debug.callback(lambda x: self.draws.append(np.asarray(x)),
                               g, ordered=True)
            return orig(logits, temperature, top_k, key)

        monkeypatch.setattr(jax_t2t, "sample_logits", recording)
        monkeypatch.setattr(jax_tf, "sample_logits", recording)

    def noise(self, B, stages, primary, staged, cond, windows=1):
        """The draws as the port's noise (B, windows, n_steps - 1, stages,
        K), windows decoded one after another. Per step JAX draws the
        primary token (when sampled), then the residual stages (when
        sampled): one draw for all, or one each along the chain. The
        chain's draws cover every position (B, n_steps - 1, K): position
        t - 1 is step t's."""
        jax.effects_barrier()
        per_step = int(primary) + (
            0 if stages == 1 or not staged else stages - 1 if cond else 1)
        assert len(self.draws) == per_step * (N_STEPS - 1) * windows
        g = np.zeros((B, windows, N_STEPS - 1, stages, K), np.float32)
        it = iter(self.draws)
        for w in range(windows):
            for t in range(N_STEPS - 1):
                at = (lambda d, t=t: d[:, t]) if cond else (lambda d: d)
                if primary:
                    g[:, w, t, 0] = at(next(it))
                if staged and stages > 1 and cond:
                    for s in range(1, stages):
                        g[:, w, t, s] = at(next(it))
                elif staged and stages > 1:
                    g[:, w, t, 1:] = next(it)
        self.draws.clear()
        return torch.from_numpy(g)


@pytest.mark.parametrize("stages,cond,temperature,stage0", [
    (1, False, 1.0, -1.0), (4, False, 1.0, -1.0), (4, True, 1.0, -1.0),
    (4, True, 1.0, 0.0), (4, True, 0.0, 1.0)])
def test_sampled_decode_matches_jax(rng, monkeypatch, stages, cond,
                                    temperature, stage0):
    """Temperature and stage0_temperature (0 keeps the primary greedy; at
    temperature 0 and stage0 1 - the recipe's policy - only the primary
    samples), top_k 5, under the JAX decode's own noise."""
    m, variables, port = _t2t(stages, cond, 1)
    ids, lengths = _text_batch(rng)
    seed = np.zeros((len(ids), N_STEPS), np.int32)
    seed[:, 0] = rng.integers(0, K, len(ids))
    eo, dh = _apply(m, variables, jnp.asarray(ids), jnp.asarray(lengths),
                    method=m.encode_text)
    mask = np.arange(MAXW)[None, :] < lengths[:, None]
    rec = _NoiseRecorder(monkeypatch)
    want = _apply(m, variables, eo, dh, jnp.asarray(seed),
                  jnp.asarray(mask), train=False, temperature=temperature,
                  top_k=5, stage0_temperature=stage0,
                  method=lambda mod, *a, **k: mod.decode_tokens(
                      *a[:3], enc_mask=a[3], **k),
                  rngs={"sample": jax.random.PRNGKey(3)})
    t0 = temperature if stage0 < 0 else stage0
    noise = rec.noise(len(ids), stages, t0 > 0, temperature > 0, cond)[:, 0]
    args = (_t(eo), _t(dh), _t(seed, torch.long), _t(mask, torch.bool))
    with torch.no_grad():
        got = port.decode_tokens(*args, temperature=temperature, top_k=5,
                                 stage0_temperature=stage0, gumbel=noise)
        greedy = port.decode_tokens(*args)
    _compare_decode(got, want)
    assert torch.equal(got["tokens"], greedy["tokens"]) == (t0 == 0)
    if stages > 1 and temperature > 0:
        assert not torch.equal(got["stage_tokens"], greedy["stage_tokens"])
    with pytest.raises(ValueError, match="Gumbel"):
        port.decode_tokens(*args, temperature=temperature,
                           stage0_temperature=stage0)


@pytest.mark.parametrize("stages,cond", [(1, False), (4, True)])
@pytest.mark.parametrize("width", [1, 4])
def test_beam_decode_matches_jax(rng, width, stages, cond):
    """Ids, stage ids and the best beam's logprob; width 1 is the greedy
    decode."""
    m, variables, port = _t2t(stages, cond, 2)
    ids, lengths = _text_batch(rng)
    seed = np.zeros((len(ids), N_STEPS), np.int32)
    seed[:, :2] = rng.integers(0, K, (len(ids), 2))
    eo, dh = _apply(m, variables, jnp.asarray(ids), jnp.asarray(lengths),
                    method=m.encode_text)
    mask = np.arange(MAXW)[None, :] < lengths[:, None]
    want = _apply(m, variables, eo, dh, jnp.asarray(seed),
                  jnp.asarray(mask), beam_width=width,
                  method=lambda mod, *a, **k: mod.beam_decode(
                      *a[:3], enc_mask=a[3], **k))
    args = (_t(eo), _t(dh), _t(seed, torch.long))
    with torch.no_grad():
        got = port.beam_decode(*args, beam_width=width,
                               enc_mask=_t(mask, torch.bool))
        greedy = port.decode_tokens(*args, _t(mask, torch.bool))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    _close(got["logprob"], want["logprob"])
    if stages > 1:
        np.testing.assert_array_equal(got["stage_tokens"].numpy(),
                                      np.asarray(want["stage_tokens"]))
    if width == 1:
        assert torch.equal(got["tokens"], greedy["tokens"])


def test_train_mode_is_refused(rng, monkeypatch):
    """Train mode is no longer refused: it is the teacher-forced parallel
    pass of JAX's train=True (dropout off on both sides, flax's patched to
    the identity), 4 chained stages on the teacher codes: logits, stage
    logits and attentions within 1e-5, the argmax tokens equal; without
    stage_targets it raises JAX's error."""
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    m, variables, port = _t2t(4, True, 1)
    ids, lengths = _text_batch(rng)
    stages = rng.integers(0, K, (len(ids), N_STEPS, 4)).astype(np.int32)
    args = (jnp.asarray(ids), jnp.asarray(lengths),
            jnp.asarray(stages[:, :, 0]))
    want = _apply(m, variables, *args, train=True,
                  stage_targets=jnp.asarray(stages))
    targs = (_t(ids, torch.long), _t(lengths, torch.long),
             _t(stages[:, :, 0], torch.long))
    port.train()
    with torch.no_grad():
        got = port(*targs, stage_targets=_t(stages, torch.long))
    for key in ("logits", "stage_logits", "attentions"):
        _close(got[key], want[key])
    for key in ("tokens", "stage_tokens"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    with pytest.raises(ValueError, match="needs stage_targets"):
        port(*targs)


# -- the generator end to end --------------------------------------------
@pytest.fixture(scope="module")
def recipe_gen():
    """The recommended recipe at small widths: a 4-stage stage-conditional
    transformer Part d (teacher prefix 1) over a 4-stage residual-VQ
    tokenizer, exemplar mode over a 300-window bank; weights perturbed."""
    from gesture2vec_tpu.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.dae_trainer import make_frame_model
    from gesture2vec_tpu.train.seq_ae_trainer import make_seq_ae

    rng = np.random.default_rng(7)
    t2t, t2t_vars, _ = _t2t(4, True, 1)
    dae = make_frame_model(load_config(dict(
        name="d", model="DAE", hidden_size=REP, input_motion_dim=DIM,
        random_seed=0)))
    seq = make_seq_ae(_cfg(name="s", rep_learning_dim=REP, n_pre_poses=1,
                           autoencoder_vq_variant="rvq", rvq_stages=4))
    dummy = jnp.zeros((2, NF, REP))
    vocab = JaxVocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    bank = {"dae_latents": rng.normal(size=(300, NF, REP)).astype(
        np.float32), "tokens": rng.integers(0, K, 300).astype(np.int32)}
    return GestureGenerator(
        t2t_model=t2t, t2t_variables=t2t_vars, seq_model=seq,
        seq_variables=perturb(_init(seq, dummy, dummy, train=False), rng),
        dae_model=dae, dae_variables={"params": perturb(_init(
            dae, jnp.zeros((2, DIM)), train=False)["params"], rng)},
        vocab=vocab, pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32),
        n_frames=NF, sentence_frame_length=SENT, fps=FPS, max_words=MAXW,
        mode="exemplar", latent_bank=bank, seed=0)


def _port(g, device="cpu", **kw):
    return fj.generator_from_jax(
        g.t2t_variables, g.seq_variables, g.dae_variables, _vocab(),
        g.pose_mean, g.pose_std, n_frames=NF, sentence_frame_length=SENT,
        fps=FPS, max_words=MAXW, latent_bank=g.latent_bank,
        t2t_n_pre_poses=1, t2t_heads=HEADS, device=device, **kw)


def _assert_same(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


@pytest.mark.parametrize("mode", ["decode", "exemplar"])
@pytest.mark.parametrize("window_carry", [True, False])
def test_generate_matches_jax(recipe_gen, mode, window_carry):
    kw = dict(mode=mode, window_carry=window_carry)
    port = _port(recipe_gen, **kw)
    assert isinstance(port.t2t_model, port_tf.TransformerText2Token)
    want = dataclasses.replace(recipe_gen, **kw).generate(_words(7.0), 7.0)
    got = port.generate(_words(7.0), 7.0)
    _assert_same(want, got)
    assert len(np.unique(got[1])) > 2


def test_per_sentence_mask_on_windows_of_two_lengths(recipe_gen):
    """window_carry=False decodes both windows in one batch: each attends
    over its own words (7 and 2, with SOS and EOS 9 and 4), as JAX's
    transformer does. The batch-max mask of the GRU model would let the
    second window read 5 pad positions, which carry content here, and its
    decode would change."""
    words = ([[f"word{i}", 0.1 * i + 0.05, 0.1 * i + 0.1] for i in range(7)]
             + [["word30", 1.3, 1.4], ["word31", 1.6, 1.7]])
    kw = dict(mode="decode", window_carry=False)
    port = _port(recipe_gen, **kw)
    ids, lengths, _ = port.window_inputs(words, 2.4)
    assert lengths.tolist() == [9, 4]          # with SOS and EOS
    want = dataclasses.replace(recipe_gen, **kw).generate(words, 2.4)
    got = port.generate(words, 2.4)
    _assert_same(want, got)
    with torch.inference_mode():
        own = port._predict_windows(ids[None], lengths[None])
        port.t2t_model.per_sentence_mask = False
        batch_max = port._predict_windows(ids[None], lengths[None])
    np.testing.assert_array_equal(own["tokens"][0].numpy(), got[1])
    assert not (torch.equal(own["tokens"], batch_max["tokens"])
                and torch.equal(own["stage"], batch_max["stage"]))


def test_generate_batch_matches_jax(recipe_gen):
    """Three transcripts of different lengths in one batch (decode mode,
    all windows at once): tokens as JAX's generate_batch gives them, and
    the frames of each as the port's own generate. The first one's frames
    are held against JAX's generate: JAX's one vmapped batch program
    differs from its own generate by up to 1.5e-5 here (sums in another
    order)."""
    words = [_words(7.0), _words(3.0, 1), _words(2.0, 2)]
    durations = [7.0, 3.0, 2.0]
    kw = dict(mode="decode", window_carry=False)
    want = dataclasses.replace(recipe_gen, **kw).generate_batch(words,
                                                               durations)
    port = _port(recipe_gen, **kw)
    got = port.generate_batch(words, durations)
    assert len(got) == 3
    for w, g_, ws, d in zip(want, got, words, durations):
        np.testing.assert_array_equal(g_[1], w[1])
        _assert_same(port.generate(ws, d), g_)
    _assert_same(dataclasses.replace(recipe_gen, **kw).generate(
        words[0], durations[0]), got[0])


def test_recipe_policy_generate_matches_jax(recipe_gen, monkeypatch):
    """The recipe's decode policy (temperature 0, stage0_temperature 1:
    a sampled primary token, greedy stages) in decode mode, the port fed
    the noise of every draw of the JAX request."""
    kw = dict(mode="decode", temperature=0.0, stage0_temperature=1.0)
    rec = _NoiseRecorder(monkeypatch)
    want = dataclasses.replace(recipe_gen, **kw).generate(_words(7.0), 7.0)
    noise = rec.noise(1, 4, True, False, True, windows=8)
    port = _port(recipe_gen, **kw)
    port._noise = lambda generator, windows: noise
    got = port.generate(_words(7.0), 7.0)
    _assert_same(want, got)
    greedy = _port(recipe_gen, mode="decode").generate(_words(7.0), 7.0)
    assert (greedy[1] != got[1]).any()


# -- JAX-written checkpoints: the entry points ---------------------------
@pytest.fixture(scope="module")
def files(tmp_path_factory, recipe_gen):
    """The recipe's checkpoints as the JAX trainers write them, a clip
    store, the bank, and transformer-encoder tokenizers (GS-Soft and
    4-stage residual VQ) with their train and validation stores."""
    from gesture2vec_tpu.data.store import ClipStoreWriter
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.seq_ae_trainer import make_seq_ae

    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        save_latent_dataset

    root = tmp_path_factory.mktemp("recipe")
    rng = np.random.default_rng(3)
    g = recipe_gen
    out = {"root": str(root), "bank": str(root / "bank.npz")}
    for name, n_clips in (("store", 2), ("val", 2)):
        w = ClipStoreWriter(str(root / name))
        for i in range(n_clips):
            w.add_clip(f"vid{i}", rng.normal(size=(30 + 7 * i, DIM)),
                       words=[[f"word{j}", 0.1 * j, 0.1 * j + 0.05]
                              for j in range(i, VOCAB_WORDS, 2)])
        w.set_stats(g.pose_mean, g.pose_std)
        w.finish()
        out[name] = str(root / name)
    save_latent_dataset(out["bank"], g.latent_bank)
    vocab = JaxVocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    out["t2t"] = str(root / "t2t.bin")
    checkpoints.save_checkpoint(
        out["t2t"], config=_cfg(
            name="t2t_rec", sentence_frame_length=SENT, n_pre_poses=1,
            autoencoder_att=True, wordembed_dim=WORDEMBED,
            motion_resampling_framerate=FPS, token_stages=4,
            stage_conditional=True, t2t_arch="transformer", t2t_heads=HEADS),
        epoch=1, params=g.t2t_variables["params"],
        lang_model=vocab.state_dict(), extra={"n_words": N_WORDS},
        kind="text2embedding")
    out["dae"] = str(root / "dae.bin")
    checkpoints.save_checkpoint(
        out["dae"], config=load_config(dict(
            name="d", model="DAE", hidden_size=REP, input_motion_dim=DIM,
            random_seed=0)), epoch=1, params=g.dae_variables["params"],
        pose_dim=DIM, kind="DAE")
    seq_cfg = dict(rep_learning_dim=REP, n_pre_poses=1, subdivision_stride=2)
    out["rvq"] = str(root / "rvq.bin")
    checkpoints.save_checkpoint(
        out["rvq"], config=_cfg(name="s", autoencoder_vq_variant="rvq",
                                rvq_stages=4, **seq_cfg),
        epoch=1, params=g.seq_variables["params"], pose_dim=REP,
        extra={"batch_stats": g.seq_variables["batch_stats"],
               "parity": False}, kind="autoencoder_vq")
    for variant in ("gssoft", "rvq"):
        cfg = _cfg(name=f"tf_{variant}", seq_arch="transformer",
                   autoencoder_vq_variant=variant, rvq_stages=4, **seq_cfg)
        dummy = jnp.zeros((2, NF, REP))
        tree = perturb(_init(make_seq_ae(cfg), dummy, dummy, train=False),
                       rng)
        if variant == "rvq":
            # codebooks at the hidden's scale: the argmin then spreads
            vq = tree["params"]["vq_layer"]
            for name in vq:
                vq[name] = vq[name] * np.float32(0.1)
        out[f"tf_{variant}"] = str(root / f"tf_{variant}.bin")
        checkpoints.save_checkpoint(
            out[f"tf_{variant}"], config=cfg, epoch=1, params=tree["params"],
            pose_dim=REP, extra={"batch_stats": tree["batch_stats"],
                                 "parity": False}, kind="autoencoder_vq")
    return out


@pytest.mark.parametrize("mode", ["decode", "exemplar"])
def test_build_generator_on_recipe_checkpoints(files, mode):
    """`cli/_common.build_generator` of both packages on the recipe's
    JAX-written checkpoints (t2t_arch transformer, 4 stages, chained,
    teacher prefix 1) under the recipe's policy (here with top_k 1, so
    that both packages' draws give the greedy choice)."""
    from gesture2vec_tpu.cli._common import build_generator as jax_build
    from gesture2vec_tpu.data.store import ClipStore as JaxStore

    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.data.store import ClipStore

    bank = files["bank"] if mode == "exemplar" else None
    policy = dict(temperature=0.0, stage0_temperature=1.0, top_k=1)
    jg, _ = jax_build(files["t2t"], files["dae"], files["rvq"],
                      JaxStore(files["store"]), mode=mode,
                      latent_bank_path=bank, **policy)
    pg, cfg = build_generator(files["t2t"], files["dae"], files["rvq"],
                              ClipStore(files["store"]), mode=mode,
                              latent_bank_path=bank, device="cpu", **policy)
    assert isinstance(pg.t2t_model, port_tf.TransformerText2Token)
    assert (cfg["t2t_arch"], pg.t2t_model.n_heads,
            pg.t2t_model.n_pre_poses) == ("transformer", HEADS, 1)
    for _ in range(2):
        _assert_same(jg.generate(_words(7.0), 7.0),
                     pg.generate(_words(7.0), 7.0))


def test_transformer_tokenizer_matches_jax(files, rng):
    """`seq_arch: transformer` tokenizers loaded by both packages: GS-Soft
    tokens and sequence latents, and the residual VQ's stage tokens."""
    from gesture2vec_tpu.data.teacher import tokenize_windows as jax_tok
    from gesture2vec_tpu.train import checkpoints

    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.teacher import tokenize_windows

    lat = rng.normal(size=(40, NF, REP)).astype(np.float32)
    for variant, stages in (("gssoft", False), ("rvq", True)):
        seq, seq_v, _ = checkpoints.load_checkpoint_and_model(
            files[f"tf_{variant}"], "autoencoder_vq")
        port, _ = load_checkpoint_and_model(files[f"tf_{variant}"],
                                            "autoencoder_vq", "cpu")
        assert port.encoder_arch == "transformer"
        want = jax_tok(seq, seq_v, lat, batch=16, all_stages=stages)
        got = tokenize_windows(port, lat, batch=16, all_stages=stages)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=ATOL)
        assert len(np.unique(got[0])) > 1


def test_cluster_cli_on_transformer_tokenizer_matches_jax(files, monkeypatch):
    """The port's cluster CLI and the JAX CLI on a `seq_arch: transformer`
    GS-Soft checkpoint: the same windows, tokens and Metrics.txt."""
    from gesture2vec_tpu.cli import cluster as jax_cli

    from gesture2vec_tpu_torch.cli import cluster as port_cli
    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        load_latent_dataset

    outs = {w: os.path.join(files["root"], f"clusters_{w}")
            for w in ("jax", "port")}
    common = [files["dae"], files["tf_gssoft"], "--store", files["store"],
              "--val-store", files["val"]]
    monkeypatch.setattr(sys, "argv", ["cluster", *common, "--out",
                                      outs["jax"], "--jax-cache", "off"])
    jax_cli.main()
    summary = port_cli.main([*common, "--out", outs["port"], "--kmeans", "3",
                             "--device", "cpu"])
    assert summary["windows"] > 0
    npz = {w: load_latent_dataset(os.path.join(
        o, "org_latent_clustering_data.npz")) for w, o in outs.items()}
    np.testing.assert_array_equal(npz["port"]["tokens"],
                                  npz["jax"]["tokens"])
    np.testing.assert_allclose(npz["port"]["seq_latents"],
                               npz["jax"]["seq_latents"], atol=ATOL)
    read = {w: open(os.path.join(o, "Metrics.txt")).read()
            for w, o in outs.items()}
    assert read["port"] == read["jax"]


# -- the recipe's decode on the card --------------------------------------
def _recipe_generator(device):
    """The recipe at this file's widths from the port's own modules (the
    card's machine has no flax): a 4-stage stage-conditional transformer
    Part d with teacher prefix 1 over a 4-stage residual-VQ tokenizer's
    decoder and a DAE, initialised by `flax_init` from a seeded
    torch.Generator (the Part d's weights then perturbed), in decode
    mode."""
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqVQAutoencoder

    gen = torch.Generator().manual_seed(7)
    t2t = port_tf.TransformerText2Token(
        n_words=N_WORDS, n_tokens=K, hidden_size=HID, n_layers=L,
        n_steps=N_STEPS, n_pre_poses=1, word_embed_size=WORDEMBED,
        n_heads=HEADS, token_stages=4, stage_conditional=True)
    seq = SeqVQAutoencoder(rep_dim=REP, hidden_size=HID, n_layers=L,
                           n_frames=NF, vq_components=K, vq_variant="rvq",
                           rvq_stages=4)
    dae = DAE(DIM, REP)
    with torch.no_grad():
        for m in (t2t, seq, dae):
            fj.flax_init(m, gen)
        table = t2t.encoder.embedding_table.weight
        table.copy_(torch.randn(table.shape, generator=gen))
        # moved off the init, so the tokens vary
        for p in t2t.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(8)
    return GestureGenerator(
        t2t_model=t2t, seq_decoder=seq.decoder, dae_model=dae,
        vocab=_vocab(), pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32),
        n_frames=NF, sentence_frame_length=SENT, fps=FPS, max_words=MAXW,
        mode="decode", device=device)


@pytest.mark.gpu
def test_recipe_decode_on_card_matches_cpu():
    """Decode mode with the chunk-decoder kernel on the card against the
    CPU path: tokens identical, frames within 1e-4 (fp32 sums in another
    order over 20 steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the chunk-decoder kernel has no CPU "
                    "mode)")
    card = _recipe_generator("cuda").generate(_words(7.0), 7.0)
    cpu = _recipe_generator("cpu").generate(_words(7.0), 7.0)
    assert len(np.unique(cpu[1])) > 1
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-4)
