"""PyTorch port vs the JAX package: the audio-context family.

Small widths (hidden 16, 2 layers, 16 codes, 2-second windows of five
8-frame chunks at 20 fps, the 135-wide Trinity pose), JAX-initialised
weights perturbed by seeded noise, the same numpy inputs on both sides:
token ids identical, floats within 1e-5.

- Each encoder (WavEncoderRaw, WavEncoderSpectral, WavEncoderTri) in eval
  and train mode (BatchNorm on batch statistics), and Audio2Token's
  encode and decode for both fusions and for 3 stage heads with and
  without the chain; sampled decodes fed the JAX decode's own Gumbel
  noise, recorded through an ordered `jax.debug.callback`; beam search.
- AudioGestureGenerator in decode and exemplar mode (with and without
  continuity), both fusions, and under sampling, beam, soft decode and
  decode overlap; the streaming session against `generate` and against
  the JAX session.
- `cli/infer_audio` with `--device cpu` on JAX-written checkpoints and a
  JAX-ingested store against JAX's `g2v-infer-audio`: frames within
  1e-5, the port's export of JAX's frames byte-identical to JAX's BVH
  file, the port's own file with the same header and motion within the
  export's rounding (see tests/test_torch_port_cli.py, MOTION_TOL).
The JAX package is imported inside the CPU tests only, so the `gpu` test
also collects on a machine without flax.
"""
import json

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat import from_jax as fj
from gesture2vec_tpu_torch.text.vocab import Vocab

ATOL = 1e-5
HID, REP, K, DIM, NF, SENT, FPS, MAXW = 16, 8, 16, 135, 8, 40, 20, 8
N_WORDS, WORDEMBED, VOCAB_WORDS = 40, 10, 30
N_STEPS, WIN_S, SR = SENT // NF, SENT // FPS, 16000


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """torch on one thread: at these widths threads only cost, and the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech(seconds, seed=0):
    """Synthetic speech-like audio: two tones and noise, amplitude
    modulated at a syllable rate, so the mel chunks vary."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    carrier = np.sin(2 * np.pi * rng.uniform(100, 200) * t) \
        + 0.5 * np.sin(2 * np.pi * rng.uniform(600, 1200) * t) \
        + 0.3 * rng.normal(size=t.shape)
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
    return (0.3 * carrier * envelope).astype(np.float32)


def words(seconds, seed=0):
    rng = np.random.default_rng(seed)
    starts = np.linspace(0.1, seconds - 0.4, int(2.5 * seconds))
    return [[f"word{rng.integers(VOCAB_WORDS + 5)}", float(s),
             float(s + 0.3)] for s in starts]


def perturb(tree, rng, scale=0.3):
    import jax

    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def vocabs():
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab

    out = (Vocab("bench"), JaxVocab("bench"))
    for v in out:
        for i in range(VOCAB_WORDS):
            v.index_word(f"word{i}")
    return out


def a2t_raw(fusion="audio", stages=1, cond=False):
    """The audio Part d's config at this file's widths."""
    return dict(
        name="a2t", model="seq2seq", hidden_size=HID, n_layers=2,
        dropout_prob=0.2, epochs=1, batch_size=4, sentence_frame_length=SENT,
        n_poses=NF, n_pre_poses=2, autoencoder_vq=True,
        autoencoder_vq_components=K, autoencoder_att=True,
        wordembed_dim=WORDEMBED, random_seed=0, audio_fusion=fusion,
        token_stages=stages, stage_conditional=cond,
        motion_resampling_framerate=FPS)


def a2t_config(*variant):
    from gesture2vec_tpu.train.config import load_config

    return load_config(a2t_raw(*variant))


_PARTS = {}


def jax_parts(fusion="audio", stages=1, cond=False):
    """The JAX models (Audio2Token, a GS-Soft or residual-VQ tokenizer,
    the DAE) and their variables, a latent bank and pose statistics, one
    per variant. The variables are the port's modules initialised as JAX
    initialises them (`flax_init`; the JAX package's init costs ~30 s
    here), carried to the JAX layout by `to_jax_variables` and perturbed;
    test_wav_encoders_match_jax and the train tests hold that layout
    against JAX's own init."""
    key = (fusion, stages, cond)
    if key in _PARTS:
        return _PARTS[key]
    from gesture2vec_tpu.train.audio2token_trainer import make_audio2token
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.dae_trainer import make_frame_model
    from gesture2vec_tpu.train.seq_ae_trainer import make_seq_ae

    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqVQAutoencoder
    from gesture2vec_tpu_torch.train import audio2token_trainer as pa2t
    from gesture2vec_tpu_torch.train.config import load_config as pload

    cfg = a2t_config(fusion, stages, cond)
    rvq = {"autoencoder_vq_variant": "rvq", "rvq_stages": stages} \
        if stages > 1 else {}
    sq_cfg = dict(name="s", model="seq2seq", hidden_size=HID, n_layers=2,
                  rep_learning_dim=REP, n_poses=NF, n_pre_poses=1,
                  autoencoder_vq=True, autoencoder_vq_components=K,
                  random_seed=0, **rvq)
    dae_cfg = dict(name="d", model="DAE", hidden_size=REP,
                   input_motion_dim=DIM, random_seed=0)
    gen = torch.Generator().manual_seed(3)
    ports = (pa2t.make_audio2token(pload(a2t_raw(fusion, stages, cond)),
                                   N_WORDS),
             SeqVQAutoencoder(rep_dim=REP, hidden_size=HID, n_layers=2,
                              n_frames=NF, vq_components=K,
                              vq_variant="rvq" if stages > 1 else "gssoft",
                              rvq_stages=stages),
             DAE(DIM, REP))
    rng = np.random.default_rng(8)
    trees = []
    for m in ports:
        fj.flax_init(m, gen)
        trees.append(perturb(fj.to_jax_variables(m), rng))
    # the token decoder moved further off its initialisation, so that
    # greedy decodes vary; the encoder's convs less, to keep its
    # pre-activations near the scale they train at; the logit heads
    # scaled back, so the logits stay ~1-10 (a soft decode's mixtures
    # carry the logits' rounding, which grows with their size)
    a2t = fj.to_jax_variables(ports[0])
    dec = perturb(a2t["params"]["decoder_step"], rng, 1.5)
    for name, head in dec.items():
        if name.startswith("out_layer"):
            dec[name] = {k: (0.25 * w).astype(np.float32)
                         for k, w in head.items()}
    trees[0] = {"params": {
        "encoder": perturb(a2t["params"]["encoder"], rng, 0.1),
        "decoder_step": dec},
        "batch_stats": perturb(a2t["batch_stats"], rng)}
    brng = np.random.default_rng(1)
    out = dict(
        a2t_model=make_audio2token(cfg, N_WORDS), a2t_variables=trees[0],
        seq_model=make_seq_ae(load_config(sq_cfg)), seq_variables=trees[1],
        dae_model=make_frame_model(load_config(dae_cfg)),
        dae_variables={"params": trees[2]["params"]},
        latent_bank={"dae_latents": brng.normal(size=(200, NF, REP))
                     .astype(np.float32),
                     "tokens": brng.integers(0, K, 200).astype(np.int32)},
        pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32) + 0.5)
    _PARTS[key] = out
    return out


def jax_generator(parts, mode="decode", **policy):
    from gesture2vec_tpu.infer.audio2gesture import AudioGestureGenerator

    p = {k: v for k, v in parts.items() if k != "latent_bank"}
    return AudioGestureGenerator(
        **p, n_frames=NF, sentence_frame_length=SENT, fps=FPS, mode=mode,
        latent_bank=parts["latent_bank"] if mode == "exemplar" else None,
        seed=0, vocab=vocabs()[1], max_words=MAXW, **policy)


def port_generator(parts, mode="decode", **policy):
    """The port's generator from the same variables, through the weight
    bridge."""
    from gesture2vec_tpu_torch.infer.audio2gesture import \
        AudioGestureGenerator

    return AudioGestureGenerator(
        a2t_model=fj.audio2token_from_jax(parts["a2t_variables"],
                                          n_steps=N_STEPS),
        seq_decoder=fj.seq_decoder_from_jax(parts["seq_variables"],
                                            n_frames=NF),
        dae_model=fj.dae_from_jax(parts["dae_variables"], motion_dim=DIM,
                                  latent_dim=REP),
        pose_mean=parts["pose_mean"], pose_std=parts["pose_std"],
        n_frames=NF, sentence_frame_length=SENT, fps=FPS, mode=mode,
        latent_bank=parts["latent_bank"] if mode == "exemplar" else None,
        seed=0, vocab=vocabs()[0], max_words=MAXW, device="cpu", **policy)


class NoiseRecorder:
    """The Gumbel noise of every categorical draw the JAX audio decode
    makes, in order (jax.random.categorical(key, lg) is argmax(lg +
    gumbel(key, lg.shape))), through an ordered callback."""

    def __init__(self, monkeypatch):
        import jax
        from gesture2vec_tpu.models import audio2token as ja2t
        from gesture2vec_tpu.models import text2token as jt2t

        self.draws = []
        orig = jt2t.sample_logits

        def recording(logits, temperature, top_k, key):
            g = jax.random.gumbel(key, logits.shape, logits.dtype)
            jax.debug.callback(lambda x: self.draws.append(np.asarray(x)),
                               g, ordered=True)
            return orig(logits, temperature, top_k, key)

        monkeypatch.setattr(jt2t, "sample_logits", recording)
        monkeypatch.setattr(ja2t, "sample_logits", recording)

    def noise(self, B, windows, stages, cond):
        """(B, windows, n_steps - 1, stages, K): per window and step the
        primary draw, then one for all stages or one a stage (chain)."""
        import jax

        jax.effects_barrier()
        per_step = 1 + (0 if stages == 1 else stages - 1 if cond else 1)
        assert len(self.draws) == windows * per_step * (N_STEPS - 1)
        g = np.zeros((B, windows, N_STEPS - 1, stages, K), np.float32)
        it = iter(self.draws)
        for w in range(windows):
            for t in range(N_STEPS - 1):
                g[:, w, t, 0] = next(it)
                if stages > 1 and cond:
                    for s in range(1, stages):
                        g[:, w, t, s] = next(it)
                elif stages > 1:
                    g[:, w, t, 1:] = next(it)
        self.draws.clear()
        return torch.from_numpy(g)


# -- the encoders ------------------------------------------------------------
@pytest.mark.parametrize("name", ["WavEncoderRaw", "WavEncoderSpectral",
                                  "WavEncoderTri"])
def test_wav_encoders_match_jax(name):
    """Eval mode on perturbed running statistics, then train mode: the
    outputs and the updated BatchNorm statistics."""
    import jax
    import jax.numpy as jnp
    from gesture2vec_tpu.models import audio as jaudio

    from gesture2vec_tpu_torch.models import audio as paudio

    rng = np.random.default_rng(1)
    shape = {"WavEncoderRaw": (2, SR), "WavEncoderSpectral": (5, 128, 32),
             "WavEncoderTri": (3, SR)}[name]
    x = rng.normal(size=shape).astype(np.float32)
    kw = {} if name == "WavEncoderRaw" else {"out_dim": HID}
    jm = getattr(jaudio, name)(**kw)
    v = perturb(_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng,
                0.1)
    pm = getattr(paudio, name)(*([HID] if kw else []))
    fj.load_jax_variables(pm, v["params"], v["batch_stats"])
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    _close_to_largest(got.numpy(), want)
    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = pm.train()(torch.from_numpy(x))
    _close_to_largest(got.numpy(), want)
    stats = fj.to_jax_variables(pm)["batch_stats"]
    for bn, s in _np(mut["batch_stats"]).items():
        for k in ("mean", "var"):
            _close_to_largest(stats[bn][k], s[k])


def _close_to_largest(got, want):
    """Within ATOL of the largest magnitude (at least 1): fp32 rounding
    grows with the magnitude (the raw-wave stacks sum thousands of
    products into outputs of ~40, where fp32's spacing is 4e-6; a soft
    decode's mixtures carry the logits' rounding into the frames)."""
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1.0)
    assert err <= ATOL, err


def _encoder_inputs(fusion, rng, B=3, seconds=WIN_S):
    if fusion == "audio":
        x = rng.normal(size=(B, seconds, 128, 32)).astype(np.float32)
        return x, torch.from_numpy(x)
    ids = rng.integers(0, N_WORDS, size=(B, MAXW)).astype(np.int32)
    wav = np.stack([speech(seconds, int(s)).reshape(seconds, SR)
                    for s in rng.integers(100, size=B)])
    return (ids, wav), (torch.from_numpy(ids).long(), torch.from_numpy(wav))


def _seed(rng, B):
    seed = np.zeros((B, N_STEPS), np.int32)
    seed[:, :2] = rng.integers(0, K, (B, 2))
    return seed


@pytest.mark.parametrize("fusion,stages,cond", [
    ("audio", 1, False), ("both", 1, False), ("audio", 3, False),
    ("audio", 3, True)])
def test_audio2token_matches_jax(fusion, stages, cond):
    """encode_audio, the greedy decode (stage ids too) and beam 3."""
    import jax.numpy as jnp

    p = jax_parts(fusion, stages, cond)
    m, v = p["a2t_model"], p["a2t_variables"]
    rng = np.random.default_rng(2)
    enc_np, enc_t = _encoder_inputs(fusion, rng)
    enc_j = (tuple(map(jnp.asarray, enc_np)) if fusion == "both"
             else jnp.asarray(enc_np))
    seed = _seed(rng, 3)
    port = fj.audio2token_from_jax(v, n_steps=N_STEPS)
    assert (port.fusion, port.token_stages, port.stage_conditional) == \
        (fusion, stages, cond)
    eo, dh = m.apply(v, enc_j, method=m.encode_audio)
    want = m.apply(v, enc_j, jnp.asarray(seed))
    beam = m.apply(v, eo, dh, jnp.asarray(seed), beam_width=3,
                   method=m.beam_decode)
    with torch.no_grad():
        peo, pdh = port.encode_audio(enc_t)
        got = port(enc_t, torch.from_numpy(seed).long())
        pbeam = port.beam_decode(torch.from_numpy(np.array(eo)),
                                 torch.from_numpy(np.array(dh)),
                                 torch.from_numpy(seed).long(), 3)
    # the fusion encoder's raw-wave convs sum thousands of products
    _close_to_largest(peo.numpy(), eo)
    _close_to_largest(pdh.numpy(), dh)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    _close_to_largest(got["logits"].numpy(), want["logits"])
    np.testing.assert_array_equal(pbeam["tokens"].numpy(),
                                  np.asarray(beam["tokens"]))
    np.testing.assert_allclose(pbeam["logprob"].numpy(),
                               np.asarray(beam["logprob"]), atol=ATOL)
    if stages > 1:
        for r, w in ((got, want), (pbeam, beam)):
            np.testing.assert_array_equal(r["stage_tokens"].numpy(),
                                          np.asarray(w["stage_tokens"]))
    assert len(np.unique(np.asarray(want["tokens"])[:, 2:])) > 1


@pytest.mark.parametrize("stages,cond", [(1, False), (3, True)])
def test_audio2token_sampled_matches_jax(monkeypatch, stages, cond):
    """temperature 1, top_k 5 on the JAX decode's own noise."""
    import jax
    import jax.numpy as jnp

    p = jax_parts("audio", stages, cond)
    m, v = p["a2t_model"], p["a2t_variables"]
    rng = np.random.default_rng(3)
    enc_np, enc_t = _encoder_inputs("audio", rng, B=4)
    seed = _seed(rng, 4)
    rec = NoiseRecorder(monkeypatch)
    want = m.apply(v, jnp.asarray(enc_np), jnp.asarray(seed),
                   temperature=1.0, top_k=5,
                   rngs={"sample": jax.random.PRNGKey(5)})
    noise = rec.noise(4, 1, stages, cond)[:, 0]
    port = fj.audio2token_from_jax(v, n_steps=N_STEPS)
    with torch.no_grad():
        got = port(enc_t, torch.from_numpy(seed).long(), temperature=1.0,
                   top_k=5, gumbel=noise)
        greedy = port(enc_t, torch.from_numpy(seed).long())
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert not torch.equal(got["tokens"], greedy["tokens"])
    if stages > 1:
        np.testing.assert_array_equal(got["stage_tokens"].numpy(),
                                      np.asarray(want["stage_tokens"]))


# -- the generator -----------------------------------------------------------
def _assert_same(want, got):
    """Tokens identical; frames (unnormalised, up to ~10) within ATOL of
    their largest magnitude."""
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    _close_to_largest(got[0], want[0])


GEN_CASES = {
    "decode": ("audio", 1, False, "decode", {}),
    "exemplar": ("audio", 1, False, "exemplar", {}),
    "exemplar_continuity": ("audio", 1, False, "exemplar",
                            {"exemplar_continuity": True}),
    "both_decode": ("both", 1, False, "decode", {}),
    "both_exemplar": ("both", 1, False, "exemplar", {}),
    "beam3": ("audio", 1, False, "decode", {"beam_width": 3}),
    "soft_overlap": ("audio", 1, False, "decode",
                     {"soft_decode": 1.0, "decode_overlap": 3}),
    "stage3_cond_soft": ("audio", 3, True, "decode", {"soft_decode": 0.5}),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_matches_jax(case):
    """A 5-second request (3 windows, zero-padded) on both packages."""
    fusion, stages, cond, mode, policy = GEN_CASES[case]
    p = jax_parts(fusion, stages, cond)
    audio, w = speech(5.0), words(5.0)
    want = jax_generator(p, mode, **policy).generate(audio, words=w)
    got = port_generator(p, mode, **policy).generate(audio, words=w)
    assert got[0].shape == (3 * SENT, DIM)
    _assert_same(want, got)
    assert len(np.unique(got[1])) > 2


@pytest.mark.parametrize("stages,cond,mode", [(1, False, "exemplar"),
                                              (3, True, "decode")])
def test_sampled_generate_matches_jax(monkeypatch, stages, cond, mode):
    """temperature 1, top_k 5: the port's request noise replaced by the
    JAX request's recorded draws; the numpy stream gives one integer per
    request in both, then the exemplar picks."""
    p = jax_parts("audio", stages, cond)
    policy = {"temperature": 1.0, "top_k": 5}
    rec = NoiseRecorder(monkeypatch)
    audio = speech(5.0, 1)
    want = jax_generator(p, mode, **policy).generate(audio)
    noise = rec.noise(1, 3, stages, cond)
    port = port_generator(p, mode, **policy)
    draws = []
    port._noise = lambda gen, windows: draws.append(gen) or noise
    got = port.generate(audio)
    assert len(draws) == 1 and draws[0] is not None
    _assert_same(want, got)


def test_generator_refusals():
    p = jax_parts()
    for policy, match in ((dict(beam_width=2, temperature=1.0),
                           "mutually exclusive"),
                          (dict(soft_decode=1.0, beam_width=2), "beam"),):
        with pytest.raises(ValueError, match=match):
            port_generator(p, **policy)
    with pytest.raises(ValueError, match="soft_decode"):
        port_generator(p, "exemplar", soft_decode=1.0)
    with pytest.raises(ValueError, match="words"):
        port_generator(jax_parts("both")).generate(speech(2.0))


# -- streaming ---------------------------------------------------------------
@pytest.mark.parametrize("fusion,mode,policy", [
    ("audio", "decode", {"soft_decode": 1.0}),
    ("audio", "exemplar", {"exemplar_continuity": True}),
    ("both", "decode", {}), ("audio", "decode", {"beam_width": 2})])
def test_streaming_matches_generate_and_jax(fusion, mode, policy):
    """Pushes of the cumulative audio at 2.5 s, 4.9 s and 5 s, then
    finish(6 s): the windows concatenate to `generate` on the same audio,
    and equal the JAX session's."""
    from gesture2vec_tpu.infer.streaming import \
        AudioStreamingGestureSession as JaxSession

    from gesture2vec_tpu_torch.infer.streaming import (
        AudioStreamingGestureSession, build_audio_streaming_step)

    p = jax_parts(fusion)
    audio, w = speech(6.0, 2), words(6.0, 2)

    def run(session):
        out = []
        for now in (2.5, 4.9, 6.0):
            out += session.push(audio[:int(now * SR)], now, words=w)
        return out + session.finish(6.0)

    gen = port_generator(p, mode, **policy)
    step = build_audio_streaming_step(gen)
    got = run(AudioStreamingGestureSession(gen, step=step))
    want = run(JaxSession(jax_generator(p, mode, **policy)))
    assert len(got) == len(want) == 3
    for (gf, gt), (wf, wt) in zip(got, want):
        _assert_same((wf, wt), (gf, gt))
    batch = port_generator(p, mode, **policy).generate(audio, 6.0, words=w)
    _assert_same(batch, (np.concatenate([f for f, _ in got]),
                         np.concatenate([t for _, t in got])))
    # a second session shares the step and starts from its own seed
    again = run(AudioStreamingGestureSession(
        port_generator(p, mode, **policy), step=build_audio_streaming_step(
            port_generator(p, mode, **policy))))
    np.testing.assert_array_equal(np.concatenate([t for _, t in again]),
                                  batch[1])


# -- g2v-infer-audio ---------------------------------------------------------
@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A JAX-ingested Trinity corpus (its train store and data_pipe.json),
    JAX-written checkpoints of the audio Part d (both fusions), the
    tokenizer and the DAE, a latent bank, a wav file and a transcript."""
    import jax
    from scipy.io import wavfile

    import gesture2vec_tpu.utils.native as jax_native
    from gesture2vec_tpu.data.ingest import ingest_trinity
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config
    from tests.corpus import make_corpus

    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        save_latent_dataset

    root = tmp_path_factory.mktemp("infer_audio")
    corpus = make_corpus(str(root / "corpus"), n_files=2, n_frames=360)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "load", lambda: None)
        stores = ingest_trinity(corpus, str(root / "jax"))
    out = {"store": stores[0], "pipeline": str(root / "jax" /
                                               "data_pipe.json"),
           "bank": str(root / "bank.npz"), "dae": str(root / "dae.bin"),
           "vq": str(root / "vq.bin"), "wav": str(root / "speech.wav"),
           "transcript": str(root / "t.json")}
    p = jax_parts()
    save_latent_dataset(out["bank"], p["latent_bank"])
    common = dict(model="seq2seq", hidden_size=HID, n_layers=2,
                  dropout_prob=0.2, epochs=1, batch_size=8, n_poses=NF,
                  autoencoder_vq=True, autoencoder_vq_components=K,
                  random_seed=0)
    for fusion in ("audio", "both"):
        v = jax_parts(fusion)["a2t_variables"]
        out[f"a2t_{fusion}"] = str(root / f"a2t_{fusion}.bin")
        checkpoints.save_checkpoint(
            out[f"a2t_{fusion}"], config=a2t_config(fusion), epoch=1,
            params=v["params"], pose_dim=K,
            lang_model=vocabs()[1].state_dict() if fusion == "both"
            else None,
            extra={"batch_stats": v["batch_stats"], "n_words": N_WORDS},
            kind="audio2token")
    checkpoints.save_checkpoint(
        out["dae"], config=load_config(dict(
            name="d", model="DAE", hidden_size=REP, input_motion_dim=DIM,
            random_seed=0)), epoch=1, params=p["dae_variables"]["params"],
        pose_dim=DIM, kind="DAE")
    checkpoints.save_checkpoint(
        out["vq"], config=load_config(dict(
            name="s", rep_learning_dim=REP, n_pre_poses=1, **common)),
        epoch=1, params=p["seq_variables"]["params"], pose_dim=REP,
        extra={"batch_stats": p["seq_variables"]["batch_stats"],
               "parity": False}, kind="autoencoder_vq")
    wavfile.write(out["wav"], SR, (speech(5.0, 4) * 30000).astype(np.int16))
    (root / "t.json").write_text(json.dumps([
        {"word": a, "start_time": s, "end_time": e}
        for a, s, e in words(5.0, 4)]))
    del jax
    return out


def _jax_cli(argv, monkeypatch):
    """JAX's g2v-infer-audio (its main() reads sys.argv) -> (frames,
    tokens) of its generate call, and the BVH text it wrote."""
    from gesture2vec_tpu.infer.audio2gesture import AudioGestureGenerator

    seen = []
    orig = AudioGestureGenerator.generate

    def recording(self, *a, **k):
        seen.append(orig(self, *a, **k))
        return seen[-1]

    monkeypatch.setattr(AudioGestureGenerator, "generate", recording)
    monkeypatch.setattr("sys.argv", ["g2v-infer-audio", *argv])
    from gesture2vec_tpu.cli.infer_audio import main
    main()
    return seen[0]


def _split(text):
    head, motion = text.split("Frame Time:", 1)
    lines = motion.splitlines()
    return (head + "Frame Time:" + lines[0],
            np.array([ln.split() for ln in lines[1:]], np.float64))


@pytest.mark.parametrize("case", ["decode", "exemplar_continuity",
                                  "both_decode"])
def test_infer_audio_cli_matches_jax(case, cli_files, tmp_path,
                                     monkeypatch):
    from gesture2vec_tpu_torch.cli import infer_audio as p_cli
    from gesture2vec_tpu_torch.cli._common import load_bvh_exporter
    from gesture2vec_tpu_torch.io.bvh import write_bvh
    from tests.test_torch_port_cli import MOTION_TOL

    fusion = "both" if case.startswith("both") else "audio"
    mode = case.split("_")[-1] if fusion == "both" else case.split("_")[0]
    argv = [cli_files[f"a2t_{fusion}"], cli_files["wav"], cli_files["dae"],
            cli_files["vq"], "--store", cli_files["store"], "--pipeline",
            cli_files["pipeline"], "--mode", mode]
    if mode == "exemplar":
        argv += ["--latent-bank", cli_files["bank"],
                 "--exemplar-continuity"]
    if fusion == "both":
        argv += ["--transcript", cli_files["transcript"]]
    want_frames, want_tokens = _jax_cli(
        argv + ["--out", str(tmp_path / "jax.bvh")], monkeypatch)
    frames, tokens, path = p_cli.main(
        argv + ["--out", str(tmp_path / "port.bvh"), "--device", "cpu"])
    assert path == str(tmp_path / "port.bvh")
    np.testing.assert_array_equal(tokens, np.asarray(want_tokens))
    np.testing.assert_allclose(frames, np.asarray(want_frames), atol=ATOL)
    want_text = (tmp_path / "jax.bvh").read_text()
    # the port's export of JAX's frames is JAX's file, byte for byte
    to_bvh = load_bvh_exporter("trinity", cli_files["pipeline"])
    assert write_bvh(to_bvh(np.asarray(want_frames))) == want_text
    got_head, got_motion = _split((tmp_path / "port.bvh").read_text())
    want_head, want_motion = _split(want_text)
    assert got_head == want_head
    np.testing.assert_allclose(got_motion, want_motion, atol=MOTION_TOL)


# -- on the card -------------------------------------------------------------
def _card_generator(device):
    """The audio generator at this file's widths from the port's own
    modules (the card's machine has no flax): Audio2Token, a tokenizer's
    decoder and a DAE initialised by `flax_init` from a seeded
    torch.Generator, the Audio2Token moved off its initialisation."""
    from gesture2vec_tpu_torch.infer.audio2gesture import \
        AudioGestureGenerator
    from gesture2vec_tpu_torch.models.audio2token import Audio2Token
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqVQAutoencoder

    gen = torch.Generator().manual_seed(11)
    a2t = Audio2Token(n_tokens=K, hidden_size=HID, n_layers=2,
                      n_steps=N_STEPS)
    seq = SeqVQAutoencoder(rep_dim=REP, hidden_size=HID, n_layers=2,
                           n_frames=NF, vq_components=K)
    dae = DAE(DIM, REP)
    with torch.no_grad():
        for m in (a2t, seq, dae):
            fj.flax_init(m, gen)
        for p in a2t.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(12)
    return AudioGestureGenerator(
        a2t_model=a2t, seq_decoder=seq.decoder, dae_model=dae,
        pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32),
        n_frames=NF, sentence_frame_length=SENT, fps=FPS, device=device)


@pytest.mark.gpu
def test_audio_decode_on_card_matches_cpu():
    """Decode mode with the GRU-sequence kernel (the encoder, 4 launches)
    and the chunk-decoder kernel (1 launch) on the card against the CPU
    path: tokens identical, frames within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the GRU-sequence and chunk-decoder "
                    "kernels have no CPU mode)")
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    audio = speech(9.0, 5)
    gk.gru_sequence.launches = dk.fused_chunk_decode.launches = 0
    card = _card_generator("cuda").generate(audio)
    assert (gk.gru_sequence.launches, dk.fused_chunk_decode.launches) == \
        (4, 1)
    cpu = _card_generator("cpu").generate(audio)
    assert len(np.unique(cpu[1])) > 1
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-4)
