"""PyTorch port vs the JAX package: decode-mode generation end to end.

The JAX GestureGenerator is the bench.py builder at small widths, with
perturbed weights; the port gets the same numpy variables through
compat/from_jax. On the CPU the JAX generator takes its scan rollout
(its fused kernel is TPU-only) and the port takes the plain versions.
Tokens must be identical; frames within 1e-5 (fp32 on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import generator_from_jax
from gesture2vec_tpu_torch.infer.text2gesture import (GestureGenerator,
                                                      bucket_windows)
from gesture2vec_tpu_torch.text.vocab import Vocab

ATOL = 1e-5
HID, REP, K, DIM, NF, SENT, FPS, MAXW = 16, 8, 32, 12, 4, 24, 20, 10
VOCAB_WORDS = 40
UNIT = SENT / FPS   # 1.2 s windows


def perturb(tree, rng, scale=0.3):
    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _words(duration_s, seed=0):
    """~2.5 words/s over the vocabulary and some unknown words."""
    rng = np.random.default_rng(seed)
    starts = np.linspace(0.1, duration_s - 0.5, int(2.5 * duration_s))
    return [[f"word{rng.integers(VOCAB_WORDS + 10)}", float(s),
             float(s + 0.3)] for s in starts]


@pytest.fixture(scope="module")
def jax_gen():
    from bench import build_generator

    g = build_generator(hid=HID, rep=REP, k=K, dim=DIM, n_frames=NF,
                        sent_len=SENT, n_words=60, max_words=MAXW,
                        wordembed=12, vocab_words=VOCAB_WORDS, fps=FPS,
                        mode="decode")
    rng = np.random.default_rng(7)
    to_np = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    return dataclasses.replace(
        g, t2t_variables=perturb(to_np(g.t2t_variables), rng),
        seq_variables=perturb(to_np(g.seq_variables), rng),
        dae_variables=perturb(to_np(g.dae_variables), rng),
        pose_mean=rng.normal(size=DIM).astype(np.float32),
        pose_std=np.abs(rng.normal(size=DIM)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_generate(jax_gen):
    """JAX generate, one generator (one compile) per window mode."""
    gens, results = {}, {}

    def run(window_carry, duration):
        key = (window_carry, duration)
        if key not in results:
            if window_carry not in gens:
                gens[window_carry] = dataclasses.replace(
                    jax_gen, window_carry=window_carry)
            results[key] = gens[window_carry].generate(_words(duration),
                                                       duration)
        return results[key]
    return run


def _vocab():
    v = Vocab("bench")
    for i in range(VOCAB_WORDS):
        v.index_word(f"word{i}")
    return v


def _port(g, device="cpu", mode="decode", **kw):
    return generator_from_jax(
        g.t2t_variables, g.seq_variables, g.dae_variables, _vocab(),
        g.pose_mean, g.pose_std, n_frames=NF, sentence_frame_length=SENT,
        fps=FPS, max_words=MAXW, device=device, mode=mode, **kw)


# 7.0 s = 6 windows -> bucket 8; 24.0 s = 20 windows -> bucket 32
@pytest.mark.parametrize("window_carry", [True, False])
@pytest.mark.parametrize("duration", [7.0, 24.0])
@pytest.mark.parametrize("fused", [True, False])
def test_generate_matches_jax(jax_gen, jax_generate, window_carry, duration,
                              fused):
    assert bucket_windows(int(np.ceil(duration / UNIT))) in (8, 32)
    frames_j, toks_j = jax_generate(window_carry, duration)
    port = _port(jax_gen, window_carry=window_carry, use_fused_decoder=fused)
    frames_t, toks_t = port.generate(_words(duration), duration)
    n_windows = int(np.ceil(duration / UNIT))
    assert frames_t.shape == (n_windows * SENT, DIM)
    assert toks_t.shape == (n_windows * SENT // NF,)
    np.testing.assert_array_equal(toks_t, toks_j)
    assert len(np.unique(toks_t)) > 3
    np.testing.assert_allclose(frames_t, frames_j, atol=ATOL)


def test_text_context_matches_jax(jax_gen):
    """Windows that also read the words of the previous 1.5 s."""
    jg = dataclasses.replace(jax_gen, text_context_s=1.5)
    frames_j, toks_j = jg.generate(_words(7.0), 7.0)
    port = _port(jax_gen, text_context_s=1.5)
    frames_t, toks_t = port.generate(_words(7.0), 7.0)
    np.testing.assert_array_equal(toks_t, toks_j)
    assert (toks_t != _port(jax_gen).generate(_words(7.0), 7.0)[1]).any()
    np.testing.assert_allclose(frames_t, frames_j, atol=ATOL)


def test_window_carry_changes_tokens(jax_gen):
    """The two window modes are different decodes (carried teacher prefix
    and per-window mask vs zero seeds and the batch-max mask), so the
    parity above could not pass with the modes swapped."""
    words = _words(24.0)
    carry = _port(jax_gen, window_carry=True).generate(words, 24.0)[1]
    batch = _port(jax_gen, window_carry=False).generate(words, 24.0)[1]
    assert (carry != batch).any()


def test_bucketing_matches_jax():
    want = {1: 1, 2: 2, 3: 4, 5: 8, 8: 8, 9: 16, 16: 16, 17: 32, 32: 32,
            33: 48, 300: 304}
    assert {n: bucket_windows(n) for n in want} == want


def test_entry_point_needs_cuda_unless_cpu(jax_gen, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _port(jax_gen, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _port(jax_gen, device="cuda")
    assert _port(jax_gen, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("case", ["generate_batch_mesh"])
def test_still_unported_raise(jax_gen, case):
    """generate_batch over a mesh, once refused, is ported: one
    transcript over dp=2 (padded to 2) gives the unsharded call's tokens
    and frames (tests/test_torch_port_mesh_infer.py holds it against
    JAX's)."""
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh

    gen = _port(jax_gen)
    (f, t), = gen.generate_batch([_words(3.0)], 3.0,
                                 mesh=make_mesh({"dp": 2}, "cpu"))
    (wf, wt), = gen.generate_batch([_words(3.0)], 3.0)
    np.testing.assert_array_equal(t, wt)
    np.testing.assert_allclose(f, wf, atol=ATOL)


@pytest.mark.parametrize("case", ["t2t_arch_transformer",
                                  "seq_arch_transformer"])
def test_transformer_checkpoints_load_like_jax(tmp_path, rng, case):
    """The transformer Part d and the transformer chunk encoder, once
    refused by the checkpoint makers: a JAX-written checkpoint of each
    loads, and its tokens are JAX's (greedy Part-d tokens of ragged
    sentences; GS-Soft tokens of random latent windows)."""
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model

    def init(model, *args, **kw):
        v = jax.jit(lambda k, *a: model.init(k, *a, **kw))(
            jax.random.PRNGKey(0), *args)
        return perturb(jax.tree_util.tree_map(np.asarray, v), rng, 0.1)

    cfg = load_config(dict(
        name=case, model="seq2seq", hidden_size=HID, n_layers=2,
        dropout_prob=0.2, n_poses=NF, n_pre_poses=1, rep_learning_dim=REP,
        sentence_frame_length=SENT, autoencoder_vq=True,
        autoencoder_vq_components=K, wordembed_dim=12, random_seed=0,
        **({"t2t_arch": "transformer"} if case.startswith("t2t")
           else {"seq_arch": "transformer"})))
    path = str(tmp_path / "ckpt.bin")
    if case.startswith("t2t"):
        from gesture2vec_tpu.train.text2token_trainer import make_text2token

        m = make_text2token(cfg, 60)
        lengths = np.array([1, MAXW, 3, 6], np.int32)
        ids = rng.integers(4, 60, size=(4, MAXW)).astype(np.int32)
        ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
        targets = rng.integers(0, K, size=(4, SENT // NF)).astype(np.int32)
        args = (jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(targets))
        variables = init(m, *args)
        checkpoints.save_checkpoint(path, config=cfg, epoch=1,
                                    params=variables["params"],
                                    extra={"n_words": 60},
                                    kind="text2embedding")
        want = m.apply(variables, *args, train=False)["tokens"]
        port, _ = load_checkpoint_and_model(path, "text2embedding", "cpu")
        with torch.no_grad():
            got = port(*(torch.from_numpy(np.asarray(a)).long()
                         for a in args))["tokens"]
    else:
        from gesture2vec_tpu.data.teacher import tokenize_windows as jax_tok
        from gesture2vec_tpu.train.seq_ae_trainer import make_seq_ae

        from gesture2vec_tpu_torch.data.teacher import tokenize_windows

        m = make_seq_ae(cfg)
        dummy = jnp.zeros((2, NF, REP))
        variables = init(m, dummy, dummy, train=False)
        checkpoints.save_checkpoint(
            path, config=cfg, epoch=1, params=variables["params"],
            pose_dim=REP, extra={"batch_stats": variables["batch_stats"],
                                 "parity": False}, kind="autoencoder_vq")
        lat = rng.normal(size=(30, NF, REP)).astype(np.float32)
        want = jax_tok(m, variables, lat, batch=8)[0]
        port, _ = load_checkpoint_and_model(path, "autoencoder_vq", "cpu")
        assert port.encoder_arch == "transformer"
        got = tokenize_windows(port, lat, batch=8)[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(np.unique(np.asarray(got))) > 1


def test_fused_decoder_raises_when_ineligible(jax_gen):
    port = _port(jax_gen)
    seq = port.seq_decoder
    seq.n_pre_poses = 2
    with pytest.raises(ValueError, match="n_pre_poses"):
        dataclasses.replace(port)
    seq.n_pre_poses = 1
    seq.decoder_step.conditioned = False
    with pytest.raises(ValueError, match="conditioned"):
        dataclasses.replace(port)
    # the module rollout takes any decoder
    assert isinstance(dataclasses.replace(port, use_fused_decoder=False),
                      GestureGenerator)
