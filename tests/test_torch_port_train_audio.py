"""PyTorch port vs the JAX package: `g2v-train --part audio`.

Small widths (tests/test_torch_port_audio.py's: hidden 16, 2 layers, 16
codes, 2-second windows of five 8-frame chunks), the same numpy inputs on
both sides, JAX on the CPU, every dropout off (`flax.linen.Dropout`
patched to the identity; the port trains outside
`models/layers.dropout_generator`).

- `data/sentence.build_sentence_dataset` with `include_audio` and
  `include_raw_audio` over a store with audio: word ids, tokens, mel
  chunks and raw chunks equal to JAX's.
- One train step (fusion "audio" with label smoothing, "both", 3 chained
  stage heads) from JAX's own initial state: the loss within 1e-5
  relative, every gradient within 1e-4 of its tensor's largest magnitude
  (a bias in front of a batch-statistics BatchNorm - the decoder's
  pre_linear, the mel encoder's fc - against the model's largest), the
  BatchNorm statistics within 1e-5; then three steps with Adam, losses
  within 1e-4 relative.
- The command: the port's `--part audio` (both fusions) on JAX-written
  DAE and tokenizer checkpoints, its loss falling; its checkpoint and a
  JAX-trained one each resumed by both packages, the next step equal.
- A mesh (dp=2, gloo ranks on the CPU) against the single run; the
  refusal of a "both" model without n_words.
"""
import glob
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gesture2vec_tpu_torch.compat import from_jax as fj
from gesture2vec_tpu_torch.io.audio import mel_chunks_per_second
from gesture2vec_tpu_torch.train import audio2token_trainer as pa2t
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.optim import Adam
# torch_one_thread: that file's autouse fixture, in force here too
from tests.test_torch_port_audio import (  # noqa: F401
    DIM, HID, K, MAXW, N_STEPS, N_WORDS, NF, REP, SENT, SR, WIN_S, a2t_raw,
    jax_parts, speech, torch_one_thread, vocabs)

LOSS_RTOL, GRAD_TOL, STEPS_RTOL = 1e-5, 1e-4, 1e-4
BS = 4
# tensors in front of a batch-statistics BatchNorm through a linear map
# only: their gradient is rounding (zero in exact arithmetic), held to
# the model's largest. The decoder's pre_linear bias; the mel encoder's
# fc bias and bn2 bias (flattened into fc, then fc_bn); the raw-chunk
# encoder's conv biases before bn0-bn2.
CANCELLED = {
    "audio": (("decoder_step", "pre_linear", "bias"),
              ("encoder", "wav_encoder", "fc", "bias"),
              ("encoder", "wav_encoder", "bn2", "bias")),
    "both": (("decoder_step", "pre_linear", "bias"),
             *(("encoder", "wav_encoder", f"conv{i}", "bias")
               for i in range(3)))}


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _close_trees(got, want, tol, what, cancelled=()):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    top = max(float(np.abs(v).max()) for v in w.values())
    for path, wv in w.items():
        scale = top if path in cancelled else float(np.abs(wv).max())
        err = float(np.abs(g[path] - wv).max()) / max(scale, 1e-30)
        assert err <= tol, f"{what} {'/'.join(path)}: {err}"


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _grab():
    """An optax transformation that keeps the gradients in its state."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        lambda p: {"g": zeros(p)}, lambda u, s, p=None: (zeros(u), {"g": u}))


def _batch(fusion, stages, seed):
    """(encoder inputs..., tokens[, stage_tokens]) in numpy: mel chunks of
    speech-like audio, or word ids and its raw chunks."""
    rng = np.random.default_rng(seed)
    audio = [speech(WIN_S, int(s)) for s in rng.integers(1000, size=BS)]
    st = rng.integers(0, K, (BS, N_STEPS, stages)).astype(np.int32)
    if fusion == "both":
        enc = (rng.integers(0, N_WORDS, (BS, MAXW)).astype(np.int32),
               np.stack(audio).reshape(BS, WIN_S, SR))
    else:
        enc = (np.stack([mel_chunks_per_second(a) for a in audio]),)
    return enc + (st[:, :, 0],) + ((st,) if stages > 1 else ())


def _torch(batch):
    return tuple(torch.from_numpy(a).long() if a.dtype.kind == "i"
                 else torch.from_numpy(a) for a in batch)


STEP_CASES = {"audio_smoothing": ("audio", 1, False, 0.1),
              "both": ("both", 1, False, 0.0),
              "audio_stage3_cond": ("audio", 3, True, 0.0)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case, no_jax_dropout):
    from gesture2vec_tpu.train import audio2token_trainer as ja2t
    from gesture2vec_tpu.train.config import load_config as jload
    from gesture2vec_tpu.train.optim import make_optimizer

    fusion, stages, cond, smoothing = STEP_CASES[case]
    raw = {**a2t_raw(fusion, stages, cond), "label_smoothing": smoothing,
           "batch_size": BS}
    jcfg, cfg = jload(raw), load_config(raw)
    batches = [_batch(fusion, stages, 20 + i) for i in range(3)]
    jmodel = ja2t.make_audio2token(jcfg, N_WORDS)
    shape = batches[0][0].shape[1:] if fusion == "audio" \
        else batches[0][1].shape[1:]

    def setup(opt):
        state = ja2t.init_state(jmodel, jax.random.PRNGKey(0), opt, shape,
                                max_words=MAXW)
        model = pa2t.make_audio2token(cfg, N_WORDS)
        fj.load_jax_variables(model, _np(state.params),
                              _np(state.batch_stats))
        return state, ja2t.make_train_step(jmodel, opt, smoothing), \
            model.train()

    state, jstep, model = setup(_grab())
    # the port's layout of the parameters and statistics is JAX's
    assert jax.tree_util.tree_structure(fj.to_jax_variables(model)) == \
        jax.tree_util.tree_structure(_np({"params": state.params,
                                          "batch_stats":
                                              state.batch_stats}))
    new_state, metrics = jstep(state, *map(jnp.asarray, batches[0]),
                               jax.random.PRNGKey(1))
    step = pa2t.TrainStep(model, Adam(model.parameters(), 1e-3), smoothing)
    loss = step.loss(*_torch(batches[0]))
    loss.backward()
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    entries = fj.param_entries(model)
    grads = fj.jax_tree(entries, {id(p): (p.grad if p.grad is not None
                                          else torch.zeros_like(p))
                                  for _, p, _, _ in entries})
    _close_trees(grads, _np(new_state.opt_state["g"]), GRAD_TOL, "grad",
                 CANCELLED[fusion])
    _close_trees(fj.to_jax_variables(model)["batch_stats"],
                 _np(new_state.batch_stats), 1e-5, "batch_stats")

    state, jstep, model = setup(make_optimizer(cfg.learning_rate))
    step = pa2t.TrainStep(model, Adam(model.parameters(),
                                      cfg.learning_rate), smoothing)
    for i, b in enumerate(batches):
        state, metrics = jstep(state, *map(jnp.asarray, b),
                               jax.random.PRNGKey(2 + i))
        got = step(*_torch(b))
        assert _rel(got, metrics["loss"]) <= STEPS_RTOL, i


# -- the dataset and the command ----------------------------------------------
@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Train and validation stores with audio (135 wide, a word every
    0.4 s), and JAX-written DAE and tokenizer checkpoints."""
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config as jload

    from gesture2vec_tpu_torch.data.store import ClipStoreWriter

    root = tmp_path_factory.mktemp("audio_train")
    rng = np.random.default_rng(5)
    out = {}
    for name, n_clips in (("train", 2), ("val", 1)):
        w = ClipStoreWriter(str(root / name))
        clips = []
        for i in range(n_clips):
            n = 200 + 37 * i
            t = np.arange(n)[:, None] / 20.0
            poses = (np.sin(t * rng.uniform(0.3, 2.0, DIM)
                            + rng.uniform(0, 6.3, DIM))
                     + 0.1 * rng.normal(size=(n, DIM))).astype(np.float32)
            # audio a little shorter than the motion; the second training
            # clip has none (its windows' audio is zeros)
            w.add_clip(f"{name}{i}", poses, [
                [f"word{rng.integers(30)}", float(s), float(s + 0.3)]
                for s in np.arange(0.1, n / 20.0 - 0.4, 0.4)],
                audio=None if name == "train" and i == 1
                else speech(n / 20.0 - 0.7, 10 + i))
            clips.append(poses)
        frames = np.concatenate(clips)
        w.set_stats(frames.mean(0), frames.std(0))
        w.set_meta(fps=20, feature_dim=DIM)
        w.finish()
        out[name] = w.root
    p = jax_parts()
    out["dae"], out["vq"] = str(root / "dae.bin"), str(root / "vq.bin")
    checkpoints.save_checkpoint(
        out["dae"], config=jload(dict(name="d", model="DAE", hidden_size=REP,
                                      input_motion_dim=DIM, random_seed=0)),
        epoch=1, params=p["dae_variables"]["params"], pose_dim=DIM,
        kind="DAE")
    checkpoints.save_checkpoint(
        out["vq"], config=jload(dict(
            name="s", model="seq2seq", hidden_size=HID, n_layers=2,
            rep_learning_dim=REP, n_poses=NF, n_pre_poses=1,
            autoencoder_vq=True, autoencoder_vq_components=K,
            random_seed=0)), epoch=1, params=p["seq_variables"]["params"],
        pose_dim=REP, extra={"batch_stats": p["seq_variables"]
                             ["batch_stats"], "parity": False},
        kind="autoencoder_vq")
    out["root"] = root
    return out


def test_sentence_audio_arrays_match_jax(files):
    """Both audio fields at once, over the JAX tokenizer and DAE."""
    from gesture2vec_tpu.data.sentence import \
        build_sentence_dataset as jbuild
    from gesture2vec_tpu.data.store import ClipStore as JaxStore

    from gesture2vec_tpu_torch.data.sentence import build_sentence_dataset
    from gesture2vec_tpu_torch.data.store import ClipStore

    p = jax_parts()
    kw = dict(sentence_frame_length=SENT, stride=20, n_frames=NF, fps=20,
              max_words=MAXW, include_audio=True, include_raw_audio=True)
    want = jbuild(JaxStore(files["train"]), vocabs()[1],
                  dae_model=p["dae_model"],
                  dae_variables=p["dae_variables"],
                  seq_model=p["seq_model"],
                  seq_variables=p["seq_variables"], **kw)
    got = build_sentence_dataset(
        ClipStore(files["train"]), vocabs()[0],
        dae_model=fj.dae_from_jax(p["dae_variables"], motion_dim=DIM,
                                  latent_dim=REP),
        seq_model=fj.seq_ae_from_jax(p["seq_variables"], n_frames=NF),
        **kw)
    assert sorted(got) == sorted(want)
    assert got["mel"].shape[1:] == (WIN_S, 128, 32)
    assert got["wav"].shape[1:] == (WIN_S, SR)
    for k in ("word_ids", "lengths", "tokens", "mel", "wav"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the second clip, without audio, holds the last windows
    assert got["wav"][0].any() and not got["wav"][-1].any()


def _write_config(path, fusion, epochs, files, **kw):
    cfg = {**a2t_raw(fusion), "epochs": epochs, "batch_size": BS,
           "learning_rate": 3e-3, "train_data_path": files["train"],
           "val_data_path": files["val"], "subdivision_stride_sentence": 20,
           **kw}
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k}: {str(v).lower() if isinstance(v, bool) else v}"
                    f"\n")
    return cfg


def _resumed(path, fusion, n_words, batch):
    """Each package resumes the checkpoint: (JAX's params and optax state
    dict, the port's, and each one's loss on the batch at its next
    step)."""
    from flax import serialization

    from gesture2vec_tpu.train import audio2token_trainer as ja2t
    from gesture2vec_tpu.train import checkpoints as jckpt
    from gesture2vec_tpu.train.config import load_config as jload
    from gesture2vec_tpu.train.optim import make_optimizer

    from gesture2vec_tpu_torch.train import checkpoints as pckpt

    raw = {**a2t_raw(fusion), "batch_size": BS, "learning_rate": 3e-3}
    opt = make_optimizer(3e-3)
    jmodel = ja2t.make_audio2token(jload(raw), n_words)
    shape = batch[0].shape[1:] if fusion == "audio" else batch[1].shape[1:]
    state = ja2t.init_state(jmodel, jax.random.PRNGKey(9), opt, shape,
                            max_words=MAXW)
    state, _, _, _ = jckpt.restore_for_resume(state, jax.random.PRNGKey(9),
                                              path)
    # copies: each step updates its state's buffers in place
    jax_side = jax.tree_util.tree_map(np.array, (
        state.params, serialization.to_state_dict(state.opt_state)))
    _, metrics = ja2t.make_train_step(jmodel, opt)(
        state, *map(jnp.asarray, batch), jax.random.PRNGKey(1))
    model = pa2t.make_audio2token(load_config(raw), n_words).train()
    adam = Adam(model.parameters(), 3e-3)
    pckpt.restore_for_resume(model, adam, torch.Generator(), path)
    port_side = jax.tree_util.tree_map(np.array, (
        fj.to_jax_variables(model)["params"],
        pckpt.opt_state_dict(model, adam)))
    loss = pa2t.TrainStep(model, adam)(*_torch(batch))
    return jax_side, port_side, float(metrics["loss"]), float(loss)


@pytest.mark.parametrize("fusion", ["audio", "both"])
def test_audio_command_trains_and_resumes_across_packages(
        fusion, files, tmp_path, no_jax_dropout):
    """The port's command over 3 epochs (the loss falls), then its last
    checkpoint and one the JAX trainer writes from the same data, each
    resumed by both packages: the same parameters and optax state
    (Adam's count and moments), and the next step's loss within 1e-4
    relative."""
    from gesture2vec_tpu.train import audio2token_trainer as ja2t
    from gesture2vec_tpu.train.config import load_config as jload

    from gesture2vec_tpu_torch.cli import train as ptrain

    cfg_path = str(tmp_path / "a2t.yml")
    raw = _write_config(cfg_path, fusion, 3, files)
    save = str(tmp_path / "port")
    model, hist = ptrain.main(["-c", cfg_path, "--part", "audio",
                               "--rep-checkpoint", files["dae"],
                               "--autoencoder-checkpoint", files["vq"],
                               "--save-dir", save, "--device", "cpu"])
    assert model.fusion == fusion
    assert hist["train_loss"][-1] < hist["first_step_loss"][0]
    assert all(np.isfinite(hist["val_loss"]))
    port_ckpt = sorted(glob.glob(os.path.join(save, "*.bin")))[-1]
    assert os.path.exists(os.path.join(save, "loss_history.json"))

    # the same data through the port's data step, then the JAX trainer
    cfg, (train, val), kw = ptrain.build_arrays(
        load_config(cfg_path, rep_learning_checkpoint=files["dae"],
                    autoencoder_checkpoint=files["vq"]), "audio", "cpu")
    assert kw["n_words"] == (model.encoder.embedding.num_embeddings
                             if fusion == "both" else 0)
    jsave = str(tmp_path / "jax")
    ja2t.train_audio2token(jload({**raw, "epochs": 1}), train, val,
                           save_dir=jsave, n_words=kw["n_words"],
                           lang_model_state=kw["lang_model_state"])
    jax_ckpt = sorted(glob.glob(os.path.join(jsave, "*.bin")))[-1]
    fields = ("word_ids", "wav", "tokens") if fusion == "both" \
        else ("mel", "tokens")
    batch = tuple(train[f][:BS] for f in fields)
    for path in (port_ckpt, jax_ckpt):
        jax_side, port_side, jloss, ploss = _resumed(path, fusion,
                                                     kw["n_words"], batch)
        for want, got in zip(jax_side, port_side):
            g = dict(_leaves(got))
            assert sorted(g) == sorted(dict(_leaves(want)))
            for k, w in _leaves(want):
                np.testing.assert_array_equal(g[k], w, err_msg=str(k))
        assert int(dict(_leaves(port_side[1]))[("1", "0", "count")]) > 0
        assert _rel(ploss, jloss) <= STEPS_RTOL, path


def test_refusals_name_their_items():
    """mesh_shape, once refused, trains: the text+audio model over dp=2
    (2 gloo ranks, dropout 0.2 drawn at the global batch's shape, its
    BatchNorms on the global batch) has the single run's history within
    1e-4. A "both" model without n_words is refused."""
    rows = [_batch("both", 1, seed) for seed in (3, 4)]
    data = {k: np.concatenate([r[i] for r in rows])
            for i, k in enumerate(("word_ids", "wav", "tokens"))}
    val = {k: v[:BS] for k, v in data.items()}
    raw = {**a2t_raw("both"), "epochs": 2}
    _, want = pa2t.train_audio2token(load_config(raw), data, val,
                                     n_words=N_WORDS, device="cpu")
    _, got = pa2t.train_audio2token(
        load_config({**raw, "mesh_shape": {"dp": 2}}), data, val,
        n_words=N_WORDS, device="cpu")
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    with pytest.raises(ValueError, match="n_words"):
        pa2t.make_audio2token(load_config(a2t_raw("both")))
