"""PyTorch port vs the JAX package: training the recommended recipe - the
transformer Part d (`t2t_arch: transformer`), the `seq_arch: transformer`
tokenizer, and the feedback-matched finetune (`feedback_finetune_epochs`).

The widths and helpers of `tests/test_torch_port_train.py` (hidden 16,
2 layers, 2 heads, 16 codes, 30 words), whose parametrised train-step
test also holds one step of each transformer model against JAX's
`make_train_step`. Here:

- the dropout sites: both packages' dropout patched to the same
  deterministic mask (every odd feature kept and doubled) in train mode,
  the text encoder, the token decoder and the tokenizer's encode (input
  dropout + chunk encoder) agree within 1e-5, so each package drops at
  the same places;
- the GRU Part d's teacher-forced outputs with chained stages (its
  stage tokens are the argmaxes, as JAX's);
- the feedback step against `make_feedback_train_step` (GRU Part d with
  the TCN, and the recipe's transformer) at feedback_temperature 0 and
  1, the sampled ones fed the JAX step's own Gumbel noise, recorded in
  order by a callback: loss within 1e-5 relative, gradients within 1e-4
  of each tensor's largest magnitude;
- `run_token_training` switching to the late step at epochs -
  feedback_finetune_epochs, and on the late step when a run resumes
  inside that phase;
- the port's command: a -> b (`seq_arch: transformer`, 4-stage residual
  VQ, re-fit every epoch) -> d (the recipe, its last epoch on the
  feedback step) on a tiny store; losses finite and falling, the JAX
  package loads both files and gives the port's tokens, and
  `build_generator` turns them into a working generator.
"""
import logging

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu.train import checkpoints as jckpt
from gesture2vec_tpu.train import text2token_trainer as jt2t
from gesture2vec_tpu.train.config import load_config as jax_load_config
from gesture2vec_tpu_torch.compat.from_jax import jax_tree, param_entries
from gesture2vec_tpu_torch.models import seq_ae as port_seq_ae
from gesture2vec_tpu_torch.models import seq_encoder as port_seq_encoder
from gesture2vec_tpu_torch.models import transformer as port_tf
from gesture2vec_tpu_torch.train import text2token_trainer as pt2t
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.optim import Adam
from tests.test_torch_port_train import (GRAD_TOL, HID, K, LOSS_RTOL, MAXW,
                                         NF, NWORDS, PARTS, REP, SENT, WEMB,
                                         _batches, _close_trees, _grab,
                                         _jax_setup, _np, _port_setup, _rel,
                                         _tiny_store, _torch_batch,
                                         _write_yaml, no_jax_dropout,
                                         torch_one_thread)

N_STEPS = SENT // NF


def _fixed_mask(d):
    """A deterministic rate-0.5 dropout mask over the last axis: every odd
    feature kept and doubled. (A plain scaling would not do: every site
    scales the residual stream alike, and the LayerNorms remove it.)"""
    return (np.arange(d) % 2 * 2.0).astype(np.float32)


def _fixed_jax_dropout(monkeypatch):
    """flax's Dropout as the fixed mask wherever it is not deterministic."""
    def fixed(self, inputs, deterministic=None, rng=None):
        det = self.deterministic if deterministic is None else deterministic
        return inputs if det else inputs * _fixed_mask(inputs.shape[-1])
    monkeypatch.setattr(fnn.Dropout, "__call__", fixed)


def _fixed_port_dropout(monkeypatch):
    """The port's dropout as the fixed mask wherever a training module
    applies it."""
    def fixed(x, rate, training, batch_dim=0):
        if not training or rate <= 0.0:
            return x
        return x * torch.from_numpy(_fixed_mask(x.shape[-1]))
    for mod in (port_tf, port_seq_encoder, port_seq_ae):
        monkeypatch.setattr(mod, "dropout", fixed)


@pytest.mark.parametrize("site", ["text_encoder", "token_decoder",
                                  "chunk_encoder"])
def test_dropout_sites_match_jax(site, monkeypatch):
    """Train-mode outputs with both packages' dropout turned into the same
    fixed mask: equal within 1e-5 only if both mask at the same sites (a
    missing or extra site moves them by far more: the masked pass is far
    from the eval pass)."""
    rng = np.random.default_rng(11)
    part = "b_tf_rvq" if site == "chunk_encoder" else "d_tf_recipe"
    cfg, jcfg = load_config(PARTS[part]), jax_load_config(PARTS[part])
    jmodel, state, _ = _jax_setup(part, jcfg, _grab())
    model, _ = _port_setup(part, cfg, state)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    _fixed_jax_dropout(monkeypatch)
    _fixed_port_dropout(monkeypatch)
    with torch.no_grad():
        if site == "chunk_encoder":
            x = rng.normal(size=(8, NF + 1, REP)).astype(np.float32)
            want = jmodel.apply(variables, jnp.asarray(x), train=True,
                                method=jmodel.encode)
            eval_out = jmodel.apply(variables, jnp.asarray(x),
                                    method=jmodel.encode)
            got = model.encode(torch.from_numpy(x))
        else:
            ids, lengths, tokens, stages = _batches("d", PARTS[part], 12, 1)[0]
            enc, hid = jmodel.apply(variables, jnp.asarray(ids),
                                    jnp.asarray(lengths), train=site ==
                                    "text_encoder",
                                    method=jmodel.encode_text)
            if site == "text_encoder":
                eval_out = jmodel.apply(variables, jnp.asarray(ids),
                                        jnp.asarray(lengths),
                                        method=jmodel.encode_text)
                want = (enc, hid)
                got = model.encode_text(torch.from_numpy(ids).long(),
                                        torch.from_numpy(lengths).long())
            else:
                mask = np.arange(MAXW)[None, :] < lengths[:, None]
                args = (enc, hid, jnp.asarray(tokens), jnp.asarray(mask))

                def decode(train):
                    out = jmodel.apply(
                        variables, *args[:3], train=train,
                        stage_targets=jnp.asarray(stages),
                        method=lambda m, *a, **k: m.decode_tokens(
                            *a, enc_mask=args[3], **k))
                    return out["logits"], out["stage_logits"]
                want = decode(True)
                # the eval rollout: another computation, far from both
                eval_out = decode(False)
                res = model.decode_tokens(
                    torch.from_numpy(np.asarray(enc)),
                    torch.from_numpy(np.asarray(hid)),
                    torch.from_numpy(tokens).long(),
                    enc_mask=torch.from_numpy(mask),
                    stage_targets=torch.from_numpy(stages).long())
                got = (res["logits"], res["stage_logits"])
    for g, w, e in zip(got, want, eval_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        # the sites matter: the masked pass is not the eval pass
        assert np.abs(np.asarray(w) - np.asarray(e)).max() > 1e-3


def test_gru_teacher_forced_outputs_match_jax(no_jax_dropout):
    """The GRU Part d's train-mode forward with 4 chained stages on the
    teacher codes, as the finetune's teacher-forced epochs run it: logits
    and stage logits within 1e-5, tokens and stage tokens (the argmaxes,
    not the teacher codes) equal to JAX's train=True outputs."""
    part = "d_stage4_cond"
    cfg, jcfg = load_config(PARTS[part]), jax_load_config(PARTS[part])
    jmodel, state, _ = _jax_setup(part, jcfg, _grab())
    model, _ = _port_setup(part, cfg, state)
    batch = _batches("d", PARTS[part], 16, 1)[0]
    want, _ = jmodel.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        *map(jnp.asarray, batch[:3]), train=True,
        stage_targets=jnp.asarray(batch[3]), mutable=["batch_stats"])
    tb = _torch_batch(part, batch)
    with torch.no_grad():
        got = model(*tb[:3], stage_targets=tb[3])
    for key in ("logits", "stage_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)
    for key in ("tokens", "stage_tokens"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


class _NoiseRecorder:
    """Records, in order, the Gumbel noise of every categorical draw the
    JAX Part d makes (jax.random.categorical(key, lg) is argmax(lg +
    gumbel(key, lg.shape))), and lays it out as the port's (B, n_steps
    - 1, stages, K): one (B, K) draw a step (one stage), or, in the
    transformer's stage chain, one (B, n_steps - 1, K) draw a stage a
    step whose position t - 1 is step t's."""

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

    def noise(self, B, stages):
        jax.effects_barrier()
        assert len(self.draws) == stages * (N_STEPS - 1)
        g = np.zeros((B, N_STEPS - 1, stages, K), np.float32)
        it = iter(self.draws)
        for t in range(N_STEPS - 1):
            for s in range(stages):
                d = next(it)
                g[:, t, s] = d[:, t] if d.ndim == 3 else d
        return torch.from_numpy(g)


@pytest.mark.parametrize("part, temperature", [
    ("d_tcn", 0.0), ("d_tcn", 1.0), ("d_tf_recipe", 0.0),
    ("d_tf_recipe", 1.0)])
def test_feedback_step_matches_jax(part, temperature, monkeypatch,
                                   no_jax_dropout):
    """One feedback-matched finetune step (the eval-mode rollout with its
    own feedback, CE against the ground-truth codes) against JAX's
    make_feedback_train_step: loss and every gradient."""
    cfg = load_config({**PARTS[part], "feedback_temperature": temperature})
    jcfg = jax_load_config(PARTS[part])
    batch = _batches(part, PARTS[part], 13, 1)[0]
    jmodel, state, _ = _jax_setup(part, jcfg, _grab())
    rec = _NoiseRecorder(monkeypatch) if temperature > 0 else None
    jstep = jt2t.make_feedback_train_step(jmodel, _grab(),
                                          cfg.label_smoothing, temperature)
    model, _ = _port_setup(part, cfg, state)
    new_state, metrics = jstep(state, *map(jnp.asarray, batch),
                               jax.random.PRNGKey(5))
    step = pt2t.FeedbackTrainStep(model, Adam(model.parameters(), 1e-3),
                                  cfg.label_smoothing, temperature,
                                  torch.Generator().manual_seed(0))
    kw = {}
    if rec is not None:
        kw["gumbel"] = rec.noise(batch[0].shape[0], cfg.token_stages)
    loss = step.loss(*_torch_batch(part, batch), **kw)
    loss.backward()
    assert model.training
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    entries = param_entries(model)
    grads = jax_tree(entries, {id(p): (p.grad if p.grad is not None
                                       else torch.zeros_like(p))
                               for _, p, _, _ in entries})
    _close_trees(grads, _np(new_state.opt_state["g"]), GRAD_TOL, "grad")
    if temperature > 0:
        # the step draws its own noise when given none
        assert torch.isfinite(step.loss(*_torch_batch(part, batch)))


@pytest.mark.parametrize("start_epoch", [0, 3])
def test_late_step_from_epochs_minus_feedback_epochs(start_epoch, caplog):
    """train_text2token with epochs 4 and feedback_finetune_epochs 2: the
    teacher-forced step in epochs 0-1, the feedback step in 2-3, a run
    resumed at epoch 3 on the feedback step; the switch logged once."""
    seen = []

    def spy(cls):
        def call(self, *batch):
            seen.append(cls.__name__)
            return torch.zeros(())
        return call

    rng = np.random.default_rng(14)

    def data(m):
        lengths = rng.integers(3, MAXW + 1, m).astype(np.int32)
        return {"word_ids": rng.integers(4, NWORDS, (m, MAXW)).astype(
                    np.int32), "lengths": lengths,
                "tokens": rng.integers(0, K, (m, N_STEPS)).astype(np.int32)}
    cfg = load_config({**PARTS["d_tf"], "epochs": 4,
                       "feedback_finetune_epochs": 2})
    train, val = data(16), data(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt2t.TrainStep, "__call__", spy(pt2t.TrainStep))
        mp.setattr(pt2t.FeedbackTrainStep, "__call__",
                   spy(pt2t.FeedbackTrainStep))
        if start_epoch:
            mp.setattr(pt2t.checkpoints, "restore_for_resume",
                       lambda *a: (start_epoch, {}))
        with caplog.at_level(logging.INFO):
            pt2t.train_text2token(cfg, train, val, NWORDS, device="cpu",
                                  resume_from="x" if start_epoch else None)
    per_epoch = 16 // cfg.batch_size
    want = ["TrainStep"] * per_epoch * 2 + ["FeedbackTrainStep"] * \
        per_epoch * 2
    assert seen == want[start_epoch * per_epoch:]
    assert sum("feedback-matched" in r.getMessage()
               for r in caplog.records) == 1


# -- the command ----------------------------------------------------------
@pytest.fixture(scope="module")
def trained_recipe(tmp_path_factory):
    """The port's g2v-train a -> b (`seq_arch: transformer`, 4-stage
    residual VQ re-fit every epoch) -> d (the recipe: transformer, 4
    chained stages, label smoothing, its last epoch the feedback step) on
    a tiny store, on the CPU."""
    from gesture2vec_tpu_torch.cli import train as ptrain
    root = tmp_path_factory.mktemp("recipe")
    _tiny_store(str(root / "train"), 2, 500, 2)
    _tiny_store(str(root / "val"), 1, 400, 3)
    base = {"train_data_path": str(root / "train"),
            "val_data_path": str(root / "val"), "random_seed": 0,
            "learning_rate": 0.001}
    _write_yaml(root / "dae.yml", {**base, "name": "dae", "hidden_size": REP,
                                   "input_motion_dim": 135, "epochs": 1,
                                   "batch_size": 32})
    _write_yaml(root / "vq.yml", {
        **base, "name": "vq", "hidden_size": HID, "n_layers": 2,
        "autoencoder_vq": True, "autoencoder_vq_components": K,
        "autoencoder_vq_variant": "rvq", "rvq_stages": 4,
        "rvq_reestimate_every": 1, "seq_arch": "transformer", "epochs": 2,
        "batch_size": 16, "n_poses": 10, "n_pre_poses": 1,
        "subdivision_stride": 5})
    _write_yaml(root / "t2t.yml", {
        **base, "name": "t2t", "hidden_size": HID, "n_layers": 2,
        "wordembed_dim": WEMB, "autoencoder_att": True,
        "autoencoder_vq": True, "autoencoder_vq_components": K,
        "t2t_arch": "transformer", "t2t_heads": 2, "token_stages": 4,
        "stage_conditional": True, "label_smoothing": 0.1, "epochs": 3,
        "feedback_finetune_epochs": 1, "batch_size": 8, "n_poses": 10,
        "n_pre_poses": 1, "sentence_frame_length": 40,
        "subdivision_stride_sentence": 20,
        "motion_resampling_framerate": 20})
    files = {"a": root / f"out/dae/dae_H{REP}_checkpoint_001.bin",
             "b": root / "out/vq/vq_checkpoint_002.bin",
             "d": root / "out/t2t/t2t_checkpoint_003.bin"}
    out = {"root": root, "files": files}
    for part, cfg, extra in (
            ("a", "dae.yml", []),
            ("b", "vq.yml", ["--rep-checkpoint", str(files["a"])]),
            ("d", "t2t.yml", ["--rep-checkpoint", str(files["a"]),
                              "--autoencoder-checkpoint", str(files["b"])])):
        save = str(root / "out" / cfg.split(".")[0])
        out[part] = ptrain.main(["-c", str(root / cfg), "--part", part,
                                 "--device", "cpu", "--save-dir", save]
                                + extra)
    return out


def test_command_trains_the_recipe(trained_recipe):
    """Finite losses that fall: the tokenizer over its two epochs, the
    Part d over its teacher-forced epochs, and its feedback epoch below
    its first step's loss."""
    _, hb = trained_recipe["b"]
    model, hd = trained_recipe["d"]
    assert isinstance(model, port_tf.TransformerText2Token)
    for h in (hb, hd):
        assert np.all(np.isfinite(h["train_loss"] + h["val_loss"]))
    assert hb["train_loss"][-1] < hb["train_loss"][0]
    assert hd["train_loss"][1] < hd["train_loss"][0]
    assert hd["train_loss"][2] < hd["first_step_loss"][0]
    for f in trained_recipe["files"].values():
        assert f.exists()


@pytest.mark.parametrize("part", ["b", "d"])
def test_recipe_checkpoints_load_in_jax(trained_recipe, part):
    """The JAX package loads the port's files: the transformer tokenizer
    gives the port's stage tokens and sequence latents, the recipe's Part
    d the port's greedy tokens and stage tokens (logits within 1e-5)."""
    from gesture2vec_tpu.data.teacher import tokenize_windows as jax_tok
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.teacher import tokenize_windows

    kind = {"b": "autoencoder_vq", "d": "text2embedding"}[part]
    path = str(trained_recipe["files"][part])
    jm, jv, payload = jckpt.load_checkpoint_and_model(path, kind)
    assert "opt_state" in payload["extra"]
    pm, _ = load_checkpoint_and_model(path, kind, "cpu")
    rng = np.random.default_rng(15)
    if part == "b":
        assert pm.encoder_arch == "transformer"
        lat = rng.normal(size=(40, 10, REP)).astype(np.float32)
        want = jax_tok(jm, jv, lat, batch=16, all_stages=True)
        got = tokenize_windows(pm, lat, batch=16, all_stages=True)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-5)
        return
    assert payload["extra"]["batch_stats"] == {}
    ids = rng.integers(4, 20, (4, 7)).astype(np.int32)
    lengths = np.array([7, 5, 3, 6], np.int32)
    tgt = rng.integers(0, K, (4, 4)).astype(np.int32)
    want = jm.apply(jv, *map(jnp.asarray, (ids, lengths, tgt)))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a).long() for a in (ids, lengths, tgt)))
    for key in ("tokens", "stage_tokens"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-5)


def test_build_generator_on_recipe_files(trained_recipe):
    """cli/_common.build_generator turns the recipe's three files into a
    working generator: a 6 s transcript gives finite frames in decode
    mode, with 4-stage tokens."""
    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.data.store import ClipStore
    f = trained_recipe["files"]
    gen, cfg = build_generator(str(f["d"]), str(f["a"]), str(f["b"]),
                               ClipStore(str(trained_recipe["root"] /
                                             "train")),
                               mode="decode", device="cpu")
    assert cfg["t2t_arch"] == "transformer" and cfg["t2t_heads"] == 2
    words = [[f"w{i}", 0.1 + 0.4 * i, 0.4 + 0.4 * i] for i in range(12)]
    frames, tokens = gen.generate(words, 6.0)
    assert frames.shape == (120, 135) and np.isfinite(frames).all()
    assert tokens.shape == (12,)
