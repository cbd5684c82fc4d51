"""PyTorch port vs the JAX package: the Part-b variants - the VAE
tokenizer (`autoencoder_vae`), the plain sequence autoencoder
(`autoencoder_vq: false`), `use_derivative`, and the similarity-
supervised step (`use_similarity` with a label file).

Small widths (latent 8, hidden 8, 2 layers, 16 codes, 6-frame windows,
batches of 8), inputs from numpy seeds, weights from one JAX init
carried across by `compat/from_jax`. Dropout is off on both sides; the
VAE's reparameterisation noise is the same seeded numpy array on both
sides (`jax.random.normal` patched inside the test, the port's
`models/layers.reparam_noise` likewise). The loss within 1e-5 relative,
every gradient within 1e-4 of its largest magnitude (pre_linear's bias,
which the decoder's batch-statistics BatchNorm cancels, against the
model's largest), the BatchNorm statistics within 1e-5, token ids equal.

- one train step of the VAE tokenizer at epochs 0 and 5 (the annealed
  KLD), of the plain autoencoder, of the plain VAE, and of a
  use_derivative model on windows of width 2 * rep_learning_dim;
- the similarity step at epochs 9 and 10, on both sides of its KLD gate,
  and without the VAE: loss, rec, sim, gradients and the BatchNorm
  statistics threaded through its three forwards;
- the labels reader and the pair sampler;
- checkpoints: a VAE (and a use_derivative) tokenizer written by JAX
  loads in the port's Part c with JAX's tokens; the plain autoencoder
  saves as kind "autoencoder", resumes, loads in JAX and gives no
  tokens; the port's command `--part b` with `use_similarity`;
- `use_derivative` on the command line's data: both trainers refuse it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu.data import similarity as jsim
from gesture2vec_tpu.train import checkpoints as jckpt
from gesture2vec_tpu.train import seq_ae_trainer as jseq
from gesture2vec_tpu.train.config import load_config as jax_load_config
from gesture2vec_tpu_torch.compat.from_jax import (jax_tree,
                                                   load_jax_variables,
                                                   param_entries)
from gesture2vec_tpu_torch.data import similarity as psim
from gesture2vec_tpu_torch.models import layers as port_layers
from gesture2vec_tpu_torch.train import seq_ae_trainer as pseq
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.optim import Adam
from tests.test_torch_port_train import (GRAD_TOL, LOSS_RTOL, _close_trees,
                                         _grab, _np, _rel, _tiny_store,
                                         _write_yaml, no_jax_dropout,
                                         torch_one_thread)

REP, HID, CODES, NP, BS, EPOCHS = 8, 8, 16, 6, 8, 20
SEQ_CFG = {"name": "seq", "hidden_size": HID, "n_layers": 2,
           "rep_learning_dim": REP, "n_poses": NP, "n_pre_poses": 1,
           "autoencoder_vq": True, "autoencoder_vq_components": CODES,
           "batch_size": BS, "epochs": EPOCHS, "learning_rate": 1e-3,
           "loss_l1_weight": 5, "loss_cont_weight": 0.1,
           "loss_var_weight": 0.5, "random_seed": 0}
VARIANTS = {"vae": {"autoencoder_vae": True},
            "plain": {"autoencoder_vq": False},
            "plain_vae": {"autoencoder_vq": False, "autoencoder_vae": True},
            "derivative": {"use_derivative": True},
            "ssl": {"autoencoder_vae": True, "use_similarity": True,
                    "loss_label_weight": 0.1},
            "ssl_gssoft": {"use_similarity": True, "loss_label_weight": 0.1}}


def _noise(shape):
    return np.random.default_rng(
        [int(s) for s in shape] + [11]).normal(size=shape).astype(np.float32)


@pytest.fixture
def same_eps(monkeypatch):
    """Both packages' VAE noise from `_noise`; call the returned function
    after the JAX init, whose initialisers draw from jax.random.normal."""
    monkeypatch.setattr(port_layers, "reparam_noise", lambda like: (
        torch.from_numpy(_noise(tuple(like.shape)))))

    def patch_jax():
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=(
            jnp.float32): jnp.asarray(_noise(tuple(shape)), dtype))
    return patch_jax


def _setup(name, seed=0):
    """(JAX config, model, state; the port's model with its weights)."""
    d = {**SEQ_CFG, **VARIANTS[name]}
    cfg = jax_load_config(d)
    jm = jseq.make_seq_ae(cfg)
    state = jseq.init_state(cfg, jm, jax.random.PRNGKey(seed), _grab())
    pm = pseq.make_seq_ae(load_config(d))
    load_jax_variables(pm, _np(state.params), _np(state.batch_stats))
    return cfg, jm, state, pm.train()


def _windows(seed, n=BS, width=REP):
    return np.random.default_rng(seed).normal(size=(n, NP, width)).astype(
        np.float32)


def _grads(model):
    entries = param_entries(model)
    return jax_tree(entries, {id(p): (p.grad if p.grad is not None
                                      else torch.zeros_like(p))
                              for _, p, _, _ in entries})


def _check_bn(model, batch_stats):
    bn = model.decoder.decoder_step.pre_bn
    stats = _np(batch_stats)["decoder_step"]["pre_bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               atol=1e-5)


@pytest.mark.parametrize("name,epoch", [
    ("vae", 0), ("vae", 5), ("plain", 0), ("plain_vae", 3),
    ("derivative", 0)])
def test_variant_step_matches_jax(name, epoch, no_jax_dropout, same_eps):
    """One step against JAX's make_train_step at an epoch: the loss (the
    VAE's KLD weight 0.1 (epoch + 1) / epochs), the perplexity (0 without
    a quantizer), every gradient and the BatchNorm statistics."""
    cfg, jm, state, pm = _setup(name)
    same_eps()
    width = 2 * REP if name == "derivative" else REP
    x = _windows(1, width=width)
    jstep = jseq.make_train_step(cfg, jm, _grab(), cfg.epochs)
    new_state, metrics = jstep(state, jnp.asarray(x), jax.random.PRNGKey(2),
                               jnp.asarray(float(epoch)))
    loss, perp = pseq.TrainStep(load_config({**SEQ_CFG, **VARIANTS[name]}),
                                pm, Adam(pm.parameters(), 1e-3)).loss(
        torch.from_numpy(x), float(epoch))
    loss.backward()
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    assert abs(float(perp) - float(metrics["perplexity"])) <= 1e-5 * max(
        1.0, float(metrics["perplexity"]))
    _close_trees(_grads(pm), _np(new_state.opt_state["g"]), GRAD_TOL,
                 "grad")
    _check_bn(pm, new_state.batch_stats)


@pytest.mark.parametrize("name,epoch", [("ssl", 9), ("ssl", 10),
                                        ("ssl_gssoft", 0)])
def test_ssl_step_matches_jax(name, epoch, no_jax_dropout, same_eps):
    """The similarity step against make_ssl_train_step: the main batch,
    then each pair member's forward (BatchNorm statistics threaded in that
    order); loss, rec, sim, gradients and the statistics. At epoch 9 the
    KLD gate (epoch + 1 > 10) is shut, at 10 open."""
    cfg, jm, state, pm = _setup(name)
    same_eps()
    x = _windows(3)
    pa, pb = _windows(4, n=3), _windows(5, n=3)
    label = np.array([1.0, 0.0, 1.0], np.float32)
    jstep = jseq.make_ssl_train_step(cfg, jm, _grab(), cfg.epochs)
    new_state, metrics = jstep(state, *map(jnp.asarray, (x, pa, pb, label)),
                               jax.random.PRNGKey(6),
                               jnp.asarray(float(epoch)))
    step = pseq.SSLTrainStep(load_config({**SEQ_CFG, **VARIANTS[name]}), pm,
                             Adam(pm.parameters(), 1e-3))
    loss, perp, rec, sim = step.loss(
        *map(torch.from_numpy, (x, pa, pb, label)), float(epoch))
    loss.backward()
    for got, key in ((loss, "loss"), (rec, "rec"), (sim, "sim")):
        assert _rel(got, metrics[key]) <= LOSS_RTOL, key
    _close_trees(_grads(pm), _np(new_state.opt_state["g"]), GRAD_TOL,
                 "grad")
    _check_bn(pm, new_state.batch_stats)
    if name == "ssl":
        # the gate: the step's loss moves with the KLD only at epoch 10
        shut = step.loss(*map(torch.from_numpy, (x, pa, pb, label)), 9.0)[0]
        assert (float(shut) == float(loss)) == (epoch == 9)


def test_similarity_labels_match_jax(tmp_path):
    """The port's labels reader and pair sampler give JAX's pairs, and
    raise where JAX's raise."""
    rng = np.random.default_rng(7)
    lines = ["x,1,2"]
    for i in range(60):
        a, m, b = rng.integers(0, 50, 3)
        lines.append(f"ann{i % 3},{a},{m},{b},"
                     f"{['left', 'right', 'neither', 'unsure'][i % 4]},1.5")
    path = tmp_path / "labels.txt"
    path.write_text("\n".join(lines) + "\n")
    want = jsim.read_gesture_labels(str(path))
    got = psim.read_gesture_labels(str(path))
    assert got == want and len(got) == 60
    for seed, count, n in ((0, 3, 50), (1, 3, 20), (2, 200, 30)):
        w = jsim.sample_pairs(want, count, np.random.default_rng(seed), n)
        g = psim.sample_pairs(got, count, np.random.default_rng(seed), n)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="no valid"):
        psim.sample_pairs(got, 3, np.random.default_rng(0), 0)


def _perturbed(name, seed):
    from tests.test_torch_port_exemplar import perturb
    cfg, jm, state, _ = _setup(name, seed)
    variables = perturb({"params": _np(state.params),
                         "batch_stats": _np(state.batch_stats)},
                        np.random.default_rng(seed), 0.2)
    return cfg, jm, variables


@pytest.mark.parametrize("name", ["vae", "derivative"])
def test_tokenizer_checkpoint_loads_in_part_c(name, tmp_path):
    """A JAX-written VAE (use_derivative) tokenizer through the port's
    loader: its tokens and sequence latents are JAX's tokenize_windows',
    which never pass through the VAE heads."""
    from gesture2vec_tpu.data.teacher import tokenize_windows as jtok
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.teacher import tokenize_windows
    cfg, jm, variables = _perturbed(name, 8)
    path = str(tmp_path / "vq.bin")
    jckpt.save_checkpoint(path, config=cfg, epoch=1,
                          params=variables["params"], pose_dim=jm.rep_dim,
                          extra={"batch_stats": variables["batch_stats"],
                                 "parity": False}, kind="autoencoder_vq")
    pm, _ = load_checkpoint_and_model(path, "autoencoder_vq", "cpu")
    assert pm.use_vae == (name == "vae") and pm.rep_dim == jm.rep_dim
    w = _windows(9, n=40, width=jm.rep_dim)
    want_t, want_l = jtok(jm, variables, w)
    got_t, got_l = tokenize_windows(pm, w)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_l, want_l, atol=1e-5)


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """The port's Part b without a quantizer: one epoch, saved."""
    root = tmp_path_factory.mktemp("plain")
    cfg = load_config({**SEQ_CFG, **VARIANTS["plain"], "epochs": 1})
    model, hist = pseq.train_seq_ae(cfg, _windows(10, n=32), _windows(11),
                                    save_dir=str(root), device="cpu")
    return {"model": model, "hist": hist, "cfg": cfg,
            "file": str(root / "seq_checkpoint_001.bin")}


def test_plain_autoencoder_checkpoint(plain_run, tmp_path):
    """Saved as kind "autoencoder"; JAX loads it and gives the port's
    outputs; the port resumes from it; uses that need tokens refuse it."""
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.train import checkpoints as pckpt
    payload = pckpt.load_checkpoint(plain_run["file"])
    assert payload["kind"] == "autoencoder"
    assert "vq_layer" not in payload["params"]
    assert plain_run["hist"]["perplexity"] == [0.0]
    jm, jv, _ = jckpt.load_checkpoint_and_model(plain_run["file"],
                                                "autoencoder")
    x = _windows(12)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(x))["outputs"]
    with torch.no_grad():
        got = plain_run["model"].eval()(torch.from_numpy(x),
                                        torch.from_numpy(x))["outputs"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    resumed, hist = pseq.train_seq_ae(
        plain_run["cfg"].replace(epochs=2), _windows(10, n=32),
        _windows(11), resume_from=plain_run["file"], device="cpu")
    assert len(hist["train_loss"]) == 1
    with pytest.raises(ValueError, match="no quantizer"):
        load_checkpoint_and_model(plain_run["file"], "autoencoder", "cpu")
    with pytest.raises(ValueError, match="no quantizer"):
        resumed.tokens_from_hidden(torch.zeros(2, 1, HID))


def test_use_derivative_on_command_line_data_is_refused():
    """The command line's Part-b data are the DAE latents as they are
    (rep_learning_dim wide), into a model built for twice that: the JAX
    trainer fails at its first step (a parameter-shape error), the port's
    before it, naming the widths."""
    d = {**SEQ_CFG, **VARIANTS["derivative"], "epochs": 1}
    w = _windows(13, n=16)
    with pytest.raises(Exception, match="shape"):
        jseq.train_seq_ae(jax_load_config(d), w, w)
    with pytest.raises(ValueError, match="use_derivative"):
        pseq.train_seq_ae(load_config(d), w, w, device="cpu")


def test_streaming_source_still_refused():
    """A streaming source trains Part b now, but not the similarity step:
    pair sampling indexes the in-RAM array (JAX's rule)."""
    class Streaming:
        def batches(self, epoch, bs):
            return iter(())

        def __len__(self):
            return 64
    with pytest.raises(ValueError, match="use_similarity needs the in-RAM"):
        pseq.train_seq_ae(load_config({**SEQ_CFG, "use_similarity": True}),
                          Streaming(), _windows(0), device="cpu")


def test_command_trains_the_similarity_step(tmp_path):
    """`--part a` (a VQFrame teacher) then `--part b` with use_similarity
    and a label file, on the CPU: every step is the similarity step, the
    epoch losses are finite and fall, and JAX loads the file (the VAE heads
    among its params) and gives the port's outputs."""
    from gesture2vec_tpu_torch.cli import train as ptrain
    _tiny_store(str(tmp_path / "train"), 1, 600, 0)
    _tiny_store(str(tmp_path / "val"), 1, 200, 1)
    base = {"train_data_path": str(tmp_path / "train"),
            "val_data_path": str(tmp_path / "val"), "random_seed": 0,
            "learning_rate": 0.005, "input_motion_dim": 135}
    _write_yaml(tmp_path / "a.yml", {**base, "name": "dae",
                                     "hidden_size": REP,
                                     "autoencoder_vq": True,
                                     "autoencoder_vq_components": CODES,
                                     "epochs": 1, "batch_size": 64})
    rng = np.random.default_rng(14)
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(
        f"a,{i},{i + 1},{i + 2},{['left', 'right', 'neither'][i % 3]},0\n"
        for i in rng.integers(0, 50, 40)))
    _write_yaml(tmp_path / "b.yml", {
        **base, **{k: v for k, v in SEQ_CFG.items()
                   if k not in ("rep_learning_dim", "learning_rate")},
        "name": "ssl", "autoencoder_vae": True, "use_similarity": True,
        "similarity_labels": str(labels), "loss_label_weight": 0.1,
        "epochs": 2, "n_poses": 10, "subdivision_stride": 5})
    ptrain.main(["-c", str(tmp_path / "a.yml"), "--part", "a", "--device",
                 "cpu", "--save-dir", str(tmp_path / "a")])
    calls = []
    loss = pseq.SSLTrainStep.loss

    def recording(self, *a):
        calls.append(len(a))
        return loss(self, *a)
    pseq.SSLTrainStep.loss = recording
    try:
        model, hist = ptrain.main([
            "-c", str(tmp_path / "b.yml"), "--part", "b", "--device", "cpu",
            "--save-dir", str(tmp_path / "b"), "--rep-checkpoint",
            str(tmp_path / "a" / f"dae_H{REP}_checkpoint_001.bin")])
    finally:
        pseq.SSLTrainStep.loss = loss
    assert calls and set(calls) == {5}
    assert np.all(np.isfinite(hist["train_loss"] + hist["val_loss"]))
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert hist["val_loss"][-1] < hist["val_loss"][0]
    path = str(tmp_path / "b" / "ssl_checkpoint_002.bin")
    jm, jv, _ = jckpt.load_checkpoint_and_model(path, "autoencoder_vq")
    assert "vae_mean" in jv["params"]
    x = np.random.default_rng(15).normal(size=(4, 10, REP)).astype(
        np.float32)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(x))["outputs"]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(x))[
            "outputs"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
