"""PyTorch port vs the JAX package: the Part-a frame models and their
quantizers - `VQFrame` (with and without the VAE heads), `VAEFrame`,
`vq_ema`, `vq_st`, `vq_gumbel`, and `train_dae`'s `vq_tricks`.

Small widths (motion 12, latent 8, 16 codes, batches of 16), inputs from
numpy seeds, weights from one JAX init carried across by
`compat/from_jax`. Dropout is off on both sides (`no_jax_dropout`, and
the port outside `models/layers.dropout_generator`); the VAEs'
reparameterisation noise is the same seeded numpy array on both sides
(`jax.random.normal` patched inside the test, the port's
`models/layers.reparam_noise` likewise). Floats within 1e-5, token ids
equal; gradients within 1e-4 of each tensor's largest magnitude (the
encoder bias in front of the VQFrame's batch-statistics BatchNorm, whose
gradient is rounding, against the model's largest).

- vq_ema (train and eval), vq_st, vq_gumbel (eval, and train with JAX's
  own Gumbel noise);
- the frame models' forwards in train and eval mode, the BatchNorm
  statistics and the EMA state after them;
- one Part-a train step per model (VQ, VQ + VAE, VQ warmup, VAE): loss,
  gradients, the new EMA state and BatchNorm statistics;
- `reestimate_codebook` from JAX's K-Means seeding; a two-epoch
  `train_dae(vq_tricks=True)` against JAX's, step kind by step kind;
- checkpoints both ways, the port's command `--part a` with
  `autoencoder_vq`, and a generator whose DAE is a VQFrame.
The card-vs-CPU step of the VQFrame is `gpu`-marked in
`tests/test_torch_port_train_kernels.py` (a file that collects without
flax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu.models import vq as jvq
from gesture2vec_tpu.train import checkpoints as jckpt
from gesture2vec_tpu.train import dae_trainer as jdae
from gesture2vec_tpu.train.config import load_config as jax_load_config
from gesture2vec_tpu.train.optim import make_optimizer
from gesture2vec_tpu_torch.compat.from_jax import (ema_state_to_jax,
                                                   jax_tree, load_ema_state,
                                                   load_jax_variables,
                                                   param_entries)
from gesture2vec_tpu_torch.models import layers as port_layers
from gesture2vec_tpu_torch.models import vq as pvq
from gesture2vec_tpu_torch.train import checkpoints as pckpt
from gesture2vec_tpu_torch.train import dae_trainer as pdae
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.optim import Adam
from tests.test_torch_port_train import (GRAD_TOL, LOSS_RTOL, _grab, _np,
                                         _rel, _write_yaml, no_jax_dropout,
                                         torch_one_thread)

ATOL = 1e-5
MOTION, LATENT, CODES, BS = 12, 8, 16, 16
FRAME_CFG = {"name": "frame", "hidden_size": LATENT,
             "input_motion_dim": MOTION, "autoencoder_vq_components": CODES,
             "batch_size": BS, "learning_rate": 1e-3, "random_seed": 0}
MODELS = {"vq": {"autoencoder_vq": True},
          "vqvae": {"autoencoder_vq": True, "autoencoder_vae": True},
          "vae": {"autoencoder_vae": True}}


def _noise(shape):
    """The reparameterisation noise of a shape, the same on both sides."""
    return np.random.default_rng(
        [int(s) for s in shape] + [7]).normal(size=shape).astype(np.float32)


@pytest.fixture
def same_eps(monkeypatch):
    """Both packages' VAE noise from `_noise` (JAX's jax.random.normal
    only where a test applies a model after its init)."""
    monkeypatch.setattr(port_layers, "reparam_noise", lambda like: (
        torch.from_numpy(_noise(tuple(like.shape))).to(like.device)))

    def patch_jax():
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=(
            jnp.float32): jnp.asarray(_noise(tuple(shape)), dtype))
    return patch_jax


def _frames(seed, n=BS):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, MOTION)) * 1.5 + 0.3).astype(np.float32)


def _jax_model(name, seed=0):
    cfg = jax_load_config({**FRAME_CFG, **MODELS[name]})
    model = jdae.make_frame_model(cfg)
    state = jdae.init_state(cfg, model, jax.random.PRNGKey(seed), _grab())
    return cfg, model, state


def _port_model(name, state):
    model = pdae.make_frame_model(load_config({**FRAME_CFG, **MODELS[name]}))
    load_jax_variables(model, _np(state.params), _np(state.batch_stats))
    if state.vq_state is not None:
        load_ema_state(model, _np(state.vq_state._asdict()))
    return model


def _jax_vars(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


def _check_state(model, batch_stats, vq_state, mean_atol=ATOL,
                 ema_atol=ATOL):
    """The port's BatchNorm statistics and EMA buffers against JAX's
    (the EMA state within ema_atol of its largest magnitude, or 1)."""
    bs = _np(batch_stats)["bn"]
    _close(model.bn.running_mean.numpy(), bs["mean"], atol=mean_atol,
           what="bn mean")
    _close(model.bn.running_var.numpy(), bs["var"], what="bn var")
    got = ema_state_to_jax(model)
    for k, v in _np(vq_state._asdict()).items():
        _close(got[k], v, atol=ema_atol * max(1.0, float(np.abs(v).max())),
               what=k)


# -- the quantizers -------------------------------------------------------
@pytest.mark.parametrize("train", [True, False])
def test_vq_ema_matches_jax(train):
    """Indices, quantized, loss, perplexity and the new state; the
    quantized value takes the pre-update codebook, and eval leaves the
    state as it is."""
    rng = np.random.default_rng(1)
    state = jvq.init_ema_state(jax.random.PRNGKey(2), CODES, LATENT)
    # a codebook near the inputs, so most codes are used
    state = state._replace(codebook=jnp.asarray(
        rng.normal(size=(CODES, LATENT)).astype(np.float32)),
        cluster_size=jnp.asarray(rng.uniform(0, 3, CODES).astype(
            np.float32)))
    x = rng.normal(size=(4, 10, LATENT)).astype(np.float32)
    want, new = jvq.vq_ema(jnp.asarray(x), state, train=train)
    pstate = pvq.VQEmaState(*(torch.from_numpy(np.asarray(v))
                              for v in state))
    got, pnew = pvq.vq_ema(torch.from_numpy(x), pstate, train=train)
    np.testing.assert_array_equal(got.encodings.argmax(-1).numpy(),
                                  np.asarray(want.encodings).argmax(-1))
    for a, b in ((got.quantized, want.quantized), (got.loss, want.loss),
                 (got.perplexity, want.perplexity),
                 (got.encodings, want.encodings)):
        _close(a.numpy(), b)
    for a, b in zip(pnew, new):
        _close(a.numpy(), b, atol=ATOL * max(1.0, float(jnp.abs(b).max())))
    if not train:
        assert all(a is b for a, b in zip(pnew, pstate))


def test_vq_st_matches_jax():
    """Straight-through VQ: the output, loss, perplexity, and the
    gradients of the input and the codebook."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(24, LATENT)).astype(np.float32)
    cb = rng.normal(size=(CODES, LATENT)).astype(np.float32)

    def jax_loss(x_, cb_):
        out = jvq.vq_st(x_, cb_)
        return out.loss + jnp.sum(out.quantized ** 2), out
    (jl, jout), (gx, gcb) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                jnp.asarray(cb))
    tx, tcb = (torch.from_numpy(a).requires_grad_() for a in (x, cb))
    out = pvq.vq_st(tx, tcb)
    loss = out.loss + torch.sum(out.quantized ** 2)
    loss.backward()
    assert _rel(loss, jl) <= LOSS_RTOL
    _close(out.perplexity.detach(), jout.perplexity)
    _close(tx.grad, gx)
    _close(tcb.grad, gcb)


@pytest.mark.parametrize("train", [False, True])
def test_vq_gumbel_matches_jax(train):
    """Eval: the hard argmin; train: JAX's own Gumbel noise (drawn from
    the same key) fed to the port."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(20, LATENT)).astype(np.float32)
    cb = rng.normal(size=(CODES, LATENT)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jvq.vq_gumbel(jnp.asarray(x), jnp.asarray(cb), key,
                         temperature=0.5, train=train)
    g = np.asarray(jax.random.gumbel(key, (20, CODES)))
    got = pvq.vq_gumbel(torch.from_numpy(x), torch.from_numpy(cb),
                        temperature=0.5, train=train,
                        gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(got.encodings.argmax(-1).numpy(),
                                  np.asarray(want.encodings).argmax(-1))
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    if train:
        # the generator's draw gives a valid relaxed one-hot
        drawn = pvq.vq_gumbel(torch.from_numpy(x), torch.from_numpy(cb),
                              generator=torch.Generator().manual_seed(0))
        _close(drawn.encodings.sum(-1).numpy(), np.ones(20))


def test_vq_ema_refuses_the_psum():
    """The psum, once refused, is ported: axis_name takes a
    parallel.mesh.Mesh (its dp ranks' sums, tests/test_torch_port_mesh.py);
    a plain process's mesh gives the update without one, and a JAX-style
    axis name string raises."""
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh

    state = pvq.init_ema_state(CODES, LATENT, torch.Generator())
    x = torch.randn(6, LATENT, generator=torch.Generator().manual_seed(1))
    _, want = pvq.vq_ema(x, state)
    _, got = pvq.vq_ema(x, state, axis_name=make_mesh({"dp": 2}, "cpu"))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="names no axes"):
        pvq.vq_ema(torch.zeros(2, LATENT), state, axis_name="dp")


def test_init_ema_state_draws_the_reference_distributions():
    """codebook U(-1/K, 1/K), ema_w N(0, 1), cluster_size 0."""
    s = pvq.init_ema_state(64, 32, torch.Generator().manual_seed(0))
    assert float(s.codebook.abs().max()) <= 1 / 64
    assert abs(float(s.codebook.std()) - (1 / 64) / 3 ** 0.5) < 1e-3
    assert abs(float(s.ema_w.std()) - 1.0) < 0.05
    assert float(s.cluster_size.abs().sum()) == 0.0


# -- the frame models -----------------------------------------------------
@pytest.mark.parametrize("name,train,skip_vq", [
    ("vq", True, False), ("vq", False, False), ("vq", True, True),
    ("vqvae", True, False), ("vqvae", False, False), ("vae", True, False),
    ("vae", False, False)])
def test_frame_forward_matches_jax(name, train, skip_vq, no_jax_dropout,
                                   same_eps):
    """Every output of the forward, and after it the BatchNorm statistics
    and the EMA state (train mode updates both, skip_vq only the first);
    encode and decode, the teacher contract."""
    cfg, jm, state = _jax_model(name)
    pm = _port_model(name, state).train(train)
    same_eps()
    x = _frames(6)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        if name == "vae":
            want = jm.apply({"params": state.params}, jnp.asarray(x),
                            train=train, rngs={"dropout": jax.random.PRNGKey(
                                0), "reparam": jax.random.PRNGKey(1)})
            for a, b in zip(pm(tx), want):
                _close(a.numpy(), b)
        else:
            (want, new_vq), mut = jm.apply(
                _jax_vars(state), jnp.asarray(x), state.vq_state,
                train=train, skip_vq=skip_vq, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0),
                      "reparam": jax.random.PRNGKey(1)})
            got = pm(tx, skip_vq=skip_vq)
            for k in ("output", "latent", "mean", "logvar"):
                if want[k] is None:
                    assert got[k] is None
                else:
                    _close(got[k].numpy(), want[k], what=k)
            for a, b in zip(got["vq"], want["vq"]):
                _close(a.numpy(), b)
            np.testing.assert_array_equal(
                got["vq"].encodings.argmax(-1).numpy(),
                np.asarray(want["vq"].encodings).argmax(-1))
            _check_state(pm, mut["batch_stats"], new_vq)
        _close(pm.encode(tx).numpy(), jm.apply(
            _jax_vars(state), jnp.asarray(x), method=jm.encode))
        z = _frames(7)[:, :LATENT]
        _close(pm.decode(torch.from_numpy(z)).numpy(), jm.apply(
            _jax_vars(state), jnp.asarray(z), method=jm.decode))


def _cancelled(path):
    return path == ("encoder", "bias")


def _close_grads(model, want, encoder_bias_cancelled):
    entries = param_entries(model)
    got = jax_tree(entries, {id(p): (p.grad if p.grad is not None
                                     else torch.zeros_like(p))
                             for _, p, _, _ in entries})
    g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(str, g)) == sorted(map(str, w))
    top = max(float(np.abs(v).max()) for v in w.values())
    for path, wv in w.items():
        keys = tuple(k.key for k in path)
        scale = top if encoder_bias_cancelled and _cancelled(keys) \
            else float(np.abs(wv).max())
        err = float(np.abs(np.asarray(g[path]) - wv).max()) / max(scale,
                                                                   1e-30)
        assert err <= GRAD_TOL, f"grad {'/'.join(keys)}: {err}"


@pytest.mark.parametrize("name,skip_vq", [
    ("vq", False), ("vq", True), ("vqvae", False), ("vae", False)])
def test_frame_train_step_matches_jax(name, skip_vq, no_jax_dropout,
                                      same_eps):
    """One Part-a step against JAX's make_train_step (skip_vq: the
    delayed-VQ warmup step): the loss, every gradient, and for a VQFrame
    the new EMA state and BatchNorm statistics."""
    cfg, jm, state = _jax_model(name)
    pm = _port_model(name, state).train()
    same_eps()
    x = _frames(8)
    jstep = jdae.make_train_step(cfg, jm, _grab(), skip_vq=skip_vq)
    new_state, metrics = jstep(state, jnp.asarray(x), jax.random.PRNGKey(3))
    step = pdae.TrainStep(pm, Adam(pm.parameters(), 1e-3), skip_vq=skip_vq)
    loss = step.loss(torch.from_numpy(x))
    loss.backward()
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    _close_grads(pm, _np(new_state.opt_state["g"]), name != "vae")
    if name != "vae":
        _check_state(pm, new_state.batch_stats, new_state.vq_state)


def test_eval_step_matches_jax(same_eps):
    for name in MODELS:
        cfg, jm, state = _jax_model(name, seed=1)
        pm = _port_model(name, state).eval()
        x = _frames(9)
        want = jdae.make_eval_step(cfg, jm)(state, jnp.asarray(x))
        assert _rel(pdae.eval_step(pm, torch.from_numpy(x)), want) <= 1e-6


def _jax_seeds(latents, k):
    """JAX's kmeans_fit seeding (key PRNGKey(0), one init)."""
    from gesture2vec_tpu.cluster import kmeans as jkm
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    return torch.from_numpy(np.asarray(jkm._plusplus_init(
        key, jnp.asarray(latents.numpy()), k)))


def test_reestimate_codebook_matches_jax():
    """Both packages' K-Means re-fit from the same weights and initial
    centers: the EMA state becomes (centers, ones, centers)."""
    cfg, jm, state = _jax_model("vqvae", seed=2)
    stats = {"bn": {"mean": np.full(LATENT, 0.1, np.float32),
                    "var": np.full(LATENT, 1.5, np.float32)}}
    state = state._replace(batch_stats=stats)
    frames = _frames(10, n=200)
    want = jdae.reestimate_codebook(jm, state, frames, CODES, batch=64)
    pm = _port_model("vqvae", state)
    pdae.reestimate_codebook(pm, frames, CODES, batch=64,
                             seed_centers=_jax_seeds)
    got = ema_state_to_jax(pm)
    for k, v in _np(want.vq_state._asdict()).items():
        _close(got[k], v, atol=1e-4, what=k)
    assert pm.vq.codebook.data_ptr() != pm.vq.ema_w.data_ptr()


def test_train_dae_vq_tricks_matches_jax(monkeypatch, no_jax_dropout):
    """Two epochs of train_dae(vq_tricks=True, vq_start_epoch=1,
    vq_reestimate_every=1) on both sides (dropout off, the port's K-Means
    from JAX's seeding): the same step kind in every step, the re-fit
    before epoch 1 only, and the same losses and final state. The
    encoder bias's gradient is rounding (the BatchNorm cancels it), so
    Adam moves it by up to lr a step in either direction on either side:
    the running mean, a convex combination of batch means that carry
    the bias, is held within 2 lr a step, and the EMA state, fitted
    from eval-mode latents that carry the running mean, within 1e-3."""
    calls = {"jax": [], "port": []}
    j_make = jdae.make_train_step

    def j_recording(config, model, optimizer, skip_vq=False):
        fn = j_make(config, model, optimizer, skip_vq=skip_vq)

        def step(*a):
            calls["jax"].append("warmup" if skip_vq else "vq")
            return fn(*a)
        return step
    monkeypatch.setattr(jdae, "make_train_step", j_recording)
    j_refit = jdae.reestimate_codebook
    monkeypatch.setattr(jdae, "reestimate_codebook", lambda *a, **k: (
        calls["jax"].append("refit"), j_refit(*a, **k))[1])
    p_loss = pdae.TrainStep.loss

    def p_recording(self, batch):
        calls["port"].append("warmup" if self.skip_vq else "vq")
        return p_loss(self, batch)
    monkeypatch.setattr(pdae.TrainStep, "loss", p_recording)
    p_refit = pdae.reestimate_codebook
    monkeypatch.setattr(pdae, "reestimate_codebook", lambda m, f, k: (
        calls["port"].append("refit"), p_refit(m, f, k,
                                               seed_centers=_jax_seeds))[1])
    monkeypatch.setattr(pdae, "dropout_generator",
                        lambda gen: port_layers.dropout_generator(None))
    d = {**FRAME_CFG, **MODELS["vq"], "epochs": 2}
    # the port starts from the JAX run's initial weights and EMA state
    _, _, init = _jax_model("vq")
    monkeypatch.setattr(pdae, "init_model", lambda model, seed, dev: (
        _port_model("vq", init)))
    frames, val = _frames(11, n=64), _frames(12, n=32)
    jstate, jhist = jdae.train_dae(jax_load_config(d), frames, val,
                                   vq_tricks=True, vq_start_epoch=1,
                                   vq_reestimate_every=1)
    pm, phist = pdae.train_dae(load_config(d), frames, val, vq_tricks=True,
                               vq_start_epoch=1, vq_reestimate_every=1,
                               device="cpu")
    assert calls["port"] == calls["jax"] == \
        ["warmup"] * 4 + ["refit"] + ["vq"] * 4
    for key in ("train_loss", "val_loss"):
        for a, b in zip(phist[key], jhist[key]):
            assert _rel(a, b) <= 1e-4, (key, phist[key], jhist[key])
    _check_state(pm, jstate.batch_stats, jstate.vq_state,
                 mean_atol=2 * 1e-3 * len(calls["jax"]), ema_atol=1e-3)


def test_vq_frame_first_epoch_matches_jax(monkeypatch, no_jax_dropout):
    """A VQFrame's first epoch at DAE.yml's widths (135 -> 40, 80 codes,
    batches of 128; 20 steps, dropout off) on both sides from JAX's init:
    the same loss step by step, and in both the loss jumps after the
    first EMA update (ema_w ~ N(0, 1) over a cluster size of 0 puts the
    codes far off), so the epoch's mean ends above its first step."""
    d = {**FRAME_CFG, **MODELS["vq"], "input_motion_dim": 135,
         "hidden_size": 40, "autoencoder_vq_components": 80,
         "batch_size": 128, "epochs": 1}
    losses = {"jax": [], "port": []}
    j_make = jdae.make_train_step

    def j_recording(config, model, optimizer, skip_vq=False):
        fn = j_make(config, model, optimizer, skip_vq=skip_vq)

        def step(*a):
            new, metrics = fn(*a)
            losses["jax"].append(float(metrics["loss"]))
            return new, metrics
        return step
    monkeypatch.setattr(jdae, "make_train_step", j_recording)
    p_loss = pdae.TrainStep.loss

    def p_recording(self, batch):
        loss = p_loss(self, batch)
        losses["port"].append(float(loss.detach()))
        return loss
    monkeypatch.setattr(pdae.TrainStep, "loss", p_recording)
    monkeypatch.setattr(pdae, "dropout_generator",
                        lambda gen: port_layers.dropout_generator(None))
    jcfg = jax_load_config(d)
    jm = jdae.make_frame_model(jcfg)
    init = jdae.init_state(jcfg, jm, jax.random.PRNGKey(0), _grab())

    def port_init(model, seed, dev):
        load_jax_variables(model, _np(init.params), _np(init.batch_stats))
        load_ema_state(model, _np(init.vq_state._asdict()))
        return model
    monkeypatch.setattr(pdae, "init_model", port_init)
    rng = np.random.default_rng(16)
    frames = rng.normal(size=(20 * 128, 135)).astype(np.float32)
    val = rng.normal(size=(128, 135)).astype(np.float32)
    jdae.train_dae(jcfg, frames, val)
    pdae.train_dae(load_config(d), frames, val, device="cpu")
    assert len(losses["port"]) == len(losses["jax"]) == 20
    for a, b in zip(losses["port"], losses["jax"]):
        assert _rel(a, b) <= 1e-4, (losses["port"], losses["jax"])
    for run in losses.values():
        assert max(run[1:]) > 10 * run[0] and np.mean(run) > run[0], run


# -- checkpoints and the command ------------------------------------------
def test_jax_vq_frame_checkpoint_resumes_in_port(tmp_path, no_jax_dropout):
    """A JAX-written VQFrame checkpoint (after one real step: optax's
    state, batch_stats, extra["vq_state"]) resumes in the port, whose
    next step matches JAX's resumed step; the port's file loads in JAX."""
    d = {**FRAME_CFG, **MODELS["vqvae"]}
    jcfg = jax_load_config(d)
    jm = jdae.make_frame_model(jcfg)
    opt = make_optimizer(1e-3)
    state = jdae.init_state(jcfg, jm, jax.random.PRNGKey(0), opt)
    jstep = jdae.make_train_step(jcfg, jm, opt)
    monkey_eps = pytest.MonkeyPatch()
    monkey_eps.setattr(jax.random, "normal", lambda key, shape, dtype=(
        jnp.float32): jnp.zeros(shape, dtype))
    try:
        state, _ = jstep(state, jnp.asarray(_frames(13)),
                         jax.random.PRNGKey(1))
        path = str(tmp_path / "jax.bin")
        jckpt.save_checkpoint(
            path, config=jcfg, epoch=1, params=_np(state.params),
            extra={"batch_stats": _np(state.batch_stats),
                   "vq_state": _np(state.vq_state._asdict()),
                   **jckpt.resume_extra(state, jax.random.PRNGKey(4),
                                        jcfg)}, kind="DAE")
        restored, _, _, payload = jckpt.restore_for_resume(
            state, jax.random.PRNGKey(4), path)
        restored = restored._replace(vq_state=jvq.VQEmaState(
            **payload["extra"]["vq_state"]))
        restored, metrics = jstep(restored, jnp.asarray(_frames(14)),
                                  jax.random.PRNGKey(2))
    finally:
        monkey_eps.undo()
    pm = pdae.make_frame_model(load_config(d))
    padam = Adam(pm.parameters(), 1e-3)
    start, payload = pckpt.restore_for_resume(pm, padam, torch.Generator(),
                                              path)
    load_ema_state(pm, payload["extra"]["vq_state"])
    assert start == 1 and padam.count == 1
    loss = pdae.TrainStep(pm.train(), padam)(torch.from_numpy(_frames(14)))
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    _check_state(pm, restored.batch_stats, restored.vq_state)
    # the port's file, in JAX
    out = str(tmp_path / "port.bin")
    pckpt.save_checkpoint(out, config=load_config(d), epoch=2,
                          params=jax_tree(param_entries(pm)),
                          pose_dim=MOTION, kind="DAE",
                          extra={"batch_stats": {"bn": {
                              "mean": pm.bn.running_mean.numpy(),
                              "var": pm.bn.running_var.numpy()}},
                              "vq_state": ema_state_to_jax(pm)})
    jm2, jv, jpayload = jckpt.load_checkpoint_and_model(out, "DAE")
    assert isinstance(jm2, type(jm))
    x = _frames(15)
    (want, _), = [jm2.apply(jv, jnp.asarray(x), jvq.VQEmaState(
        **jpayload["extra"]["vq_state"]))]
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    _close(got["output"].numpy(), want["output"])


@pytest.fixture(scope="module")
def command_a(tmp_path_factory):
    """The port's g2v-train --part a with autoencoder_vq on a tiny store."""
    from gesture2vec_tpu_torch.cli import train as ptrain
    from tests.test_torch_port_train import _tiny_store
    root = tmp_path_factory.mktemp("frame")
    _tiny_store(str(root / "train"), 1, 400, 0)
    _tiny_store(str(root / "val"), 1, 200, 1)
    _write_yaml(root / "a.yml", {
        "name": "vqf", "hidden_size": LATENT, "input_motion_dim": 135,
        "autoencoder_vq": True, "autoencoder_vq_components": CODES,
        "train_data_path": str(root / "train"),
        "val_data_path": str(root / "val"), "epochs": 2, "batch_size": 32,
        "learning_rate": 0.01, "random_seed": 0})
    save = str(root / "out")
    model, hist = ptrain.main(["-c", str(root / "a.yml"), "--part", "a",
                               "--device", "cpu", "--save-dir", save])
    return {"root": root, "model": model, "hist": hist,
            "file": str(root / "out" / f"vqf_H{LATENT}_checkpoint_002.bin")}


def test_command_trains_a_vq_frame(command_a):
    """Finite, falling losses; the file holds batch_stats and vq_state and
    loads in JAX, whose eval forward gives the port's."""
    hist = command_a["hist"]
    assert np.all(np.isfinite(hist["train_loss"] + hist["val_loss"]))
    assert hist["train_loss"][-1] < hist["first_step_loss"][0]
    jm, jv, payload = jckpt.load_checkpoint_and_model(command_a["file"],
                                                      "DAE")
    assert set(payload["extra"]["vq_state"]) == {"codebook", "cluster_size",
                                                 "ema_w"}
    x = np.random.default_rng(16).normal(size=(5, 135)).astype(np.float32)
    (want, _) = jm.apply(jv, jnp.asarray(x), jvq.VQEmaState(
        **payload["extra"]["vq_state"]))
    with torch.no_grad():
        got = command_a["model"].eval()(torch.from_numpy(x))
    _close(got["output"].numpy(), want["output"])


def test_generator_on_a_vq_frame_dae_matches_jax(tmp_path):
    """A generator whose DAE is a VQFrame (a JAX-written checkpoint with
    its EMA state) decodes, through both packages' build_generator, the
    same frames."""
    import dataclasses

    from bench import build_generator as bench_generator
    from gesture2vec_tpu.cli._common import build_generator as jax_build
    from gesture2vec_tpu.data.store import ClipStore as JaxStore
    from gesture2vec_tpu.data.store import ClipStoreWriter
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.data.store import ClipStore
    from tests.test_torch_port_exemplar import _words, perturb

    hid, nf, sent, fps, words, emb = 16, 4, 24, 20, 40, 12
    g = bench_generator(hid=hid, rep=LATENT, k=CODES, dim=MOTION,
                        n_frames=nf, sent_len=sent, n_words=60,
                        max_words=10, wordembed=emb, vocab_words=words,
                        fps=fps, mode="decode")
    rng = np.random.default_rng(17)
    g = dataclasses.replace(g, t2t_variables=perturb(_np(g.t2t_variables),
                                                     rng),
                            seq_variables=perturb(_np(g.seq_variables), rng))
    cfg, jm, state = _jax_model("vq", seed=3)
    w = ClipStoreWriter(str(tmp_path / "store"))
    w.add_clip("v", rng.normal(size=(30, MOTION)),
               words=[[f"word{j}", 0.1 * j, 0.15 * j] for j in range(words)])
    w.set_stats(rng.normal(size=MOTION).astype(np.float32),
                np.abs(rng.normal(size=MOTION)).astype(np.float32) + 0.5)
    w.finish()
    vocab = JaxVocab("bench")
    for i in range(words):
        vocab.index_word(f"word{i}")
    common = dict(model="seq2seq", hidden_size=hid, n_layers=2, n_poses=nf,
                  autoencoder_vq=True, autoencoder_vq_components=CODES)
    files = {k: str(tmp_path / f"{k}.bin") for k in ("t2t", "dae", "vq")}
    jckpt.save_checkpoint(
        files["t2t"], config=jax_load_config(dict(
            name="t", sentence_frame_length=sent, n_pre_poses=2,
            autoencoder_att=True, wordembed_dim=emb,
            motion_resampling_framerate=fps, **common)), epoch=1,
        params=g.t2t_variables["params"], lang_model=vocab.state_dict(),
        extra={"batch_stats": g.t2t_variables["batch_stats"],
               "n_words": 60}, kind="text2embedding")
    jckpt.save_checkpoint(
        files["dae"], config=cfg, epoch=1, params=_np(state.params),
        pose_dim=MOTION, kind="DAE",
        extra={"batch_stats": _np(state.batch_stats),
               "vq_state": _np(state.vq_state._asdict())})
    jckpt.save_checkpoint(
        files["vq"], config=jax_load_config(dict(
            name="s", rep_learning_dim=LATENT, n_pre_poses=1, **common)),
        epoch=1, params=g.seq_variables["params"], pose_dim=LATENT,
        extra={"batch_stats": g.seq_variables["batch_stats"],
               "parity": False}, kind="autoencoder_vq")
    jg, _ = jax_build(files["t2t"], files["dae"], files["vq"],
                      JaxStore(str(tmp_path / "store")), mode="decode")
    pg, _ = build_generator(files["t2t"], files["dae"], files["vq"],
                            ClipStore(str(tmp_path / "store")),
                            mode="decode", device="cpu")
    assert type(pg.dae_model).__name__ == "VQFrame"
    want, got = jg.generate(_words(5.0), 5.0), pg.generate(_words(5.0), 5.0)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[0], want[0])

