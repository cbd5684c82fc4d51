"""PyTorch port vs the JAX package: training the baseline, c2g and the
unrolled GAN (`g2v-train --part baseline|c2g|gan`), and every trainer
over a mesh.

Small widths (hidden 16, 2 layers, 8 word slots, 10 frames, pose 12,
batches of 6), inputs from numpy seeds, weights from the JAX trainers'
own init, dropout 0 on both sides (the configs' dropout_prob), JAX on
the CPU.

- One step each: the baseline's and c2g's loss and gradients against the
  JAX trainers' one-step runs (`train_baseline` / `train_c2g` with an
  optimizer that keeps the gradients), the parameters after Adam against
  JAX's optimizer on those gradients, the BatchNorm statistics; the GAN
  step against `make_gan_step` (2 unrolled D updates) fed JAX's noise,
  with D restored and with `keep_unrolled`: the three losses, both
  models' parameters, the generator's BatchNorm statistics (one update a
  step: the fake batch's forward leaves them), D's optimizer count.
- Whole runs: 2 epochs of `train_baseline` / `train_c2g` from JAX's init:
  the histories within 1e-4.
- The command on a tiny store (`--device cpu`): the three parts train,
  and the JAX package loads each checkpoint to the port's outputs.
- Every trainer over dp=2 (gloo ranks on the CPU) against its single
  run.
"""
import json

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import (jax_tree,
                                                   load_jax_variables,
                                                   param_entries,
                                                   to_jax_variables)
from gesture2vec_tpu_torch.train import gan_trainer as pgan
from gesture2vec_tpu_torch.train import misc_trainers as pmisc
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.optim import Adam
from tests.test_torch_port_misc_models import CFG, D, MAXW, NCL, NWORDS, T

LOSS_RTOL, GRAD_TOL, HIST_RTOL = 1e-5, 1e-4, 1e-4
# c2g's first decoder step reads the zero frame in every row, so its
# BatchNorm normalises a constant column (variance 0, eps alone), whose
# fast-variance backward amplifies rounding in both packages: against
# the port's float64 step, JAX's fp32 gradients lie up to 5.0e-5 of
# their tensor's largest magnitude away and the port's fp32 up to 1.6e-4
# (measured at these inputs). The fp32 step is held to JAX within
# C2G_GRAD_TOL, and JAX's gradients to the float64 step within GRAD_TOL.
C2G_GRAD_TOL = 2 * GRAD_TOL
BS = 6
STEP_CFG = {**CFG, "dropout_prob": 0.0, "batch_size": BS}
# the gradient of a bias in front of the decoder's batch-statistics
# BatchNorm is rounding (zero in exact arithmetic): held against the
# model's largest gradient, and Adam may move it by up to 2 lr
CANCELLED = (("decoder_step", "pre_linear", "bias"),
             ("step", "pre_linear", "bias"))


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _close_trees(got, want, tol, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    top = max(float(np.abs(v).max()) for v in w.values())
    for path, wv in w.items():
        scale = top if path in CANCELLED else float(np.abs(wv).max())
        err = float(np.abs(g[path] - wv).max()) / max(scale, 1e-30)
        assert err <= tol, f"{what} {'/'.join(path)}: {err}"


def _close_after_adam(got, want, grads, lr, what):
    """Parameters after one Adam step from the same start: the step of an
    element is lr * g / (|g| + 1e-8), so gradients within GRAD_TOL of the
    tensor's largest magnitude d of each other may move it up to 2 lr d /
    (|g| + 1e-8) apart; beyond that, 1e-5 of the tensor (or of lr)."""
    g, w, gr = _flat(got), _flat(want), _flat(grads)
    top = max(float(np.abs(v).max()) for v in gr.values())
    for path, wv in w.items():
        scale = top if path in CANCELLED else float(np.abs(gr[path]).max())
        allowed = np.minimum(
            2 * lr, 1e-5 * max(float(np.abs(wv).max()), lr)
            + 2 * lr * GRAD_TOL * scale / (np.abs(gr[path]) + 1e-8))
        err = np.abs(g[path] - wv)
        assert (err <= allowed).all(), \
            f"{what} {'/'.join(path)}: {err.max()}"


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _text_pose(seed, n):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, MAXW + 1, n).astype(np.int32)
    ids = rng.integers(4, NWORDS, (n, MAXW)).astype(np.int32)
    ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
    ts = np.linspace(0, 1, T)[None, :, None]
    base = rng.normal(size=(n, 1, D))
    poses = (base + 0.5 * np.sin(2 * np.pi * ts + base)).astype(np.float32)
    return {"word_ids": ids, "lengths": lengths, "poses": poses}


def _clusters(seed, n):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, NCL, n).astype(np.int32)
    ts = np.linspace(0, 1, T)[None, :, None]
    lat = (ids[:, None, None] / 6.0 - 1.0 + 0.1 * np.sin(2 * np.pi * ts)
           + 0.1 * rng.normal(size=(n, T, D))).astype(np.float32)
    return ids, lat


def _jax_init(part, cfg, data):
    """The variables the JAX trainer initialises its model with."""
    import jax
    import jax.numpy as jnp

    from gesture2vec_tpu.train import misc_trainers as jmisc

    rng = jax.random.PRNGKey(max(cfg.random_seed, 0))
    rngs = {"params": rng, "dropout": jax.random.fold_in(rng, 1)}
    if part == "baseline":
        model = jmisc.make_baseline(cfg, NWORDS, D)
        v = model.init(rngs, *(jnp.asarray(data[k][:2]) for k in (
            "word_ids", "lengths", "poses")), train=False)
    else:
        model = jmisc.make_c2g(cfg, D)
        v = model.init(rngs, jnp.asarray(data[0][:2]), train=False)
    return _np(v)


def _data(part, seed, n):
    return _text_pose(seed, n) if part == "baseline" else _clusters(seed, n)


def _jax_train(part, cfg, data, val):
    from gesture2vec_tpu.train import misc_trainers as jmisc

    if part == "baseline":
        return jmisc.train_baseline(cfg, data, val, NWORDS)
    return jmisc.train_c2g(cfg, *data, *val)


def _port_step(part, cfg, variables):
    model = (pmisc.make_baseline(cfg, NWORDS, D) if part == "baseline"
             else pmisc.make_c2g(cfg, D))
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    opt = Adam(model.parameters(), cfg.learning_rate)
    cls = pmisc.BaselineStep if part == "baseline" else pmisc.C2GStep
    return model.train(), cls(cfg, model, opt)


def _torch(part, data):
    if part == "baseline":
        return (torch.from_numpy(data["word_ids"]).long(),
                torch.from_numpy(data["lengths"]).long(),
                torch.from_numpy(data["poses"]))
    return torch.from_numpy(data[0]).long(), torch.from_numpy(data[1])


def _grab():
    """An optax transformation that leaves the params and keeps the
    gradients in its state."""
    import jax
    import jax.numpy as jnp
    import optax

    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        lambda p: {"g": zeros(p)}, lambda u, s, p=None: (zeros(u), {"g": u}))


@pytest.mark.parametrize("part", ["baseline", "c2g"])
def test_train_step_matches_jax(part, monkeypatch):
    """One step from the JAX trainer's init: the loss (the JAX trainer's
    one-step epoch) within 1e-5, every gradient within 1e-4 of its
    tensor's largest magnitude (c2g: see C2G_GRAD_TOL), the parameters
    after Adam (JAX's optimizer on JAX's gradients) and the BatchNorm
    statistics within 1e-5."""
    import optax

    from gesture2vec_tpu.train import misc_trainers as jmisc
    from gesture2vec_tpu.train.config import load_config as jload
    from gesture2vec_tpu.train.optim import make_optimizer

    jcfg, cfg = jload({**STEP_CFG, "epochs": 1}), load_config(STEP_CFG)
    data = _data(part, 5, BS)
    init = _jax_init(part, jcfg, data)
    monkeypatch.setattr(jmisc, "make_optimizer", lambda lr: _grab())
    # a validation set short of a batch: no validation step to compile
    short = ({k: v[:1] for k, v in data.items()} if part == "baseline"
             else tuple(a[:1] for a in data))
    state, hist = _jax_train(part, jcfg, data, short)
    grads = _np(state.opt_state["g"])

    model, step = _port_step(part, cfg, init)
    loss = step.loss(*_torch(part, data))
    loss.backward()
    assert _rel(loss, hist["train_loss"][0]) <= LOSS_RTOL
    entries = param_entries(model)
    got = jax_tree(entries, {id(p): p.grad for _, p, _, _ in entries})
    if part == "c2g":
        _close_trees(got, grads, C2G_GRAD_TOL, "grad")
        m64, step64 = _port_step(part, cfg, init)
        step64.model = m64.double()
        batch = _torch(part, data)
        step64.loss(batch[0], batch[1].double()).backward()
        e64 = param_entries(m64)
        _close_trees(grads, jax_tree(e64, {id(p): p.grad for _, p, _, _
                                           in e64}), GRAD_TOL,
                     "JAX's grad against the float64 step")
    else:
        _close_trees(got, grads, GRAD_TOL, "grad")
    bn = to_jax_variables(model)["batch_stats"]
    for path, v in _flat(_np(state.batch_stats)).items():
        np.testing.assert_allclose(_flat(bn)[path], v, rtol=0, atol=1e-5)
    step.opt.step()
    opt = make_optimizer(cfg.learning_rate)
    updates, _ = opt.update(grads, opt.init(init["params"]), init["params"])
    want = _np(optax.apply_updates(init["params"], updates))
    _close_after_adam(jax_tree(entries), want, grads, cfg.learning_rate,
                      "params after Adam")


@pytest.mark.parametrize("part", ["baseline", "c2g"])
def test_whole_run_history_matches_jax(part, monkeypatch):
    """2 epochs of 3 steps from the JAX trainer's init (the port's
    initialiser replaced by it), the same batches (default_rng(seed +
    epoch)): train_loss and val_loss within 1e-4 of JAX's history. The
    decoder's pre_linear bias is held fixed on both sides: its gradient
    is rounding (the batch-statistics BatchNorm cancels it), which Adam
    turns into steps of +-lr of either sign, and eval mode's running
    statistics do not cancel it."""
    import optax

    from gesture2vec_tpu.train import misc_trainers as jmisc
    from gesture2vec_tpu.train.config import load_config as jload

    cfg = {**STEP_CFG, "epochs": 2}
    data, val = _data(part, 6, 3 * BS + 2), _data(part, 7, 2 * BS)
    init = _jax_init(part, jload(cfg), data)
    dec = "decoder_step" if part == "baseline" else "step"

    def from_jax(model, seed, device, embedding_weights=None):
        load_jax_variables(model, init["params"], init["batch_stats"])
        getattr(model, dec).pre_linear.bias.register_hook(torch.zeros_like)
        return model

    monkeypatch.setattr(pmisc, "init_misc", from_jax)
    import jax
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: path[-2:] == (jax.tree_util.DictKey("pre_linear"),
                                      jax.tree_util.DictKey("bias")),
        init["params"])
    real = jmisc.make_optimizer
    monkeypatch.setattr(jmisc, "make_optimizer", lambda lr: optax.chain(
        optax.masked(optax.set_to_zero(), mask), real(lr)))
    _, want = _jax_train(part, jload(cfg), data, val)
    if part == "baseline":
        _, got = pmisc.train_baseline(load_config(cfg), data, val, NWORDS,
                                      device="cpu")
    else:
        _, got = pmisc.train_c2g(load_config(cfg), *data, *val,
                                 device="cpu")
    for key in ("train_loss", "val_loss"):
        assert len(got[key]) == 2
        for a, b in zip(got[key], want[key]):
            assert _rel(a, b) <= HIST_RTOL, (key, got[key], want[key])
    assert got["first_step_loss"][0] > got["train_loss"][-1]


@pytest.mark.parametrize("keep", [False, True], ids=["restore", "keep"])
def test_gan_step_matches_jax(keep):
    """One unrolled-GAN step (2 unrolled D updates) against JAX's
    make_gan_step on the same init, batch and noise (JAX's draw from the
    step's key): d_real, d_fake and g_loss within 1e-5; the generator's
    parameters after its Adam step (within 1e-5, or the allowance of an
    element whose gradient is near 0: `_close_after_adam`, over the
    port's gradients), D's parameters (after its first update with D
    restored, after all three with keep_unrolled) and the generator's
    BatchNorm statistics (one update: JAX keeps only the G-loss
    forward's) within 1e-5; D's Adam count 1 or 3."""
    import jax
    import jax.numpy as jnp

    from gesture2vec_tpu.train import gan_trainer as jgan
    from gesture2vec_tpu.train.config import load_config as jload
    from gesture2vec_tpu.train.optim import make_optimizer

    jcfg, cfg = jload(STEP_CFG), load_config(STEP_CFG)
    data = _text_pose(8, BS)
    g, d = jgan.build_gan(jcfg, NWORDS, D)
    opts = [make_optimizer(cfg.learning_rate, clip_norm=None)
            for _ in range(2)]
    state = _np(jgan.init_gan(g, d, jax.random.PRNGKey(0), *opts,
                              max_words=MAXW))
    init = _np(state)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(jax.random.split(key, 4)[0],
                                         (BS, cfg.noise_dim)))
    step = jgan.make_gan_step(g, d, *opts, unroll_steps=2,
                              keep_unrolled=keep)
    new, metrics = step(jax.tree_util.tree_map(jnp.asarray, state),
                        *(jnp.asarray(data[k]) for k in (
                            "word_ids", "lengths", "poses")), key)
    new = _np(new)

    pg, pd = pgan.build_gan(cfg, NWORDS, D)
    load_jax_variables(pg, init.g_params, init.g_batch_stats)
    load_jax_variables(pd, init.d_params)
    gopt = Adam(pg.parameters(), cfg.learning_rate, clip_norm=None)
    dopt = Adam(pd.parameters(), cfg.learning_rate, clip_norm=None)
    pstep = pgan.GANStep(pg, pd, gopt, dopt, unroll_steps=2,
                         keep_unrolled=keep)
    got = pstep(*_torch("baseline", data), torch.from_numpy(noise))
    for k in ("d_real", "d_fake", "g_loss"):
        assert _rel(got[k], metrics[k]) <= LOSS_RTOL, k
    assert dopt.count == (3 if keep else 1) and gopt.count == 1
    lr = cfg.learning_rate
    entries = param_entries(pg)
    _close_after_adam(jax_tree(entries), new.g_params,
                      jax_tree(entries, {id(p): p.grad for _, p, _, _ in
                                         entries}), lr, "generator")
    got_d = _flat(to_jax_variables(pd)["params"])
    for path, wv in _flat(new.d_params).items():
        np.testing.assert_allclose(got_d[path], wv, rtol=0, atol=1e-5,
                                   err_msg="/".join(path))
    stats = _flat(new.g_batch_stats)
    for path, v in _flat(to_jax_variables(pg)["batch_stats"]).items():
        np.testing.assert_allclose(v, stats[path], rtol=0, atol=1e-5)
    assert not np.allclose(stats[("decoder_step", "pre_bn", "mean")],
                           init.g_batch_stats["decoder_step"]["pre_bn"]
                           ["mean"])


def test_gan_restores_d_by_copy():
    """With D restored, the step leaves D's parameters and Adam state as
    its first update left them, however the unroll moved them: a second
    call of the update alone from the saved state reproduces them."""
    cfg = load_config(STEP_CFG)
    data = _torch("baseline", _text_pose(9, BS))
    g, d = pgan.init_gan(*pgan.build_gan(cfg, NWORDS, D), 0,
                         torch.device("cpu"))
    gopt = Adam(g.parameters(), 1e-3, clip_norm=None)
    dopt = Adam(d.parameters(), 1e-3, clip_norm=None)
    step = pgan.GANStep(g, d, gopt, dopt, unroll_steps=3)
    before = [p.detach().clone() for p in d.parameters()]
    noise = torch.randn(BS, cfg.noise_dim,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), pgan.running_stats_kept(g):
        fake = g(*data[:2], noise, data[2][:, 0])
    # the first update alone, on a copy of D
    d1 = pgan.build_gan(cfg, NWORDS, D)[1]
    d1.load_state_dict(d.state_dict())
    opt1 = Adam(d1.parameters(), 1e-3, clip_norm=None)
    pgan.GANStep(g, d1, gopt, opt1).d_update(*data, fake)
    step(*data, noise)
    moved = any(not torch.equal(a, b) for a, b in zip(before,
                                                      d.parameters()))
    assert moved and dopt.count == 1
    for a, b in zip(d.parameters(), d1.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for a, b in zip(dopt.mu + dopt.nu, opt1.mu + opt1.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# -- the command --------------------------------------------------------------
def _write_teachers(root):
    """A DAE (latent 8) and a GS-Soft tokenizer (hidden 16, 12 codes) in
    the JAX package's file format, from the port's initialisers."""
    from gesture2vec_tpu_torch.train import checkpoints as pckpt
    from gesture2vec_tpu_torch.train import dae_trainer as pdae
    from gesture2vec_tpu_torch.train import seq_ae_trainer as pseq

    dae_cfg = load_config({"name": "dae", "hidden_size": 8,
                           "input_motion_dim": 135})
    seq_cfg = load_config({
        "name": "vq", "hidden_size": 16, "n_layers": 2,
        "rep_learning_dim": 8, "n_poses": 10, "n_pre_poses": 1,
        "autoencoder_vq": True, "autoencoder_vq_components": NCL})
    out = {}
    for name, cfg, model, kind, dim in (
            ("dae", dae_cfg, pdae.make_frame_model(dae_cfg), "DAE", 135),
            ("vq", seq_cfg, pseq.make_seq_ae(seq_cfg), "autoencoder_vq", 8)):
        pdae.init_model(model, 0, torch.device("cpu"))
        v = to_jax_variables(model)
        out[name] = str(root / f"{name}.bin")
        pckpt.save_checkpoint(out[name], config=cfg, epoch=1,
                              params=v["params"], pose_dim=dim,
                              extra={"batch_stats": v["batch_stats"],
                                     "parity": False}, kind=kind)
    return out


def _cli_config(root, part):
    from tests.test_torch_port_train import _write_yaml

    cfg = {"name": part, "hidden_size": 16, "n_layers": 2,
           "wordembed_dim": 12, "noise_dim": 8, "n_poses": 10,
           "n_pre_poses": 1, "subdivision_stride": 10,
           "motion_resampling_framerate": 20, "dropout_prob": 0.1,
           "batch_size": 32 if part == "gan" else 8,
           "epochs": 1 if part == "gan" else 2, "learning_rate": 0.002,
           "autoencoder_vq_components": NCL, "random_seed": 0,
           "train_data_path": str(root / "train"),
           "val_data_path": str(root / "val")}
    path = root / f"{part}.yml"
    _write_yaml(path, cfg)
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`g2v-train --part baseline|c2g|gan --device cpu` on a tiny store
    (c2g over a written DAE and tokenizer)."""
    from gesture2vec_tpu_torch.cli import train as ptrain
    from tests.test_torch_port_train import _tiny_store

    root = tmp_path_factory.mktemp("misc_train")
    _tiny_store(str(root / "train"), 2, 500, 0)
    _tiny_store(str(root / "val"), 1, 400, 1)
    teachers = _write_teachers(root)
    out = {"root": root, "teachers": teachers}
    for part in ("baseline", "c2g", "gan"):
        extra = (["--rep-checkpoint", teachers["dae"],
                  "--autoencoder-checkpoint", teachers["vq"]]
                 if part == "c2g" else [])
        save = root / "out" / part
        out[part] = ptrain.main(["-c", _cli_config(root, part), "--part",
                                 part, "--device", "cpu", "--save-dir",
                                 str(save), "--resume", "ignored.bin"]
                                + extra)
        out[part + "_file"] = str(sorted(save.glob("*.bin"))[-1])
    return out


def test_command_trains_each_part(trained):
    """Each part trains: finite losses (the baseline's and c2g's last
    epoch below their first step's), the history JSON and the
    checkpoint of the part's kind."""
    from gesture2vec_tpu_torch.train import checkpoints as pckpt

    for part, kind in (("baseline", "baseline"), ("c2g", "c2g"),
                       ("gan", "text2embedding_gan")):
        _, hist = trained[part]
        losses = [v for vals in hist.values() for v in vals]
        assert np.all(np.isfinite(losses)), part
        if part != "gan":
            assert hist["train_loss"][-1] < hist["first_step_loss"][0]
        with open(trained["root"] / "out" / part /
                  "loss_history.json") as f:
            assert sorted(json.load(f)) == sorted(hist)
        payload = pckpt.load_checkpoint(trained[part + "_file"])
        assert payload["kind"] == kind
    models, _ = trained["gan"]
    assert isinstance(models[1], torch.nn.Module)


@pytest.mark.parametrize("part", ["baseline", "c2g", "gan"])
def test_port_checkpoint_loads_in_jax(trained, part):
    """The JAX package's load_checkpoint_and_model reads the command's
    file (its extra holds batch_stats, n_words, the GAN's d_params) and
    its eval forward equals the port's loaded model's within 1e-5."""
    import jax.numpy as jnp

    from gesture2vec_tpu.train import checkpoints as jckpt

    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model

    kind = {"baseline": "baseline", "c2g": "c2g",
            "gan": "text2embedding_gan"}[part]
    path = trained[part + "_file"]
    jm, jv, payload = jckpt.load_checkpoint_and_model(path, kind)
    pm, _ = load_checkpoint_and_model(path, kind, "cpu")
    if part == "gan":
        assert "d_params" in payload["extra"]
    rng = np.random.default_rng(3)
    pose_dim = 135 if part != "c2g" else 8
    ids = rng.integers(4, 20, (3, 7)).astype(np.int32)
    lengths = np.array([7, 4, 2], np.int32)
    poses = rng.normal(size=(3, 10, pose_dim)).astype(np.float32)
    with torch.no_grad():
        if part == "baseline":
            want = jm.apply(jv, *map(jnp.asarray, (ids, lengths, poses)))[
                "outputs"]
            got = pm(torch.from_numpy(ids).long(),
                     torch.from_numpy(lengths).long(),
                     torch.from_numpy(poses))["outputs"]
        elif part == "c2g":
            c = np.arange(3, dtype=np.int32)
            want = jm.apply(jv, jnp.asarray(c))
            got = pm(torch.from_numpy(c).long())
        else:
            noise = rng.normal(size=(3, 8)).astype(np.float32)
            want = jm.apply(jv, *map(jnp.asarray, (ids, lengths, noise,
                                                   poses[:, 0])))
            got = pm(torch.from_numpy(ids).long(),
                     torch.from_numpy(lengths).long(),
                     torch.from_numpy(noise), torch.from_numpy(poses[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# -- every trainer over a mesh --------------------------------------------
MESH_CFG = {**CFG, "rep_learning_dim": 8, "input_motion_dim": D,
            "sentence_frame_length": 4 * T, "autoencoder_vq": True}
TRAINERS = ["dae", "seq_ae", "text2token", "baseline", "c2g", "gan"]


def _mesh_job(trainer, mesh_shape=None):
    """(fn, args, kwargs) of a 2-epoch run of each trainer at this file's
    widths, dropout 0.1, over mesh_shape."""
    from gesture2vec_tpu_torch.train import dae_trainer as pdae
    from gesture2vec_tpu_torch.train import seq_ae_trainer as pseq
    from gesture2vec_tpu_torch.train import text2token_trainer as pt2t

    cfg = load_config({**MESH_CFG, "mesh_shape": mesh_shape})
    rng = np.random.default_rng(11)
    frames = rng.normal(size=(48, D)).astype(np.float32)
    windows = rng.normal(size=(24, T, 8)).astype(np.float32)
    text = _text_pose(12, 24)
    t2t = {"word_ids": text["word_ids"], "lengths": text["lengths"],
           "tokens": rng.integers(0, NCL, (24, 4)).astype(np.int32)}
    ids, lat = _clusters(13, 24)
    cpu = {"device": "cpu"}
    return {"dae": (pdae.train_dae, (cfg, frames, frames[:12]), cpu),
            "seq_ae": (pseq.train_seq_ae, (cfg, windows, windows[:12]),
                       cpu),
            "text2token": (pt2t.train_text2token,
                           (cfg, t2t, {k: v[:12] for k, v in t2t.items()},
                            NWORDS), cpu),
            "baseline": (pmisc.train_baseline,
                         (cfg, text, {k: v[:12] for k, v in text.items()},
                          NWORDS), cpu),
            "c2g": (pmisc.train_c2g, (cfg, ids, lat, ids[:12], lat[:12]),
                    cpu),
            "gan": (pgan.train_gan, (cfg, text, NWORDS), cpu)}[trainer]


@pytest.fixture(scope="module")
def dp2_runs():
    """Rank 0's (model, history) of every trainer over dp=2, from one
    launch of 2 gloo ranks."""
    from gesture2vec_tpu_torch.parallel import launch

    got = launch.run(launch.call_all, ([_mesh_job(t, {"dp": 2})
                                         for t in TRAINERS],),
                     world_size=2, device="cpu")
    return dict(zip(TRAINERS, got))


@pytest.mark.parametrize("trainer", TRAINERS)
def test_trainers_refuse_mesh_shape(trainer, dp2_runs):
    """mesh_shape {dp: 2}, once refused, now trains: each trainer's dp=2
    run (its ranks started by the trainer's own launch, dropout 0.1
    drawn at the global batch's shape) has the single run's history
    within 1e-4 (baseline's and c2g's val_loss, which reads the pre-BN
    bias whose gradient is rounding, within 1e-3; see
    tests/test_torch_port_mesh.py)."""
    fn, args, kw = _mesh_job(trainer)
    _, want = fn(*args, **kw)
    _, got = dp2_runs[trainer]
    assert sorted(got) == sorted(want)
    for key in want:
        rtol = 1e-3 if key == "val_loss" and trainer in ("baseline",
                                                         "c2g") else 1e-4
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg=key)
