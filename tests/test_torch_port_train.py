"""PyTorch port vs the JAX package: `g2v-train` parts a, b and d.

Small widths (hidden 16, 2 layers, 16 codes, batches of 8-16), inputs
from numpy seeds, JAX on the CPU. Every dropout is off on both sides:
the JAX side's by patching `flax.linen.Dropout` to the identity inside
the test (nothing in the JAX package changes), the port's by training
outside `models/layers.dropout_generator`.

- The building blocks: every `configs/*.yml` through the port's reader
  against JAX's `load_config`; the losses; one Adam update with and
  without clipping (1e-6); BatchNorm's running statistics after 20
  train-mode calls (1e-6).
- One train step per part (a; b with GS-Soft and with residual VQ; d
  with the TCN, with the GRU encoder, with 4 chained stage heads), from
  the same JAX-initialised weights and batch: the loss within 1e-5
  relative, every gradient within 1e-4 of the JAX gradient's largest
  magnitude, the BatchNorm statistics within 1e-5; then three steps of
  each with the real optimizers, losses within 1e-4 relative and the
  parameters after the first within 1e-5. The parts include the
  transformer Part d (one stage; the recommended recipe's 4 chained
  stages with label smoothing; 4 independent heads) and the `seq_arch:
  transformer` tokenizer (GS-Soft, residual VQ).
- Validation: the eval-mode teacher-forced decode through the
  chunk-decoder path against the JAX decode, and against the rollout from
  the seed; a decoder the kernel cannot run names why.
- Checkpoints: the port's command trains a -> b -> d on a tiny store; the
  JAX package's `load_checkpoint_and_model` loads each file and gives the
  port's forward within 1e-5; `build_generator` turns them into a working
  generator. A JAX-written checkpoint resumes in the port and its next
  step matches JAX's resumed step. `reestimate_rvq_codebooks` equals
  JAX's from the same initial centers.
"""
import glob
import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gesture2vec_tpu.train import checkpoints as jckpt
from gesture2vec_tpu.train import dae_trainer as jdae
from gesture2vec_tpu.train import losses as jlosses
from gesture2vec_tpu.train import seq_ae_trainer as jseq
from gesture2vec_tpu.train import text2token_trainer as jt2t
from gesture2vec_tpu.train.config import load_config as jax_load_config
from gesture2vec_tpu.train.optim import make_optimizer
from gesture2vec_tpu_torch.compat.from_jax import (jax_tree,
                                                   load_jax_variables,
                                                   param_entries)
from gesture2vec_tpu_torch.models.layers import BatchNorm
from gesture2vec_tpu_torch.train import checkpoints as pckpt
from gesture2vec_tpu_torch.train import dae_trainer as pdae
from gesture2vec_tpu_torch.train import losses as plosses
from gesture2vec_tpu_torch.train import seq_ae_trainer as pseq
from gesture2vec_tpu_torch.train import text2token_trainer as pt2t
from gesture2vec_tpu_torch.train.config import load_config, parse_yaml
from gesture2vec_tpu_torch.train.optim import Adam

LOSS_RTOL, GRAD_TOL, STEPS_RTOL = 1e-5, 1e-4, 1e-4
HID, REP, K, NF, SENT, WEMB, NWORDS, MAXW = 16, 8, 16, 5, 20, 12, 30, 9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DAE_CFG = {"name": "dae", "hidden_size": REP, "input_motion_dim": 27,
           "batch_size": 16, "learning_rate": 1e-3, "random_seed": 0}
VQ_CFG = {"name": "vq", "hidden_size": HID, "n_layers": 2,
          "rep_learning_dim": REP, "n_poses": NF + 1, "n_pre_poses": 1,
          "autoencoder_vq": True, "autoencoder_vq_components": K,
          "autoencoder_conditioned": True, "autoencoder_att": False,
          "batch_size": 8, "learning_rate": 1e-3, "loss_l1_weight": 5,
          "loss_cont_weight": 0.1, "loss_var_weight": 0.5,
          "random_seed": 0}
T2T_CFG = {"name": "t2t", "hidden_size": HID, "n_layers": 2,
           "autoencoder_vq_components": K, "n_poses": NF,
           "sentence_frame_length": SENT, "n_pre_poses": 2,
           "wordembed_dim": WEMB, "autoencoder_att": True, "batch_size": 8,
           "learning_rate": 1e-3, "random_seed": 0}
PARTS = {
    "a": DAE_CFG,
    "b_gssoft": VQ_CFG,
    "b_rvq": {**VQ_CFG, "autoencoder_vq_variant": "rvq", "rvq_stages": 3},
    "d_tcn": {**T2T_CFG, "text_encoder": "tcn", "label_smoothing": 0.1},
    "d_gru": {**T2T_CFG, "text_encoder": "gru"},
    "d_stage4_cond": {**T2T_CFG, "text_encoder": "tcn", "token_stages": 4,
                      "stage_conditional": True},
    # the transformer Part d (t2t_arch: transformer, 2 heads): one stage;
    # the recommended recipe's settings (4 chained stages, label smoothing
    # 0.1, teacher prefix 1); 4 independent stage heads
    "d_tf": {**T2T_CFG, "t2t_arch": "transformer", "t2t_heads": 2},
    "d_tf_recipe": {**T2T_CFG, "t2t_arch": "transformer", "t2t_heads": 2,
                    "token_stages": 4, "stage_conditional": True,
                    "label_smoothing": 0.1, "n_pre_poses": 1},
    "d_tf_stage4": {**T2T_CFG, "t2t_arch": "transformer", "t2t_heads": 2,
                    "token_stages": 4},
    # the transformer chunk encoder (seq_arch: transformer)
    "b_tf_gssoft": {**VQ_CFG, "seq_arch": "transformer"},
    "b_tf_rvq": {**VQ_CFG, "seq_arch": "transformer",
                 "autoencoder_vq_variant": "rvq", "rvq_stages": 3},
}


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """torch on one thread for this file's tests and fixtures: at these
    widths threads only cost, and the suite's workers share the cores
    (each worker's default of one thread a core oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)


def _grab():
    """An optax transformation that leaves the params and keeps the
    gradients in its state: JAX's gradients of a train step, exactly."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa
    return optax.GradientTransformation(
        lambda p: {"g": zeros(p)}, lambda u, s, p=None: (zeros(u), {"g": u}))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


# tensors whose gradient reaches the loss only through what the decoder's
# batch-statistics BatchNorm cancels: the bias of pre_linear (removed by
# the batch mean: zero in exact arithmetic), and the TCN's output bias,
# whose attention-context path the same BatchNorm removes (what is left,
# through the attention scores, is ~1e-5 of the tree's largest
# gradient). So is an attention's key bias (q . b_k shifts a query's
# scores by one constant, which the softmax removes). Their fp32
# gradients are mostly rounding, so they are held to the tree's largest
# magnitude, and Adam, which normalises any gradient to a step of ~lr,
# may move them by up to 2 lr.
CANCELLED = (("decoder_step", "pre_linear", "bias"),
             ("encoder", "decoder", "bias"))


def _cancelled(path):
    return path in CANCELLED or path[-2:] == ("k", "bias")


def _close_trees(got, want, tol, what, lr=None):
    """Each tensor within tol of its largest magnitude (CANCELLED ones:
    of the tree's largest, or within 2 lr when lr is given)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    top = max(float(np.abs(v).max()) for v in w.values())
    for path, wv in w.items():
        err = float(np.abs(g[path] - wv).max())
        if _cancelled(path) and lr is not None:
            assert err <= 2 * lr, f"{what} {'/'.join(path)}: {err}"
            continue
        scale = top if _cancelled(path) else float(np.abs(wv).max())
        err /= max(scale, 1e-30)
        assert err <= tol, f"{what} {'/'.join(path)}: {err}"


def _close_after_adam(got, want, grads, lr):
    """Parameters after one Adam step from the same start. The step is lr
    * g / (|g| + 1e-8) an element, so gradients within d = GRAD_TOL of
    the tensor's largest magnitude of each other may move an element by
    up to 2 lr d / (|g| + 1e-8) apart (2 lr where |g| <= d: there
    rounding decides the sign); beyond that, 1e-5 of the tensor's
    largest magnitude (or of lr)."""
    g, w, gr = dict(_leaves(got)), dict(_leaves(want)), dict(_leaves(grads))
    top = max(float(np.abs(v).max()) for v in gr.values())
    for path, wv in w.items():
        scale = top if _cancelled(path) else float(np.abs(gr[path]).max())
        d = GRAD_TOL * scale
        allowed = np.minimum(2 * lr, 1e-5 * max(float(np.abs(wv).max()), lr)
                             + 2 * lr * d / (np.abs(gr[path]) + 1e-8))
        err = np.abs(g[path] - wv)
        assert (err <= allowed).all(), \
            f"params after one Adam step {'/'.join(path)}: {err.max()}"


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _batches(part, cfg, seed, n):
    """n batches of the part's inputs (numpy)."""
    rng = np.random.default_rng(seed)
    bs = cfg["batch_size"]
    out = []
    for _ in range(n):
        if part == "a":
            out.append((rng.normal(size=(bs, 27)).astype(np.float32),))
        elif part.startswith("b"):
            out.append((rng.normal(size=(bs, NF + 1, REP)).astype(
                np.float32),))
        else:
            lengths = rng.integers(3, MAXW + 1, bs).astype(np.int32)
            ids = rng.integers(4, NWORDS, (bs, MAXW)).astype(np.int32)
            ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
            n_steps = SENT // NF
            stages = rng.integers(0, K, (bs, n_steps, cfg.get(
                "token_stages", 1))).astype(np.int32)
            b = (ids, lengths, stages[:, :, 0])
            if cfg.get("token_stages", 1) > 1:
                b = b + (stages,)
            out.append(b)
    return out


def _jax_setup(part, cfg, opt):
    """(JAX model, its initial state, a step fn(state, batch) ->
    (state, loss))."""
    key = jax.random.PRNGKey(0)
    if part == "a":
        model = jdae.make_frame_model(cfg)
        state = jdae.init_state(cfg, model, key, opt)
        step = jdae.make_train_step(cfg, model, opt)
        return model, state, lambda s, b, r: step(s, jnp.asarray(b[0]), r)
    if part.startswith("b"):
        model = jseq.make_seq_ae(cfg)
        state = jseq.init_state(cfg, model, key, opt)
        step = jseq.make_train_step(cfg, model, opt, cfg.epochs)
        return model, state, lambda s, b, r: step(
            s, jnp.asarray(b[0]), r, jnp.asarray(0.0))
    model = jt2t.make_text2token(cfg, NWORDS)
    state = jt2t.init_state(model, key, opt, max_words=MAXW)
    step = jt2t.make_train_step(model, opt, cfg.label_smoothing)
    return model, state, lambda s, b, r: step(s, *map(jnp.asarray, b), r)


def _port_setup(part, cfg, state):
    """The port's model with the JAX state's weights, in train mode, and
    its TrainStep class."""
    if part == "a":
        model, cls = pdae.make_frame_model(cfg), pdae.TrainStep
    elif part.startswith("b"):
        model, cls = pseq.make_seq_ae(cfg), pseq.TrainStep
    else:
        model, cls = pt2t.make_text2token(cfg, NWORDS), pt2t.TrainStep
    load_jax_variables(model, _np(state.params), _np(state.batch_stats))
    return model.train(), cls


def _make_step(part, cls, cfg, model, opt):
    if part == "a":
        return cls(model, opt)
    if part.startswith("b"):
        return cls(cfg, model, opt)
    return cls(model, opt, cfg.label_smoothing)


def _loss_of(out):
    """A step's loss (Part b's comes with the perplexity)."""
    return out[0] if isinstance(out, tuple) else out


def _torch_batch(part, b):
    if part == "a" or part.startswith("b"):
        return (torch.from_numpy(b[0]),)
    return tuple(torch.from_numpy(a).long() for a in b)


@pytest.mark.parametrize("part", sorted(PARTS))
def test_train_step_matches_jax(part, no_jax_dropout):
    """One step's loss, gradients and BatchNorm statistics against JAX's
    make_train_step; then three steps with the real optimizers."""
    cfg = load_config(PARTS[part])
    jcfg = jax_load_config(PARTS[part])
    batches = _batches(part, PARTS[part], 7, 3)
    jmodel, state, jstep = _jax_setup(part, jcfg, _grab())
    model, cls = _port_setup(part, cfg, state)
    new_state, metrics = jstep(state, batches[0], jax.random.PRNGKey(1))

    opt = Adam(model.parameters(), cfg.learning_rate)
    step = _make_step(part, cls, cfg, model, opt)
    loss = _loss_of(step.loss(*_torch_batch(part, batches[0])))
    loss.backward()
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    entries = param_entries(model)
    grads = jax_tree(entries, {id(p): (p.grad if p.grad is not None
                                       else torch.zeros_like(p))
                               for _, p, _, _ in entries})
    _close_trees(grads, _np(new_state.opt_state["g"]), GRAD_TOL, "grad")
    if jax.tree_util.tree_leaves(new_state.batch_stats):
        bn = (model.decoder.decoder_step.pre_bn if part.startswith("b")
              else model.decoder_step.pre_bn)
        stats = _np(new_state.batch_stats)["decoder_step"]["pre_bn"]
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                   atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                   atol=1e-5)

    # three steps with the trainers' optimizers
    jmodel, state, jstep = _jax_setup(part, jcfg,
                                      make_optimizer(cfg.learning_rate))
    model, cls = _port_setup(part, cfg, state)
    step = _make_step(part, cls, cfg, model,
                      Adam(model.parameters(), cfg.learning_rate))
    for i, b in enumerate(batches):
        state, metrics = jstep(state, b, jax.random.PRNGKey(2 + i))
        got = _loss_of(step(*_torch_batch(part, b)))
        assert _rel(got, metrics["loss"]) <= STEPS_RTOL, (i, float(got),
                                                          float(metrics[
                                                              "loss"]))
        if i == 0:
            _close_after_adam(jax_tree(param_entries(model)),
                              _np(state.params),
                              _np(new_state.opt_state["g"]),
                              cfg.learning_rate)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs",
                                                        "*.yml"))))
def test_config_reader_matches_jax(name):
    """The port's YAML subset reader gives yaml.safe_load's values, and
    the Config equals JAX's field by field and in extras."""
    import dataclasses

    import yaml
    path = os.path.join(REPO, "configs", name)
    with open(path) as f:
        assert parse_yaml(f.read()) == yaml.safe_load(open(path))
    got, want = load_config(path), jax_load_config(path)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert type(g) is type(w), f.name
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, f.name


def test_yaml_scalars_follow_yaml_1_1():
    """yes/no/on/off are booleans, 1e-5 without a dot is a string, the
    int forms and quoted strings resolve as PyYAML resolves them."""
    import yaml
    text = ("a: yes\nb: Off\nc: 1e-5\nd: 1.0e-5\ne: 0x1F\nf: 017\n"
            "g: ~\nh: 'x # y'  # comment\ni: [1, 2.5, no]\nj: 1_000\n"
            "k: y\nl: .inf\n")
    assert parse_yaml(text) == yaml.safe_load(text)
    assert parse_yaml(text)["c"] == "1e-5"


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    out = rng.normal(size=(4, 6, 5)).astype(np.float32)
    tgt = rng.normal(size=(4, 6, 5)).astype(np.float32)
    kw = dict(l1_weight=5.0, cont_weight=0.1, var_weight=0.5)
    assert _rel(plosses.custom_loss(torch.from_numpy(out),
                                    torch.from_numpy(tgt), **kw),
                jlosses.custom_loss(out, tgt, **kw)) <= 1e-6
    logits = rng.normal(size=(4, 6, 9)).astype(np.float32)
    ids = rng.integers(0, 9, (4, 6))
    for ls in (0.0, 0.1):
        assert _rel(plosses.token_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(ids),
            label_smoothing=ls),
            jlosses.token_cross_entropy(logits, ids,
                                        label_smoothing=ls)) <= 1e-6
    res = {"stage_logits": rng.normal(size=(4, 5, 3, 9)).astype(np.float32)}
    st = rng.integers(0, 9, (4, 6, 4))
    assert _rel(plosses.stage_ce({"stage_logits": torch.from_numpy(
        res["stage_logits"])}, torch.from_numpy(st)),
        jt2t._stage_ce(res, st)) <= 1e-6


@pytest.mark.parametrize("grad_scale", [0.05, 10.0])
def test_adam_update_matches_optax(grad_scale):
    """Two updates of optax's chain(clip_by_global_norm(5), adam(0.5,
    0.999)) with the same gradients, below and above the clip norm."""
    rng = np.random.default_rng(1)
    shapes = {"w": (7, 5), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    opt = make_optimizer(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    padam = Adam(list(tp.values()), 1e-3)
    for _ in range(2):
        g = {k: (grad_scale * rng.normal(size=s)).astype(np.float32)
             for k, s in shapes.items()}
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        padam.step()
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(padam.mu[0].numpy(),
                               np.asarray(state[1][0].mu["w"]), atol=1e-6)


def test_batchnorm_running_stats_match_flax():
    """20 train-mode calls (as a 20-step decoder makes them): running
    mean and the biased running variance within 1e-6 of flax's."""
    rng = np.random.default_rng(2)
    xs = [(rng.normal(size=(6, 5)) * 2 + 1).astype(np.float32)
          for _ in range(20)]
    bn = fnn.BatchNorm(use_running_average=False)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    pbn = BatchNorm(5).train()
    for x in xs:
        y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        py = pbn(torch.from_numpy(x))
        np.testing.assert_allclose(py.detach().numpy(), np.asarray(y),
                                   atol=1e-5)
    np.testing.assert_allclose(pbn.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(pbn.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]),
                               atol=1e-6)


def test_validation_decode_is_the_kernel_rollout():
    """Eval mode, 1-frame teacher prefix: the port's decode (through
    fused_chunk_decode's path) equals the JAX decode, and decode[:, 1:]
    is the rollout from the seed frame over n_frames - 1 steps."""
    cfg = jax_load_config(VQ_CFG)
    jmodel = jseq.make_seq_ae(cfg)
    state = jseq.init_state(cfg, jmodel, jax.random.PRNGKey(3),
                            make_optimizer(1e-3))
    rng = np.random.default_rng(4)
    stats = {"decoder_step": {"pre_bn": {
        "mean": (0.1 * rng.normal(size=HID)).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, HID).astype(np.float32)}}}
    variables = {"params": state.params, "batch_stats": stats}
    x = rng.normal(size=(8, NF + 1, REP)).astype(np.float32)
    _, hid = jmodel.apply(variables, jnp.asarray(x), method=jmodel.encode)
    want = jmodel.apply(variables, hid, jnp.asarray(x), None,
                        method=jmodel.decode)
    model = pseq.make_seq_ae(load_config(VQ_CFG))
    load_jax_variables(model, _np(state.params), stats)
    model.eval()
    with torch.no_grad():
        h = torch.from_numpy(np.asarray(hid))
        got = model.decoder.decode(h, torch.from_numpy(x))
        roll = model.decoder.rollout(h, torch.from_numpy(x[:, 0]),
                                     n_steps=NF)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got[:, 1:].numpy(), roll.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got[:, 0].numpy(), x[:, 0])


@pytest.mark.parametrize("change, why", [
    ({"n_pre_poses": 2}, "one seed frame"),
    ({"n_layers": 1}, "2 GRU layers"),
    ({"autoencoder_conditioned": False}, "conditioned")])
def test_ineligible_validation_decode_says_why(change, why):
    """A decoder the chunk-decoder kernel cannot run: `kernel_reason`
    names why (the eval decode raises with it on a CUDA tensor, and
    train_seq_ae refuses such a config on the card before its first
    step); on the CPU the eval decode is the plain teacher-forced loop,
    as with the kernel switched off."""
    model = pseq.make_seq_ae(load_config({**VQ_CFG, **change})).eval()
    assert why in model.decoder.kernel_reason()
    assert pseq.make_seq_ae(load_config(VQ_CFG)).decoder.kernel_reason() \
        == ""
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(
        size=(model.decoder.n_layers, 4, HID)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(4, NF + 1, REP)).astype(
        np.float32))
    with torch.no_grad():
        got = model.decoder.decode(h, x)
        model.set_use_kernels(False)
        want = model.decoder.decode(h, x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_reestimate_rvq_codebooks_matches_jax():
    """Both packages' K-Means re-fit of a 3-stage residual quantizer from
    the same weights and the same initial centers per stage."""
    from gesture2vec_tpu.cluster import kmeans as jkm
    cfg = jax_load_config(PARTS["b_rvq"])
    jmodel = jseq.make_seq_ae(cfg)
    state = jseq.init_state(cfg, jmodel, jax.random.PRNGKey(5),
                            make_optimizer(1e-3))
    windows = np.random.default_rng(6).normal(size=(80, NF + 1, REP)) \
        .astype(np.float32)
    want = jseq.reestimate_rvq_codebooks(jmodel, state, windows, K, 3,
                                         batch=32)
    model = pseq.make_seq_ae(load_config(PARTS["b_rvq"]))
    load_jax_variables(model, _np(state.params), _np(state.batch_stats))

    def seeds(resid, k, s):
        key = jax.random.split(jax.random.PRNGKey(s), 1)[0]
        return torch.from_numpy(np.asarray(jkm._plusplus_init(
            key, jnp.asarray(resid.numpy()), k)))

    pseq.reestimate_rvq_codebooks(model, windows, K, 3, batch=32,
                                  seed_centers=seeds)
    for s, cb in enumerate(model.vq_layer.codebooks()):
        name = "codebook" if s == 0 else f"codebook_r{s}"
        np.testing.assert_allclose(
            cb.detach().numpy(), np.asarray(want.params["vq_layer"][name]),
            atol=1e-4)


@pytest.mark.parametrize("part", ["a", "b_gssoft", "b_tf_rvq",
                                  "d_tf_recipe"])
def test_jax_checkpoint_resumes_in_port(part, tmp_path, no_jax_dropout):
    """A JAX-written checkpoint (after one real step, with optax's state)
    resumes in the port: its next step matches JAX's resumed step (the
    transformer Part d's with an empty batch_stats and n_words)."""
    cfg, jcfg = load_config(PARTS[part]), jax_load_config(PARTS[part])
    batches = _batches(part, PARTS[part], 9, 2)
    opt = make_optimizer(cfg.learning_rate)
    jmodel, state, jstep = _jax_setup(part, jcfg, opt)
    state, _ = jstep(state, batches[0], jax.random.PRNGKey(0))
    path = str(tmp_path / "jax.bin")
    rng = jax.random.PRNGKey(4)
    kind = {"a": "DAE", "b": "autoencoder_vq", "d": "text2embedding"}
    jckpt.save_checkpoint(path, config=jcfg, epoch=1,
                          params=_np(state.params),
                          extra={"batch_stats": _np(state.batch_stats),
                                 "n_words": NWORDS,
                                 **jckpt.resume_extra(state, rng, jcfg)},
                          kind=kind[part[0]])
    restored, _, epoch, _ = jckpt.restore_for_resume(state, rng, path)
    restored, metrics = jstep(restored, batches[1], jax.random.PRNGKey(1))

    model, cls = _port_setup(part, cfg, state)
    padam = Adam(model.parameters(), cfg.learning_rate)
    gen = torch.Generator().manual_seed(0)
    start, _ = pckpt.restore_for_resume(model, padam, gen, path)
    assert start == epoch == 1 and padam.count == 1
    step = _make_step(part, cls, cfg, model, padam)
    loss = _loss_of(step(*_torch_batch(part, batches[1])))
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    entries = param_entries(model)
    _close_trees(jax_tree(entries), _np(restored.params), 1e-5, "params",
                 lr=cfg.learning_rate)


# -- the command ----------------------------------------------------------
def _tiny_store(root, n_clips, n_frames, seed):
    from gesture2vec_tpu_torch.data.store import ClipStoreWriter
    rng = np.random.default_rng(seed)
    w = ClipStoreWriter(root)
    allp = []
    for c in range(n_clips):
        t = np.arange(n_frames)[:, None] / 20.0
        poses = (np.sin(t * rng.uniform(0.5, 3, 135)
                        + rng.uniform(0, 6, 135))
                 + 0.1 * rng.normal(size=(n_frames, 135))).astype(np.float32)
        words = [[f"w{rng.integers(40)}", float(s), float(s + 0.3)]
                 for s in np.arange(0.1, n_frames / 20.0 - 0.5, 0.4)]
        w.add_clip(f"clip{c}", poses, words)
        allp.append(poses)
    p = np.concatenate(allp)
    w.set_stats(p.mean(0), p.std(0))
    w.set_meta(fps=20, feature_dim=135)
    w.finish()


def _write_yaml(path, d):
    with open(path, "w") as f:
        for k, v in d.items():
            f.write(f"{k}: {json.dumps(v) if isinstance(v, str) else v}\n"
                    .replace("True", "true").replace("False", "false"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's g2v-train a -> b (residual VQ) -> d (GRU encoder, 2
    chained stages) on a tiny store, on the CPU."""
    from gesture2vec_tpu_torch.cli import train as ptrain
    root = tmp_path_factory.mktemp("train")
    _tiny_store(str(root / "train"), 2, 500, 0)
    _tiny_store(str(root / "val"), 1, 400, 1)
    base = {"train_data_path": str(root / "train"),
            "val_data_path": str(root / "val"), "random_seed": 0,
            "learning_rate": 0.001}
    _write_yaml(root / "dae.yml", {**base, "name": "dae", "hidden_size": 8,
                                   "input_motion_dim": 135, "epochs": 2,
                                   "batch_size": 32})
    _write_yaml(root / "vq.yml", {
        **base, "name": "vq", "hidden_size": HID, "n_layers": 2,
        "autoencoder_vq": True, "autoencoder_vq_components": K,
        "autoencoder_vq_variant": "rvq", "rvq_stages": 2,
        "rvq_reestimate_every": 1, "epochs": 2, "batch_size": 16,
        "n_poses": 10, "n_pre_poses": 1, "subdivision_stride": 5})
    _write_yaml(root / "t2t.yml", {
        **base, "name": "t2t", "hidden_size": HID, "n_layers": 2,
        "wordembed_dim": WEMB, "autoencoder_att": True,
        "autoencoder_vq": True, "autoencoder_vq_components": K,
        "epochs": 2, "batch_size": 8, "n_poses": 10, "n_pre_poses": 2,
        "sentence_frame_length": 40, "subdivision_stride_sentence": 20,
        "motion_resampling_framerate": 20, "token_stages": 2,
        "stage_conditional": True, "text_encoder": "gru"})
    out = {"root": root}
    for part, cfg, extra in (
            ("a", "dae.yml", []),
            ("b", "vq.yml", ["--rep-checkpoint",
                             str(root / "out/dae/dae_H8_checkpoint_002.bin")]),
            ("d", "t2t.yml", [
                "--rep-checkpoint",
                str(root / "out/dae/dae_H8_checkpoint_002.bin"),
                "--autoencoder-checkpoint",
                str(root / "out/vq/vq_checkpoint_002.bin")])):
        save = str(root / "out" / cfg.split(".")[0])
        out[part] = ptrain.main(["-c", str(root / cfg), "--part", part,
                                 "--device", "cpu", "--save-dir", save]
                                + extra)
    out["files"] = {"a": root / "out/dae/dae_H8_checkpoint_002.bin",
                    "b": root / "out/vq/vq_checkpoint_002.bin",
                    "d": root / "out/t2t/t2t_checkpoint_002.bin"}
    return out


def test_command_trains_each_part(trained):
    """Each part's loss is finite and falls; the files and the history
    JSON are where the command says."""
    for part in "abd":
        _, hist = trained[part]
        assert np.all(np.isfinite(hist["train_loss"]))
        assert hist["train_loss"][-1] < hist["train_loss"][0]
        assert os.path.exists(trained["files"][part])
    for d in ("dae", "vq", "t2t"):
        with open(trained["root"] / "out" / d / "loss_history.json") as f:
            assert "train_loss" in json.load(f)


@pytest.mark.parametrize("part", ["a", "b", "d"])
def test_port_checkpoint_loads_in_jax(trained, part):
    """The JAX package's load_checkpoint_and_model reads the port's file
    and its forward equals the port's (loaded by the port's loader)
    within 1e-5."""
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    kind = {"a": "DAE", "b": "autoencoder_vq", "d": "text2embedding"}[part]
    path = str(trained["files"][part])
    jm, jv, payload = jckpt.load_checkpoint_and_model(path, kind)
    assert payload["epoch"] == 2 and "opt_state" in payload["extra"]
    pm, _ = load_checkpoint_and_model(path, kind, "cpu")
    rng = np.random.default_rng(8)
    with torch.no_grad():
        if part == "a":
            x = rng.normal(size=(5, 135)).astype(np.float32)
            want = jm.apply(jv, jnp.asarray(x))
            got = pm.decode(pm.encode(torch.from_numpy(x)))
        elif part == "b":
            x = rng.normal(size=(6, 10, 8)).astype(np.float32)
            want = jm.apply(jv, jnp.asarray(x), jnp.asarray(x))["outputs"]
            got = pm(torch.from_numpy(x), torch.from_numpy(x))["outputs"]
        else:
            ids = rng.integers(4, 20, (4, 7)).astype(np.int32)
            lengths = np.array([7, 5, 3, 6], np.int32)
            tgt = rng.integers(0, K, (4, 4)).astype(np.int32)
            want = jm.apply(jv, *map(jnp.asarray, (ids, lengths, tgt)))[
                "logits"]
            got = pm(*(torch.from_numpy(a).long() for a in (ids, lengths,
                                                           tgt)))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_build_generator_on_trained_files(trained):
    """cli/_common.build_generator turns the three files into a working
    generator: a 6 s transcript gives finite frames in decode mode."""
    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.data.store import ClipStore
    f = trained["files"]
    gen, _ = build_generator(str(f["d"]), str(f["a"]), str(f["b"]),
                             ClipStore(str(trained["root"] / "train")),
                             mode="decode", device="cpu")
    words = [[f"w{i}", 0.1 + 0.4 * i, 0.4 + 0.4 * i] for i in range(12)]
    frames, tokens = gen.generate(words, 6.0)
    assert frames.shape == (120, 135) and np.isfinite(frames).all()
    assert tokens.shape == (12,)


def test_port_resume_continues_the_run(trained, tmp_path):
    """Part a for 2 epochs, against 1 epoch and a resume from its file
    for the second (dropout on: the generator's state travels in the
    checkpoint): the same parameters, bit for bit, and the optimizer's
    step count in the file."""
    from gesture2vec_tpu_torch.data.datasets import all_frames
    from gesture2vec_tpu_torch.data.store import ClipStore
    root = trained["root"]
    frames = all_frames(ClipStore(str(root / "train")))
    cfg = load_config(str(root / "dae.yml"))
    straight, _ = pdae.train_dae(cfg.replace(epochs=2), frames, frames[:64],
                                 device="cpu")
    pdae.train_dae(cfg.replace(epochs=1), frames, frames[:64],
                   save_dir=str(tmp_path), device="cpu")
    first = str(tmp_path / "dae_H8_checkpoint_001.bin")
    resumed, hist = pdae.train_dae(cfg.replace(epochs=2), frames,
                                   frames[:64], save_dir=str(tmp_path),
                                   resume_from=first, device="cpu")
    assert len(hist["train_loss"]) == 1
    for a, b in zip(straight.parameters(), resumed.parameters()):
        assert torch.equal(a, b)
    payload = pckpt.load_checkpoint(
        str(tmp_path / "dae_H8_checkpoint_002.bin"))
    assert payload["epoch"] == 2
    assert int(payload["extra"]["opt_state"]["1"]["0"]["count"]) == \
        2 * (frames.shape[0] // 32)


def test_refused_options_name_their_queue_items(trained, tmp_path):
    """A config's mesh_shape and --mesh, once refused, train over the
    mesh: part a on the tiny store with `mesh_shape: {dp: 2}` in the YAML,
    and with `--mesh dp=2` over the plain YAML, each through cli/train
    (the trainer starts its 2 gloo ranks), and `--mesh dp=2` under
    `torchrun --nproc-per-node 2` (each process joins torchrun's gloo
    group and trains in place), give the single run's history within
    1e-4, and the meshed run's checkpoint is the single run's file (the
    same format; parameters within 1e-5). Decoder attention
    and --plot-every are ported (tests/test_torch_port_reconstruct.py,
    tests/test_torch_port_analysis.py), and so are the parts baseline,
    c2g and gan (tests/test_torch_port_train_misc.py)."""
    from gesture2vec_tpu_torch.cli import train as ptrain
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model

    assert pseq.make_seq_ae(load_config(
        {**VQ_CFG, "autoencoder_att": True})).decoder.use_attention
    root = trained["root"]
    meshed = tmp_path / "mesh.yml"
    with open(root / "dae.yml") as f:
        meshed.write_text(f.read() + "mesh_shape: {dp: 2}\n")
    want = trained["a"][1]
    runs = {"yaml": ["-c", str(meshed)],
            "flag": ["-c", str(root / "dae.yml"), "--mesh", "dp=2"]}
    runs["torchrun"] = runs["flag"]
    for name, argv in runs.items():
        save = tmp_path / name
        argv = argv + ["--part", "a", "--device", "cpu", "--save-dir",
                       str(save)]
        if name == "torchrun":
            env = {**os.environ, "OMP_NUM_THREADS": "1",
                   "PYTHONPATH": str(REPO)}
            subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "2", "-m",
                 "gesture2vec_tpu_torch.cli.train", *argv], check=True,
                env=env, cwd=str(tmp_path), timeout=300)
            hist = json.loads((save / "loss_history.json").read_text())
        else:
            model, hist = ptrain.main(argv)
        for key in want:
            np.testing.assert_allclose(hist[key], want[key], rtol=1e-4,
                                       err_msg=f"{name} {key}")
        got, payload = load_checkpoint_and_model(
            str(save / "dae_H8_checkpoint_002.bin"), "DAE", "cpu")
        ref, ref_payload = load_checkpoint_and_model(
            str(root / "out/dae/dae_H8_checkpoint_002.bin"), "DAE", "cpu")
        assert payload["epoch"] == ref_payload["epoch"] == 2
        assert sorted(payload["extra"]) == sorted(ref_payload["extra"])
        for (k, a), (_, b) in zip(got.state_dict().items(),
                                  ref.state_dict().items()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        assert json.loads((save / "loss_history.json").read_text()) \
            == hist


def test_keep_best_saves_and_returns_the_best_epoch(tmp_path):
    """keep_best: the best validation epoch's state is saved under the
    "best" tag and is the state the trainer returns."""
    rng = np.random.default_rng(10)
    n, n_steps = 32, SENT // NF

    def data(m):
        lengths = rng.integers(3, MAXW + 1, m).astype(np.int32)
        return {"word_ids": rng.integers(4, NWORDS, (m, MAXW)).astype(
                    np.int32), "lengths": lengths,
                "tokens": rng.integers(0, K, (m, n_steps)).astype(np.int32)}
    cfg = load_config({**T2T_CFG, "text_encoder": "tcn", "epochs": 3,
                       "keep_best": True})
    model, hist = pt2t.train_text2token(cfg, data(n), data(8), NWORDS,
                                        save_dir=str(tmp_path),
                                        device="cpu")
    best = hist["best_epoch"][0]
    assert hist["best_val_loss"][0] == min(hist["val_loss"])
    payload = pckpt.load_checkpoint(str(tmp_path / "t2t_checkpoint_best.bin"))
    assert payload["epoch"] == best + 1
    _close_trees(jax_tree(param_entries(model)), payload["params"], 0.0,
                 "returned state")
