"""PyTorch port vs the JAX package in `compute_dtype: bfloat16`, continued.

tests/test_torch_port_train_bf16.py states the setting and the
tolerances (FWD_TOL = 2^-6 of the largest magnitude for forwards and
losses; each gradient's error against JAX's fp32 one within c times JAX's
bf16 error plus 2^-6, here c = 2; BF16_RAN = 1e-3 for "bf16 ran"); this
file holds:
  - the recipe's feedback-matched finetune step (the transformer Part d,
    4 chained stages, its eval-mode rollout with grad);
  - the audio Part d (mel chunks through the bf16 encoder BiGRU);
  - validation: the Part-b eval decode through the bf16 chunk-decoder
    path, the dtypes at JAX's cast sites, the tokens from one fp32 hidden
    (exact) and end to end (flips only at margins within FWD_TOL);
  - the bf16 checkpoint: a port-trained bf16 Part d loads fp32 in both
    packages' registries and resumes in each, the next step's losses
    within FWD_TOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gesture2vec_tpu.train import checkpoints as jckpt
from gesture2vec_tpu.train import text2token_trainer as jt2t
from gesture2vec_tpu.train.config import load_config as jax_load_config
from gesture2vec_tpu.train.optim import make_optimizer
from gesture2vec_tpu_torch.compat import checkpoint as pckpt_load
from gesture2vec_tpu_torch.ops import decoder_kernel as dk
from gesture2vec_tpu_torch.train import checkpoints as pckpt
from gesture2vec_tpu_torch.train import text2token_trainer as pt2t
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.optim import Adam
from tests.test_torch_port_train import (  # noqa: F401
    NWORDS, PARTS, _batches, _grab, _jax_setup, _loss_of, _make_step, _np,
    _port_setup, _torch_batch, no_jax_dropout, torch_one_thread)
from tests.test_torch_port_train_bf16 import (BF16, BF16_RAN, FWD_TOL,
                                              _f32, _grad_tree,
                                              _grads_close, _host, _max_rel,
                                              _trees_differ)


def test_feedback_step_matches_jax(no_jax_dropout):
    """The recipe's feedback-matched finetune step in bf16 (the eval-mode
    rollout with its own argmax fed back) against JAX's bf16
    make_feedback_train_step: loss within FWD_TOL, gradients against
    JAX's (see the module note)."""
    part = "d_tf_recipe"
    raw = {**PARTS[part], **BF16}
    cfg, jcfg = load_config(raw), jax_load_config(raw)
    batch = _batches(part, raw, 13, 1)[0]

    def jax_step(c):
        jmodel, st, _ = _jax_setup(part, c, _grab())
        host = _host(st)
        jstep = jt2t.make_feedback_train_step(jmodel, _grab(),
                                              cfg.label_smoothing, 0.0)
        new, metrics = jstep(st, *map(jnp.asarray, batch),
                             jax.random.PRNGKey(5))
        return host, _np(new.opt_state["g"]), metrics

    state, jgrads, metrics = jax_step(jcfg)
    _, jgrads32, _ = jax_step(jax_load_config(PARTS[part]))
    def port_step(c):
        model, _ = _port_setup(part, c, state)
        step = pt2t.FeedbackTrainStep(model, Adam(model.parameters(), 1e-3),
                                      cfg.label_smoothing, 0.0)
        loss = step.loss(*_torch_batch(part, batch))
        loss.backward()
        return loss, _grad_tree(model)

    loss, grads = port_step(cfg)
    assert abs(float(loss) - float(metrics["loss"])) \
        <= FWD_TOL * abs(float(metrics["loss"]))
    _grads_close(grads, jgrads, jgrads32, "grad", factor=2)
    _, grads32 = port_step(load_config(PARTS[part]))
    assert _trees_differ(grads, grads32) > BF16_RAN


def test_audio2token_step_matches_jax(no_jax_dropout):
    """The audio Part d (mel chunks, the bf16 encoder BiGRU and decoder
    step): one bf16 step against JAX's, loss within FWD_TOL, gradients
    against JAX's (the biases in front of batch-statistics BatchNorms
    measured against the tree's largest)."""
    from gesture2vec_tpu.train import audio2token_trainer as ja2t

    from gesture2vec_tpu_torch.compat import from_jax as fj
    from gesture2vec_tpu_torch.train import audio2token_trainer as pa2t
    from tests.test_torch_port_train_audio import (CANCELLED as A_CANCELLED,
                                                   MAXW, N_WORDS, _batch,
                                                   _torch, a2t_raw)

    raw = {**a2t_raw("audio", 1, False), "batch_size": 4, **BF16}
    raw32 = {**raw, "compute_dtype": "float32"}
    cfg = load_config(raw)
    batch = _batch("audio", 1, 20)

    def jax_step(c):
        jmodel = ja2t.make_audio2token(c, N_WORDS)
        st = ja2t.init_state(jmodel, jax.random.PRNGKey(0), _grab(),
                             batch[0].shape[1:], max_words=MAXW)
        host = _host(st)
        new, metrics = ja2t.make_train_step(jmodel, _grab(), 0.0)(
            st, *map(jnp.asarray, batch), jax.random.PRNGKey(1))
        return host, _np(new.opt_state["g"]), metrics

    host, jgrads, metrics = jax_step(jax_load_config(raw))
    _, jgrads32, _ = jax_step(jax_load_config(raw32))

    def port_step(c):
        model = pa2t.make_audio2token(c, N_WORDS)
        fj.load_jax_variables(model, host.params, host.batch_stats)
        loss = pa2t.TrainStep(model.train(), Adam(model.parameters(), 1e-3)
                              ).loss(*_torch(batch))
        loss.backward()
        return loss, _grad_tree(model)

    loss, grads = port_step(cfg)
    assert abs(float(loss) - float(metrics["loss"])) \
        <= FWD_TOL * abs(float(metrics["loss"]))
    _grads_close(grads, jgrads, jgrads32, "grad",
                 lambda path: path in A_CANCELLED["audio"], factor=2)
    _, grads32 = port_step(load_config(raw32))
    assert _trees_differ(grads, grads32) > BF16_RAN


# -- validation: the eval decode and the tokens --------------------------
def test_eval_decode_and_tokens_match_jax(monkeypatch):
    """Part b in eval mode (validation): the bf16 encoder and the bf16
    chunk-decoder path (its plain version here, fed bf16: never the fp32
    one) against JAX's bf16 eval apply; outputs fp32 within FWD_TOL, the
    quantizer's input and encodings fp32 as in JAX; tokens equal from
    the same fp32 hidden, flips end to end only at margins within
    FWD_TOL."""
    from gesture2vec_tpu.train import seq_ae_trainer as jseq
    raw = {**PARTS["b_gssoft"], **BF16}
    cfg, jcfg = load_config(raw), jax_load_config(raw)
    _, state, _ = _jax_setup("b_gssoft", jcfg, _grab())
    jmodel = jseq.make_seq_ae(jcfg)
    x = np.random.default_rng(11).normal(size=(16, 6, 8)).astype(np.float32)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    jres = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(x))

    seen = []
    plain = dk.fused_chunk_decode_plain
    monkeypatch.setattr(dk, "fused_chunk_decode_plain",
                        lambda x0, *a: seen.append(x0.dtype) or plain(x0, *a))
    vq_in = []
    model, _ = _port_setup("b_gssoft", cfg, state)
    model.vq_layer.register_forward_pre_hook(
        lambda m, args: vq_in.append(args[0].dtype))
    model.eval()
    with torch.no_grad():
        res = model(torch.from_numpy(x), torch.from_numpy(x))
    assert seen == [torch.bfloat16]
    assert vq_in == [torch.float32]
    for k in ("outputs",):
        assert res[k].dtype == torch.float32 and jres[k].dtype == jnp.float32
    assert res["vq"].encodings.dtype == torch.float32 \
        and jres["vq"].encodings.dtype == jnp.float32
    assert _max_rel(_f32(res["outputs"]), _f32(jres["outputs"])) <= FWD_TOL
    model32, _ = _port_setup("b_gssoft", load_config(PARTS["b_gssoft"]),
                             state)
    with torch.no_grad():
        res32 = model32.eval()(torch.from_numpy(x), torch.from_numpy(x))
    assert _max_rel(_f32(res["outputs"]), _f32(res32["outputs"])) > BF16_RAN

    # tokens: the same fp32 hidden through both quantizers, exactly
    _, jh = jmodel.apply(variables, jnp.asarray(x), method=jmodel.encode)
    jh32 = np.asarray(jh.astype(jnp.float32))
    jtok = np.asarray(jmodel.apply(variables, jnp.asarray(jh32),
                                   method=jmodel.tokens_from_hidden))
    with torch.no_grad():
        ptok = model.tokens_from_hidden(torch.from_numpy(jh32)).numpy()
        ph = model.encode(torch.from_numpy(x))[1]
        ptok_e2e = model.tokens_from_hidden(ph).numpy()
    np.testing.assert_array_equal(ptok, jtok)
    # end to end: a flip only where JAX's margin is within FWD_TOL
    flat = np.transpose(jh32, (1, 0, 2)).reshape(16, -1)
    cb = np.asarray(state.params["vq_layer"]["codebook"])
    d = ((flat[:, None, :] - cb[None]) ** 2).sum(-1)
    for i in np.nonzero(ptok_e2e != jtok)[0]:
        margin = abs(d[i, ptok_e2e[i]] - d[i, jtok[i]])
        assert margin <= FWD_TOL * d[i].max(), (i, margin)


# -- the bf16 checkpoint ----------------------------------------------------
def test_bf16_checkpoint_loads_fp32_and_resumes_across(tmp_path,
                                                       no_jax_dropout):
    """A port-trained bf16 Part d (TCN) checkpoint: both registries build
    fp32 models from it (JAX's compute_dtype "float32", the port's no
    compute dtype); both packages resume the bf16 run from it and their
    next steps agree within FWD_TOL."""
    part = "d_tcn"
    raw = {**PARTS[part], **BF16, "epochs": 1}
    cfg, jcfg = load_config(raw), jax_load_config(raw)
    rng = np.random.default_rng(4)
    n, n_steps = 16, 4

    def data(m):
        lengths = rng.integers(3, 10, m).astype(np.int32)
        return {"word_ids": rng.integers(4, NWORDS, (m, 9)).astype(np.int32),
                "lengths": lengths,
                "tokens": rng.integers(0, 16, (m, n_steps)).astype(np.int32)}
    model, hist = pt2t.train_text2token(cfg, data(n), data(8), NWORDS,
                                        save_dir=str(tmp_path),
                                        device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert np.isfinite(hist["train_loss"]).all()
    path = str(tmp_path / "t2t_checkpoint_001.bin")
    jm, _, _ = jckpt.load_checkpoint_and_model(path, "text2embedding")
    assert jm.compute_dtype == "float32"
    pm, payload = pckpt_load.load_checkpoint_and_model(
        path, "text2embedding", "cpu")
    assert pm.compute_dtype is None
    assert payload["config"]["compute_dtype"] == "float32"
    assert all(p.dtype == torch.float32 for p in pm.parameters())

    # resume the bf16 run in each package and take the same next step
    batch = _batches(part, raw, 21, 1)[0]
    _, state, jstep = _jax_setup(part, jcfg, make_optimizer(1e-3))
    pmodel, cls = _port_setup(part, cfg, state)
    rkey = jax.random.PRNGKey(0)
    restored, _, epoch, _ = jckpt.restore_for_resume(state, rkey, path)
    _, metrics = jstep(restored, batch, jax.random.PRNGKey(1))
    padam = Adam(pmodel.parameters(), cfg.learning_rate)
    start, _ = pckpt.restore_for_resume(pmodel, padam,
                                        torch.Generator().manual_seed(0),
                                        path)
    assert start == epoch == 1 and padam.count == n // cfg.batch_size
    loss = _loss_of(_make_step(part, cls, cfg, pmodel, padam)(
        *_torch_batch(part, batch)))
    assert abs(float(loss) - float(metrics["loss"])) \
        <= FWD_TOL * abs(float(metrics["loss"]))
