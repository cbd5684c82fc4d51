"""PyTorch port vs the JAX package: the Part-b decoder's remaining work and
the reconstruction round trips (`infer/reconstruct`, `cli/reconstruct`).

A synthetic Trinity-layout corpus (2 BVH files, 120 frames at 20 fps
after the ingest, 135-wide features) goes through the port's ingest; the
JAX package writes the checkpoints, each random and perturbed: a DAE
(latent 8) and three tokenizers at hidden 16, 2 layers, 8 codes, 10-pose
chunks: a plain GS-Soft one, one with the decoder attention
(`autoencoder_att`) and a parity checkpoint (extra["parity"], so
`vq_flatten: torch_view` and the eval step dropout). The weights are the
port's modules initialised as flax would (`compat/from_jax.flax_init`)
and carried to JAX's layout, since the JAX package's own init takes
~12 s here. Floats are held within 1e-5 of the JAX package's.

- The attention decoder step, `warmup_hidden` and the eval decode with
  attention against JAX's modules; `chunked_reconstruct` with overlap 0
  and 5, warm-up 0 and 5, with and without attention.
- The parity checkpoint (the repair of an earlier fault): the port loads
  it with the eval step dropout on, the kernel refuses it, its round
  trip is reproducible and not the dropout-free one; with flax's Dropout
  and the port's `dropout` reading one numpy mask stream (flax's through
  an ordered `io_callback` that takes the dropped input, so each call
  runs in data order), its rollout and round trip match JAX's.
- One `autoencoder_att` Part-b train step against JAX's
  `make_train_step` (dropout off on both sides, as in
  `tests/test_torch_port_train.py`), and the checkpoint in both
  directions.
- `cli/reconstruct` (Part a and Part a+b with overlap and warm-up) on the
  BVH against the JAX command; `--plot-kernels` writes its PNGs.
- On the card (`gpu`, skipped here): the round trip through the kernels
  against the plain versions on the card. The card's machine has JAX but
  no flax, so this file imports flax and the JAX package only inside its
  CPU tests and fixtures (and the repo's `tests` helpers there too).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.cli import make_dataset as p_make_dataset
from gesture2vec_tpu_torch.cli import reconstruct as p_cli
from gesture2vec_tpu_torch.compat.checkpoint import load_checkpoint_and_model
from gesture2vec_tpu_torch.data.datasets import normalize
from gesture2vec_tpu_torch.data.store import ClipStore
from gesture2vec_tpu_torch.infer.reconstruct import (chunked_reconstruct,
                                                     dae_roundtrip)
from gesture2vec_tpu_torch.io.bvh import parse_bvh
from gesture2vec_tpu_torch.mocap.features import FeatureExtractor
from gesture2vec_tpu_torch.models import seq_ae as port_seq_ae

ATOL = 1e-5
DIM, REP, HID, L, K, NP = 135, 8, 16, 2, 8, 10
TOKENIZERS = {"plain": {}, "attention": {"autoencoder_att": True},
              "parity": {}}


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """torch on one thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(tree, rng, scale=0.3):
    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _seq_cfg(**kw):
    return dict(name="vq", model="seq2seq", hidden_size=HID, n_layers=L,
                dropout_prob=0.1, rep_learning_dim=REP, n_poses=NP,
                n_pre_poses=1, subdivision_stride=5, autoencoder_vq=True,
                autoencoder_vq_components=K, random_seed=0, **kw)


def _init_variables(model, seed, scale=0.3):
    """A port model's weights as flax initialises them (from a seeded
    generator), perturbed, in the JAX package's layout (numpy)."""
    from gesture2vec_tpu_torch.compat.from_jax import (flax_init,
                                                       to_jax_variables)

    flax_init(model, torch.Generator().manual_seed(seed))
    return _perturb(to_jax_variables(model), np.random.default_rng(seed),
                    scale)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The ingested corpus and the JAX-written checkpoints (paths)."""
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.train.config import load_config as p_config
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae
    from tests.corpus import make_corpus

    root = tmp_path_factory.mktemp("reconstruct")
    corpus = make_corpus(str(root / "corpus"), n_files=2, n_frames=360)
    train, _ = p_make_dataset.main([corpus, "--out", str(root / "data")])
    out = {"root": root, "store": train,
           "pipeline": str(root / "data" / "data_pipe.json"),
           "bvh": os.path.join(corpus, "Motion", "Recording_001.bvh"),
           "dae": str(root / "dae.bin")}
    dae_cfg = load_config(dict(name="dae", model="DAE", hidden_size=REP,
                               input_motion_dim=DIM, random_seed=0))
    checkpoints.save_checkpoint(
        out["dae"], config=dae_cfg, epoch=1,
        params=_init_variables(DAE(DIM, REP), 1, 0.1)["params"],
        pose_dim=DIM, kind="DAE")
    for i, (name, kw) in enumerate(TOKENIZERS.items()):
        tree = _init_variables(make_seq_ae(p_config(_seq_cfg(**kw))), 2 + i)
        out[name] = str(root / f"{name}.bin")
        checkpoints.save_checkpoint(
            out[name], config=load_config(_seq_cfg(**kw)), epoch=1,
            params=tree["params"],
            pose_dim=REP, extra={"batch_stats": tree["batch_stats"],
                                 "parity": name == "parity"},
            kind="autoencoder_vq")
    return out


def _frames(files):
    store = ClipStore(files["store"])
    feats = FeatureExtractor.load(files["pipeline"]).transform(
        parse_bvh(files["bvh"]))
    return normalize(feats.astype(np.float32), store.pose_mean,
                     store.pose_std)


def _jax_models(files, name):
    from gesture2vec_tpu.train import checkpoints

    dae, dae_v, _ = checkpoints.load_checkpoint_and_model(files["dae"],
                                                          "DAE")
    seq, seq_v, _ = checkpoints.load_checkpoint_and_model(files[name],
                                                          "autoencoder_vq")
    return dae, dae_v, seq, seq_v


def _port_models(files, name):
    dae, _ = load_checkpoint_and_model(files["dae"], "DAE", "cpu")
    seq, _ = load_checkpoint_and_model(files[name], "autoencoder_vq", "cpu")
    return dae, seq


@pytest.mark.parametrize("name", ["plain", "attention"])
def test_decoder_step_warmup_and_decode_match_jax(files, name):
    """The eval decode (teacher seed, then fed back) and warmup_hidden from
    the quantized encoder hidden, with the attention over the encoder
    outputs where the tokenizer has it."""
    _, _, jm, jv = _jax_models(files, name)
    _, pm = _port_models(files, name)
    assert pm.decoder.use_attention == (name == "attention")
    assert pm.decoder.decoder_step.pre_linear.in_features == \
        REP + (HID if name == "attention" else 0)
    x = np.random.default_rng(3).normal(size=(5, NP, REP)).astype(np.float32)

    @jax.jit
    def run(xj):
        enc, h = jm.apply(jv, xj, method=jm.encode)
        _, hq = jm.apply(jv, h, method=jm.quantize)
        return (enc, jm.apply(jv, hq, xj, enc, method=jm.decode),
                jm.apply(jv, hq, xj[:, 0], enc, 5, method=jm.warmup_hidden))

    enc, want_dec, want_wu = run(jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        enc_p, h_p = pm.encode(xt)
        _, hq_p = pm.quantize(h_p)
        got_dec = pm.decoder.decode(hq_p, xt, enc_p)
        got_wu = pm.decoder.warmup_hidden(hq_p, xt[:, 0], enc_p, 5)
    np.testing.assert_allclose(enc_p.numpy(), np.asarray(enc), atol=ATOL)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec),
                               atol=ATOL)
    np.testing.assert_allclose(got_wu.numpy(), np.asarray(want_wu),
                               atol=ATOL)
    if name == "attention":
        with pytest.raises(ValueError, match="encoder outputs"):
            pm.decoder.rollout(hq_p, xt[:, 0])


@pytest.mark.parametrize("name, overlap, warmup", [
    ("plain", 0, 0), ("plain", 5, 0), ("plain", 0, 5), ("plain", 5, 5),
    ("attention", 0, 0), ("attention", 5, 5)])
def test_chunked_reconstruct_matches_jax(files, name, overlap, warmup):
    from gesture2vec_tpu.infer.reconstruct import \
        chunked_reconstruct as jax_chunked

    frames = _frames(files)
    dae, dae_v, jm, jv = _jax_models(files, name)
    want = jax_chunked(jm, jv, dae, dae_v, frames, NP, overlap=overlap,
                       warmup_steps=warmup)
    p_dae, pm = _port_models(files, name)
    got = chunked_reconstruct(pm, p_dae, frames, NP, overlap=overlap,
                              warmup_steps=warmup)
    assert got.shape == frames.shape == (120, DIM)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dae_roundtrip_matches_jax(files):
    from gesture2vec_tpu.infer.reconstruct import \
        dae_roundtrip as jax_roundtrip

    frames = _frames(files)
    dae, dae_v, _, _ = _jax_models(files, "plain")
    want = jax_roundtrip(dae, dae_v, frames)
    got = dae_roundtrip(_port_models(files, "plain")[0], frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_parity_checkpoint_decodes_with_eval_dropout(files):
    """A JAX parity checkpoint: the port applies the reference's 0.95 step
    dropout in eval (as JAX's loader sets eval_step_dropout), which the
    chunk-decoder kernel does not compute; the round trip is the same
    from run to run (each chunk's stream seeded 0) and not the round trip
    without the dropout."""
    frames = _frames(files)
    dae, seq = _port_models(files, "parity")
    assert seq.vq_flatten == "torch_view"
    assert seq.decoder.eval_step_dropout
    assert "eval step dropout" in seq.decoder.kernel_reason()
    first = chunked_reconstruct(seq, dae, frames, NP)
    again = chunked_reconstruct(seq, dae, frames, NP)
    np.testing.assert_array_equal(first, again)
    seq.decoder.decoder_step.eval_step_dropout = False
    plain = chunked_reconstruct(seq, dae, frames, NP)
    assert np.abs(first - plain).max() > 1e-2


class _MaskStream:
    """One numpy stream of keep masks; each package's patched dropout
    draws from its own copy, in call order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.draws = 0

    def keep(self, shape, rate):
        self.draws += 1
        return (self.rng.random(shape) < 1.0 - rate).astype(np.float32)


def _shared_masks(monkeypatch, seed):
    """flax's Dropout and the port's models/seq_ae.dropout as x * keep /
    (1 - rate), keep from two copies of one numpy stream."""
    import flax.linen as fnn
    from jax.experimental import io_callback

    jax_s, port_s = _MaskStream(seed), _MaskStream(seed)

    def jax_dropout(self, inputs, deterministic=None, rng=None):
        det = self.deterministic if deterministic is None else deterministic
        if det or self.rate == 0:
            return inputs
        keep = io_callback(lambda x: jax_s.keep(x.shape, self.rate),
                           jax.ShapeDtypeStruct(inputs.shape, jnp.float32),
                           inputs, ordered=True)
        return inputs * keep / (1.0 - self.rate)

    def port_dropout(x, rate, training, batch_dim=0):
        if not training or rate <= 0.0:
            return x
        return x * torch.from_numpy(port_s.keep(tuple(x.shape), rate)) \
            / (1.0 - rate)

    monkeypatch.setattr(fnn.Dropout, "__call__", jax_dropout)
    monkeypatch.setattr(port_seq_ae, "dropout", port_dropout)
    return jax_s, port_s


@pytest.mark.parametrize("what", ["reconstruct", "reconstruct_warmup",
                                  "rollout"])
def test_parity_decode_matches_jax_under_shared_masks(files, what,
                                                      monkeypatch):
    from gesture2vec_tpu.infer.reconstruct import \
        chunked_reconstruct as jax_chunked

    dae, dae_v, jm, jv = _jax_models(files, "parity")
    p_dae, pm = _port_models(files, "parity")
    jax_s, port_s = _shared_masks(monkeypatch, 17)
    if what == "rollout":
        rng = np.random.default_rng(4)
        h = rng.normal(size=(L, 3, HID)).astype(np.float32) * 0.5
        seed = rng.normal(size=(3, REP)).astype(np.float32)
        want = jm.apply(jv, jnp.asarray(h), jnp.asarray(seed),
                        method=jm.rollout,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        with torch.no_grad():
            got = pm.decoder.rollout(torch.from_numpy(h),
                                     torch.from_numpy(seed)).numpy()
    else:
        frames = _frames(files)
        warmup = 5 if what == "reconstruct_warmup" else 0
        want = jax_chunked(jm, jv, dae, dae_v, frames, NP,
                           warmup_steps=warmup)
        got = chunked_reconstruct(pm, p_dae, frames, NP,
                                  warmup_steps=warmup)
    assert jax_s.draws == port_s.draws > 0
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def _att_cfg():
    from tests.test_torch_port_train import VQ_CFG

    return {**VQ_CFG, "autoencoder_att": True}


def _jax_att_setup(jcfg, opt):
    """(JAX state, step fn(state, batch, rng) -> (state, metrics)) of
    the autoencoder_att tokenizer, its state built from `_init_variables`
    (the JAX package's init is slow here)."""
    from gesture2vec_tpu.train import seq_ae_trainer as jseq

    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae

    v = jax.tree_util.tree_map(jnp.asarray, _init_variables(
        make_seq_ae(load_config(_att_cfg())), 5, 0.1))
    state = jseq.SeqAETrainState(params=v["params"],
                                 opt_state=opt.init(v["params"]),
                                 batch_stats=v["batch_stats"],
                                 step=jnp.zeros((), jnp.int32))
    step = jseq.make_train_step(jcfg, jseq.make_seq_ae(jcfg), opt,
                                jcfg.epochs)
    return state, lambda st, b, r: step(st, jnp.asarray(b[0]), r,
                                        jnp.asarray(0.0))


def test_attention_train_step_matches_jax(no_jax_dropout):
    """One autoencoder_att Part-b step (the train-mode decode in plain
    PyTorch): loss within 1e-5 relative, every gradient within 1e-4 of
    JAX's largest, the attention's among them."""
    from gesture2vec_tpu.train.config import load_config as jax_load_config

    from gesture2vec_tpu_torch.compat.from_jax import jax_tree, param_entries
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.optim import Adam
    from tests.test_torch_port_train import (GRAD_TOL, LOSS_RTOL, _batches,
                                             _close_trees, _grab,
                                             _port_setup, _rel, _torch_batch)

    att = _att_cfg()
    cfg, jcfg = load_config(att), jax_load_config(att)
    batch = _batches("b_att", att, 7, 1)[0]
    state, jstep = _jax_att_setup(jcfg, _grab())
    model, cls = _port_setup("b_att", cfg, state)
    new_state, metrics = jstep(state, batch, jax.random.PRNGKey(1))
    assert model.decoder.use_attention
    step = cls(cfg, model, Adam(model.parameters(), cfg.learning_rate))
    loss = step.loss(*_torch_batch("b_att", batch))[0]
    loss.backward()
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL
    entries = param_entries(model)
    grads = jax_tree(entries, {id(p): p.grad for _, p, _, _ in entries})
    want = _np(new_state.opt_state["g"])
    assert "attn" in want["decoder_step"]
    _close_trees(grads, want, GRAD_TOL, "grad")


def test_attention_checkpoint_across_packages(tmp_path, no_jax_dropout):
    """A JAX-written autoencoder_att checkpoint with optax's state resumes
    in the port (the same weights and Adam count, the next step's loss
    JAX's), and the port's checkpoint loads in the JAX package with the
    same eval forward."""
    from gesture2vec_tpu.train import checkpoints as jckpt
    from gesture2vec_tpu.train.config import load_config as jax_load_config
    from gesture2vec_tpu.train.optim import make_optimizer

    from gesture2vec_tpu_torch.compat.from_jax import (jax_tree,
                                                       param_entries,
                                                       to_jax_variables)
    from gesture2vec_tpu_torch.train import checkpoints as pckpt
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.optim import Adam
    from tests.test_torch_port_train import (LOSS_RTOL, _batches,
                                             _close_trees, _port_setup, _rel,
                                             _torch_batch)

    att = _att_cfg()
    cfg, jcfg = load_config(att), jax_load_config(att)
    batches = _batches("b_att", att, 9, 2)
    state, jstep = _jax_att_setup(jcfg, make_optimizer(cfg.learning_rate))
    state, _ = jstep(state, batches[0], jax.random.PRNGKey(0))
    path = str(tmp_path / "jax.bin")
    rng = jax.random.PRNGKey(4)
    jckpt.save_checkpoint(path, config=jcfg, epoch=1,
                          params=_np(state.params),
                          extra={"batch_stats": _np(state.batch_stats),
                                 **jckpt.resume_extra(state, rng, jcfg)},
                          kind="autoencoder_vq")
    restored, _, _, _ = jckpt.restore_for_resume(state, rng, path)
    model, cls = _port_setup("b_att", cfg, state)
    padam = Adam(model.parameters(), cfg.learning_rate)
    gen = torch.Generator().manual_seed(0)
    start, _ = pckpt.restore_for_resume(model, padam, gen, path)
    assert start == 1 and padam.count == 1
    _close_trees(jax_tree(param_entries(model)), _np(restored.params), 1e-6,
                 "params")
    restored, metrics = jstep(restored, batches[1], jax.random.PRNGKey(1))
    loss = cls(cfg, model, padam)(*_torch_batch("b_att", batches[1]))[0]
    assert _rel(loss, metrics["loss"]) <= LOSS_RTOL

    out = str(tmp_path / "port.bin")
    v = to_jax_variables(model)
    pckpt.save_checkpoint(out, config=cfg, epoch=2, params=v["params"],
                          pose_dim=REP, extra={"batch_stats":
                                               v["batch_stats"],
                                               "parity": False},
                          kind="autoencoder_vq")
    jm, jv, _ = jckpt.load_checkpoint_and_model(out, "autoencoder_vq")
    x = batches[1][0]
    want = jax.jit(lambda a: jm.apply(jv, a, a)["outputs"])(jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(got["outputs"].numpy(), np.asarray(want),
                               atol=ATOL)


def _split(text):
    """(the BVH header through its Frame Time line, the motion numbers)."""
    head, motion = text.split("Frame Time:", 1)
    lines = motion.splitlines()
    return (head + "Frame Time:" + lines[0],
            np.array([ln.split() for ln in lines[1:]], np.float64))


# the euler extraction of an untrained model's feature matrices amplifies
# float32 rounding (frames within 1e-5 give motion within ~1e-2 degrees;
# tests/test_torch_port_cli.py's MOTION_TOL); the export itself is exact
MOTION_TOL = 1e-2


@pytest.mark.parametrize("flags", [[], ["--autoencoder-checkpoint", "plain",
                                        "--overlap", "5",
                                        "--warmup-steps", "5"],
                                   ["--autoencoder-checkpoint", "attention"]])
def test_reconstruct_cli_matches_jax_cli(files, flags, monkeypatch):
    """The port's command with --device cpu against the JAX command: the
    reconstruction within 1e-5, the port's export of the JAX command's
    frames byte for byte its BVH, the BVH header identical, the motion
    within MOTION_TOL (the number of differing values printed), the HTML
    player of each side's BVH identical to the other package's player of
    it; the Part-a run also writes the kernel plots."""
    from gesture2vec_tpu.cli import reconstruct as jax_cli
    from gesture2vec_tpu.infer import reconstruct as jax_rec
    from gesture2vec_tpu.mocap.viz import save_html_player as jax_html

    from gesture2vec_tpu_torch.data.datasets import unnormalize
    from gesture2vec_tpu_torch.infer.exporter import frames_to_bvh
    from gesture2vec_tpu_torch.io.bvh import write_bvh

    flags = [files.get(f, f) for f in flags]
    tag = "a" if not flags else os.path.basename(flags[1])[:-4]
    root = files["root"]
    out = {w: (str(root / f"{tag}_{w}.bvh"), str(root / f"{tag}_{w}.html"))
           for w in ("jax", "port")}
    common = [files["dae"], files["bvh"], "--store", files["store"],
              "--pipeline", files["pipeline"], *flags]
    want = {}
    for fn in ("chunked_reconstruct", "dae_roundtrip"):
        def keep(*a, _fn=getattr(jax_rec, fn), **k):
            want["frames"] = _fn(*a, **k)
            return want["frames"]
        monkeypatch.setattr(jax_rec, fn, keep)
    monkeypatch.setattr(sys, "argv", [
        "reconstruct", *common, "--out", out["jax"][0], "--html-player",
        out["jax"][1], "--jax-cache", "off"])
    jax_cli.main()
    extra = ["--plot-kernels", str(root / "kernels")] if not flags else []
    res = p_cli.main([*common, "--out", out["port"][0], "--html-player",
                      out["port"][1], "--device", "cpu", *extra])
    assert res["kernel"] == (tag == "plain")
    w_frames = want["frames"][0] if tag == "a" else want["frames"]
    np.testing.assert_allclose(res["frames"], w_frames, atol=ATOL)
    texts = {w: [open(p).read() for p in paths] for w, paths in out.items()}
    store = ClipStore(files["store"])
    fe = FeatureExtractor.load(files["pipeline"])
    assert write_bvh(frames_to_bvh(unnormalize(
        w_frames, store.pose_mean, store.pose_std), fe)) == texts["jax"][0]
    (head, motion), (w_head, w_motion) = (_split(texts[w][0])
                                          for w in ("port", "jax"))
    assert head == w_head and motion.shape == w_motion.shape
    err = float(np.abs(motion - w_motion).max())
    print(f"{tag}: {int((motion != w_motion).sum())} of {motion.size} BVH "
          f"motion values differ, by at most {err}")
    assert err <= MOTION_TOL
    jax_html(parse_bvh(out["port"][0]), str(root / f"{tag}_cross.html"),
             title=f"reconstruction of {files['bvh']}")
    assert texts["port"][1] == open(root / f"{tag}_cross.html").read()
    if extra:
        pngs = res["plots"]
        assert len(pngs) == 1 + 2 * REP
        assert all(os.path.getsize(p) > 1000 for p in pngs)


@pytest.mark.gpu
def test_reconstruct_kernels_on_card_match_plain():
    """On the card, over the port's own modules (flax_init from a seed,
    the tests' widths): the round trip of 120 frames with overlap 5
    through the GRU-sequence kernel (4 launches an encode) and the
    chunk-decoder kernel (1 launch, the 23 chunks as one batch) against
    the same models' plain versions on the card; decode_codebook (1
    launch at B = 8 codes) likewise; an attention tokenizer refused with
    the decoder kernel on, and with it off (no launch) against the CPU.
    Tolerance 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from gesture2vec_tpu_torch.cluster.latent_dataset import decode_codebook
    from gesture2vec_tpu_torch.compat.from_jax import flax_init
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqVQAutoencoder
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    def models(att, seed):
        seq = SeqVQAutoencoder(REP, HID, L, NP, vq_components=K,
                               use_attention=att)
        dae = DAE(DIM, REP)
        for i, m in enumerate((seq, dae)):
            flax_init(m, torch.Generator().manual_seed(seed + i))
        return seq.eval(), dae.eval()

    frames = np.random.default_rng(0).normal(size=(120, DIM)).astype(
        np.float32)
    seq, dae = (m.cuda() for m in models(False, 0))
    gru0, dec0 = gk.gru_sequence.launches, dk.fused_chunk_decode.launches
    got = chunked_reconstruct(seq, dae, frames, NP, overlap=5)
    assert gk.gru_sequence.launches - gru0 == 4
    assert dk.fused_chunk_decode.launches - dec0 == 1
    cb = decode_codebook(seq, dae)
    assert dk.fused_chunk_decode.launches - dec0 == 2
    seq.set_use_kernels(False)
    np.testing.assert_allclose(got, chunked_reconstruct(
        seq, dae, frames, NP, overlap=5), atol=1e-4)
    np.testing.assert_allclose(cb, decode_codebook(seq, dae), atol=1e-4)
    att_cpu, dae_cpu = models(True, 2)
    want = chunked_reconstruct(att_cpu, dae_cpu, frames, NP)
    att, dae = att_cpu.cuda(), dae_cpu.cuda()
    with pytest.raises(ValueError, match="eval decode on the card"):
        chunked_reconstruct(att, dae, frames, NP)
    att.decoder.use_kernel = False
    dec0 = dk.fused_chunk_decode.launches
    got = chunked_reconstruct(att, dae, frames, NP)
    assert dk.fused_chunk_decode.launches == dec0
    np.testing.assert_allclose(got, want, atol=1e-4)
