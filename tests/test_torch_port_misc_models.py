"""PyTorch port vs the JAX package: the baseline (Seq2SeqNet), c2g
(Cluster2Gesture) and the GAN's generator and discriminator.

Small widths (hidden 16, 2 layers, 8 word slots, 10 frames, pose 12),
weights from one JAX init carried across by `compat/from_jax`, inputs
from numpy seeds; JAX on the CPU.

- Forward, eval and train mode, within 1e-5: dropout 0.1 on both sides
  under one numpy mask stream (flax's Dropout and the port's dropout
  patched, as tests/test_torch_port_reconstruct.py's `_shared_masks`
  does), the BatchNorm statistics a train-mode forward leaves; c2g with
  parity_frozen_hidden off and on; c2g's eval rollout as the chunk
  decoder's plain version against JAX's eval.
- The weight bridge: the converters and `to_jax_variables` give back
  JAX's tree, `flax_init` the tree's layout.
- Checkpoints of the three kinds both ways (JAX writes, the port loads;
  the port writes, JAX loads): the same outputs.
- `generate_baseline` against JAX's on the same vocabulary and words.
- On the card (`gpu`, skipped here): the GRU sequence at the slice's
  shapes (T 32, 20 and 1 at B = 128) forward and backward, and c2g's
  rollout through the chunk-decoder kernel (B 128 and 512), each against
  its plain version within 1e-4. The JAX package is imported inside the
  CPU tests only (the card's machine has no flax).
"""
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import (
    baseline_from_jax, c2g_from_jax, flax_init, gan_discriminator_from_jax,
    gan_generator_from_jax, load_jax_variables, param_entries, to_jax_layout,
    to_jax_variables)
from gesture2vec_tpu_torch.models import gru as port_gru
from gesture2vec_tpu_torch.models import seq_ae as port_seq_ae
from gesture2vec_tpu_torch.train import gan_trainer as pgan
from gesture2vec_tpu_torch.train import misc_trainers as pmisc
from gesture2vec_tpu_torch.train.config import load_config

ATOL = 1e-5
NWORDS, MAXW, T, D, B, HID, NCL = 30, 8, 10, 12, 6, 16, 12
CFG = dict(name="misc", model="seq2seq", hidden_size=HID, n_layers=2,
           dropout_prob=0.1, epochs=2, batch_size=B, learning_rate=0.003,
           n_poses=T, n_pre_poses=2, wordembed_dim=12, noise_dim=8,
           autoencoder_vq_components=NCL, random_seed=0, loss_l1_weight=5,
           loss_cont_weight=0.1, loss_var_weight=0.5)
MODELS = ("baseline", "c2g", "c2g_frozen", "gan_g", "gan_d")


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, MAXW - 1, B).astype(np.int32)
    ids = rng.integers(4, NWORDS, (B, MAXW)).astype(np.int32)
    ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
    poses = rng.normal(size=(B, T, D)).astype(np.float32)
    return {"ids": ids, "lengths": lengths, "poses": poses,
            "clusters": rng.integers(0, NCL, B).astype(np.int32),
            "noise": rng.normal(size=(B, CFG["noise_dim"])).astype(
                np.float32)}


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_models():
    """{name: (JAX module, numpy variables)} from one init each."""
    import jax
    import jax.numpy as jnp

    from gesture2vec_tpu.models.c2g import Cluster2Gesture
    from gesture2vec_tpu.train import gan_trainer as jgan
    from gesture2vec_tpu.train import misc_trainers as jmisc
    from gesture2vec_tpu.train.config import load_config as jload

    cfg = jload(CFG)
    x = _inputs()
    key = jax.random.PRNGKey(0)
    toks, lens = jnp.asarray(x["ids"]), jnp.asarray(x["lengths"])
    base = jmisc.make_baseline(cfg, NWORDS, D)
    c2g = jmisc.make_c2g(cfg, D)
    g, d = jgan.build_gan(cfg, NWORDS, D)
    out = {"baseline": (base, base.init(key, toks, lens,
                                        jnp.asarray(x["poses"]))),
           "c2g": (c2g, c2g.init(key, jnp.asarray(x["clusters"]))),
           "gan_g": (g, g.init(key, toks, lens, jnp.asarray(x["noise"]),
                               jnp.asarray(x["poses"][:, 0]))),
           "gan_d": (d, d.init(key, toks, lens, jnp.asarray(x["poses"])))}
    # the quirk, on the same weights
    frozen = Cluster2Gesture(n_clusters=NCL, output_size=D, hidden_size=HID,
                             n_frames=T, n_layers=2, dropout=0.1,
                             parity_frozen_hidden=True)
    out["c2g_frozen"] = (frozen, out["c2g"][1])
    for k, (m, v) in out.items():
        # perturbed statistics, so eval mode reads something else than
        # the init's
        v = _np(v)
        for stats in _stats(v):
            stats["mean"] = (0.1 * np.random.default_rng(1).normal(
                size=stats["mean"].shape)).astype(np.float32)
            stats["var"] = (1.0 + 0.5 * np.random.default_rng(2).random(
                stats["var"].shape)).astype(np.float32)
        out[k] = (m, v)
    return out


def _stats(v):
    bs = v.get("batch_stats", {})
    return [s["pre_bn"] for s in bs.values()]


def _port_model(name):
    cfg = load_config(CFG)
    if name == "baseline":
        return pmisc.make_baseline(cfg, NWORDS, D)
    if name.startswith("c2g"):
        m = pmisc.make_c2g(cfg, D)
        m.parity_frozen_hidden = name == "c2g_frozen"
        return m
    g, d = pgan.build_gan(cfg, NWORDS, D)
    return g if name == "gan_g" else d


def _port(name, variables):
    m = _port_model(name)
    load_jax_variables(m, variables["params"], variables.get("batch_stats"))
    return m


def _run_jax(name, module, variables, x, train):
    import jax
    import jax.numpy as jnp

    toks, lens = jnp.asarray(x["ids"]), jnp.asarray(x["lengths"])
    args = {"baseline": (toks, lens, jnp.asarray(x["poses"])),
            "c2g": (jnp.asarray(x["clusters"]),),
            "c2g_frozen": (jnp.asarray(x["clusters"]),),
            "gan_g": (toks, lens, jnp.asarray(x["noise"]),
                      jnp.asarray(x["poses"][:, 0])),
            "gan_d": (toks, lens, jnp.asarray(x["poses"]))}[name]
    if not train:
        out, stats = module.apply(variables, *args, train=False), None
    else:
        out, mut = module.apply(variables, *args, train=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(5)})
        stats = _np(mut.get("batch_stats", {}))
    out = out["outputs"] if name == "baseline" else out
    return np.asarray(out), stats


def _run_port(name, model, x):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    toks, lens = t["ids"].long(), t["lengths"].long()
    with torch.no_grad():
        if name == "baseline":
            return model(toks, lens, t["poses"])["outputs"].numpy()
        if name.startswith("c2g"):
            return model(t["clusters"].long()).numpy()
        if name == "gan_g":
            return model(toks, lens, t["noise"], t["poses"][:, 0]).numpy()
        return model(toks, lens, t["poses"]).numpy()


def _masks(monkeypatch, seed):
    """Both packages' dropout from one numpy mask stream (the port's
    decoder-step and GRU sites)."""
    from tests.test_torch_port_reconstruct import _shared_masks

    streams = _shared_masks(monkeypatch, seed)
    monkeypatch.setattr(port_gru, "dropout", port_seq_ae.dropout)
    return streams


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(jax_models, name, mode, monkeypatch):
    """Outputs within 1e-5; in train mode under shared dropout masks, with
    the BatchNorm statistics the forward leaves."""
    module, variables = jax_models[name]
    x = _inputs(11)
    model = _port(name, variables)
    model.train(mode == "train")
    jax_s, port_s = _masks(monkeypatch, 21) if mode == "train" \
        else (None, None)
    want, stats = _run_jax(name, module, variables, x, mode == "train")
    got = _run_port(name, model, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if name.startswith("c2g"):
        np.testing.assert_array_equal(got[:, 0], 0.0)
    if mode == "train":
        assert jax_s.draws == port_s.draws > 0
        for path, bn in {p: b for p, b in _batch_norms(model)}.items():
            s = stats[path]["pre_bn"]
            np.testing.assert_allclose(bn.running_mean.numpy(), s["mean"],
                                       atol=ATOL)
            np.testing.assert_allclose(bn.running_var.numpy(), s["var"],
                                       atol=ATOL)


def _batch_norms(model):
    from gesture2vec_tpu_torch.compat.from_jax import batch_norms
    return [(path[0], bn) for path, bn in batch_norms(model).items()]


def test_c2g_eval_rollout_is_the_chunk_decoder(jax_models):
    """c2g's eval rollout is the chunk decoder's rollout from a zero seed:
    its plain version (`fused_chunk_decode_plain`, what the kernel is held
    to) over the folded step gives JAX's eval within 1e-5; the kernel
    admits the step, and the frozen-hidden quirk names its reason."""
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk

    module, variables = jax_models["c2g"]
    x = _inputs(12)
    want, _ = _run_jax("c2g", module, variables, x, False)
    model = _port("c2g", variables).eval()
    assert model.kernel_reason() == ""
    with torch.no_grad():
        _, h = model.pre_gru(model.embedding(
            torch.from_numpy(x["clusters"]).long())[None])
        ys = dk.fused_chunk_decode_plain(
            torch.zeros(B, D), h, dk.fold_decoder_step(model.step), T - 1)
    np.testing.assert_allclose(ys.transpose(0, 1).numpy(), want[:, 1:],
                               rtol=0, atol=ATOL)
    frozen = _port("c2g_frozen", variables)
    assert "parity_frozen_hidden" in frozen.kernel_reason()


def test_weight_bridge_round_trips(jax_models):
    """The converters read every width from the arrays; to_jax_variables
    gives back JAX's params and batch_stats exactly; flax_init lays out
    the same tree (paths and shapes) as JAX's init."""
    conv = {"baseline": lambda v: baseline_from_jax(v, n_frames=T,
                                                    n_pre_poses=2),
            "c2g": lambda v: c2g_from_jax(v, n_frames=T),
            "gan_g": lambda v: gan_generator_from_jax(v, n_frames=T),
            "gan_d": lambda v: gan_discriminator_from_jax(v["params"])}
    for name, fn in conv.items():
        _, v = jax_models[name]
        model = fn(v)
        back = to_jax_variables(model)
        for key in ("params", "batch_stats"):
            want, got = _flat(v.get(key, {})), _flat(back[key])
            assert sorted(got) == sorted(want), (name, key)
            for path, leaf in want.items():
                np.testing.assert_array_equal(got[path], leaf)
        fresh = _port_model(name)
        flax_init(fresh, torch.Generator().manual_seed(0))
        shapes = {tuple(p): to_jax_layout(t, layout).shape
                  for p, t, layout, _ in param_entries(fresh)}
        assert shapes == {p: np.shape(a) for p, a in
                          _flat(v["params"]).items()}


def _flat(tree):
    """{path as a tuple of keys: leaf}."""
    import jax
    return {tuple(k.key for k in p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _jax_write(path, name, variables, cfg):
    from gesture2vec_tpu.train import checkpoints as jckpt

    kind = {"baseline": "baseline", "c2g": "c2g",
            "gan_g": "text2embedding_gan"}[name]
    jckpt.save_checkpoint(path, config=cfg, epoch=1,
                          params=variables["params"], pose_dim=D,
                          extra={"batch_stats": variables["batch_stats"],
                                 "n_words": NWORDS}, kind=kind)
    return kind


@pytest.mark.parametrize("name", ["baseline", "c2g", "gan_g"])
def test_checkpoints_load_across_packages(jax_models, name, tmp_path):
    """A checkpoint of each kind written by the JAX package loads in the
    port, and one the port writes loads in the JAX package: both give
    the same eval outputs as the JAX model within 1e-5."""
    from gesture2vec_tpu.train import checkpoints as jckpt
    from gesture2vec_tpu.train.config import load_config as jload

    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.train import checkpoints as pckpt

    module, variables = jax_models[name]
    x = _inputs(13)
    want, _ = _run_jax(name, module, variables, x, False)
    path = str(tmp_path / "jax.bin")
    kind = _jax_write(path, name, variables, jload(CFG))
    model, _ = load_checkpoint_and_model(path, kind, "cpu")
    np.testing.assert_allclose(_run_port(name, model, x), want, rtol=0,
                               atol=ATOL)
    v = to_jax_variables(model)
    path = str(tmp_path / "port.bin")
    pckpt.save_checkpoint(path, config=load_config(CFG), epoch=1,
                          params=v["params"], pose_dim=D,
                          extra={"batch_stats": v["batch_stats"],
                                 "n_words": NWORDS}, kind=kind)
    jm, jv, payload = jckpt.load_checkpoint_and_model(path, kind)
    assert payload["kind"] == kind
    got, _ = _run_jax(name, jm, jv, x, False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_generate_baseline_matches_jax(jax_models):
    """The sliding-window baseline generation (seed carry, at most 8
    words a window, overlap 4, cross-fade, unnormalise) against JAX's on
    the same vocabulary and words."""
    from gesture2vec_tpu.infer.baseline_infer import \
        generate_baseline as jax_generate
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab

    from gesture2vec_tpu_torch.infer.baseline_infer import generate_baseline
    from gesture2vec_tpu_torch.text.vocab import Vocab

    module, variables = jax_models["baseline"]
    jvocab, vocab = JaxVocab("t"), Vocab("t")
    for i in range(NWORDS - 4):
        jvocab.index_word(f"w{i}")
        vocab.index_word(f"w{i}")
    rng = np.random.default_rng(14)
    words = [[f"w{rng.integers(40)}", k * 0.3, k * 0.3 + 0.2]
             for k in range(12)]
    mean = rng.normal(size=D).astype(np.float32)
    std = (0.5 + rng.random(D)).astype(np.float32)
    kw = dict(pose_mean=mean, pose_std=std, fps=20, max_words=MAXW,
              overlap=4)
    want = jax_generate(module, variables, jvocab, words, 2.2, **kw)
    got = generate_baseline(_port("baseline", variables), vocab, words, 2.2,
                            device="cpu", **kw)
    assert got.shape == (44, D)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


# -- on the card ------------------------------------------------------------
@pytest.mark.gpu
def test_misc_kernels_on_card_match_plain():
    """The slice's new kernel shapes on the card against the plain
    versions within 1e-4, over the port's own modules (flax_init from a
    seed): the GRU sequence forward (inference and gate-saving) and its
    gradient through `GRUSequenceFn` at T 32 (the text encoders' word
    window), 20 (the discriminator's pose GRU) and 1 (c2g's pre_gru) with
    B = 128, H = 200; c2g's eval rollout through the chunk-decoder kernel
    (B 128 and 512, 19 steps, D = 40) against its plain loop, and the
    frozen-hidden model, which launches no chunk decoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.ops import gru_kernel as gk

    g = torch.Generator(device="cuda").manual_seed(0)
    H = 200
    w_hh = (torch.rand(3 * H, H, device="cuda", generator=g) * 2 - 1) \
        / H ** 0.5
    b_hh = (torch.rand(3 * H, device="cuda", generator=g) * 2 - 1) / H ** 0.5
    for Tn in (32, 20, 1):
        xp = torch.randn(Tn, 128, 3 * H, device="cuda", generator=g)
        h0 = torch.randn(128, H, device="cuda", generator=g) * 0.5
        leaves = [t.clone().requires_grad_() for t in (xp, h0, w_hh, b_hh)]
        ys, h = gk.gru_sequence(*leaves)
        ys_p, h_p = gk.gru_sequence_plain(*leaves)
        dys, dh = torch.randn_like(ys), torch.randn_like(h)
        got = torch.autograd.grad((ys, h), leaves, (dys, dh))
        want = torch.autograd.grad((ys_p, h_p), leaves, (dys, dh))
        for a, b in zip((ys, h, *got), (ys_p, h_p, *want)):
            err = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
            assert err <= 1e-4, Tn
    cfg = load_config({**CFG, "hidden_size": H, "n_poses": 20,
                       "autoencoder_vq_components": 512})
    for frozen in (False, True):
        model = pmisc.init_misc(pmisc.make_c2g(cfg, 40), 0,
                                torch.device("cuda")).eval()
        model.parity_frozen_hidden = frozen
        for n in (128, 512):
            ids = torch.arange(n, device="cuda") % 512
            dk.fused_chunk_decode.launches = 0
            with torch.no_grad():
                out = model(ids)
                launches = dk.fused_chunk_decode.launches
                model.use_kernel = False
                plain = model(ids)
                model.use_kernel = True
            assert launches == (0 if frozen else 1)
            err = (out - plain).abs().max().item()
            assert err <= 1e-4 * max(plain.abs().max().item(), 1.0), n
