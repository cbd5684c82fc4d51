"""PyTorch port vs the JAX package: the models on the decode path.

Same seeded numpy weights and inputs go through the JAX module and its
port (converted by compat/from_jax); tokens must be identical, floats
within 1e-5 (both sides fp32; sums run in another order).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat import from_jax

ATOL = 1e-5
HID, K, N_WORDS, EMB, MAXW, N_STEPS = 16, 24, 40, 12, 10, 6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(tree, rng, scale=0.3):
    """Random, non-default weights: every float leaf gets noise; BN
    variances stay positive."""
    def leaf(path, x):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if path and getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def t2t_pair():
    """A JAX Text2Token (TCN encoder, attention) with perturbed weights,
    and its port."""
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.optim import make_optimizer
    from gesture2vec_tpu.train.text2token_trainer import (init_state,
                                                          make_text2token)

    cfg = load_config(dict(name="t", model="seq2seq", hidden_size=HID,
                           n_layers=2, dropout_prob=0.2, epochs=1,
                           batch_size=8, sentence_frame_length=N_STEPS * 4,
                           n_poses=4, n_pre_poses=2, autoencoder_vq=True,
                           autoencoder_vq_components=K, autoencoder_att=True,
                           wordembed_dim=EMB, random_seed=0))
    model = make_text2token(cfg, N_WORDS)
    st = init_state(model, jax.random.PRNGKey(2), make_optimizer(1e-3),
                    max_words=MAXW)
    variables = perturb(_np_tree({"params": st.params,
                                  "batch_stats": st.batch_stats}),
                        np.random.default_rng(1))
    port = from_jax.text2token_from_jax(variables, n_steps=N_STEPS,
                                        n_pre_poses=2)
    return model, variables, port


def _text_batch(rng, B=5):
    lengths = rng.integers(1, MAXW + 1, size=B).astype(np.int32)
    ids = rng.integers(4, N_WORDS, size=(B, MAXW)).astype(np.int32)
    ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
    return ids, lengths


def test_tcn_encoder_matches_jax(t2t_pair, rng):
    model, variables, port = t2t_pair
    ids, lengths = _text_batch(rng)
    eo_j, dh_j = model.apply(variables, jnp.asarray(ids),
                             jnp.asarray(lengths), method=model.encode_text)
    with torch.no_grad():
        eo_t, dh_t = port.encode_text(torch.from_numpy(ids).long(),
                                      torch.from_numpy(lengths).long())
    assert eo_t.shape == eo_j.shape and dh_t.shape == dh_j.shape
    np.testing.assert_allclose(eo_t.numpy(), np.asarray(eo_j), atol=ATOL)
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_token_decoder_step_matches_jax(t2t_pair, rng, masked):
    model, variables, port = t2t_pair
    B, S = 4, MAXW
    token = rng.integers(0, K, size=B).astype(np.int32)
    hidden = rng.normal(size=(2, B, HID)).astype(np.float32)
    enc = rng.normal(size=(S, B, HID)).astype(np.float32)
    mask = np.arange(S) < (6 if masked else S)
    from gesture2vec_tpu.models.text2token import TokenDecoderStep
    step = TokenDecoderStep(hidden_size=HID, n_tokens=K, n_layers=2,
                            dropout_p=0.2, use_attention=True)
    lg_j, h_j, _ = step.apply(
        {"params": variables["params"]["decoder_step"],
         "batch_stats": variables["batch_stats"]["decoder_step"]},
        jnp.asarray(token), jnp.asarray(hidden), jnp.asarray(enc),
        train=False, enc_mask=jnp.asarray(mask))
    with torch.no_grad():
        lg_t, h_t = port.decoder_step(
            torch.from_numpy(token).long(), torch.from_numpy(hidden),
            torch.from_numpy(enc), enc_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)


def test_text2token_greedy_decode_matches_jax(t2t_pair, rng):
    model, variables, port = t2t_pair
    ids, lengths = _text_batch(rng, B=7)
    targets = rng.integers(0, K, size=(7, N_STEPS)).astype(np.int32)
    res_j = model.apply(variables, jnp.asarray(ids), jnp.asarray(lengths),
                        jnp.asarray(targets), train=False)
    with torch.no_grad():
        res_t = port(torch.from_numpy(ids).long(),
                     torch.from_numpy(lengths).long(),
                     torch.from_numpy(targets).long())
    toks = res_t["tokens"].numpy()
    np.testing.assert_array_equal(toks, np.asarray(res_j["tokens"]))
    # the teacher prefix (steps 1..n_pre) is fed, not emitted: steps past
    # it must show the model's own choices
    assert len(np.unique(toks[:, 2:])) > 1
    np.testing.assert_allclose(res_t["logits"].numpy(),
                               np.asarray(res_j["logits"]), atol=ATOL)


def test_gru_cell_stack_matches_jax(rng):
    from gesture2vec_tpu.models.gru import GRUCellStack as JaxStack

    from gesture2vec_tpu_torch.models.gru import GRUCellStack

    B, IN, H = 5, 7, 9
    x = rng.normal(size=(B, IN)).astype(np.float32)
    h = rng.normal(size=(2, B, H)).astype(np.float32)
    jm = JaxStack(hidden_size=H, n_layers=2)
    params = perturb(_np_tree(jm.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x), jnp.asarray(h))),
                     rng)
    out_j, h_j = jm.apply(params, jnp.asarray(x), jnp.asarray(h))
    tm = GRUCellStack(IN, H, 2)
    from_jax._gru(tm, params["params"])
    with torch.no_grad():
        out_t, h_t = tm(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)


@pytest.mark.parametrize("latent", [8, -2, -1])
def test_dae_decode_matches_jax(rng, latent):
    from gesture2vec_tpu.models.dae import DAE as JaxDAE

    dim = 12
    jm = JaxDAE(motion_dim=dim, latent_dim=latent)
    x = rng.normal(size=(6, dim)).astype(np.float32)
    variables = perturb(_np_tree(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    port = from_jax.dae_from_jax(variables, motion_dim=dim,
                                 latent_dim=latent)
    z_j = jm.apply(variables, jnp.asarray(x), method=jm.encode)
    z = np.array(z_j)
    y_j = jm.apply(variables, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        z_t = port.encode(torch.from_numpy(x))
        y_t = port.decode(torch.from_numpy(z))
    np.testing.assert_allclose(z_t.numpy(), z, atol=ATOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL)


def test_vocab_and_unnormalize_copies_match_jax(rng):
    from gesture2vec_tpu.data.datasets import unnormalize as jax_unnorm
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.text.vocab import normalize_string as jax_norm

    from gesture2vec_tpu_torch.data.datasets import unnormalize
    from gesture2vec_tpu_torch.text.vocab import Vocab, normalize_string

    text = "Shouldn't we, at 100 km/h -- go?!  Yes."
    assert normalize_string(text) == jax_norm(text)
    jv, tv = JaxVocab("a"), Vocab("a")
    words = normalize_string(text).split() + ["again", "we"]
    for w in words:
        jv.index_word(w)
        tv.index_word(w)
    probe = words + ["unseen"]
    assert tv.words_to_ids(probe) == jv.words_to_ids(probe)
    assert tv.words_to_ids(probe, add_sos_eos=False) == \
        jv.words_to_ids(probe, add_sos_eos=False)
    poses = rng.normal(size=(5, 4)).astype(np.float32)
    mean = rng.normal(size=4).astype(np.float32)
    std = np.array([0.001, 0.5, 2.0, 0.02], np.float32)
    np.testing.assert_array_equal(unnormalize(poses, mean, std),
                                  jax_unnorm(poses, mean, std))


_BANNED = {"jax", "flax", "optax", "yaml", "msgpack", "gesture2vec_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    """No file of the port, nor chip_smoke.py, imports JAX, flax, optax,
    yaml, msgpack or the JAX package (gesture2vec_tpu_torch is not a
    match: roots are compared whole)."""
    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "gesture2vec_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    names = {str(f.relative_to(root / "gesture2vec_tpu_torch"))
             for f in files[:-1]}
    assert {"models/baseline.py", "models/c2g.py", "models/gan.py",
            "train/misc_trainers.py", "train/gan_trainer.py",
            "infer/baseline_infer.py", "parallel/mesh.py",
            "parallel/launch.py", "parallel/pipeline.py",
            "parallel/dryrun.py", "cli/tools.py", "compat/torch_import.py",
            "text/sentence_embedding.py", "utils/profiling.py",
            "utils/flops.py"} <= names
    bad = [(str(f.relative_to(root)), m) for f in files
           for m in _imported_roots(f) if m in _BANNED]
    assert bad == []
