"""PyTorch port vs the JAX package: the tokenizer's encoder, quantizers
and the GRU-sequence and VQ-argmin kernels.

The port's plain `gru_sequence` and `vq_argmin` (what the CUDA kernels
compute, and what the wrappers run on CPU tensors) are held against the
JAX Pallas kernels in interpret mode and their jnp references, as
tests/test_pallas_ops.py holds the Pallas kernels. The encoder and the
quantizers get the same seeded numpy weights and inputs as their JAX
modules: tokens identical, floats within 1e-5 (fp32 on both sides, sums
in another order). The kernels themselves run only on the card (the
`gpu`-marked tests).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import seq_ae_from_jax
from gesture2vec_tpu_torch.models import gru as port_gru
from gesture2vec_tpu_torch.models import vq as port_vq
from gesture2vec_tpu_torch.ops import gru_kernel as gk
from gesture2vec_tpu_torch.ops import vq_kernel as vk

ATOL = 1e-5
HID, L, K, REP, NP = 16, 2, 32, 8, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def perturb(tree, rng, scale=0.3):
    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def _seq_model(variant, parity):
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.optim import make_optimizer
    from gesture2vec_tpu.train.seq_ae_trainer import init_state, make_seq_ae

    cfg = load_config(dict(name="s", model="seq2seq", hidden_size=HID,
                           n_layers=L, dropout_prob=0.1, epochs=1,
                           batch_size=8, rep_learning_dim=REP, n_poses=NP,
                           n_pre_poses=1, autoencoder_vq=True,
                           autoencoder_vq_components=K,
                           autoencoder_vq_variant=variant, rvq_stages=3,
                           random_seed=0))
    model = make_seq_ae(cfg, parity=parity)
    st = init_state(cfg, model, jax.random.PRNGKey(0), make_optimizer(1e-3))
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": st.params, "batch_stats": st.batch_stats})
    variables = perturb(variables, np.random.default_rng(5))
    port = seq_ae_from_jax(variables, n_frames=NP,
                           vq_flatten="torch_view" if parity
                           else "per_sample")
    return model, variables, port


def _gru_weights(rng, H, D):
    return [rng.normal(size=s).astype(np.float32) * 0.3
            for s in ((3 * H, D), (3 * H, H), (3 * H,), (3 * H,))]


# (T, B, H, D): the JAX kernel test's shape, and a ragged batch
GRU_CASES = [(20, 32, 64, 48), (7, 13, 16, 8)]


@pytest.mark.parametrize("T,B,H,D", GRU_CASES)
def test_gru_sequence_plain_matches_jax_kernel_and_scan(rng, T, B, H, D):
    from gesture2vec_tpu.models.gru import gru_layer
    from gesture2vec_tpu.ops.gru_pallas import gru_sequence_fused

    xs = rng.normal(size=(T, B, D)).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    w_ih, w_hh, b_ih, b_hh = _gru_weights(rng, H, D)
    x_proj = xs @ w_ih.T + b_ih
    ys_k, h_k = gru_sequence_fused(jnp.asarray(x_proj), jnp.asarray(h0),
                                   jnp.asarray(w_hh), jnp.asarray(b_hh),
                                   interpret=True)
    ys_p, h_p = gk.gru_sequence(_t(x_proj), _t(h0), _t(w_hh), _t(b_hh))
    np.testing.assert_allclose(ys_p.numpy(), np.asarray(ys_k), atol=ATOL)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_k), atol=ATOL)
    for reverse in (False, True):
        ys_j, h_j = gru_layer(*map(jnp.asarray, (xs, h0, w_ih, w_hh, b_ih,
                                                  b_hh)), reverse=reverse)
        ys_p, h_p = gk.gru_sequence(_t(x_proj), _t(h0), _t(w_hh), _t(b_hh),
                                    reverse=reverse)
        np.testing.assert_allclose(ys_p.numpy(), np.asarray(ys_j),
                                   atol=ATOL)
        np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=ATOL)
        ys_l, h_l = port_gru.gru_layer(_t(xs), _t(h0), *map(
            _t, (w_ih, w_hh, b_ih, b_hh)), reverse=reverse)
        np.testing.assert_allclose(ys_l.numpy(), np.asarray(ys_j),
                                   atol=ATOL)
        np.testing.assert_allclose(h_l.numpy(), np.asarray(h_j), atol=ATOL)


def test_bigru_matches_jax(rng):
    from gesture2vec_tpu.models.gru import BiGRU as JaxBiGRU

    T, B, D, H = 9, 5, 7, 6
    xs = rng.normal(size=(T, B, D)).astype(np.float32)
    jm = JaxBiGRU(hidden_size=H, n_layers=3)
    v = perturb(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(xs))), rng)
    out_j, h_j = jm.apply(v, jnp.asarray(xs))
    tm = port_gru.BiGRU(D, H, 3)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            p.copy_(_t(v["params"][name]))
        out_t, h_t = tm(_t(xs))
        _, h_1 = tm(_t(xs), n_run=1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    assert h_t.shape == (6, B, H) and h_1.shape == (2, B, H)
    np.testing.assert_array_equal(h_1.numpy(), h_t[:2].numpy())


@pytest.mark.parametrize("n,k,d", [(300, 128, 64), (37, 300, 40)])
def test_vq_argmin_plain_matches_jax_kernel(rng, n, k, d):
    from gesture2vec_tpu.models.vq import codebook_distances
    from gesture2vec_tpu.ops.vq_pallas import vq_argmin

    x = rng.normal(size=(n, d)).astype(np.float32)
    cb = rng.normal(size=(k, d)).astype(np.float32)
    idx_j, dmin_j = vq_argmin(jnp.asarray(x), jnp.asarray(cb),
                              interpret=True)
    idx, dmin = vk.vq_argmin(_t(x), _t(cb))
    assert idx.dtype == torch.int64 and idx.shape == (n,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(dmin.numpy(), np.asarray(dmin_j), atol=1e-3)
    d_ref = np.asarray(codebook_distances(jnp.asarray(x), jnp.asarray(cb)))
    np.testing.assert_allclose(vk.codebook_distances(_t(x), _t(cb)).numpy(),
                               d_ref, atol=1e-3)


def test_vq_argmin_takes_the_first_index_on_ties():
    x = torch.zeros(3, 4)
    cb = torch.tensor([[1., 0, 0, 0], [0, 1, 0, 0], [1, 0, 0, 0]])
    idx, dmin = vk.vq_argmin(x, cb)
    assert idx.tolist() == [0, 0, 0] and dmin.tolist() == [1.0] * 3


def test_wrappers_reject_bad_inputs_and_count_no_cpu_launch():
    x_proj, h0 = torch.zeros(4, 3, 12), torch.zeros(3, 4)
    w_hh, b_hh = torch.zeros(12, 4), torch.zeros(12)
    with pytest.raises(ValueError, match="h0: shape"):
        gk.gru_sequence(x_proj, torch.zeros(2, 4), w_hh, b_hh)
    with pytest.raises(ValueError, match="dtype"):
        gk.gru_sequence(x_proj.double(), h0, w_hh, b_hh)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gru_sequence(x_proj, torch.zeros(4, 3).t(), w_hh, b_hh)
    with pytest.raises(ValueError, match="empty"):
        gk.gru_sequence(torch.zeros(0, 3, 12), h0, w_hh, b_hh)
    with pytest.raises(ValueError, match="shared memory"):
        big = 233                # the w_hh slice and state pass 227 KB
        gk.gru_sequence(torch.empty(1, 1, 3 * big), torch.empty(1, big),
                        torch.empty(3 * big, big), torch.empty(3 * big))
    x, cb = torch.zeros(5, 4), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="want \\(N, D\\)"):
        vk.vq_argmin(x, torch.zeros(3, 5))
    with pytest.raises(ValueError, match="dtype"):
        vk.vq_argmin(x.double(), cb)
    with pytest.raises(ValueError, match="contiguous"):
        vk.vq_argmin(torch.zeros(4, 5).t(), cb)
    with pytest.raises(ValueError, match="empty"):
        vk.vq_argmin(torch.zeros(0, 4), cb)
    with pytest.raises(ValueError, match="shared memory"):
        vk.vq_argmin(torch.zeros(2, 1669), torch.zeros(3, 1669))
    before = (gk.gru_sequence.launches, vk.vq_argmin.launches)
    gk.gru_sequence(x_proj, h0, w_hh, b_hh)
    vk.vq_argmin(x, cb)
    assert (gk.gru_sequence.launches, vk.vq_argmin.launches) == before


# (kernel, rows, width, what the launch must be): the tokenizer's GRU
# batches at H=200 and the first H past the shared-memory limit; K-Means'
# and the residual-VQ sweep's row counts at D=400, the DAE latent width,
# a wide D, and the first D past the limit
LAUNCH_CASES = [("gru", 1, 200, 1), ("gru", 7, 200, 1),
                ("gru", 512, 200, 1), ("gru", 512, 233, ValueError),
                ("vq", 58488, 400, 128), ("vq", 512, 400, 32),
                ("vq", 58488, 40, 128), ("vq", 58488, 1024, 32),
                ("vq", 58488, 1669, ValueError)]


@pytest.mark.parametrize("kind,n,width,want", LAUNCH_CASES)
def test_launch_shapes_fit_one_h100_or_raise(kind, n, width, want):
    """The wrappers' mirrors of the kernels' launch arithmetic: GRU
    clusters at H=200 fit one wave at B=512 (26 clusters of 4 blocks, the
    card holding 30); VQ takes the tallest block that still gives all 132
    SMs a block; both raise ValueError past their shared memory."""
    helper = gk.launch_shape if kind == "gru" else vk.launch_shape
    if want is ValueError:
        with pytest.raises(ValueError, match="shared memory"):
            helper(n, width)
        return
    shape = helper(n, width)
    assert shape["smem_bytes"] <= 232448 and shape["threads"] <= 512
    assert shape["threads"] % 32 == 0
    if kind == "gru":
        assert shape["waves"] == want and shape["blocks"] <= 132
        assert shape["rows"] * shape["clusters"] >= n > \
            shape["rows"] * (shape["clusters"] - 1)
    else:
        assert shape["block_rows"] == want
        assert shape["blocks"] == -(-n // want)


def test_gssoft_probs_match_jax_including_the_clamp(rng):
    from gesture2vec_tpu.models.vq import gssoft_probs

    d = np.abs(rng.normal(size=(6, 10)).astype(np.float32)) * 400
    z = rng.normal(size=(6, 10)).astype(np.float32) * 3
    z[0, :3] = [40.0, -40.0, 15.1]              # beyond the +-30 clamp
    want = np.asarray(gssoft_probs(jnp.asarray(d), jnp.asarray(z)))
    got = port_vq.gssoft_probs(_t(d), _t(z)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


SEQ_CASES = [("gssoft", False), ("gssoft", True), ("rvq", False),
             ("rvq", True)]


@pytest.mark.parametrize("variant,parity", SEQ_CASES)
def test_encode_and_quantize_match_jax(rng, variant, parity):
    model, v, port = _seq_model(variant, parity)
    x = rng.normal(size=(10, NP, REP)).astype(np.float32)
    eo_j, dh_j = model.apply(v, jnp.asarray(x), method=model.encode)
    vq_j, nh_j = model.apply(v, dh_j, method=model.quantize)
    tok_j = np.asarray(model.apply(v, dh_j, method=model.tokens_from_hidden))
    with torch.no_grad():
        eo_t, dh_t = port.encode(_t(x))
        vq_t, nh_t = port.quantize(dh_t)
        tok_t = port.tokens_from_hidden(dh_t).numpy()
        dh_fast = port.encode_hidden(_t(x))
    np.testing.assert_allclose(eo_t.numpy(), np.asarray(eo_j), atol=ATOL)
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), atol=ATOL)
    np.testing.assert_array_equal(dh_fast.numpy(), dh_t.numpy())
    np.testing.assert_array_equal(tok_t, tok_j)
    assert len(np.unique(tok_t)) > 1
    for a, b in ((vq_t.quantized, vq_j.quantized), (nh_t, nh_j),
                 (vq_t.encodings, vq_j.encodings)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(vq_t.loss.item(), float(vq_j.loss),
                               rtol=ATOL)
    np.testing.assert_allclose(vq_t.perplexity.item(),
                               float(vq_j.perplexity), rtol=ATOL)
    if variant == "rvq":
        st_j = np.asarray(model.apply(v, dh_j, method=model.stage_tokens))
        with torch.no_grad():
            st_t = port.stage_tokens(dh_t)
            emb = port.vq_layer.embed_stage_tokens(st_t[:, :2])
        np.testing.assert_array_equal(st_t.numpy(), st_j)
        hid_j = model.apply(v, jnp.asarray(st_j[:, :2]),
                            method=model.hidden_from_stage_tokens)
        from gesture2vec_tpu_torch.models.seq_ae import _unflatten_hidden
        hid_t = _unflatten_hidden(emb, (L, 10, HID), port.vq_flatten)
        np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                                   atol=ATOL)
    else:
        with pytest.raises(ValueError, match="rvq"):
            port.stage_tokens(dh_t)


def test_plain_route_matches_kernel_route_on_cpu(rng):
    """set_use_kernels(False) (the card's plain path) computes the same
    values as the wrappers' CPU route."""
    _, _, port = _seq_model("rvq", False)
    x = _t(rng.normal(size=(6, NP, REP)).astype(np.float32))
    with torch.no_grad():
        a = port.stage_tokens(port.encode_hidden(x))
        port.set_use_kernels(False)
        try:
            b = port.stage_tokens(port.encode_hidden(x))
        finally:
            port.set_use_kernels(True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_unported_options_raise():
    from gesture2vec_tpu_torch.models.seq_ae import (SeqVQAutoencoder,
                                                     _flatten_hidden)

    # the transformer chunk encoder is ported; an unknown one is refused
    from gesture2vec_tpu_torch.models.seq_encoder import \
        TransformerSeqEncoder
    assert isinstance(SeqVQAutoencoder(8, 16, 2, 8,
                                       encoder_arch="transformer").encoder,
                      TransformerSeqEncoder)
    with pytest.raises(ValueError, match="encoder_arch"):
        SeqVQAutoencoder(8, 16, 2, 8, encoder_arch="conv")
    # the VAE heads are ported (over the L*H hidden); an unknown
    # quantizer is refused
    vae = SeqVQAutoencoder(8, 16, 2, 8, use_vae=True)
    assert vae.vae_mean.weight.shape == (32, 32)
    with pytest.raises(ValueError, match="vq_variant"):
        SeqVQAutoencoder(8, 16, 2, 8, vq_variant="bogus")
    with pytest.raises(ValueError, match="vq_flatten"):
        SeqVQAutoencoder(8, 16, 2, 8, vq_flatten="bogus")
    with pytest.raises(ValueError, match="vq_flatten"):
        _flatten_hidden(torch.zeros(2, 3, 4), "bogus")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.gpu
def test_gru_kernel_matches_plain_on_card():
    """At the tokenizer width (T=20, H=200), forward and reverse, batches
    that fill one row of a cluster, part of one, and many (the kernel
    takes 20 rows per cluster); and at H=201, which the kernel stages
    with 4-byte copies. Tolerance 1e-4: fp32 sums in another order over
    20 recurrent steps."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for H, batches in ((200, (1, 17, 300, 512)), (201, (17, 300))):
        bnd = 1.0 / H ** .5
        w = (torch.rand(3 * H, H, device="cuda", generator=g) * 2 - 1) * bnd
        b = (torch.rand(3 * H, device="cuda", generator=g) * 2 - 1) * bnd
        for B in batches:
            xp = torch.randn(20, B, 3 * H, device="cuda", generator=g)
            h0 = torch.randn(B, H, device="cuda", generator=g)
            for reverse in (False, True):
                ys, h = gk.gru_sequence(xp, h0, w, b, reverse)
                ys_p, h_p = gk.gru_sequence_plain(xp, h0, w, b, reverse)
                torch.cuda.synchronize()
                assert (ys - ys_p).abs().max().item() < 1e-4
                assert (h - h_p).abs().max().item() < 1e-4


@pytest.mark.gpu
def test_vq_kernel_matches_plain_on_card():
    """Indices equal except at near-ties (plain distances within 1e-3),
    minima within 1e-3: row counts that are no multiple of any block
    height (32, 64, 128), code counts below, inside and past a 64-code
    tile, the DAE latent and tokenizer widths; D=401 and rows at an
    address that is not 16-byte aligned, which the kernel stages with
    4-byte copies; and exact ties between identical codes in two code
    tiles, where the lower index wins."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, k, d, offset in ((4099, 7, 40, 0), (4099, 300, 40, 0),
                            (4099, 513, 40, 0), (58488, 300, 400, 0),
                            (4099, 513, 400, 0), (10, 7, 400, 0),
                            (4099, 300, 401, 0), (4099, 300, 400, 1)):
        x = torch.randn(n * d + offset, device="cuda",
                        generator=g)[offset:].view(n, d)
        cb = torch.randn(k, d, device="cuda", generator=g)
        idx, dmin = vk.vq_argmin(x, cb)
        dist = vk.codebook_distances(x, cb)
        dmin_p, idx_p = dist.min(dim=1)
        torch.cuda.synchronize()
        diff = (idx != idx_p).nonzero()[:, 0]
        gap = (dist[diff, idx[diff]] - dist[diff, idx_p[diff]]).abs()
        assert (gap <= 1e-3).all()
        assert (dmin - dmin_p).abs().max().item() < 1e-3
    cb = torch.randn(300, 400, device="cuda", generator=g)
    cb[64], cb[200] = cb[63], cb[130]
    near = torch.tensor([63] * 50 + [130] * 50, device="cuda")
    x = cb[near] + 0.01 * torch.randn(100, 400, device="cuda", generator=g)
    idx, _ = vk.vq_argmin(x, cb)
    assert torch.equal(idx, near)
