"""PyTorch port vs the JAX package: the fused chunk decoder.

The port's plain `fused_chunk_decode` (what the CUDA kernel computes,
and what the wrapper runs on CPU tensors) is held against the JAX
Pallas kernel in interpret mode and against `seq_ae.decode`, as
tests/test_pallas_ops.py holds the Pallas kernel, including a batch of
more than one JAX grid block. Tolerance 1e-5: both sides are fp32.
The kernel itself runs only on the card (the `gpu`-marked test).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import seq_decoder_from_jax
from gesture2vec_tpu_torch.ops import decoder_kernel as dk

ATOL = 1e-5


def perturb(tree, rng, scale=0.3):
    """Random, non-default weights: every float leaf gets noise; BN
    variances stay positive (so the BN fold is exercised)."""
    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def _seq_model(hid, rep, n_poses):
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.optim import make_optimizer
    from gesture2vec_tpu.train.seq_ae_trainer import init_state, make_seq_ae

    cfg = load_config(dict(name="f", model="seq2seq", hidden_size=hid,
                           n_layers=2, dropout_prob=0.1, epochs=1,
                           batch_size=8, rep_learning_dim=rep,
                           n_poses=n_poses, n_pre_poses=1,
                           autoencoder_vq=True, autoencoder_vq_components=8,
                           random_seed=0))
    model = make_seq_ae(cfg)
    st = init_state(cfg, model, jax.random.PRNGKey(0), make_optimizer(1e-3))
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": st.params, "batch_stats": st.batch_stats})
    return model, perturb(variables, np.random.default_rng(3))


# (hidden, rep_dim, n_poses, B): one JAX grid block, then BLOCK + 37
# rows (two blocks and padding on the TPU side; ragged against the CUDA
# kernel's tiles of at most 8 rows)
CASES = [(32, 16, 10, 6), (16, 8, 6, 256 + 37)]


@pytest.mark.parametrize("hid,rep,n_poses,B", CASES)
def test_plain_matches_jax_kernel_and_decode(rng, hid, rep, n_poses, B):
    from gesture2vec_tpu.ops.decoder_pallas import fused_chunk_decode

    model, variables = _seq_model(hid, rep, n_poses)
    h0 = rng.normal(size=(2, B, hid)).astype(np.float32)
    seed = rng.normal(size=(B, rep)).astype(np.float32)

    ref = model.apply(variables, jnp.asarray(h0),
                      jnp.tile(jnp.asarray(seed)[:, None, :],
                               (1, n_poses, 1)), None, method=model.decode)
    ref = np.asarray(ref)[:, 1:, :]     # drop the copied seed frame
    ys_j = np.asarray(fused_chunk_decode(
        jnp.asarray(seed), jnp.asarray(h0),
        variables["params"]["decoder_step"],
        variables["batch_stats"]["decoder_step"], n_steps=n_poses - 1,
        interpret=True))

    port = seq_decoder_from_jax(variables, n_frames=n_poses - 1)
    folded = dk.fold_decoder_step(port.decoder_step)
    ys_t = dk.fused_chunk_decode(torch.from_numpy(seed),
                                 torch.from_numpy(h0), folded,
                                 n_steps=n_poses - 1).numpy()
    assert ys_t.shape == ys_j.shape == (n_poses - 1, B, rep)
    np.testing.assert_allclose(ys_t, ys_j, atol=ATOL)
    np.testing.assert_allclose(np.transpose(ys_t, (1, 0, 2)), ref,
                               atol=ATOL)


def test_plain_matches_module_rollout(rng):
    """The folded plain loop and SeqDecoder.rollout (the unfused path the
    generator takes with use_fused_decoder=False) agree."""
    _, variables = _seq_model(16, 8, 6)
    port = seq_decoder_from_jax(variables, n_frames=7)
    h0 = torch.from_numpy(rng.normal(size=(2, 11, 16)).astype(np.float32))
    seed = torch.from_numpy(rng.normal(size=(11, 8)).astype(np.float32))
    with torch.no_grad():
        roll = port.rollout(h0, seed)
    ys = dk.fused_chunk_decode(seed, h0,
                               dk.fold_decoder_step(port.decoder_step), 7)
    np.testing.assert_allclose(ys.transpose(0, 1).numpy(), roll.numpy(),
                               atol=ATOL)


def test_wrapper_rejects_bad_inputs():
    from gesture2vec_tpu_torch.models.seq_ae import DecoderStep

    folded = dk.fold_decoder_step(DecoderStep(8, 16, 2).eval())
    x0, h0 = torch.zeros(4, 8), torch.zeros(2, 4, 16)
    with pytest.raises(ValueError, match="h0: shape"):
        dk.fused_chunk_decode(x0, torch.zeros(2, 3, 16), folded, 5)
    with pytest.raises(ValueError, match="dtype"):
        dk.fused_chunk_decode(x0.double(), h0, folded, 5)
    with pytest.raises(ValueError, match="contiguous"):
        dk.fused_chunk_decode(torch.zeros(8, 4).t(), h0, folded, 5)
    with pytest.raises(ValueError, match="empty"):
        dk.fused_chunk_decode(torch.zeros(0, 8), torch.zeros(2, 0, 16),
                              folded, 5)
    before = dk.fused_chunk_decode.launches
    dk.fused_chunk_decode(x0, h0, folded, 5)
    assert dk.fused_chunk_decode.launches == before  # CPU: plain version


def test_supported_names_the_reason():
    from gesture2vec_tpu_torch.models.seq_ae import DecoderStep

    assert dk.supported(DecoderStep(40, 200, 2)) == ""
    assert "2 GRU layers" in dk.supported(DecoderStep(40, 200, 1))
    assert "conditioned" in dk.supported(DecoderStep(40, 200, 2,
                                                     conditioned=False))
    assert "shared memory" in dk.supported(DecoderStep(40, 2000, 2))
    # the 16-block cluster's shared memory takes H <= 204 at D=40
    assert "shared memory" in dk.supported(DecoderStep(40, 205, 2))
    assert dk.supported(DecoderStep(40, 204, 2)) == ""


# (B, H, what the launch must be): the decode path's batches and every
# tile edge at H=200, D=40 (rows per tile when the card holds 7 clusters);
# the first H past the shared-memory limit
LAUNCH_CASES = [(1, 200, 1), (6, 200, 1), (7, 200, 1), (8, 200, 2),
                (9, 200, 2), (96, 200, 7), (293, 200, 7), (1824, 200, 8),
                (6, 204, 1), (6, 205, ValueError)]


@pytest.mark.parametrize("B,H,rows", LAUNCH_CASES)
def test_launch_shape_fits_one_h100_or_raises(B, H, rows):
    """The wrapper's mirror of the kernel's launch arithmetic: 16-block
    clusters of 512 threads whose tiles cover the batch exactly once, a
    persistent grid of at most the clusters the card holds, shared memory
    within one block's 232,448 bytes; past it, ValueError."""
    if rows is ValueError:
        with pytest.raises(ValueError, match="shared memory"):
            dk.launch_shape(B, H, 40, max_clusters=7)
        return
    shape = dk.launch_shape(B, H, 40, max_clusters=7)
    assert shape["rows"] == rows <= 8
    assert shape["rows"] * shape["tiles"] >= B > \
        shape["rows"] * (shape["tiles"] - 1)
    assert shape["smem_bytes"] <= 232448
    assert shape["threads"] % 32 == 0 and shape["cluster"] == 16
    assert shape["clusters"] == min(shape["tiles"], 7)
    assert shape["rounds"] * shape["clusters"] >= shape["tiles"]


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at the bench width
    (H=200, D=40, 20 steps) at every tile edge and with more tiles than
    the card's clusters (the persistent walk), and once with x0 and h0 at
    an address that is not 16-byte aligned. Tolerance 1e-4: fp32 sums in
    another order, carried through 20 recurrent steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder

    gen = torch.Generator().manual_seed(0)
    dec = SeqDecoder(40, 200, 2, 20, 8)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) * 0.14 - 0.07)
        bn = dec.decoder_step.pre_bn
        bn.running_mean.copy_(torch.randn(200, generator=gen) * 0.1)
        bn.running_var.copy_(torch.rand(200, generator=gen) + 0.5)
    folded = dk.FoldedDecoder(*(t.cuda() for t in
                                dk.fold_decoder_step(dec.decoder_step)))
    for B, offset in [(B, 0) for B in (1, 6, 7, 8, 9, 96, 293, 1824)] + \
            [(293, 1)]:
        x0 = torch.randn(B * 40 + offset, generator=gen).cuda()[
            offset:].view(B, 40)
        h0 = torch.randn(2 * B * 200 + offset, generator=gen).cuda()[
            offset:].view(2, B, 200)
        ys = dk.fused_chunk_decode(x0, h0, folded, 20)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, 20)
        torch.cuda.synchronize()
        assert (ys - ref).abs().max().item() < 1e-4
