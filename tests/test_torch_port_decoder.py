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
# rows (two blocks and padding on the TPU side; 37 ragged rows for the
# kernel's 8- and 16-row tiles)
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


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at the bench width
    (H=200, D=40, 20 steps) and ragged batches. Tolerance 1e-4: fp32
    sums in another order, carried through 20 recurrent steps."""
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
    for B in (6, 293, 1824):
        x0 = torch.randn(B, 40, generator=gen).cuda()
        h0 = torch.randn(2, B, 200, generator=gen).cuda()
        ys = dk.fused_chunk_decode(x0, h0, folded, 20)
        ref = dk.fused_chunk_decode_plain(x0, h0, folded, 20)
        torch.cuda.synchronize()
        assert (ys - ref).abs().max().item() < 1e-4
