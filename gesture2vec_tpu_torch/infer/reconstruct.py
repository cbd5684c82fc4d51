"""Reconstruction round trips (Parts a and b).

Port of the JAX package's `infer/reconstruct.py`:
  dae_roundtrip        every frame through the DAE's encoder and decoder;
  chunked_reconstruct  the motion chunk by chunk through the frozen DAE
                       and the gesture tokenizer (encode, quantize,
                       decode), chunks optionally overlapping and
                       cross-faded linearly, the decoder optionally warmed
                       up first (the reference's `warmup_steps`
                       repeats of the first decode step).
Inputs and outputs are numpy; the models run on their own device.

The chunks run as one batch: the BiGRU encoder is 4 GRU-sequence
launches on the card (both layers: the attention reads the encoder
outputs), and the eval decode one chunk-decoder launch over all chunks.
With warm-up, the warm-up steps are plain decoder steps and the decode
after them is still the kernel's. A decoder the kernel does not compute
(`SeqDecoder.kernel_reason`: attention, a parity checkpoint's eval step
dropout) raises on the card unless the caller turned its kernel off
(`cli/reconstruct` decides from kernel_reason); its decode then runs in
plain PyTorch, as the JAX package's scan does. Under eval step dropout the
chunks run one at a time, each with its own dropout stream seeded 0 (JAX
seeds every chunk with PRNGKey(0): deterministic per chunk, not its
bits), shared by its warm-up and its decode; so do the chunks of a
`vq_flatten: torch_view` tokenizer (the JAX package's parity flattening
pairs the rows of a batch), one launch a chunk.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gesture2vec_tpu_torch.device import module_device


@torch.inference_mode()
def dae_roundtrip(dae_model, frames: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(T, D) normalized frames -> (reconstruction (T, D), latents)."""
    x = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(
        module_device(dae_model))
    z = dae_model.encode(x)
    return dae_model.decode(z).cpu().numpy(), z.cpu().numpy()


@torch.inference_mode()
def _roundtrip_chunks(seq_model, dae_model, x: torch.Tensor,
                      warmup_steps: int,
                      generator=None) -> torch.Tensor:
    """chunks (B, n_poses, D) -> their reconstruction, one batch."""
    B, T, D = x.shape
    lat = dae_model.encode(x.reshape(B * T, D)).reshape(B, T, -1)
    lat = lat.to(module_device(seq_model))
    enc_outs, hidden = seq_model.encode(lat)
    if seq_model.use_vq:
        _, hidden = seq_model.quantize(hidden)
    dec = seq_model.decoder
    if warmup_steps > 0:
        hidden = dec.warmup_hidden(hidden, lat[:, 0], enc_outs,
                                   warmup_steps, generator=generator)
    out = dec.decode(hidden, lat, enc_outs, generator=generator)
    return dae_model.decode(out.to(x.device))


def chunked_reconstruct(seq_model, dae_model, frames: np.ndarray,
                        n_poses: int, overlap: int = 0, blend: bool = True,
                        warmup_steps: int = 0) -> np.ndarray:
    """(T, D) normalized motion round-tripped through the Part-a and
    Part-b autoencoders, n_poses frames a chunk. overlap > 0 strides
    chunks by n_poses - overlap and cross-fades the overlapping frames
    linearly (blend); frames no chunk covers keep the input. seq_model is
    a SeqVQAutoencoder in eval mode."""
    T = frames.shape[0]
    stride = n_poses - overlap if overlap > 0 else n_poses
    starts = list(range(0, T - n_poses + 1, stride))
    if not starts:
        raise ValueError(f"motion shorter than one chunk ({T} < {n_poses})")
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack([frames[s:s + n_poses] for s in starts]),
        np.float32)).to(module_device(dae_model))
    dev = module_device(seq_model)
    dropout = seq_model.decoder.eval_step_dropout
    if dropout or seq_model.vq_flatten == "torch_view":
        # chunk by chunk: a dropout stream each, and torch_view's
        # flattening, which pairs the rows of a batch, sees one chunk
        chunks = torch.cat([_roundtrip_chunks(
            seq_model, dae_model, x[i:i + 1], warmup_steps,
            torch.Generator(device=dev).manual_seed(0) if dropout
            else None) for i in range(len(starts))])
    else:
        chunks = _roundtrip_chunks(seq_model, dae_model, x, warmup_steps)
    chunks = chunks.cpu().numpy()

    recon = np.zeros_like(frames)
    weight = np.zeros((T, 1))
    ramp = np.ones(n_poses)
    if blend and overlap > 0:
        ramp[:overlap] = np.linspace(0, 1, overlap, endpoint=False)
        ramp[-overlap:] = np.linspace(1, 0, overlap, endpoint=False)
    for s, chunk in zip(starts, chunks):
        recon[s:s + n_poses] += chunk * ramp[:, None]
        weight[s:s + n_poses] += ramp[:, None]
    covered = weight[:, 0] > 0
    recon[covered] /= weight[covered]
    recon[~covered] = frames[~covered]
    return recon
