"""Offline frozen-teacher encoding: the Part-c corpus sweep.

Port of the JAX package's `data/teacher.py`: batched sweeps of the
frozen Part-a DAE over frames and of the Part-b tokenizer over DAE-latent
windows, with the same batch sizes (4096 frames, 256 windows for the
DAE, 512 windows for the tokenizer) and zero padding of the last batch.
Inputs and outputs are numpy; each batch runs on the model's device.

The tokenizer needs only the decoder-initial hidden, so the sweep runs
only the GRU layers that hidden holds (`SeqVQAutoencoder.encode_hidden`:
layer 0 at 2 layers), as XLA does when it drops the unused encoder
outputs under jit: two GRU-kernel launches (forward and reverse) per
batch at 2 layers.

`window_teacher` is the frozen DAE as a streaming source's transform
(`data/streaming.StreamingWindows`): it runs in the prefetch worker and
hands the training step device tensors.

Scale-out over several cards (`mesh=` in the JAX package) is not ported
yet (ROADMAP.md queue A, scale-out).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from gesture2vec_tpu_torch.device import module_device

_MESH = "mesh= is not ported yet (the scale-out slice of the PyTorch port)"


def _padded_batches(a: np.ndarray, batch: int):
    """Batches of `batch` rows, the last one zero-padded."""
    n = a.shape[0]
    pad = (-n) % batch
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    for s in range(0, a.shape[0], batch):
        yield a[s:s + batch]


@torch.inference_mode()
def encode_frames_with_dae(dae_model, frames: np.ndarray, batch: int = 4096,
                           mesh=None) -> np.ndarray:
    """(N, motion_dim) normalized frames -> (N, latent_dim) DAE latents."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    dev = module_device(dae_model)
    outs = [dae_model.encode(torch.from_numpy(b).to(dev)).cpu().numpy()
            for b in _padded_batches(frames, batch)]
    return np.concatenate(outs, axis=0)[:frames.shape[0]]


def encode_windows_with_dae(dae_model, windows: np.ndarray, batch: int = 256,
                            mesh=None) -> np.ndarray:
    """(N, T, motion_dim) -> (N, T, latent_dim)."""
    N, T, D = windows.shape
    flat = encode_frames_with_dae(dae_model, windows.reshape(N * T, D),
                                  batch=batch * T, mesh=mesh)
    return flat.reshape(N, T, -1)


@torch.inference_mode()
def tokenize_windows(seq_model, latent_windows: np.ndarray, batch: int = 512,
                     mesh=None, all_stages: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, T, rep_dim) DAE-latent windows -> (tokens (N,) int32, sequence
    latents (N, L*H), the decoder-initial hidden flattened per window).

    all_stages (residual-VQ tokenizers only): tokens come back (N, S),
    one column per stage, column 0 the pipeline token."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    dev = module_device(seq_model)
    toks, lats = [], []
    for b in _padded_batches(latent_windows, batch):
        hidden = seq_model.encode_hidden(torch.from_numpy(b).to(dev))
        L, B, H = hidden.shape
        lats.append(hidden.transpose(0, 1).reshape(B, L * H).cpu().numpy())
        if all_stages:
            t = seq_model.stage_tokens(hidden)
        else:
            t = seq_model.tokens_from_hidden(hidden)
        toks.append(t.cpu().numpy().astype(np.int32))
    n = latent_windows.shape[0]
    return np.concatenate(toks)[:n], np.concatenate(lats)[:n]


def window_teacher(dae_model) -> Callable[[np.ndarray], torch.Tensor]:
    """A StreamingWindows transform: (B, T, motion_dim) normalized windows
    -> (B, T, latent_dim) latents of the frozen DAE (in eval mode), a
    tensor on the DAE's device, so no batch makes a round trip to the
    host. Grad mode is per thread, so the transform turns it off itself;
    it uses no_grad rather than inference_mode, since the latents then
    enter the training step's graph as inputs."""
    dev = module_device(dae_model)

    def transform(batch: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
            B, T, D = x.shape
            return dae_model.encode(x.to(dev).reshape(B * T, D)).reshape(
                B, T, -1)
    return transform
