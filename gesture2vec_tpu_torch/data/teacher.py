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

With a mesh (`parallel/mesh.make_mesh`, the JAX package's `mesh=`) a
sweep shards its corpus rows over every axis of the mesh: the batch
rounds up to a multiple of the mesh's size (as the JAX package's
`_sweep_setup` does), each superbatch splits into equal row chunks, and
the outputs are concatenated in row order (`Mesh.map_rows`: ranks run
their own chunk and gather; a plain process runs the rows whole). The
sweep is row-wise, so its tokens are the single sweep's and its latents
equal to rounding.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from gesture2vec_tpu_torch.device import module_device

def _padded_batches(a: np.ndarray, batch: int):
    """Batches of `batch` rows, the last one zero-padded."""
    n = a.shape[0]
    pad = (-n) % batch
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    for s in range(0, a.shape[0], batch):
        yield a[s:s + batch]


def _sweep(a: np.ndarray, batch: int, mesh, device: torch.device,
           fn: Callable[[torch.Tensor], Sequence[torch.Tensor]]
           ) -> List[np.ndarray]:
    """fn over the padded batches of a (each row-sharded over the mesh),
    its outputs concatenated and trimmed to a's rows."""
    if mesh is not None:
        split = mesh.row_split()
        batch = -(-batch // split) * split
    outs = []
    for b in _padded_batches(a, batch):
        x = torch.from_numpy(b).to(device)
        got = fn(x) if mesh is None else mesh.map_rows(fn, [x])
        outs.append([o.cpu().numpy() for o in got])
    return [np.concatenate(col)[:a.shape[0]] for col in zip(*outs)]


@torch.inference_mode()
def encode_frames_with_dae(dae_model, frames: np.ndarray, batch: int = 4096,
                           mesh=None) -> np.ndarray:
    """(N, motion_dim) normalized frames -> (N, latent_dim) DAE latents."""
    return _sweep(frames, batch, mesh, module_device(dae_model),
                  lambda x: (dae_model.encode(x),))[0]


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
    def fn(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = seq_model.encode_hidden(x)
        L, B, H = hidden.shape
        t = (seq_model.stage_tokens(hidden) if all_stages
             else seq_model.tokens_from_hidden(hidden))
        return t.to(torch.int32), hidden.transpose(0, 1).reshape(B, L * H)

    toks, lats = _sweep(latent_windows, batch, mesh,
                        module_device(seq_model), fn)
    return toks, lats


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
