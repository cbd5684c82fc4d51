"""Part c - the corpus latent dataset (the clustering / exemplar
substrate).

Port of the JAX package's `cluster/latent_dataset.py`: every corpus
window is recorded with its frame-level DAE latents, its sequence latent
(the decoder-initial hidden) and its gesture token, saved as npz with
the same keys. `decode_codebook` decodes the whole codebook to motion in
one eval decode (one chunk-decoder launch at B = codes on the card), and
`export_cluster_samples` writes the first windows of each token as BVH
files (one batched DAE decode, then the host's BVH writer).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from gesture2vec_tpu_torch.data.datasets import pose_windows, unnormalize
from gesture2vec_tpu_torch.device import module_device
from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                tokenize_windows)
from gesture2vec_tpu_torch.io.bvh import write_bvh


def build_latent_dataset(store, *, dae_model, seq_model, n_poses: int = 20,
                         stride: int = 5, mean: Optional[np.ndarray] = None,
                         std: Optional[np.ndarray] = None,
                         all_stages: bool = False
                         ) -> Dict[str, np.ndarray]:
    """{windows (N, T, D) normalized, dae_latents (N, T, R), tokens (N,)
    int32 ((N, S) with all_stages), seq_latents (N, L*H)}. The models run
    on their own device."""
    windows = pose_windows(store, n_poses, stride, mean, std)
    dae_latents = encode_windows_with_dae(dae_model, windows)
    tokens, seq_latents = tokenize_windows(seq_model, dae_latents,
                                           all_stages=all_stages)
    return {"windows": windows, "dae_latents": dae_latents,
            "tokens": tokens.astype(np.int32), "seq_latents": seq_latents}


def save_latent_dataset(path: str, data: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **data)


def load_latent_dataset(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def token_index(tokens: np.ndarray, n_tokens: int) -> Dict[int, np.ndarray]:
    """token id -> indices of the windows that carry it."""
    return {t: np.where(tokens == t)[0] for t in range(n_tokens)}


@torch.inference_mode()
def decode_codebook(seq_model, dae_model) -> np.ndarray:
    """Every stage-0 codebook row decoded to motion frames: (K, n_frames,
    motion_dim). The rows become decoder-initial hiddens (L, K, H) and
    decode from zero seed frames in the eval `SeqDecoder.decode` (the
    chunk-decoder kernel on the card: one launch at B = K), then through
    the DAE decoder. seq_model is a SeqVQAutoencoder or its SeqDecoder; a
    decoder with attention has no encoder outputs here and is refused."""
    dec = getattr(seq_model, "decoder", seq_model)
    cb = dec.codebook
    K = cb.shape[0]
    hidden = cb.reshape(K, dec.n_layers, dec.hidden_size).transpose(0, 1)
    seed = cb.new_zeros((K, dec.n_frames, dec.rep_dim))
    lat = dec.decode(hidden.contiguous(), seed)
    return dae_model.decode(lat.to(module_device(dae_model))).cpu().numpy()


def sample_indices(tokens: np.ndarray, max_per_token: int
                   ) -> Dict[int, np.ndarray]:
    """token id -> the first max_per_token windows that carry it, in
    window order."""
    return {int(t): np.flatnonzero(tokens == t)[:max_per_token]
            for t in np.unique(tokens)}


@torch.inference_mode()
def export_cluster_samples(data: Dict[str, np.ndarray], out_dir: str,
                           extractor, mean: np.ndarray, std: np.ndarray,
                           dae_model, max_per_token: int = 5) -> int:
    """Write the first max_per_token windows of each token, their DAE
    latents decoded and unnormalised, as <out_dir>/<token>/sample_<i>.bvh
    (i counting the token's windows in window order), the files the JAX
    package writes. The chosen windows' latents decode in one call on
    the DAE's device; the BVH text is written on the host. Returns the
    number of files written."""
    picks = sample_indices(np.asarray(data["tokens"]), max_per_token)
    rows = np.sort(np.concatenate([np.asarray(v, np.int64)
                                   for v in picks.values()]))
    lat = torch.from_numpy(np.ascontiguousarray(data["dae_latents"][rows],
                                                np.float32))
    frames = dae_model.decode(lat.to(module_device(dae_model))).cpu().numpy()
    written: Dict[int, int] = {}
    tokens = np.asarray(data["tokens"])
    for frame_block, i in zip(frames, rows):
        tok = int(tokens[i])
        d = os.path.join(out_dir, str(tok))
        os.makedirs(d, exist_ok=True)
        write_bvh(extractor.to_bvh(unnormalize(frame_block, mean, std)),
                  os.path.join(d, f"sample_{written.get(tok, 0)}.bvh"))
        written[tok] = written.get(tok, 0) + 1
    return len(rows)
