"""Part c - the corpus latent dataset (the clustering / exemplar
substrate).

Port of the JAX package's `cluster/latent_dataset.py`: every corpus
window is recorded with its frame-level DAE latents, its sequence latent
(the decoder-initial hidden) and its gesture token, saved as npz with
the same keys. Decoding the codebook and the BVH export are not ported
yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from gesture2vec_tpu_torch.data.datasets import pose_windows
from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                tokenize_windows)


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
