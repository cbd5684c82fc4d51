"""Pose normalisation and corpus windows (the port's copy of the JAX
package's `data/datasets.py` helpers, and of `utils/native`'s window
extraction in numpy)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

STD_CLIP = 0.01  # pose std is clipped at 0.01 before (un)normalising


def normalize(poses: np.ndarray, mean: np.ndarray,
              std: np.ndarray) -> np.ndarray:
    std = np.clip(std, a_min=STD_CLIP, a_max=None)
    return (poses - mean) / std


def unnormalize(poses: np.ndarray, mean: np.ndarray,
                std: np.ndarray) -> np.ndarray:
    std = np.clip(std, a_min=STD_CLIP, a_max=None)
    return poses * std + mean


def extract_windows(frames: np.ndarray, window: int,
                    stride: int) -> np.ndarray:
    """(T, D) -> (N, window, D) float32 sliding windows, with
    N = (T - window) // stride + 1 (0 when T < window)."""
    f = np.ascontiguousarray(frames, dtype=np.float32)
    T, D = f.shape
    n = max((T - window) // stride + 1, 0)
    if n == 0:
        return np.zeros((0, window, D), np.float32)
    view = np.lib.stride_tricks.sliding_window_view(f, window, axis=0)
    return np.ascontiguousarray(view[::stride][:n].transpose(0, 2, 1))


def pose_windows(store, n_poses: int, stride: int,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, n_poses, D) sliding windows over every clip of a ClipStore,
    normalised by mean / std (the store's own when None)."""
    mean = store.pose_mean if mean is None else mean
    std = store.pose_std if std is None else std
    wins: List[np.ndarray] = []
    for clip in store:
        w = extract_windows(clip["poses"], n_poses, stride)
        if w.shape[0]:
            wins.append(w)
    out = np.concatenate(wins, axis=0).astype(np.float32)
    if mean is not None and std is not None:
        out = normalize(out, mean, std)
    return out
