"""Pose normalisation, corpus views and batching (the port's copy of the
JAX package's `data/datasets.py`, and of `utils/native`'s window
extraction in numpy): every frame for Part a, sliding pose windows for
Part b, sentence windows with their words for Part d."""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

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


def all_frames(store, mean: Optional[np.ndarray] = None,
               std: Optional[np.ndarray] = None) -> np.ndarray:
    """Every pose frame of a ClipStore as one (N, D) float32 array,
    normalised by mean / std (the store's own when None)."""
    mean = store.pose_mean if mean is None else mean
    std = store.pose_std if std is None else std
    frames = np.concatenate([c["poses"] for c in store], axis=0)
    if mean is not None and std is not None:
        frames = normalize(frames, mean, std)
    return frames.astype(np.float32)


def sentence_windows(store, frame_length: int, stride: int, fps: int,
                     min_words: int = 4, context_s: float = 0.0
                     ) -> List[dict]:
    """Windows of frame_length frames every stride frames with the words
    that overlap them (word end > window start and word start < window
    end); a window with fewer than min_words is skipped. context_s > 0
    extends the word range backwards by that many seconds (the filter
    still counts the window's own range). Each window is {"clip",
    "frame0", "words", "t0", "t1"}."""
    out = []
    for ci, clip in enumerate(store.clips):
        n_frames = clip["n_frames"]
        words = clip["words"]
        n = (n_frames - frame_length) // stride + 1
        for k in range(max(n, 0)):
            f0 = k * stride
            t0, t1 = f0 / fps, (f0 + frame_length) / fps
            inside = [w for w in words if w[2] > t0 and w[1] < t1]
            if len(inside) < min_words:
                continue
            if context_s > 0:
                inside = [w for w in words
                          if w[2] > t0 - context_s and w[1] < t1]
            out.append({"clip": ci, "frame0": f0, "words": inside,
                        "t0": t0, "t1": t1})
    return out


def batch_iterator(arrays: Tuple[np.ndarray, ...], batch_size: int,
                   seed: int = 0, shuffle: bool = True,
                   drop_last: bool = True
                   ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Minibatches over parallel arrays, shuffled by
    np.random.default_rng(seed); drop_last keeps every batch full."""
    n = arrays[0].shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        take = idx[s:s + batch_size]
        yield tuple(a[take] for a in arrays)
