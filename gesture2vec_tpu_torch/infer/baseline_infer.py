"""Baseline Seq2SeqNet inference: sliding windows with a seed-pose carry.

Port of the JAX package's `infer/baseline_infer.py`: windows of
n_frames frames every n_frames - overlap frames; each takes the words
that overlap it (at most max_words ids, with SOS / EOS); the first
n_pre_poses frames of each window are seeded with the previous window's
last n_pre_poses outputs (zeros for the first); overlapping frames are
cross-faded linearly, and the motion is unnormalised. Each window is one
eval forward of the model (its text encoder on `gru_sequence` on the
card), in order, since each seeds the next.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.data.datasets import unnormalize
from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.models.baseline import Seq2SeqNet
from gesture2vec_tpu_torch.text.vocab import Vocab


@torch.inference_mode()
def generate_baseline(model: Seq2SeqNet, vocab: Vocab, words: List[List],
                      duration_s: float, *, pose_mean: np.ndarray,
                      pose_std: np.ndarray, fps: int = 20,
                      max_words: int = 32, overlap: int = 4,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> np.ndarray:
    """words: [[word, start_s, end_s], ...] -> motion (T, pose_dim),
    unnormalised, T = max(duration_s * fps, n_frames). Runs on CUDA
    unless device says otherwise."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    n_frames, n_pre, pose_dim = (model.n_frames, model.n_pre_poses,
                                 model.pose_dim)
    stride = n_frames - overlap
    total = max(int(duration_s * fps), n_frames)
    starts = list(range(0, total - n_frames + 1, stride)) or [0]

    out = np.zeros((total, pose_dim), np.float32)
    weight = np.zeros((total, 1), np.float32)
    ramp = np.ones(n_frames, np.float32)
    if overlap > 0:
        ramp[:overlap] = np.linspace(0, 1, overlap, endpoint=False)
        ramp[-overlap:] = np.linspace(1, 0, overlap, endpoint=False)

    prev_tail = np.zeros((n_pre, pose_dim), np.float32)
    for s in starts:
        t0, t1 = s / fps, (s + n_frames) / fps
        inside = [w[0] for w in words if w[2] > t0 and w[1] < t1]
        ids = np.zeros((1, max_words), np.int64)
        wid = vocab.words_to_ids(inside)[:max_words]
        ids[0, :len(wid)] = wid
        lengths = np.array([max(len(wid), 1)], np.int64)
        seed = np.zeros((1, n_frames, pose_dim), np.float32)
        seed[0, :n_pre] = prev_tail
        win = model(torch.from_numpy(ids).to(dev),
                    torch.from_numpy(lengths).to(dev),
                    torch.from_numpy(seed).to(dev))["outputs"][0]
        win = win.cpu().numpy()
        prev_tail = win[-n_pre:]
        out[s:s + n_frames] += win * ramp[:, None]
        weight[s:s + n_frames] += ramp[:, None]

    covered = weight[:, 0] > 0
    out[covered] /= weight[covered]
    return unnormalize(out, pose_mean, pose_std)
