"""Motion smoothing for export.

The port's copy of the JAX package's `infer/smoothing.py`.

Rebuild of the reference's smoothing_function
(ref: scripts/inference_Autoencoder.py:418-554) and the export-time
savgol pass (ref: scripts/inference_text2embedding.py:811-815). The
csaps cubic smoothing spline is replaced by scipy's
make_smoothing_spline with lam = (1-p)/p, the exact same objective
(csaps minimizes p*sum((y-f)^2) + (1-p)*integral(f''^2)).
All methods are vectorized across channels (the reference loops per
joint per frame).
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import make_smoothing_spline
from scipy.signal import savgol_filter


def savgol(poses: np.ndarray, window: int = 25, order: int = 5
           ) -> np.ndarray:
    """Per-channel Savitzky-Golay (ref: inference_text2embedding.py:811-815).
    Window is clamped to the sequence length like scipy requires."""
    n = poses.shape[0]
    w = min(window, n if n % 2 == 1 else n - 1)
    if w <= order:
        return poses.copy()
    return savgol_filter(poses, w, order, axis=0)


def moving_average(poses: np.ndarray, window: int = 10) -> np.ndarray:
    """Symmetric boxcar mean with edge truncation
    (ref: inference_Autoencoder.py:435-446)."""
    n = poses.shape[0]
    out = np.zeros_like(poses)
    csum = np.cumsum(np.vstack([np.zeros((1, poses.shape[1])), poses]),
                     axis=0)
    for j in range(n):
        lo = max(j - window, 0)
        hi = min(j + window, n)
        out[j] = (csum[hi] - csum[lo]) / (hi - lo)
    return out


def smoothing_spline(poses: np.ndarray, smooth: float = 0.5) -> np.ndarray:
    """csaps-equivalent cubic smoothing spline per channel
    (ref: inference_Autoencoder.py:502-533, smooth_f=0.5)."""
    n = poses.shape[0]
    if n < 4:
        return poses.copy()
    x = np.arange(n, dtype=np.float64)
    lam = (1.0 - smooth) / smooth
    out = np.empty_like(poses, dtype=np.float64)
    for j in range(poses.shape[1]):
        out[:, j] = make_smoothing_spline(x, poses[:, j].astype(np.float64),
                                          lam=lam)(x)
    return out.astype(poses.dtype)


def export_smooth(poses: np.ndarray) -> np.ndarray:
    """The reference's export chain: savgol(25,5) on rotmat features
    (euler-space spline smoothing happens separately in the exporter,
    ref: inference_text2embedding.py:806-829)."""
    return savgol(poses)
