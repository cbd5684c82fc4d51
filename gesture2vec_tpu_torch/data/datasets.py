"""Pose normalisation constants (the port's copy of the JAX package's
`data/datasets.py` helpers that inference needs)."""
from __future__ import annotations

import numpy as np

STD_CLIP = 0.01  # pose std is clipped at 0.01 before (un)normalising


def unnormalize(poses: np.ndarray, mean: np.ndarray,
                std: np.ndarray) -> np.ndarray:
    std = np.clip(std, a_min=STD_CLIP, a_max=None)
    return poses * std + mean
