"""Human similarity labels for the semi-supervised Part-b step.

The port's numpy copy of the JAX package's `data/similarity.py`. Label
lines are "annotator,left,middle,right,label,time": the middle window is
the anchor, and the label names which side is more similar to it. The
pairs are built as the reference's loader builds them:
  "right"   -> (right, middle, 1)
  "left"    -> (left, middle, 1)
  "neither" -> (right, middle, 0) and (left, middle, 0)
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def read_gesture_labels(path: str) -> List[Tuple[int, int, int]]:
    """-> [(i, j, label), ...] window-index pairs, 1 = similar."""
    pairs: List[Tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 5:
                continue
            left, middle, right = (int(parts[1]), int(parts[2]),
                                   int(parts[3]))
            label = parts[4]
            if label == "neither":
                pairs.append((right, middle, 0))
                pairs.append((left, middle, 0))
            elif label == "right":
                pairs.append((right, middle, 1))
            elif label == "left":
                pairs.append((left, middle, 1))
    return pairs


def sample_pairs(pairs: List[Tuple[int, int, int]], count: int,
                 rng: np.random.Generator, n_windows: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """count random labelled pairs among those whose windows exist:
    (first indices, second indices, labels as float32)."""
    valid = [(i, j, l) for i, j, l in pairs
             if i < n_windows and j < n_windows]
    if not valid:
        raise ValueError("no valid similarity pairs for this corpus")
    take = rng.choice(len(valid), size=count, replace=len(valid) < count)
    arr = np.asarray([valid[t] for t in take], np.int64)
    return arr[:, 0], arr[:, 1], arr[:, 2].astype(np.float32)
