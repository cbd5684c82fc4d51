"""Motion export: feature frames -> smoothed BVH file.

The port's copy of the JAX package's `infer/exporter.py`.

Rebuild of the reference's make_bvh
(ref: scripts/inference_text2embedding.py:796-834): savgol(25,5) on the
rotation-matrix features, matrices -> ZXY euler, cubic smoothing spline
in euler space (csaps smooth=0.5, ref: inference_Autoencoder.py:502-533),
then the fitted pipeline's inverse_transform and the BVH writer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gesture2vec_tpu_torch.infer.smoothing import savgol, smoothing_spline
from gesture2vec_tpu_torch.io.bvh import write_bvh
from gesture2vec_tpu_torch.mocap.features import (FeatureExtractor,
                                                  features_to_euler)


def frames_to_bvh(frames: np.ndarray, extractor: FeatureExtractor,
                  path: Optional[str] = None, smooth: bool = True
                  ) -> "BVHData | str | None":
    """frames: (T, J*9) unnormalized rotation-matrix features."""
    feats = savgol(frames) if smooth else frames
    euler = features_to_euler(feats, extractor.orders)
    if smooth:
        euler = smoothing_spline(euler, smooth=0.5)
    bvh = extractor.pipeline.inverse_transform([euler])[0]
    if path is None:
        return bvh
    write_bvh(bvh, path)
    return None


def frames_to_bvh_twh(frames: np.ndarray, extractor,
                      path: Optional[str] = None, smooth: bool = True
                      ) -> "BVHData | str | None":
    """TWH/GENEA export (ref: scripts/inference_DAE.py:534-577
    make_bvh_TWH): savgol on the features, then the TWH extractor's own
    variant-aware inverse (see mocap/features.TWHFeatureExtractor)."""
    feats = savgol(frames) if smooth else frames
    bvh = extractor.to_bvh(feats)
    if path is None:
        return bvh
    write_bvh(bvh, path)
    return None
