"""Skeleton-to-feature extraction (the L1 ingest math).

The port's copy of the JAX package's `mocap/features.py`, numpy only:
the all-ZXY euler -> rotation-matrix conversion runs `rotations.
euler_to_matrix`, where the JAX package may take its native C++ helper
(the two agree to 1e-12).

Behavior-compatible rebuild of the reference's per-file processing
(ref: scripts/trinity_data_to_lmdb.py:31-58 for Trinity,
scripts/twh_dataset_to_lmdb.py:26-149 for TWH/GENEA): a fitted
MotionPipeline reduces a BVH file to per-frame euler channels, which are
then converted to flattened 3x3 rotation matrices per joint - 135 dims
for the Trinity 15-joint upper body. The euler->rotmat conversion is one
vectorized call (the reference loops frame by frame through scipy).

The inverse path (features -> BVH) is the export half used by inference
(ref: scripts/inference_text2embedding.py:796-834).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from gesture2vec_tpu_torch.io.bvh import BVHData, parse_bvh
from gesture2vec_tpu_torch.mocap import rotations as rot
from gesture2vec_tpu_torch.mocap.pipeline import (
    ConstantsRemover, Downsample, JointSelect, Mirror, MotionPipeline,
    Numpyfy, RootCentric, RootNormalizer, ToExpmap)

# ref: scripts/trinity_data_to_lmdb.py:23-25
TRINITY_TARGET_JOINTS = [
    "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Neck1", "Head",
    "RightShoulder", "RightArm", "RightForeArm", "RightHand",
    "LeftShoulder", "LeftArm", "LeftForeArm", "LeftHand",
]

# ref: scripts/twh_dataset_to_lmdb.py:17-24 (18 upper-body joints)
TWH_TARGET_JOINTS = [
    "b_spine0", "b_spine1", "b_spine2", "b_spine3", "b_neck0", "b_head",
    "b_r_shoulder", "b_r_arm", "b_r_arm_twist", "b_r_forearm",
    "b_r_wrist_twist", "b_r_wrist",
    "b_l_shoulder", "b_l_arm", "b_l_arm_twist", "b_l_forearm",
    "b_l_wrist_twist", "b_l_wrist",
]


def trinity_pipeline(tgt_fps: int = 20) -> MotionPipeline:
    """The Trinity ingest pipeline (ref: trinity_data_to_lmdb.py:37-44)."""
    return MotionPipeline([
        ("dwnsampl", Downsample(tgt_fps=tgt_fps, keep_all=False)),
        ("root", RootCentric()),
        ("mir", Mirror(axis="X", append=True)),
        ("jtsel", JointSelect(TRINITY_TARGET_JOINTS, include_root=True)),
        ("cnst", ConstantsRemover()),
        ("np", Numpyfy()),
    ])


def _euler_orders(columns: List[str]) -> List[str]:
    """Per-joint rotation orders from the remaining euler columns."""
    orders = []
    for i in range(0, len(columns), 3):
        tri = columns[i:i + 3]
        joints = {c.rsplit("_", 1)[0] for c in tri}
        assert len(joints) == 1, f"non-joint-aligned columns: {tri}"
        orders.append("".join(c.rsplit("_", 1)[1][0] for c in tri))
    return orders


def euler_to_features(euler_blocks: np.ndarray,
                      orders: List[str]) -> np.ndarray:
    """(..., J*3) euler degrees -> (..., J*9) flattened rotation matrices."""
    lead = euler_blocks.shape[:-1]
    n_j = euler_blocks.shape[-1] // 3
    e = euler_blocks.reshape(*lead, n_j, 3)
    if all(o == "ZXY" for o in orders):
        # one call for the (ubiquitous) all-ZXY skeleton: the JAX
        # package's numpy path for this case, operation for operation
        flat = rot.euler_to_matrix(e.reshape(-1, 3), "ZXY").reshape(-1, 9)
        return flat.reshape(*lead, n_j * 9)
    mats = []
    for j, order in enumerate(orders):
        mats.append(np.asarray(rot.euler_to_matrix(e[..., j, :], order)))
    m = np.stack(mats, axis=-3)  # (..., J, 3, 3)
    return m.reshape(*lead, n_j * 9)


def features_to_euler(features: np.ndarray,
                      orders: List[str]) -> np.ndarray:
    """(..., J*9) rotation matrices -> (..., J*3) euler degrees."""
    lead = features.shape[:-1]
    n_j = features.shape[-1] // 9
    m = features.reshape(*lead, n_j, 3, 3)
    eulers = []
    for j, order in enumerate(orders):
        eulers.append(np.asarray(rot.matrix_to_euler(m[..., j, :, :], order)))
    e = np.stack(eulers, axis=-2)  # (..., J, 3)
    return e.reshape(*lead, n_j * 3)


def twh_pipeline(variant: str = "test1") -> MotionPipeline:
    """TWH/GENEA ingest pipelines (ref: scripts/twh_dataset_to_lmdb.py).

    Variants (matching the reference's four process_bvh* functions):
      "posrot"  (ref :26-56):  30 fps, RootNormalizer, 18 joints,
                 per-joint [3 pos + euler->rotmat 9] = 12 dims
      "rot"     (ref :57-87):  30 fps + ConstantsRemover, euler->rotmat
      "taras"   (ref :88-119): 10 fps, raw expmap features
      "test1"   (ref :120-149, the inference variant): 10 fps +
                 ConstantsRemover + expmap, then the expmap triples are
                 re-read as ZXY euler DEGREES and converted to rotation
                 matrices - a reference quirk kept for corpus parity.
    """
    steps = [("dwnsampl", Downsample(tgt_fps=30 if variant in
                                     ("posrot", "rot") else 10,
                                     keep_all=False)),
             ("root", RootNormalizer()),
             ("jtsel", JointSelect(TWH_TARGET_JOINTS, include_root=False))]
    if variant in ("rot", "test1"):
        steps.append(("cnst", ConstantsRemover()))
    if variant in ("taras", "test1"):
        steps.append(("exp", ToExpmap()))
    steps.append(("np", Numpyfy()))
    return MotionPipeline(steps)


class TWHFeatureExtractor:
    """TWH/GENEA skeleton features with exact inverses per variant."""

    def __init__(self, variant: str = "test1",
                 pipeline: Optional[MotionPipeline] = None):
        self.variant = variant
        self.pipeline = pipeline or twh_pipeline(variant)
        self.fitted = False
        self._columns: List[str] = []

    def process(self, bvh: "BVHData | str") -> np.ndarray:
        if isinstance(bvh, str):
            bvh = parse_bvh(bvh)
        arr = self.pipeline.fit_transform([bvh])[0]   # (T, C)
        numpyfy = self.pipeline.steps[-1][1]
        self._columns = numpyfy.template.columns
        self.fitted = True
        if self.variant == "taras":
            return arr
        if self.variant == "posrot":
            # per-joint [x y z, Zrot Xrot Yrot] -> [x y z, rotmat(9)]
            T = arr.shape[0]
            grouped = arr.reshape(T, -1, 6)
            mats = np.asarray(rot.euler_to_matrix(grouped[..., 3:], "ZXY"))
            return np.concatenate(
                [grouped[..., :3], mats.reshape(T, -1, 9)],
                axis=-1).reshape(T, -1)
        # "rot" (euler) and "test1" (expmap-as-euler quirk): triples are
        # fed to from_euler('ZXY', degrees=True) regardless
        # (ref: twh_dataset_to_lmdb.py:78-86, :140-148)
        T = arr.shape[0]
        grouped = arr.reshape(T, -1, 3)
        mats = np.asarray(rot.euler_to_matrix(grouped, "ZXY"))
        return mats.reshape(T, -1)

    def to_bvh(self, features: np.ndarray) -> BVHData:
        assert self.fitted, "TWHFeatureExtractor must process a file first"
        T = features.shape[0]
        if self.variant == "taras":
            arr = features
        elif self.variant == "posrot":
            grouped = features.reshape(T, -1, 12)
            euler = np.asarray(rot.matrix_to_euler(
                grouped[..., 3:].reshape(T, -1, 3, 3), "ZXY"))
            arr = np.concatenate([grouped[..., :3], euler],
                                 axis=-1).reshape(T, -1)
        else:
            mats = features.reshape(T, -1, 3, 3)
            arr = np.asarray(rot.matrix_to_euler(mats,
                                                 "ZXY")).reshape(T, -1)
        return self.pipeline.inverse_transform([arr])[0]

    def save(self, path: str) -> None:
        self.pipeline.save(path)

    @classmethod
    def load(cls, path: str, variant: str = "test1"
             ) -> "TWHFeatureExtractor":
        fe = cls(variant, MotionPipeline.load(path))
        numpyfy = fe.pipeline.steps[-1][1]
        fe._columns = numpyfy.template.columns
        fe.fitted = True
        return fe


class FeatureExtractor:
    """Fitted BVH -> rotation-matrix feature transform with exact inverse.

    process() mirrors the reference process_bvh() contract of returning
    (original, mirrored) feature tracks
    (ref: scripts/trinity_data_to_lmdb.py:31-58).
    """

    def __init__(self, pipeline: Optional[MotionPipeline] = None):
        self.pipeline = pipeline or trinity_pipeline()
        self.fitted = False
        self.orders: List[str] = []
        self._columns: List[str] = []

    def process(self, bvh: "BVHData | str") -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(bvh, str):
            bvh = parse_bvh(bvh)
        arr = self.pipeline.fit_transform([bvh])  # (tracks, T, C) euler deg
        numpyfy = self.pipeline.steps[-1][1]
        self._columns = numpyfy.template.columns
        self.orders = _euler_orders(self._columns)
        self.fitted = True
        feats = euler_to_features(arr, self.orders)
        if feats.shape[0] == 1:  # no mirror stage in pipeline
            return feats[0], feats[0]
        return feats[0], feats[1]

    def transform(self, bvh: "BVHData | str") -> np.ndarray:
        """Extract features with the ALREADY-FITTED pipeline (no refit):
        the path for new files once a corpus pipeline exists. Returns the
        original (non-mirrored) track's (T, J*9) features."""
        assert self.fitted, "FeatureExtractor must be fitted/loaded first"
        if isinstance(bvh, str):
            bvh = parse_bvh(bvh)
        tracks = self.pipeline.transform([bvh])
        return euler_to_features(tracks[0], self.orders)

    def to_bvh(self, features: np.ndarray) -> BVHData:
        """(T, J*9) features -> BVHData ready for write_bvh."""
        assert self.fitted, "FeatureExtractor must process a file first"
        euler = features_to_euler(np.asarray(features), self.orders)
        return self.pipeline.inverse_transform([euler])[0]

    def save(self, path: str) -> None:
        self.pipeline.save(path)

    @classmethod
    def load(cls, path: str) -> "FeatureExtractor":
        fe = cls(MotionPipeline.load(path))
        numpyfy = fe.pipeline.steps[-1][1]
        fe._columns = numpyfy.template.columns
        fe.orders = _euler_orders(fe._columns)
        fe.fitted = True
        return fe
