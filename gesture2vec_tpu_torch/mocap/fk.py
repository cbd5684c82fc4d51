"""Forward kinematics: joint rotations -> world positions, batched.

The port's copy of the JAX package's `mocap/fk.py`.

Rebuild of pymo's MocapParameterizer('position')
(ref: scripts/pymo/preprocessing.py:86-168 _to_pos), which walks the
skeleton per joint with per-frame scipy Rotation lists. Here the whole
(frames, joints) batch is converted to rotation matrices in one call and
the tree walk does one (T, 3, 3) matmul per joint.

Convention note: the reference composes INVERTED rotations and applies
parent.inv() to offsets (ref :136,147,153); algebraically that equals
standard FK with world = parent_world @ local, verified in tests against
an independent scipy implementation.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from gesture2vec_tpu_torch.io.bvh import BVHData
from gesture2vec_tpu_torch.mocap import rotations as rot


def _topo_order(data: BVHData) -> List[str]:
    order = []

    def walk(name):
        order.append(name)
        for c in data.skeleton[name].children:
            walk(c)

    walk(data.root_name)
    return order


def forward_kinematics(data: BVHData,
                       values: Optional[np.ndarray] = None
                       ) -> Dict[str, np.ndarray]:
    """Returns {joint: (T, 3) world positions} for every joint (including
    end-site Nubs). `values` overrides data.values (same column layout).
    """
    vals = np.asarray(values if values is not None else data.values,
                      dtype=np.float64)
    T = vals.shape[0]
    cidx = data.column_index()

    world_rot: Dict[str, np.ndarray] = {}
    world_pos: Dict[str, np.ndarray] = {}

    for name in _topo_order(data):
        j = data.skeleton[name]
        # local rotation from euler channels (if any)
        if j.order:
            euler = np.stack([vals[:, cidx[f"{name}_{ax}rotation"]]
                              for ax in j.order], axis=1)
            local_rot = np.asarray(rot.euler_to_matrix(euler, j.order))
        else:
            local_rot = np.tile(np.eye(3), (T, 1, 1))
        # local translation: offset + position channels (if any)
        offset = np.tile(j.offsets, (T, 1))
        for k, ax in enumerate("XYZ"):
            col = f"{name}_{ax}position"
            if col in cidx:
                offset[:, k] += vals[:, cidx[col]]

        if j.parent is None:
            world_rot[name] = local_rot
            world_pos[name] = offset
        else:
            pr = world_rot[j.parent]
            world_rot[name] = pr @ local_rot
            world_pos[name] = world_pos[j.parent] + \
                np.einsum("tij,tj->ti", pr, offset)

    return world_pos


def positions_matrix(data: BVHData,
                     values: Optional[np.ndarray] = None,
                     joints: Optional[List[str]] = None
                     ) -> np.ndarray:
    """(T, J, 3) array in topological (or given) joint order."""
    pos = forward_kinematics(data, values)
    names = joints or _topo_order(data)
    return np.stack([pos[n] for n in names], axis=1)
