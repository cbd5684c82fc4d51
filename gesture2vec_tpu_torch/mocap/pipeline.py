"""Vectorized motion preprocessing pipeline.

The port's copy of the JAX package's `mocap/pipeline.py`. A fitted
pipeline saved by either package (`data_pipe.json`, whose template
tracks are BVH text) loads in the other and inverts to the same values.

Replaces the reference's pandas/sklearn transformer stack
(ref: scripts/pymo/preprocessing.py) with numpy column operations over a
lightweight Track structure. Semantics are kept behavior-compatible with
the reference Trinity ingest pipeline
(ref: scripts/trinity_data_to_lmdb.py:37-44):

    Downsample(20 fps) -> RootCentric -> Mirror(X, append)
      -> JointSelect(15 joints + root) -> ConstantsRemover -> Numpyfy

Each stage exposes fit/transform/inverse_transform and a state dict so a
fitted pipeline can be saved with numpy+json instead of joblib pickles
(the reference persists `data_pipe.sav` via joblib,
ref: scripts/trinity_data_to_lmdb.py:47).

Known reference quirk preserved on purpose: Mirror only swaps joints whose
names contain the TWH-style "_l_"/"_r_" markers
(ref: scripts/pymo/preprocessing.py:292-293), so on the Trinity skeleton
("LeftArm"/"RightArm") the "mirrored" track is a pure per-axis sign flip
with no left/right swap. `Mirror(lr_markers=("Left", "Right"))` gives the
anatomically correct behavior when parity with the reference corpus is
not required.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gesture2vec_tpu_torch.io.bvh import BVHData


@dataclasses.dataclass
class Track:
    """A motion track mid-pipeline: named columns over frames."""

    source: BVHData  # skeleton / root / framerate context (values ignored)
    columns: List[str]
    values: np.ndarray  # (frames, len(columns))
    framerate: float

    @classmethod
    def from_bvh(cls, data: BVHData) -> "Track":
        return cls(source=data, columns=data.column_names(),
                   values=np.asarray(data.values, dtype=np.float64),
                   framerate=data.framerate)

    def col(self, name: str) -> np.ndarray:
        return self.values[:, self.columns.index(name)]

    def replace(self, **kw) -> "Track":
        return dataclasses.replace(self, **kw)

    def to_bvh(self) -> BVHData:
        out = self.source.clone()
        idx = {f"{j}_{c}": i for i, (j, c) in
               enumerate(out.channel_names)}
        vals = np.zeros((self.values.shape[0], len(out.channel_names)))
        for i, c in enumerate(self.columns):
            if c in idx:
                vals[:, idx[c]] = self.values[:, i]
        out.values = vals
        out.frame_time = 1.0 / self.framerate
        return out


class Transform:
    """Base: fit on a list of Tracks, transform/inverse lists of Tracks."""

    def fit(self, tracks: List[Track]) -> "Transform":
        return self

    def transform(self, tracks: List[Track]) -> List[Track]:
        raise NotImplementedError

    def inverse_transform(self, tracks: List[Track]) -> List[Track]:
        return tracks

    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None:
        pass


class Downsample(Transform):
    """Integer-rate fps downsampling (ref: pymo/preprocessing.py:899-931).

    Matches the reference's slicing `values[ii:-1:rate]` including its
    off-by-one (the final frame is always dropped). keep_all=True emits
    every phase offset as its own track.
    """

    def __init__(self, tgt_fps: int, keep_all: bool = False):
        self.tgt_fps = tgt_fps
        self.keep_all = keep_all

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            rate = max(1, int(round(tr.framerate)) // self.tgt_fps)
            for phase in range(rate):
                out.append(tr.replace(values=tr.values[phase:-1:rate].copy(),
                                      framerate=float(self.tgt_fps)))
                if not self.keep_all:
                    break
        return out


class RootCentric(Transform):
    """Zero out root position+rotation channels
    (ref: pymo/preprocessing.py:532-556, method='hip_centric')."""

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            root = tr.source.root_name
            vals = tr.values.copy()
            for suffix in ("Xposition", "Yposition", "Zposition",
                           "Xrotation", "Yrotation", "Zrotation"):
                name = f"{root}_{suffix}"
                if name in tr.columns:
                    vals[:, tr.columns.index(name)] = 0.0
            out.append(tr.replace(values=vals))
        return out


_MIRROR_SIGNS = {"X": np.array([1.0, -1.0, -1.0]),
                 "Y": np.array([-1.0, 1.0, -1.0]),
                 "Z": np.array([-1.0, -1.0, 1.0])}


class Mirror(Transform):
    """Mirror motion across a body plane (ref: pymo/preprocessing.py:246-321).

    Root positions are negated per the complementary axes; rotation
    channels flip sign per axis; joints whose names contain the left
    marker swap values with the right counterpart. append=True keeps the
    original tracks followed by mirrored copies, like the reference.
    """

    def __init__(self, axis: str = "X", append: bool = True,
                 lr_markers: Tuple[str, str] = ("_l_", "_r_")):
        self.axis = axis
        self.append = append
        self.lr_markers = tuple(lr_markers)

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = list(tracks) if self.append else []
        signs = _MIRROR_SIGNS[self.axis]
        lmark, rmark = self.lr_markers
        for tr in tracks:
            root = tr.source.root_name
            vals = tr.values.copy()
            cidx = {c: i for i, c in enumerate(tr.columns)}

            for ax_i, pos in enumerate(("Xposition", "Yposition",
                                        "Zposition")):
                name = f"{root}_{pos}"
                if name in cidx:
                    vals[:, cidx[name]] = -signs[ax_i] * tr.values[:, cidx[name]]

            joints = {c.rsplit("_", 1)[0] for c in tr.columns
                      if "rotation" in c}
            for joint in joints:
                if lmark in joint:
                    other = joint.replace(lmark, rmark)
                elif rmark in joint:
                    other = joint.replace(rmark, lmark)
                else:
                    other = joint
                for ax_i, ax in enumerate("XYZ"):
                    dst = f"{joint}_{ax}rotation"
                    src = f"{other}_{ax}rotation"
                    if dst in cidx and src in cidx:
                        vals[:, cidx[dst]] = signs[ax_i] * tr.values[:, cidx[src]]
            out.append(tr.replace(values=vals))
        return out


class JointSelect(Transform):
    """Keep only channels of selected joints
    (ref: pymo/preprocessing.py:326-381)."""

    def __init__(self, joints: Sequence[str], include_root: bool = False):
        self.joints = list(joints)
        self.include_root = include_root
        self.selected_channels: List[str] = []
        self.dropped: Dict[str, float] = {}

    def fit(self, tracks: List[Track]) -> "JointSelect":
        t0 = tracks[0]
        selected = ([t0.source.root_name] if self.include_root else []) + \
            self.joints
        # channel order is per-joint in selection order (root first, then
        # the requested joints), matching the reference's column layout
        # (ref: pymo/preprocessing.py:338-347) on which the published
        # 135-dim data_mean/data_std vectors depend.
        self.selected_channels = [
            c for j in selected for c in t0.columns
            if c.rsplit("_", 1)[0] == j and "Nub" not in c
        ]
        self.dropped = {
            c: float(t0.values[0, i]) for i, c in enumerate(t0.columns)
            if c not in self.selected_channels
        }
        return self

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            keep = [tr.columns.index(c) for c in self.selected_channels]
            out.append(tr.replace(columns=list(self.selected_channels),
                                  values=tr.values[:, keep].copy()))
        return out

    def inverse_transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            cols = list(tr.columns) + list(self.dropped.keys())
            extra = np.tile(np.array(list(self.dropped.values())),
                            (tr.values.shape[0], 1))
            out.append(tr.replace(columns=cols,
                                  values=np.hstack([tr.values, extra])))
        return out

    def state_dict(self):
        return {"selected_channels": self.selected_channels,
                "dropped": self.dropped}

    def load_state_dict(self, state):
        self.selected_channels = list(state["selected_channels"])
        self.dropped = dict(state["dropped"])


class ConstantsRemover(Transform):
    """Drop channels whose std over the first track is < eps
    (ref: pymo/preprocessing.py:755-797)."""

    def __init__(self, eps: float = 1e-6):
        self.eps = eps
        self.const_values: Dict[str, float] = {}

    def fit(self, tracks: List[Track]) -> "ConstantsRemover":
        t0 = tracks[0]
        stds = t0.values.std(axis=0)
        self.const_values = {
            c: float(t0.values[0, i]) for i, c in enumerate(t0.columns)
            if stds[i] < self.eps
        }
        return self

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            keep = [i for i, c in enumerate(tr.columns)
                    if c not in self.const_values]
            out.append(tr.replace(
                columns=[tr.columns[i] for i in keep],
                values=tr.values[:, keep].copy()))
        return out

    def inverse_transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            cols = list(tr.columns) + list(self.const_values.keys())
            extra = np.tile(np.array(list(self.const_values.values())),
                            (tr.values.shape[0], 1))
            out.append(tr.replace(columns=cols,
                                  values=np.hstack([tr.values, extra])))
        return out

    def state_dict(self):
        return {"const_values": self.const_values}

    def load_state_dict(self, state):
        self.const_values = dict(state["const_values"])


class RootNormalizer(Transform):
    """TWH/GENEA-2022 root normalization
    (ref: pymo/preprocessing.py:617-672 RootNormalizer): center root
    positions on their mean, zero X/Z root rotations, and set Yrotation
    to -90 or +90 by the sign of the first frame's X position so all
    subjects face the same way. Inverse is identity, like the reference.
    """

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            root = tr.source.root_name
            vals = tr.values.copy()
            cidx = {c: i for i, c in enumerate(tr.columns)}
            xp = cidx.get(f"{root}_Xposition")
            for suffix in ("Xposition", "Yposition", "Zposition"):
                i = cidx.get(f"{root}_{suffix}")
                if i is not None:
                    vals[:, i] = tr.values[:, i] - tr.values[:, i].mean()
            for suffix in ("Xrotation", "Zrotation"):
                i = cidx.get(f"{root}_{suffix}")
                if i is not None:
                    vals[:, i] = 0.0
            yi = cidx.get(f"{root}_Yrotation")
            if yi is not None and xp is not None:
                face = -90.0 if tr.values[0, xp] < 0 else 90.0
                vals[:, yi] = face
            out.append(tr.replace(values=vals))
        return out


class ToExpmap(Transform):
    """Euler rotation channels -> exponential-map channels
    (ref: pymo/preprocessing.py:170-244 MocapParameterizer('expmap')).

    Reference column-order quirks preserved: per joint the euler triple
    becomes <joint>_alpha/beta/gamma, inserted at the FRONT of the column
    list, so the final order is reversed joint order followed by any
    non-rotation columns (ref :200-202 insert(loc=0)). Rotvec conversion
    uses the EXTRINSIC (lowercase) euler convention like the reference
    (ref :197 rot_order.lower()) and applies the discontinuity unroll.
    """

    def transform(self, tracks: List[Track]) -> List[Track]:
        from gesture2vec_tpu_torch.mocap import rotations as rot

        out = []
        for tr in tracks:
            cidx = {c: i for i, c in enumerate(tr.columns)}
            joints = []
            for c in tr.columns:
                if "rotation" in c and "Nub" not in c:
                    j = c.rsplit("_", 1)[0]
                    if j not in joints:
                        joints.append(j)
            exp_cols: List[str] = []
            exp_vals: List[np.ndarray] = []
            for joint in joints:
                order = tr.source.skeleton[joint].order
                euler = np.stack(
                    [tr.values[:, cidx[f"{joint}_{ax}rotation"]]
                     for ax in order], axis=1)
                # extrinsic convention == intrinsic with reversed sequence
                mats = rot.euler_to_matrix(euler[:, ::-1],
                                           order[::-1].upper())
                rv = rot.unroll_rotvec(np.asarray(rot.matrix_to_rotvec(mats)))
                # front-insertion -> reversed joint order overall
                exp_cols = [f"{joint}_alpha", f"{joint}_beta",
                            f"{joint}_gamma"] + exp_cols
                exp_vals = [rv[:, 0], rv[:, 1], rv[:, 2]] + exp_vals
            keep = [c for c in tr.columns
                    if "rotation" not in c or "Nub" in c]
            cols = exp_cols + keep
            vals = np.stack(exp_vals +
                            [tr.values[:, cidx[c]] for c in keep], axis=1)
            out.append(tr.replace(columns=cols, values=vals))
        return out

    def inverse_transform(self, tracks: List[Track]) -> List[Track]:
        from gesture2vec_tpu_torch.mocap import rotations as rot

        out = []
        for tr in tracks:
            cidx = {c: i for i, c in enumerate(tr.columns)}
            joints = []
            for c in tr.columns:
                if c.endswith("_alpha"):
                    joints.append(c[: -len("_alpha")])
            cols = [c for c in tr.columns
                    if not c.endswith(("_alpha", "_beta", "_gamma"))]
            vals_list = [tr.values[:, cidx[c]] for c in cols]
            for joint in joints:
                order = tr.source.skeleton[joint].order
                rv = np.stack([tr.values[:, cidx[f"{joint}_{g}"]]
                               for g in ("alpha", "beta", "gamma")], axis=1)
                mats = rot.rotvec_to_matrix(rv)
                euler = np.asarray(rot.matrix_to_euler(
                    mats, order[::-1].upper()))[:, ::-1]
                for k, ax in enumerate(order):
                    cols.append(f"{joint}_{ax}rotation")
                    vals_list.append(euler[:, k])
            out.append(tr.replace(columns=cols,
                                  values=np.stack(vals_list, axis=1)))
        return out


class Numpyfy(Transform):
    """Track list -> stacked float array; remembers the column template so
    inverse_transform can rebuild Tracks (ref: pymo/preprocessing.py:384-423).
    """

    def __init__(self):
        self.template: Optional[Track] = None

    def fit(self, tracks: List[Track]) -> "Numpyfy":
        self.template = tracks[0]
        return self

    def transform(self, tracks: List[Track]) -> np.ndarray:
        return np.stack([tr.values for tr in tracks], axis=0)

    def inverse_transform(self, arrays) -> List[Track]:
        assert self.template is not None, "Numpyfy not fitted"
        out = []
        for arr in arrays:
            out.append(self.template.replace(values=np.asarray(arr,
                                                               dtype=np.float64)))
        return out

    def state_dict(self):
        # store template columns + a single-frame snapshot of source BVH
        return _track_state(self.template)

    def load_state_dict(self, state):
        self.template = _track_from_state(state)


class ToPositions(Transform):
    """Euler rotation channels -> world-space joint positions via batched
    forward kinematics (ref: pymo/preprocessing.py:86-168
    MocapParameterizer('position')).

    Output columns are <joint>_{X,Y,Z}position for every skeleton joint
    (including end-site Nubs) in skeleton order; all non-position columns
    are dropped, like the reference. The root's static OFFSET is excluded
    (the reference seeds the root's world position from its position
    channels only, ref :142-144). Inverse is unsupported, matching the
    reference (positions->rotations is not implemented there either).
    """

    def transform(self, tracks: List[Track]) -> List[Track]:
        from gesture2vec_tpu_torch.mocap.fk import (_topo_order,
                                                    forward_kinematics)

        out = []
        for tr in tracks:
            data = tr.to_bvh()
            pos = forward_kinematics(data)
            root_off = np.asarray(data.skeleton[data.root_name].offsets,
                                  dtype=np.float64)
            cols: List[str] = []
            vals: List[np.ndarray] = []
            for joint in _topo_order(data):
                p = pos[joint] - root_off
                for k, ax in enumerate("XYZ"):
                    cols.append(f"{joint}_{ax}position")
                    vals.append(p[:, k])
            out.append(tr.replace(columns=cols,
                                  values=np.stack(vals, axis=1)))
        return out

    def inverse_transform(self, tracks):
        raise NotImplementedError(
            "positions -> rotations is not supported (matches the "
            "reference MocapParameterizer('position'))")


class Slicer(Transform):
    """Slice each track into fixed windows with fractional overlap and
    pool them into one (n_windows, window_size, C) array
    (ref: pymo/preprocessing.py:425-477). overlap is a fraction of the
    window; stride = window_size - int(overlap * window_size). fit stores
    an empty column template so inverse_transform can rebuild Tracks from
    arrays, like the reference's org_mocap_ clone.
    """

    def __init__(self, window_size: int, overlap: float = 0.5):
        self.window_size = int(window_size)
        self.overlap = float(overlap)
        self.template: Optional[Track] = None

    def fit(self, tracks: List[Track]) -> "Slicer":
        self.template = tracks[0]
        return self

    def transform(self, tracks: List[Track]) -> np.ndarray:
        ws = self.window_size
        ov = int(self.overlap * ws)
        stride = ws - ov
        wins = []
        for tr in tracks:
            n = (tr.values.shape[0] - ov) // stride
            for i in range(max(0, n)):
                wins.append(tr.values[i * stride:i * stride + ws])
        return np.array(wins)

    def inverse_transform(self, arrays) -> List[Track]:
        assert self.template is not None, "Slicer not fitted"
        return [self.template.replace(values=np.asarray(a, dtype=np.float64))
                for a in arrays]

    def state_dict(self):
        return _track_state(self.template)

    def load_state_dict(self, state):
        self.template = _track_from_state(state)


class RootDeltas(Transform):
    """RootTransformer('abdolute_translation_deltas')
    (ref: pymo/preprocessing.py:478-615): the root's X/Z positions become
    per-frame deltas <root>_dXposition/<root>_dZposition appended at the
    end of the column list, with the first delta duplicated from the
    second (ref :525-526). With position_smoothing > 0 the smoothed
    trajectory is differenced and the residual x - smooth(x) stays in the
    position columns (ref :510-517); otherwise the position columns are
    dropped. inverse_transform integrates the deltas from start_pos:
    position[i] = start + sum(delta[1..i]) — delta[0] never contributes
    (ref :574-594) — and re-appends X/Z at the END of the columns (the
    reference assigns to dropped DataFrame columns, which appends).
    """

    def __init__(self, position_smoothing: float = 0.0):
        self.position_smoothing = float(position_smoothing)

    def _root_cols(self, tr: Track):
        root = tr.source.root_name
        return f"{root}_Xposition", f"{root}_Zposition", \
            f"{root}_dXposition", f"{root}_dZposition"

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            xp, zp, dxp, dzp = self._root_cols(tr)
            cidx = {c: i for i, c in enumerate(tr.columns)}
            x = tr.values[:, cidx[xp]].copy()
            z = tr.values[:, cidx[zp]].copy()
            if self.position_smoothing > 0:
                from scipy.ndimage import gaussian_filter1d
                x_sm = gaussian_filter1d(x, self.position_smoothing,
                                         axis=0, mode="nearest")
                z_sm = gaussian_filter1d(z, self.position_smoothing,
                                         axis=0, mode="nearest")
                dx, dz = _diff_first_dup(x_sm), _diff_first_dup(z_sm)
                cols = list(tr.columns) + [dxp, dzp]
                vals = tr.values.copy()
                vals[:, cidx[xp]] = x - x_sm
                vals[:, cidx[zp]] = z - z_sm
                vals = np.column_stack([vals, dx, dz])
            else:
                dx, dz = _diff_first_dup(x), _diff_first_dup(z)
                keep = [i for i, c in enumerate(tr.columns)
                        if c not in (xp, zp)]
                cols = [tr.columns[i] for i in keep] + [dxp, dzp]
                vals = np.column_stack([tr.values[:, keep], dx, dz])
            out.append(tr.replace(columns=cols, values=vals))
        return out

    def inverse_transform(self, tracks: List[Track],
                          start_pos=None) -> List[Track]:
        startx, startz = start_pos if start_pos is not None else (0.0, 0.0)
        out = []
        for tr in tracks:
            xp, zp, dxp, dzp = self._root_cols(tr)
            cidx = {c: i for i, c in enumerate(tr.columns)}
            dx = tr.values[:, cidx[dxp]]
            dz = tr.values[:, cidx[dzp]]
            recx = startx + np.concatenate([[0.0], np.cumsum(dx[1:])])
            recz = startz + np.concatenate([[0.0], np.cumsum(dz[1:])])
            if self.position_smoothing > 0:
                vals = tr.values.copy()
                vals[:, cidx[xp]] += recx
                vals[:, cidx[zp]] += recz
                keep = [i for i, c in enumerate(tr.columns)
                        if c not in (dxp, dzp)]
                out.append(tr.replace(
                    columns=[tr.columns[i] for i in keep],
                    values=vals[:, keep]))
            else:
                keep = [i for i, c in enumerate(tr.columns)
                        if c not in (dxp, dzp)]
                cols = [tr.columns[i] for i in keep] + [xp, zp]
                vals = np.column_stack([tr.values[:, keep], recx, recz])
                out.append(tr.replace(columns=cols, values=vals))
        return out


class RootCentricPositionNormalizer(Transform):
    """Subtract the root's floor-projected position (X, 0, Z) from every
    joint's world position (ref: pymo/preprocessing.py:675-755).

    Reference quirks preserved: "non-root" means the joint name does not
    CONTAIN the root name as a substring (ref :697), so joints named
    after the root are dropped from the output entirely; the output holds
    only position triples, non-root joints first then the root's own
    (unchanged) triple at the end; and inverse_transform adds the
    projected root position back to EVERY joint including the root
    itself, doubling the root's X/Z (ref :735-741). Set
    parity_root_double=False for the repaired inverse that restores the
    root exactly.
    """

    def __init__(self, parity_root_double: bool = True):
        self.parity_root_double = parity_root_double

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            root = tr.source.root_name
            cidx = {c: i for i, c in enumerate(tr.columns)}
            proj = np.stack([tr.values[:, cidx[f"{root}_Xposition"]],
                             np.zeros(tr.values.shape[0]),
                             tr.values[:, cidx[f"{root}_Zposition"]]],
                            axis=1)
            cols: List[str] = []
            vals: List[np.ndarray] = []
            joints = [j for j in tr.source.skeleton if root not in j]
            for joint in joints:
                for k, ax in enumerate("XYZ"):
                    c = f"{joint}_{ax}position"
                    if c in cidx:
                        cols.append(c)
                        vals.append(tr.values[:, cidx[c]] - proj[:, k])
            for ax in "XYZ":
                c = f"{root}_{ax}position"
                cols.append(c)
                vals.append(tr.values[:, cidx[c]].copy())
            out.append(tr.replace(columns=cols,
                                  values=np.stack(vals, axis=1)))
        return out

    def inverse_transform(self, tracks: List[Track]) -> List[Track]:
        out = []
        for tr in tracks:
            root = tr.source.root_name
            cidx = {c: i for i, c in enumerate(tr.columns)}
            proj = np.stack([tr.values[:, cidx[f"{root}_Xposition"]],
                             np.zeros(tr.values.shape[0]),
                             tr.values[:, cidx[f"{root}_Zposition"]]],
                            axis=1)
            cols: List[str] = []
            vals: List[np.ndarray] = []
            for joint in tr.source.skeleton:
                add = proj if (self.parity_root_double or joint != root) \
                    else np.zeros_like(proj)
                for k, ax in enumerate("XYZ"):
                    c = f"{joint}_{ax}position"
                    if c in cidx:
                        cols.append(c)
                        vals.append(tr.values[:, cidx[c]] + add[:, k])
            out.append(tr.replace(columns=cols,
                                  values=np.stack(vals, axis=1)))
        return out


class ListStandardScaler(Transform):
    """Per-column z-normalization with statistics pooled over every frame
    of every track (ref: pymo/preprocessing.py:799-846). Accepts Tracks
    or plain arrays (the reference's is_DataFrame flag is auto-detected).
    """

    def __init__(self):
        self.data_mean: Optional[np.ndarray] = None
        self.data_std: Optional[np.ndarray] = None

    def fit(self, items) -> "ListStandardScaler":
        flat = np.concatenate([_item_values(it) for it in items], axis=0)
        self.data_mean = flat.mean(axis=0)
        self.data_std = flat.std(axis=0)
        return self

    def transform(self, items):
        return [_item_apply(it, lambda v: (v - self.data_mean) /
                            self.data_std) for it in items]

    def inverse_transform(self, items):
        return [_item_apply(it, lambda v: v * self.data_std +
                            self.data_mean) for it in items]

    def state_dict(self):
        return {"mean": self.data_mean.tolist(),
                "std": self.data_std.tolist()}

    def load_state_dict(self, state):
        self.data_mean = np.asarray(state["mean"], dtype=np.float64)
        self.data_std = np.asarray(state["std"], dtype=np.float64)


class ListMinMaxScaler(Transform):
    """Per-column min-max scaling to [0, 1] with statistics pooled over
    every frame of every track (ref: pymo/preprocessing.py:849-897).
    """

    def __init__(self):
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, items) -> "ListMinMaxScaler":
        flat = np.concatenate([_item_values(it) for it in items], axis=0)
        self.data_min = flat.min(axis=0)
        self.data_max = flat.max(axis=0)
        return self

    def transform(self, items):
        span = self.data_max - self.data_min
        return [_item_apply(it, lambda v: (v - self.data_min) / span)
                for it in items]

    def inverse_transform(self, items):
        span = self.data_max - self.data_min
        return [_item_apply(it, lambda v: v * span + self.data_min)
                for it in items]

    def state_dict(self):
        return {"min": self.data_min.tolist(),
                "max": self.data_max.tolist()}

    def load_state_dict(self, state):
        self.data_min = np.asarray(state["min"], dtype=np.float64)
        self.data_max = np.asarray(state["max"], dtype=np.float64)


class ReverseTime(Transform):
    """Append (or substitute) time-reversed copies of every track — a
    data-augmentation transform (ref: pymo/preprocessing.py:936-961).
    Inverse is identity, like the reference.
    """

    def __init__(self, append: bool = True):
        self.append = append

    def transform(self, tracks: List[Track]) -> List[Track]:
        out = list(tracks) if self.append else []
        for tr in tracks:
            out.append(tr.replace(values=tr.values[::-1].copy()))
        return out


class Flattener(Transform):
    """Concatenate a list of arrays along the frame axis
    (ref: pymo/preprocessing.py:757-765)."""

    def transform(self, items):
        return np.concatenate(items, axis=0)


def _diff_first_dup(x: np.ndarray) -> np.ndarray:
    """Frame-to-frame diff with the first entry duplicated from the
    second (pandas .diff() leaves NaN at 0; the reference overwrites it
    with dx[1], ref: pymo/preprocessing.py:525-526)."""
    d = np.empty_like(x)
    if x.shape[0] > 1:
        d[1:] = x[1:] - x[:-1]
        d[0] = d[1]
    else:
        d[:] = 0.0
    return d


def _item_values(item) -> np.ndarray:
    return item.values if isinstance(item, Track) else np.asarray(item)


def _item_apply(item, fn):
    if isinstance(item, Track):
        return item.replace(values=fn(item.values))
    return fn(np.asarray(item))


def _track_state(t: Optional[Track]) -> Dict:
    if t is None:
        return {}
    from gesture2vec_tpu_torch.io.bvh import write_bvh
    snap = t.source.clone()
    snap.values = snap.values[:1] if snap.values.shape[0] else snap.values
    return {"columns": t.columns, "framerate": t.framerate,
            "bvh_header": write_bvh(snap)}


def _track_from_state(state: Dict) -> Optional[Track]:
    if not state:
        return None
    from gesture2vec_tpu_torch.io.bvh import parse_bvh
    src = parse_bvh(state["bvh_header"], from_text=True)
    return Track(source=src, columns=list(state["columns"]),
                 values=np.zeros((0, len(state["columns"]))),
                 framerate=float(state["framerate"]))


class MotionPipeline:
    """Ordered transform chain with fit_transform / inverse_transform and
    JSON persistence (replaces joblib'd sklearn Pipeline,
    ref: scripts/trinity_data_to_lmdb.py:37-47)."""

    def __init__(self, steps: List[Tuple[str, Transform]]):
        self.steps = steps

    def fit_transform(self, data: List[BVHData]):
        x = [Track.from_bvh(d) for d in data]
        for _, t in self.steps:
            x = t.fit(x).transform(x)
        return x

    def transform(self, data: List[BVHData]):
        x = [Track.from_bvh(d) for d in data]
        for _, t in self.steps:
            x = t.transform(x)
        return x

    def inverse_transform(self, arrays) -> List[BVHData]:
        x = arrays
        for _, t in reversed(self.steps):
            x = t.inverse_transform(x)
        return [tr.to_bvh() for tr in x]

    def save(self, path: str) -> None:
        state = {name: t.state_dict() for name, t in self.steps}
        meta = {"steps": [(name, type(t).__name__,
                           _ctor_args(t)) for name, t in self.steps],
                "state": state}
        with open(path, "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "MotionPipeline":
        with open(path) as f:
            meta = json.load(f)
        registry = {c.__name__: c for c in
                    (Downsample, RootCentric, Mirror, JointSelect,
                     ConstantsRemover, Numpyfy, RootNormalizer, ToExpmap,
                     ToPositions, Slicer, RootDeltas,
                     RootCentricPositionNormalizer, ListStandardScaler,
                     ListMinMaxScaler, ReverseTime, Flattener)}
        steps = []
        for name, clsname, kwargs in meta["steps"]:
            t = registry[clsname](**kwargs)
            t.load_state_dict(meta["state"][name])
            steps.append((name, t))
        return cls(steps)


def _ctor_args(t: Transform) -> Dict:
    if isinstance(t, Downsample):
        return {"tgt_fps": t.tgt_fps, "keep_all": t.keep_all}
    if isinstance(t, Mirror):
        return {"axis": t.axis, "append": t.append,
                "lr_markers": list(t.lr_markers)}
    if isinstance(t, JointSelect):
        return {"joints": t.joints, "include_root": t.include_root}
    if isinstance(t, ConstantsRemover):
        return {"eps": t.eps}
    if isinstance(t, Slicer):
        return {"window_size": t.window_size, "overlap": t.overlap}
    if isinstance(t, RootDeltas):
        return {"position_smoothing": t.position_smoothing}
    if isinstance(t, RootCentricPositionNormalizer):
        return {"parity_root_double": t.parity_root_double}
    if isinstance(t, ReverseTime):
        return {"append": t.append}
    return {}
