"""Clip store: the corpus cache between ingest and training.

The port's copy of the JAX package's `data/store.py`, on the port's own
msgpack codec (`utils/mpack`). Layout:
    <root>/meta.msgpack      {"clips": [{vid, file, n_frames, words}],
                              "pose_mean": [...], "pose_std": [...],
                              ...}
    <root>/clip_<i>.npz      poses (T, D) f16, audio (S,) f32 optional,
                             plus any named arrays
Poses are stored float16 and read back as float32. Stores written by
either package read identically through the other.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from gesture2vec_tpu_torch.utils import mpack


class ClipStoreWriter:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._clips: List[Dict[str, Any]] = []
        self._extra: Dict[str, Any] = {}

    def add_clip(self, vid: str, poses: np.ndarray,
                 words: Optional[List] = None,
                 audio: Optional[np.ndarray] = None,
                 **arrays: np.ndarray) -> None:
        """words: list of [word, start_s, end_s] triples."""
        fname = f"clip_{len(self._clips):05d}.npz"
        data = {"poses": np.asarray(poses, dtype=np.float16)}
        if audio is not None:
            data["audio"] = np.asarray(audio, dtype=np.float32)
        data.update({k: np.asarray(v) for k, v in arrays.items()})
        np.savez_compressed(os.path.join(self.root, fname), **data)
        self._clips.append({
            "vid": vid, "file": fname, "n_frames": int(poses.shape[0]),
            "words": [[w, float(s), float(e)] for w, s, e in (words or [])],
        })

    def set_stats(self, mean: np.ndarray, std: np.ndarray) -> None:
        self._extra["pose_mean"] = np.asarray(mean, np.float64).tolist()
        self._extra["pose_std"] = np.asarray(std, np.float64).tolist()

    def set_meta(self, **kw) -> None:
        self._extra.update(kw)

    def finish(self) -> None:
        meta = {"clips": self._clips, **self._extra}
        with open(os.path.join(self.root, "meta.msgpack"), "wb") as f:
            f.write(mpack.packb(meta))


class ClipStore:
    """Read side. Clip arrays are cached per index (an LRU of 4 clips)."""

    _CACHE_DEPTH = 4

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "meta.msgpack"), "rb") as f:
            self.meta = mpack.unpackb(f.read())
        self.clips = self.meta["clips"]
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = \
            OrderedDict()

    def __len__(self) -> int:
        return len(self.clips)

    @property
    def pose_mean(self) -> Optional[np.ndarray]:
        m = self.meta.get("pose_mean")
        return None if m is None else np.asarray(m, np.float32)

    @property
    def pose_std(self) -> Optional[np.ndarray]:
        s = self.meta.get("pose_std")
        return None if s is None else np.asarray(s, np.float32)

    def arrays(self, i: int) -> Dict[str, np.ndarray]:
        if i in self._cache:
            self._cache.move_to_end(i)
            return dict(self._cache[i])
        with np.load(os.path.join(self.root, self.clips[i]["file"]),
                     allow_pickle=False) as z:
            arrs = {k: z[k] for k in z.files}
        # cached arrays are shared across calls: read-only, so an
        # in-place change raises instead of corrupting the cache
        for a in arrs.values():
            a.flags.writeable = False
        self._cache[i] = arrs
        if len(self._cache) > self._CACHE_DEPTH:
            self._cache.popitem(last=False)
        return dict(arrs)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        entry = dict(self.clips[i])
        entry.update(self.arrays(i))
        entry["poses"] = entry["poses"].astype(np.float32)
        return entry

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]
