"""Streaming window and frame sources for corpora larger than host RAM.

The port's copy of the JAX package's `data/streaming.py`, over the port's
`data/store.ClipStore` (whose LRU keeps only a few clips resident) and
numpy `data/datasets.extract_windows`. Clips are read one at a time in a
per-epoch permuted order, their rows pass through a bounded reservoir
shuffle, and fixed-shape batches come out: RAM stays O(shuffle_rows + 2
batches) whatever the corpus size. Both shuffles draw from
np.random.default_rng(seed + epoch), so an epoch's batches are the JAX
package's, bit for bit, over the same store.

A source has `.batches(epoch, batch_size)` and `__len__`; the trainers
(`train/dae_trainer.train_dae`, `train/seq_ae_trainer.train_seq_ae`) take
one in place of the in-RAM array. `StreamingWindows`' transform maps each
(B, n_poses, D) batch to the model's input (the frozen-DAE teacher for
Part b) inside the prefetch worker thread (`utils/prefetch`), so the
teacher's work overlaps the training step.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

from gesture2vec_tpu_torch.data.datasets import extract_windows, normalize
from gesture2vec_tpu_torch.data.store import ClipStore


def _shuffled_stream(items: Iterator[np.ndarray], buffer_rows: int,
                     rng: np.random.Generator) -> Iterator[np.ndarray]:
    """Reservoir shuffle over row blocks: up to buffer_rows rows stay
    resident; once full, each new row swaps a random resident one out.
    Rows are copied in, so no yielded row pins its whole clip."""
    buf: list = []
    for block in items:
        for row in block:
            if len(buf) < buffer_rows:
                buf.append(row.copy())
                continue
            j = int(rng.integers(len(buf)))
            out, buf[j] = buf[j], row.copy()
            yield out
    rng.shuffle(buf)
    yield from buf


def _batched(rows: Iterator[np.ndarray], batch_size: int
             ) -> Iterator[np.ndarray]:
    """Stacked batches of batch_size rows; the trailing partial batch is
    dropped, as the in-RAM loops drop it."""
    buf = []
    for row in rows:
        buf.append(row)
        if len(buf) == batch_size:
            yield np.stack(buf, axis=0)
            buf.clear()


class StreamingWindows:
    """(n_poses, D) windows over a ClipStore: the parameters of
    `data/datasets.pose_windows`, plus the reservoir's size, the seed and
    an optional transform of each batch."""

    def __init__(self, store: ClipStore, n_poses: int, stride: int,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 shuffle_rows: int = 4096, seed: int = 0,
                 transform: Optional[Callable] = None):
        self.store = store
        self.n_poses = n_poses
        self.stride = stride
        self.mean = store.pose_mean if mean is None else mean
        self.std = store.pose_std if std is None else std
        self.shuffle_rows = shuffle_rows
        self.seed = seed
        self.transform = transform
        # windows per clip, from the metadata alone
        self._per_clip = [max((c["n_frames"] - n_poses) // stride + 1, 0)
                          for c in store.clips]
        self._n = sum(self._per_clip)

    def __len__(self) -> int:
        return self._n

    def _clip_windows(self, i: int) -> np.ndarray:
        poses = self.store.arrays(i)["poses"].astype(np.float32)
        w = extract_windows(poses, self.n_poses, self.stride)
        if self.mean is not None and self.std is not None:
            w = normalize(w, self.mean, self.std)
        return w.astype(np.float32)

    def batches(self, epoch: int, batch_size: int) -> Iterator:
        """The epoch's (batch_size, n_poses, D) batches (transformed when
        a transform is set), the same every call."""
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.store.clips))
        blocks = (self._clip_windows(int(i)) for i in order
                  if self._per_clip[int(i)])
        for batch in _batched(_shuffled_stream(blocks, self.shuffle_rows,
                                               rng), batch_size):
            yield self.transform(batch) if self.transform else batch


class StreamingFrames:
    """(D,) frames over a ClipStore (the Part-a data): every frame of the
    corpus, as `data/datasets.all_frames`, without concatenating it."""

    def __init__(self, store: ClipStore,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 shuffle_rows: int = 65536, seed: int = 0):
        self.store = store
        self.mean = store.pose_mean if mean is None else mean
        self.std = store.pose_std if std is None else std
        self.shuffle_rows = shuffle_rows
        self.seed = seed
        self._n = sum(c["n_frames"] for c in store.clips)

    def __len__(self) -> int:
        return self._n

    def batches(self, epoch: int, batch_size: int) -> Iterator[np.ndarray]:
        """The epoch's (batch_size, D) batches, the same every call."""
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.store.clips))

        def blocks():
            for i in order:
                poses = self.store.arrays(int(i))["poses"].astype(np.float32)
                if self.mean is not None and self.std is not None:
                    poses = normalize(poses, self.mean, self.std)
                yield poses.astype(np.float32)

        yield from _batched(_shuffled_stream(blocks(), self.shuffle_rows,
                                             rng), batch_size)
