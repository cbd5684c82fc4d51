"""Background batch preparation and host-to-device copies.

The port's copy of the JAX package's `utils/prefetch.py`: a daemon
thread draws the next batches from an iterable (reading clips, a
streaming source's shuffle, a transform such as the frozen-DAE teacher)
and copies them to the device while the current step runs; a queue of
depth 2 is double buffering. On the card a numpy batch is copied from
pinned host memory with non_blocking=True. The copies and any kernel a
transform launches go on the thread's current stream, the device's
default one, which the training step uses too, so they stay ordered with
it. A transform's launch counts are safe there (`ops/build.count_launch`
takes a lock), and dropout is off in the worker: the dropout generator
is a context variable of the training thread (`models/layers`).

The worker checks a stop event between puts, so a consumer that stops
early (an exception mid-epoch, a generator dropped) releases the thread;
an exception in the worker is raised in the consumer. The consumer's
wait for a batch is the span g2v.feed.wait (`utils/profiling.annotate`).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.train.token_loop import to_device
from gesture2vec_tpu_torch.utils.profiling import annotate

_SENTINEL = object()


def place_on(batch: Any, device: torch.device) -> Any:
    """A batch (a numpy array converted as `train/token_loop.to_device`
    does, a tensor, or a tuple or list of them) on the device; a numpy
    array goes to a card from pinned host memory."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(place_on(b, device) for b in batch)
    if isinstance(batch, np.ndarray):
        if device.type != "cuda":
            return to_device(batch, device)
        batch = to_device(batch, "cpu").pin_memory()
    return batch.to(device, non_blocking=True)


def prefetch(batches: Iterable[Any], device: Union[str, torch.device],
             depth: int = 2, place: Any = None) -> Iterator[Any]:
    """Yield the batches of an iterable, each prepared and moved to the
    device by a worker thread up to depth batches ahead. `place` (the JAX
    package's mesh placement, `parallel/mesh.batch_placer`) takes a host
    batch to the device in place of `place_on`: under a mesh, this
    rank's rows of it."""
    dev = torch.device(device)
    place = place or (lambda b: place_on(b, dev))
    q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def worker():
        try:
            for b in batches:
                b = place(b)
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # raised in the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.5)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with annotate("feed.wait"):
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
