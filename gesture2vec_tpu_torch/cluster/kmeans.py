"""K-Means (Lloyd's algorithm with k-means++ seeding) on the card.

Port of the JAX package's `cluster/kmeans.py` (sklearn-default
semantics: best of n_init fits by inertia, max_iter 300, stop once the
summed squared center shift is at most tol, empty clusters relocated
to the points farthest from their centers). Every assignment goes
through `ops/vq_kernel.vq_argmin`, whose (labels, minimum distances) is
all a Lloyd step needs: labels, the distances for relocation, and the
inertia.

k-means++ seeding cannot reproduce `jax.random`: the port draws from a
`torch.Generator` seeded with `seed`, with `torch.multinomial`. `lloyd`
takes its initial centers, so a caller (the tests) can start it from the
centers the JAX seeding gives.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.device import resolve_device
from gesture2vec_tpu_torch.ops.vq_kernel import vq_argmin, vq_argmin_plain


class KMeansResult(NamedTuple):
    centers: torch.Tensor   # (k, d)
    labels: torch.Tensor    # (n,) int64
    inertia: torch.Tensor   # scalar
    n_iter: List[int]       # Lloyd steps of each of the n_init fits


def plusplus_init(x: torch.Tensor, k: int,
                  generator: torch.Generator) -> torch.Tensor:
    """k-means++: the first center uniformly, each next one with
    probability proportional to the squared distance to the nearest
    center so far."""
    n = x.shape[0]
    first = x[torch.randint(n, (1,), generator=generator,
                            device=x.device)][0]
    centers = x.new_zeros((k, x.shape[1]))
    centers[0] = first
    min_d = torch.sum((x - first) ** 2, dim=1)
    for i in range(1, k):
        total = min_d.sum()
        # all points already chosen (k above the distinct points):
        # draw uniformly instead of from an all-zero distribution
        probs = torch.where(total > 0, min_d / total.clamp(min=1e-12),
                            torch.ones_like(min_d))
        c = x[torch.multinomial(probs, 1, generator=generator)][0]
        centers[i] = c
        min_d = torch.minimum(min_d, torch.sum((x - c) ** 2, dim=1))
    return centers


def _update(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
            point_d: torch.Tensor) -> torch.Tensor:
    """Every center moves to the mean of its points; an empty cluster
    takes one of the points farthest from their own centers (one
    distinct far point per empty cluster, in order)."""
    k = centers.shape[0]
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    # index_put_ with accumulate sorts the labels and sums each cluster's
    # points in order on CUDA: deterministic, where index_add_'s atomics
    # make every fit a different fit
    sums = torch.zeros_like(centers).index_put_((labels,), x,
                                                accumulate=True)
    means = torch.where(counts[:, None] > 0,
                        sums / counts.clamp(min=1)[:, None], centers)
    far = x[torch.argsort(-point_d, stable=True)[:k]]
    empty = counts == 0
    rank = (torch.cumsum(empty, 0) - 1).clamp(0, far.shape[0] - 1)
    return torch.where(empty[:, None], far[rank], means)


def lloyd_step(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """One Lloyd update, its assignment through the vq_argmin kernel."""
    return _update(x, centers, *vq_argmin(x, centers.contiguous()))


def lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int = 300,
          tol: float = 1e-4, use_kernel: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Lloyd's algorithm from the given centers, stopped after max_iter
    steps or once the summed squared shift is at most tol. Returns
    (centers, labels, inertia, steps). use_kernel=False assigns with
    vq_argmin's plain version on any device."""
    assign = vq_argmin if use_kernel else vq_argmin_plain
    centers, steps = centers.contiguous(), 0
    while steps < max_iter:
        new = _update(x, centers, *assign(x, centers))
        shift = torch.sum((new - centers) ** 2)
        centers = new
        steps += 1
        if not shift.item() > tol:
            break
    labels, dmin = assign(x, centers)
    return centers, labels, dmin.sum(), steps


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def kmeans_fit(x: Union[np.ndarray, torch.Tensor], k: int, *, seed: int = 0,
               n_init: int = 10, max_iter: int = 300, tol: float = 1e-4,
               device: Optional[Union[str, torch.device]] = None
               ) -> KMeansResult:
    """Best of n_init fits by inertia (strict <: the first fit wins
    ties). Runs on CUDA unless device says otherwise."""
    x = _as_tensor(x, resolve_device(device))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    best, steps = None, []
    for _ in range(n_init):
        centers, labels, inertia, n = lloyd(
            x, plusplus_init(x, k, gen), max_iter, tol)
        steps.append(n)
        if best is None or float(inertia) < float(best[2]):
            best = (centers, labels, inertia)
    return KMeansResult(*best, steps)


def kmeans_predict(x: Union[np.ndarray, torch.Tensor],
                   centers: Union[np.ndarray, torch.Tensor],
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.Tensor:
    dev = resolve_device(device)
    return vq_argmin(_as_tensor(x, dev), _as_tensor(centers, dev))[0]


def save_kmeans(path: str, result: KMeansResult) -> None:
    np.savez(path, centers=result.centers.cpu().numpy(),
             inertia=result.inertia.cpu().numpy())


def load_kmeans(path: str) -> np.ndarray:
    """The centers `save_kmeans` wrote (either package's file)."""
    with np.load(path) as z:
        return z["centers"]
