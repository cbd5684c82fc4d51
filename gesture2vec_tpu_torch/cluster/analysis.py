"""Latent-space analysis utilities.

Port of the JAX package's `cluster/analysis.py`:
  silhouette_sweep     K-Means silhouette scores over cluster counts; the
                       fits run the port's `cluster/kmeans` (one
                       `vq_argmin` launch a Lloyd step on the card), the
                       score is `silhouette_score`, computed in torch
                       where the JAX package calls scikit-learn's;
  encoder_kernel_poses each DAE encoder latent unit's input weights as a
                       pseudo-pose, and `plot_kernel_stickfigures` their
                       stick figures and heatmaps (matplotlib);
  save_unity_latents   the joint t-SNE of encoder kernels and latents as
                       text (scikit-learn), and `save_for_unity` per-frame
                       joint positions as text.
Everything but the sweep is host code on numpy arrays; matplotlib and
scikit-learn are imported inside the functions that need them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from gesture2vec_tpu_torch.device import resolve_device


def silhouette_score(x: torch.Tensor, labels: torch.Tensor) -> float:
    """scikit-learn's silhouette_score (euclidean) of x (N, D) under
    labels (N,): for each point a, its mean distance to the other points
    of its cluster, and b, its smallest mean distance to the points of
    another cluster; s = (b - a) / max(a, b), 0 for a point alone in its
    cluster; the mean over the points. The distances are taken in
    float64 from |x|^2 + |y|^2 - 2 x.y, clamped at 0, the diagonal 0, as
    scikit-learn takes them. Needs 2 <= clusters <= N - 1."""
    x = x.to(torch.float64)
    _, lab = torch.unique(labels, return_inverse=True)
    n, k = x.shape[0], int(lab.max()) + 1
    if not 2 <= k <= n - 1:
        raise ValueError(f"the silhouette needs 2 to {n - 1} clusters, "
                         f"got {k}")
    sq = torch.sum(x * x, dim=1)
    d = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2.0 * x @ x.T,
                               min=0.0))
    d.fill_diagonal_(0.0)
    onehot = torch.nn.functional.one_hot(lab, k).to(torch.float64)
    sums = d @ onehot                                       # (N, K)
    counts = onehot.sum(dim=0)                              # (K,)
    own = counts[lab]
    a = sums.gather(1, lab[:, None])[:, 0] / torch.clamp(own - 1, min=1)
    other = sums / counts[None, :]
    other.scatter_(1, lab[:, None], float("inf"))
    b = other.min(dim=1).values
    s = (b - a) / torch.maximum(a, b)
    s = torch.where(own > 1, torch.nan_to_num(s), torch.zeros_like(s))
    return float(s.mean())


def silhouette_sweep(latents: Union[np.ndarray, torch.Tensor],
                     k_range: Sequence[int] = range(2, 12), seed: int = 0,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[int, float]:
    """K-Means (n_init 3, 50 Lloyd steps at most, seeded with `seed`)
    silhouette score per cluster count; counts at or above the number of
    points end the sweep, and fits with one cluster left are skipped, as
    in JAX. Runs on CUDA unless device says otherwise."""
    from gesture2vec_tpu_torch.cluster.kmeans import kmeans_fit

    dev = resolve_device(device)
    x = (latents if isinstance(latents, torch.Tensor)
         else torch.from_numpy(np.asarray(latents, np.float32)))
    x = x.to(device=dev, dtype=torch.float32).contiguous()
    scores: Dict[int, float] = {}
    for k in k_range:
        if k >= len(x):
            break
        res = kmeans_fit(x, k, seed=seed, n_init=3, max_iter=50,
                         device=dev)
        if len(torch.unique(res.labels)) < 2:
            continue
        scores[k] = silhouette_score(x, res.labels)
    return scores


def encoder_kernel_poses(encoder_kernel: np.ndarray,
                         mean: np.ndarray, std: np.ndarray,
                         scale: float = 1.0) -> np.ndarray:
    """(motion_dim, latent_dim) DAE encoder kernel (the JAX layout: the
    port's `DAE.encoder.weight.T`) -> (latent_dim, motion_dim)
    pseudo-poses: each latent unit's weights, scaled to at most 1 and
    unnormalised into feature space, the pose pattern that excites that
    unit most."""
    k = np.asarray(encoder_kernel, np.float64)
    k = k / np.maximum(np.abs(k).max(axis=0, keepdims=True), 1e-8)
    poses = mean[None, :] + scale * k.T * np.clip(std, 0.01, None)[None, :]
    return poses


def plot_kernel_stickfigures(encoder_kernel: np.ndarray, fe,
                             mean: np.ndarray, std: np.ndarray,
                             out_dir: str, max_units: int = 16) -> list:
    """The DAE encoder kernel as PNGs under out_dir: the whole kernel
    (kernel_matrix.png), and for the first max_units latent units the
    pseudo-pose's stick figure (through fe.to_bvh) and the unit's weights
    as a (joints, feature width) heatmap (9, 12 or 3 wide; none for
    another width). Returns the paths written."""
    import os

    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    from gesture2vec_tpu_torch.mocap.viz import draw_stickfigure

    os.makedirs(out_dir, exist_ok=True)
    written = []
    k = np.asarray(encoder_kernel, np.float64)

    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(k, aspect="auto")
    ax.set_title(f"Kernel w ({k.min():.3f},{k.max():.3f})")
    fig.colorbar(im)
    p = os.path.join(out_dir, "kernel_matrix.png")
    fig.savefig(p, dpi=100, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    poses = encoder_kernel_poses(k, mean, std)
    feat_w = next((w for w in (9, 12, 3) if poses.shape[1] % w == 0),
                  None)
    n_joints = poses.shape[1] // feat_w if feat_w else 0
    for i in range(min(poses.shape[0], max_units)):
        data = fe.to_bvh(poses[i:i + 1])
        ax = draw_stickfigure(data, 0)
        ax.set_title(f"latent unit {i}")
        fig = ax.figure
        p = os.path.join(out_dir, f"kernel_{i:03d}_pose.png")
        fig.savefig(p, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

        if feat_w is None:
            continue
        fig, ax2 = plt.subplots(figsize=(4, 4))
        ax2.imshow(k[:, i].reshape(n_joints, feat_w))
        ax2.set_title(f"unit {i} ({n_joints},{feat_w} style)")
        p = os.path.join(out_dir, f"kernel_{i:03d}_heat.png")
        fig.savefig(p, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(p)
    return written


def save_unity_latents(kernels: np.ndarray, latents: np.ndarray,
                       indices: Sequence[int], components: int,
                       path: str, seed: int = 0) -> str:
    """The reference's Save4Unity latents.txt: a joint 2-D t-SNE
    (`cluster/plots.tsne_embed`) of encoder kernels and sample latents,
    written as the component count, then "x,y" per kernel, then
    "i,x,y,cluster_index" per latent."""
    from gesture2vec_tpu_torch.cluster.plots import tsne_embed

    combined = np.concatenate([np.asarray(kernels, np.float64),
                               np.asarray(latents, np.float64)], axis=0)
    emb = tsne_embed(combined, seed=seed)
    tk, tl = emb[:len(kernels)], emb[len(kernels):]
    with open(path, "w") as f:
        f.write(f"{components}\n")
        for row in tk:
            f.write(f"{row[0]:.3f},{row[1]:.3f}\n")
        for i, row in enumerate(tl):
            f.write(f"{i},{row[0]:.3f},{row[1]:.3f},{indices[i]}\n")
    return path


def save_for_unity(positions: Dict[str, np.ndarray], path: str,
                   joints: Optional[List[str]] = None) -> None:
    """Per-frame joint positions as 'joint:x,y,z;...' lines."""
    names = joints or list(positions.keys())
    T = next(iter(positions.values())).shape[0]
    with open(path, "w") as f:
        for t in range(T):
            parts = []
            for n in names:
                p = positions[n][t]
                parts.append(f"{n}:{p[0]:.4f},{p[1]:.4f},{p[2]:.4f}")
            f.write(";".join(parts) + "\n")
