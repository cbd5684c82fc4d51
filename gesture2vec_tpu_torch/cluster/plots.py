"""Analysis plots: codebook t-SNE, latent spaces, attention heatmaps.

The port's copy of the JAX package's `cluster/plots.py`: host code on
numpy arrays, matplotlib and scikit-learn imported inside the functions
(the rest of the port runs where they are missing). Rebuilds the reference's matplotlib artifacts:
  plot_codebook_tsne  <- per-epoch codebook t-SNE
                         (ref: scripts/train_autoencoder_VQVAE.py:450-545,
                         scripts/train_DAE.py:491-570 plot_embedding)
  plot_latent_space   <- latent scatter/heatmap
                         (ref: scripts/inference_DAE.py:267-355,
                         scripts/Clustering.py:1020-1113 plot_tsne)
  plot_attention      <- attention matrix heatmaps
                         (ref: scripts/inference_text2embedding.py:69-105)
openTSNE is replaced by sklearn's TSNE (PCA(50) pre-reduction kept).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported (the CLIs check a plot flag
    before any work)."""
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def _agg():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def tsne_embed(x: np.ndarray, seed: int = 0,
               pca_dims: int = 50) -> np.ndarray:
    """PCA(50) -> t-SNE 2D (ref: Clustering.py:1020-1060)."""
    from sklearn.decomposition import PCA
    from sklearn.manifold import TSNE

    x = np.asarray(x, np.float64)
    n_comp = min(pca_dims, x.shape[0] - 1, x.shape[1])
    if x.shape[1] > n_comp >= 2:
        x = PCA(n_components=n_comp, random_state=seed).fit_transform(x)
    perplexity = min(30.0, max(2.0, x.shape[0] / 4 - 1))
    return TSNE(n_components=2, random_state=seed,
                perplexity=perplexity, init="pca").fit_transform(x)


def plot_codebook_tsne(codebook: np.ndarray, path: str,
                       usage: Optional[np.ndarray] = None,
                       title: str = "codebook") -> None:
    plt = _agg()
    emb = tsne_embed(codebook)
    fig, ax = plt.subplots(figsize=(6, 6))
    s = 20 if usage is None else 10 + 90 * (usage / max(usage.max(), 1))
    ax.scatter(emb[:, 0], emb[:, 1], s=s, c=np.arange(len(emb)),
               cmap="viridis", alpha=0.8)
    ax.set_title(title)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_latent_space(latents: np.ndarray, path: str,
                      labels: Optional[Sequence[int]] = None,
                      title: str = "latents") -> None:
    plt = _agg()
    emb = tsne_embed(latents)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(emb[:, 0], emb[:, 1], s=8,
               c=(labels if labels is not None else "tab:blue"),
               cmap="tab20", alpha=0.7)
    ax.set_title(title)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_attention(attn: np.ndarray, path: str,
                   words: Optional[Sequence[str]] = None,
                   title: str = "attention") -> None:
    """attn (n_steps, seq_len) attention weights per decoded token."""
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 3))
    im = ax.imshow(np.asarray(attn), aspect="auto", cmap="viridis")
    ax.set_xlabel("input words")
    ax.set_ylabel("gesture tokens")
    if words is not None:
        ax.set_xticks(range(len(words)))
        ax.set_xticklabels(words, rotation=90, fontsize=6)
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
