"""Objective metrics for gesture token / latent distributions.

The port's copy (numpy / scipy) of the JAX package's
`cluster/metrics.py` pieces that the cluster CLI writes: Hellinger
distance between token histograms, Frechet distance between Gaussians
fit to latents, token perplexity, the Wasserstein distance between
token samples, the representation-neighbour smoothness metric, and
sentence / corpus BLEU over token sequences (single reference, the
JAX package's epsilon smoothing).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

import numpy as np
from scipy import linalg
from scipy.stats import wasserstein_distance  # noqa: F401 (re-export)


def hellinger(p: np.ndarray, q: np.ndarray) -> float:
    """H(p, q) = ||sqrt(p) - sqrt(q)||_2 / sqrt(2) of the normalised
    histograms."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    p = p / max(p.sum(), 1e-12)
    q = q / max(q.sum(), 1e-12)
    return float(np.sqrt(np.sum((np.sqrt(p) - np.sqrt(q)) ** 2)) /
                 math.sqrt(2))


def token_histogram(tokens: np.ndarray, n_classes: int) -> np.ndarray:
    return np.bincount(np.asarray(tokens).reshape(-1),
                       minlength=n_classes).astype(np.float64)


def frechet_distance(x: np.ndarray, y: np.ndarray, eps: float = 1e-6
                     ) -> float:
    """The FID / FGD formula between Gaussians fit to two latent sets."""
    mu1, mu2 = x.mean(0), y.mean(0)
    s1 = np.cov(x, rowvar=False)
    s2 = np.cov(y, rowvar=False)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2 * np.trace(covmean))


def token_perplexity(tokens: np.ndarray, n_classes: int) -> float:
    """exp(entropy of the empirical token distribution)."""
    hist = token_histogram(tokens, n_classes)
    p = hist / max(hist.sum(), 1)
    nz = p[p > 0]
    return float(np.exp(-(nz * np.log(nz)).sum()))


def representation_neighbor_distance(latents: np.ndarray) -> dict:
    """Mean L2 distance of each window's latent to its +-1 and +-2
    stride neighbours, raw and normalised by the corpus-wide mean
    pairwise distance (all pairs up to 2000 windows, else 200,000
    random pairs from numpy seed 0)."""
    x = np.asarray(latents, np.float64)
    n = x.shape[0]
    if n < 5:
        raise ValueError("need at least 5 windows")
    if n <= 2000:
        from scipy.spatial.distance import pdist
        avg_total = float(np.mean(pdist(x)))
    else:
        rng = np.random.default_rng(0)
        i = rng.integers(0, n, 200_000)
        j = rng.integers(0, n, 200_000)
        keep = i != j
        avg_total = float(np.mean(np.linalg.norm(x[i[keep]] - x[j[keep]],
                                                 axis=1)))
    mid = slice(2, n - 2)
    d1 = (np.linalg.norm(x[1:-3] - x[mid], axis=1) +
          np.linalg.norm(x[3:-1] - x[mid], axis=1)) / 2
    d2 = (np.linalg.norm(x[:-4] - x[mid], axis=1) +
          np.linalg.norm(x[4:] - x[mid], axis=1)) / 2
    return {
        "avg_near": float(d1.mean()), "std_near": float(d1.std()),
        "avg_far": float(d2.mean()), "std_far": float(d2.std()),
        "avg_dist_total": avg_total,
        "normal_avg_near": float(d1.mean() / avg_total),
        "normal_avg_far": float(d2.mean() / avg_total),
    }


def _ngrams(seq: Sequence[int], n: int) -> Counter:
    return Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def sentence_bleu(candidate: Sequence[int], reference: Sequence[int],
                  max_n: int = 4) -> float:
    """Modified-precision BLEU with brevity penalty against one
    reference; zero precisions become 1e-9 so that short token sequences
    do not score 0."""
    precisions = []
    for n in range(1, max_n + 1):
        cand = _ngrams(candidate, n)
        ref = _ngrams(reference, n)
        overlap = sum(min(c, ref[g]) for g, c in cand.items())
        total = max(sum(cand.values()), 1)
        precisions.append(max(overlap, 0) / total)
    if min(precisions) == 0:
        precisions = [max(p, 1e-9) for p in precisions]
    log_p = sum(math.log(p) for p in precisions) / max_n
    bp = 1.0 if len(candidate) >= len(reference) else \
        math.exp(1 - len(reference) / max(len(candidate), 1))
    return bp * math.exp(log_p)


def corpus_bleu(candidates: List[Sequence[int]],
                references: List[Sequence[int]], max_n: int = 4) -> float:
    """The mean sentence BLEU of candidate / reference pairs (0 for none)."""
    if len(candidates) != len(references):
        raise ValueError(f"{len(candidates)} candidates, "
                         f"{len(references)} references")
    scores = [sentence_bleu(c, r, max_n) for c, r in
              zip(candidates, references)]
    return float(np.mean(scores)) if scores else 0.0
