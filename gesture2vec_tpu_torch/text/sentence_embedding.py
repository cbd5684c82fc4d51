"""Pluggable sentence-embedding providers (the reference's GPT-3 hook):
the port's copy of the JAX package's `text/sentence_embedding.py`, numpy
in and numpy out, with the same vectors for the same inputs.

Rebuild of the reference's GPT-3 embedding machinery:
  - ``DataPreprocessor.GPT_3_caller`` (ref: scripts/data_loader/
    data_preprocessor.py:459-472) is committed as a stub that
    ``return 1``-s before any work, so every cached ``GPT3_Embedding``
    batch slot (ref: lmdb_data_loader.py:67-119) holds the constant 1;
  - the GENEA inference caller + pickle cache (ref:
    scripts/inference_text2embedding_GENEA.py:57-68; cache file
    ``<transcript>.gpt`` holding {sample_words_list,
    GPT_3_Embedding_list}, :547-552) makes live OpenAI
    ``text-similarity-ada-001`` calls — and carries a leaked API key at
    :56, which is deliberately NOT replicated here;
  - the consuming DNN encoder head is inside a commented-out block
    (ref: Helper_models.py:452-840), so ``GPT3_embedding_active=True``
    cannot actually run in the reference.

This module keeps the *interface* so the batch slot has a first-class
equivalent: a provider maps a sentence string to a fixed-dim vector.

  ConstantProvider     — the reference's committed stub (returns 1s)
  HashedNGramProvider  — deterministic, offline, no-egress stand-in
                         (word + bigram feature hashing, L2-normalized)
  ApiProvider          — adapts any user callable (e.g. a real OpenAI
                         client) without this package importing network
                         libraries
  CachedProvider       — look-up-then-call semantics with a
                         self-contained npz cache; can import the
                         reference's ``.gpt`` pickle caches
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class SentenceEmbeddingProvider:
    """Interface: ``dim`` plus ``embed_sentence(text) -> (dim,)``."""

    dim: int

    def embed_sentence(self, text: str) -> np.ndarray:
        raise NotImplementedError

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.embed_sentence(t) for t in texts], axis=0)


class ConstantProvider(SentenceEmbeddingProvider):
    """The reference's committed behavior: GPT_3_caller returns the
    scalar 1 unconditionally (ref: data_preprocessor.py:459-461), so
    the GPT3_Embedding slot is a constant."""

    def __init__(self, dim: int = 1, value: float = 1.0):
        self.dim = dim
        self.value = float(value)

    def embed_sentence(self, text: str) -> np.ndarray:
        return np.full((self.dim,), self.value, np.float32)


class HashedNGramProvider(SentenceEmbeddingProvider):
    """Deterministic offline sentence embedding: hash each word and
    word-bigram into a ``dim``-d signed feature vector, L2-normalize.
    Same spirit as text/vocab.py's hash fallback for fasttext: no model
    file, no network, stable across runs/processes."""

    def __init__(self, dim: int = 1024, seed: int = 0):
        self.dim = dim
        self.seed = seed

    def _feature(self, token: str) -> np.ndarray:
        # stable per-token pseudo-random signed indicator
        h = np.frombuffer(token.encode("utf-8"), np.uint8).astype(np.uint64)
        acc = np.uint64(1469598103934665603 + self.seed)
        for b in h:
            acc = np.uint64((int(acc) ^ int(b)) *
                            1099511628211 & 0xFFFFFFFFFFFFFFFF)
        rng = np.random.default_rng(int(acc))
        vec = np.zeros(self.dim, np.float32)
        idx = rng.integers(0, self.dim, size=4)
        vec[idx] = rng.choice([-1.0, 1.0], size=4)
        return vec

    def embed_sentence(self, text: str) -> np.ndarray:
        words = [w for w in text.lower().split() if w]
        if not words:
            return np.zeros((self.dim,), np.float32)
        feats = [self._feature(w) for w in words]
        feats += [self._feature(a + "_" + b)
                  for a, b in zip(words, words[1:])]
        v = np.sum(feats, axis=0)
        n = float(np.linalg.norm(v))
        return (v / n if n > 0 else v).astype(np.float32)


class ApiProvider(SentenceEmbeddingProvider):
    """Adapter for a user-supplied embedding callable, e.g.::

        ApiProvider(lambda s: client.embeddings.create(
            input=s, model=...).data[0].embedding, dim=1536)

    mirroring the reference's live openai.Embedding.create call
    (ref: inference_text2embedding_GENEA.py:65-68) without importing
    any network client here."""

    def __init__(self, fn: Callable[[str], Sequence[float]], dim: int):
        self._fn = fn
        self.dim = dim

    def embed_sentence(self, text: str) -> np.ndarray:
        out = np.asarray(self._fn(text), np.float32).reshape(-1)
        if out.shape[0] != self.dim:
            raise ValueError(f"provider returned dim {out.shape[0]}, "
                             f"expected {self.dim}")
        return out


class CachedProvider(SentenceEmbeddingProvider):
    """Look-up-then-call with a persistent cache, reproducing the
    reference's semantics (scan the cache for the exact sentence, else
    call the live provider — ref: inference_text2embedding_GENEA.py:
    57-68) with a self-contained npz file instead of a pickle."""

    def __init__(self, provider: SentenceEmbeddingProvider,
                 path: Optional[str] = None):
        self.provider = provider
        self.dim = provider.dim
        self.path = path
        self._cache: Dict[str, np.ndarray] = {}
        if path and os.path.exists(path):
            self._cache = load_cache(path)

    @property
    def n_cached(self) -> int:
        return len(self._cache)

    def embed_sentence(self, text: str) -> np.ndarray:
        hit = self._cache.get(text)
        if hit is not None:
            return hit
        emb = self.provider.embed_sentence(text)
        self._cache[text] = emb
        return emb

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("no cache path")
        save_cache(path, self._cache)


def save_cache(path: str, cache: Dict[str, np.ndarray]) -> None:
    texts = list(cache.keys())
    embs = (np.stack([cache[t] for t in texts], axis=0)
            if texts else np.zeros((0, 0), np.float32))
    np.savez_compressed(path, texts=np.array(texts, dtype=object),
                        embeddings=embs)


def load_cache(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=True) as z:
        texts = [str(t) for t in z["texts"]]
        embs = np.asarray(z["embeddings"], np.float32)
    return {t: embs[i] for i, t in enumerate(texts)}


def import_reference_gpt_cache(gpt_path: str) -> Dict[str, np.ndarray]:
    """Convert a reference ``.gpt`` pickle cache ({sample_words_list,
    GPT_3_Embedding_list}, ref: inference_text2embedding_GENEA.py:
    547-552, 57-63) into a CachedProvider-compatible dict."""
    with open(gpt_path, "rb") as f:
        raw = pickle.load(f)
    texts: List[str] = list(raw["sample_words_list"])
    embs = [np.asarray(e, np.float32).reshape(-1)
            for e in raw["GPT_3_Embedding_list"]]
    return {t: e for t, e in zip(texts, embs)}
