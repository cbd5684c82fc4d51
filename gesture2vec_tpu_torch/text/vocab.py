"""Vocabulary: word -> id lookup for the text encoder.

The port's own copy of the JAX package's `text/vocab.py` lookup half
(same special-token ids PAD=0, SOS=1, EOS=2, UNK=3 and the same
normalisation), with its checkpoint state (`state_dict` /
`from_state_dict`, the `lang_model` of a Part-d checkpoint), a
`build_vocab` that builds ids, and `load_word_vectors`, the JAX
package's word-vector table for training Part d: rows from a `.npy`
table or a FastText `.vec` file, and for every word the file lacks (or
without a file) the same deterministic pseudo-vector, normal(0, 0.3)
seeded by the word's sha1.
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, SOS, EOS, UNK = 0, 1, 2, 3
_SPECIALS = {PAD: "<PAD>", SOS: "<SOS>", EOS: "<EOS>", UNK: "<UNK>"}


def normalize_string(s: str) -> str:
    """Lowercase, strip apostrophes (shouldn't -> shouldnt), keep
    alphanumerics and ,.!? (digits are kept, so "100" stays a token)."""
    s = s.lower().strip()
    s = re.sub(r"([,.!?])", r" \1 ", s)
    s = re.sub(r"(['])", "", s)
    s = re.sub(r"[^a-zA-Z0-9,.!?]+", " ", s)
    s = re.sub(r"\s+", " ", s).strip()
    return s


class Vocab:
    def __init__(self, name: str = "vocab"):
        self.name = name
        self.word2index: Dict[str, int] = {}
        self.word2count: Dict[str, int] = {}
        self.index2word: Dict[int, str] = dict(_SPECIALS)
        self.n_words = len(_SPECIALS)
        self.word_embedding_weights: Optional[np.ndarray] = None

    def index_word(self, word: str) -> None:
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.word2count[word] = 1
            self.index2word[self.n_words] = word
            self.n_words += 1
        else:
            self.word2count[word] += 1

    def index_words(self, sentence_words: Sequence[str]) -> None:
        for w in sentence_words:
            self.index_word(w)

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, UNK)

    def words_to_ids(self, words: List[str], add_sos_eos: bool = True
                     ) -> List[int]:
        ids = [self.get_word_index(w) for w in words]
        if add_sos_eos:
            ids = [SOS] + ids + [EOS]
        return ids

    def load_word_vectors(self, path: Optional[str], dim: int = 300) -> None:
        """The (n_words, dim) embedding table: a .npy table as it is, rows
        of a .vec file where it has the word, else `_hash_vector`."""
        if path is not None and os.path.exists(path):
            if path.endswith(".npy"):
                self.word_embedding_weights = np.load(path)
                if self.word_embedding_weights.shape != (self.n_words, dim):
                    raise ValueError(f"{path}: shape "
                                     f"{self.word_embedding_weights.shape}, "
                                     f"want {(self.n_words, dim)}")
                return
            table = _read_vec_file(path, dim)
        else:
            table = {}
        weights = np.zeros((self.n_words, dim), dtype=np.float32)
        for idx, word in self.index2word.items():
            weights[idx] = table[word] if word in table \
                else _hash_vector(word, dim)
        self.word_embedding_weights = weights

    def state_dict(self) -> dict:
        """The JAX package's vocab state, with the word vectors when the
        table was loaded."""
        return {"name": self.name, "word2index": dict(self.word2index),
                "word2count": dict(self.word2count),
                "weights": self.word_embedding_weights}

    @classmethod
    def from_state_dict(cls, state: dict) -> "Vocab":
        """Ids in the order of the state's word2index, as the JAX package
        rebuilds them, and its word vectors."""
        v = cls(state["name"])
        for w in sorted(state["word2index"], key=state["word2index"].get):
            v.index_word(w)
        v.word2count = dict(state["word2count"])
        w = state.get("weights")
        v.word_embedding_weights = None if w is None else np.asarray(w)
        return v


def _hash_vector(word: str, dim: int) -> np.ndarray:
    """Deterministic pseudo-embedding seeded by the word's sha1."""
    seed = int.from_bytes(hashlib.sha1(word.encode()).digest()[:8], "little")
    return np.random.default_rng(seed).normal(0, 0.3, dim).astype(np.float32)


def _read_vec_file(path: str, dim: int) -> Dict[str, np.ndarray]:
    table: Dict[str, np.ndarray] = {}
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue  # header line or malformed
            table[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
    return table


def build_vocab(name: str, word_lists: Sequence[Sequence[str]]) -> Vocab:
    """Corpus word lists -> Vocab: the ids of the JAX package's
    build_vocab, without its embedding matrix."""
    v = Vocab(name)
    for words in word_lists:
        v.index_words(words)
    return v
