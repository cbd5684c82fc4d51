"""Vocabulary: word -> id lookup for the text encoder.

The port's own copy of the JAX package's `text/vocab.py` lookup half
(same special-token ids PAD=0, SOS=1, EOS=2, UNK=3 and the same
normalisation), with its checkpoint state (`state_dict` /
`from_state_dict`, the `lang_model` of a Part-d checkpoint) and a
`build_vocab` that builds ids only. Embedding-file loading is not part
of the port: word vectors arrive as the text encoder's embedding table.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence

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

    def state_dict(self) -> dict:
        """The JAX package's vocab state; the port holds no word vectors,
        so "weights" is None."""
        return {"name": self.name, "word2index": dict(self.word2index),
                "word2count": dict(self.word2count), "weights": None}

    @classmethod
    def from_state_dict(cls, state: dict) -> "Vocab":
        """Ids in the order of the state's word2index, as the JAX package
        rebuilds them; word vectors in the state are not kept."""
        v = cls(state["name"])
        for w in sorted(state["word2index"], key=state["word2index"].get):
            v.index_word(w)
        v.word2count = dict(state["word2count"])
        return v


def build_vocab(name: str, word_lists: Sequence[Sequence[str]]) -> Vocab:
    """Corpus word lists -> Vocab: the ids of the JAX package's
    build_vocab, without its embedding matrix."""
    v = Vocab(name)
    for words in word_lists:
        v.index_words(words)
    return v
