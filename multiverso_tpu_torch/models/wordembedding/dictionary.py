"""Vocabulary: word counts, ids, subsampling.

TPU-native equivalent of the reference's ``Dictionary`` + preprocess
word-count pass (ref: Applications/WordEmbedding/src/dictionary.cpp,
preprocess/word_count.cpp): build from a corpus (or load a saved vocab),
filter by ``min_count``, and precompute word2vec subsample-keep
probabilities ``p(w) = (sqrt(f/t) + 1) * t/f`` and the unigram^0.75
negative-sampling distribution used by SGNS.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional

import numpy as np

from ...io import StreamFactory, TextReader


class Dictionary:
    def __init__(self) -> None:
        self.words: List[str] = []
        self.counts: np.ndarray = np.zeros(0, np.int64)
        self.word2id: Dict[str, int] = {}

    @property
    def size(self) -> int:
        return len(self.words)

    @property
    def total_count(self) -> int:
        return int(self.counts.sum())

    @classmethod
    def build(cls, corpus_path: str, min_count: int = 5,
              stopwords: Optional[set] = None) -> "Dictionary":
        counter: collections.Counter = collections.Counter()
        reader = TextReader(corpus_path)
        while True:
            line = reader.get_line()
            if line is None:
                break
            counter.update(line.split())
        reader.close()
        dictionary = cls()
        stopwords = stopwords or set()
        # Deterministic order: by count desc, then lexicographic — frequent
        # words get small ids (helps HBM locality of hot rows).
        items = sorted(((w, c) for w, c in counter.items()
                        if c >= min_count and w not in stopwords),
                       key=lambda kv: (-kv[1], kv[0]))
        dictionary.words = [w for w, _ in items]
        dictionary.counts = np.array([c for _, c in items], np.int64)
        dictionary.word2id = {w: i for i, w in enumerate(dictionary.words)}
        return dictionary

    def ids(self, tokens: Iterable[str]) -> List[int]:
        w2i = self.word2id
        return [w2i[t] for t in tokens if t in w2i]

    # -- word2vec sampling tables --
    def subsample_keep_prob(self, sample: float = 1e-3) -> np.ndarray:
        """Keep probability per word id (word2vec subsampling)."""
        if sample <= 0:
            return np.ones(self.size, np.float32)
        freq = self.counts / max(self.total_count, 1)
        ratio = sample / np.maximum(freq, 1e-12)
        return np.minimum((np.sqrt(ratio) + ratio), 1.0).astype(np.float32)

    def negative_table(self, power: float = 0.75) -> np.ndarray:
        """Unigram^power sampling distribution (probabilities per id)."""
        weighted = self.counts.astype(np.float64) ** power
        return (weighted / weighted.sum()).astype(np.float32)

    # -- persistence (reference saves vocab as "word count" lines) --
    def store(self, path: str) -> None:
        with StreamFactory.get_stream(path, "w") as stream:
            for word, count in zip(self.words, self.counts):
                stream.write(f"{word} {int(count)}\n".encode())

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        dictionary = cls()
        reader = TextReader(path)
        words, counts = [], []
        while True:
            line = reader.get_line()
            if line is None:
                break
            if not line.strip():
                continue
            word, _, count = line.rpartition(" ")
            words.append(word)
            counts.append(int(count))
        reader.close()
        dictionary.words = words
        dictionary.counts = np.array(counts, np.int64)
        dictionary.word2id = {w: i for i, w in enumerate(words)}
        return dictionary
