"""The word2vec benchmark corpus, generated from a seed (no download).

Copy of ``write_corpus`` and its constants from the repository's
``bench.py`` (:84-125): two topic bands over a Zipf(0.8) unigram
distribution; sentences draw all words from one band, so frequent words
cluster by band. 150,000 sentences of 40 words (6M tokens) spread wide
enough that the trained dictionary itself exceeds 1M words at
``min_count=1`` — tables of reference-like height.
"""

from __future__ import annotations

import numpy as np

VOCAB = 1_200_000
SENTENCES = 150_000
WORDS_PER_SENTENCE = 40
MIN_COUNT = 1


def write_corpus(path: str, sentences: int = SENTENCES) -> None:
    rng = np.random.default_rng(0)
    half = VOCAB // 2
    ranks = np.arange(1, half + 1)
    probs = 1.0 / ranks**0.8
    cdf = np.cumsum(probs / probs.sum())
    topics = rng.integers(0, 2, size=sentences)
    draws = rng.random((sentences, WORDS_PER_SENTENCE))
    ids = np.searchsorted(cdf, draws).astype(np.int64)
    ids = np.minimum(ids, half - 1) + topics[:, None] * half
    with open(path, "w") as f:
        for row in ids:
            f.write(" ".join(f"w{i}" for i in row) + "\n")
