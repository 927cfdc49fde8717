"""Training-pair pipeline: sentences -> fixed-shape pair batches.

TPU-native re-design of the reference's Reader/DataBlock/BlockQueue
(ref: Applications/WordEmbedding/src/reader.cpp, data_block.cpp,
block_queue.cpp): a loader thread turns the corpus into fixed-shape
batches of (center, context) training pairs — subsampled, with the
word2vec shrinking-window trick — which is what a TPU step wants instead
of the reference's per-sentence scalar walk. Negative sampling happens
*inside* the jitted step (inverse-CDF over the unigram^0.75 distribution),
so batches carry only the pairs.

CBOW batches carry the padded context window per center instead of
exploded pairs (ref trains both modes, wordembedding.cpp).
"""

from __future__ import annotations

import queue as queue_mod
from typing import Iterator, List, Optional

import numpy as np

from ...io import TextReader
from ...runtime import thread_roles
from .dictionary import Dictionary

MAX_SENTENCE_LEN = 1000  # ref: constant MAX_SENTENCE_LENGTH


class PairBatch:
    """Skip-gram: (centers[B], contexts[B]); ``count`` = real pairs (rows
    beyond it are padding the train step masks out); ``words`` = corpus
    words (pre-subsampling) this batch consumed — the unit the lr schedule
    and words/sec decay in (pairs ≈ window x words, a different unit)."""

    __slots__ = ("centers", "contexts", "count", "words")

    def __init__(self, centers, contexts, count, words):
        self.centers = centers
        self.contexts = contexts
        self.count = count
        self.words = words


class CbowBatch:
    """CBOW: (window[B, 2W] padded with -1, centers[B]); see PairBatch for
    count/words semantics."""

    __slots__ = ("window", "centers", "count", "words")

    def __init__(self, window, centers, count, words):
        self.window = window
        self.centers = centers
        self.count = count
        self.words = words


class TokenizedCorpus:
    """One-pass tokenization cache: the corpus as a flat id array plus
    sentence offsets. Multi-epoch training re-reads ids (cheap numpy)
    instead of re-tokenizing text (Python dict lookups per token — the
    loader bottleneck). Subsampling stays per-epoch randomized."""

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = flat
        self.offsets = offsets  # [n_sentences + 1]

    @classmethod
    def build(cls, dictionary: Dictionary,
              corpus_path: str) -> "TokenizedCorpus":
        chunks: List[np.ndarray] = []
        lengths: List[int] = [0]
        for path in corpus_path.split(";"):
            reader = TextReader(path)
            while True:
                line = reader.get_line()
                if line is None:
                    break
                ids = dictionary.ids(line.split())
                if len(ids) >= 2:
                    chunks.append(np.asarray(ids[:MAX_SENTENCE_LEN],
                                             np.int32))
                    lengths.append(chunks[-1].size)
            reader.close()
        flat = np.concatenate(chunks) if chunks \
            else np.zeros(0, np.int32)
        return cls(flat, np.cumsum(lengths).astype(np.int64))

    def sentences(self) -> Iterator[np.ndarray]:
        for i in range(len(self.offsets) - 1):
            yield self.flat[self.offsets[i]:self.offsets[i + 1]]


def iter_sentences(dictionary: Dictionary, corpus,
                   subsample: float = 1e-3,
                   seed: int = 1) -> Iterator[Tuple[np.ndarray, int]]:
    """Yields (subsampled ids, raw word count). ``corpus`` is a path
    (tokenized on the fly) or TokenizedCorpus. The raw count is what the
    word2vec lr schedule decays in (it counts every word read, including
    subsample-discarded ones)."""
    keep = dictionary.subsample_keep_prob(subsample)
    rng = np.random.default_rng(seed)
    no_subsample = subsample <= 0

    def emit(ids: np.ndarray) -> Optional[np.ndarray]:
        if not no_subsample:
            ids = ids[rng.random(ids.size) < keep[ids]]
        return ids if ids.size >= 2 else None

    if isinstance(corpus, TokenizedCorpus):
        for ids in corpus.sentences():
            out = emit(ids)
            if out is not None:
                yield out, ids.size
        return
    for path in corpus.split(";"):
        reader = TextReader(path)
        while True:
            line = reader.get_line()
            if line is None:
                break
            ids = np.array(dictionary.ids(line.split()), np.int32)
            if ids.size:
                out = emit(ids[:MAX_SENTENCE_LEN])
                if out is not None:
                    yield out, min(ids.size, MAX_SENTENCE_LEN)
        reader.close()


def iter_pair_batches(dictionary: Dictionary, corpus_path,
                      batch_size: int = 4096, window: int = 5,
                      subsample: float = 1e-3, cbow: bool = False,
                      seed: int = 1,
                      chunk_words: int = 16384) -> Iterator:
    """Walk sentences emitting fixed-shape batches; the per-center window
    size shrinks uniformly in [1, window] (the word2vec trick,
    ref: wordembedding.cpp Train window sampling).

    Sentences are expanded to pairs in multi-sentence CHUNKS
    (``chunk_sentence_pairs``): per-sentence numpy calls are the loader
    bottleneck at scale — one vectorized call per ~16K words instead of
    one per ~40-word sentence keeps the loader ahead of the device."""
    rng = np.random.default_rng(seed + 7)
    if cbow:
        yield from _iter_cbow(dictionary, corpus_path, batch_size, window,
                              subsample, rng, seed)
        return
    # Pending pairs carry a per-pair fractional word weight so each batch
    # reports exactly the corpus words it consumed (a sentence's raw words
    # spread over its pairs; sums are exact across batch boundaries).
    pending: List[np.ndarray] = []  # [3, k]: center, context, word-frac
    pending_count = 0
    chunk: List[np.ndarray] = []
    chunk_raw: List[int] = []
    chunk_n = 0

    def flush_chunk():
        nonlocal pending, pending_count, chunk, chunk_raw, chunk_n
        if not chunk:
            return
        pairs, sent_of_pair = chunk_sentence_pairs(chunk, window, rng)
        if pairs.shape[1]:
            # Per-sentence raw words spread over that sentence's pairs.
            per_sent = np.bincount(sent_of_pair, minlength=len(chunk))
            raw = np.asarray(chunk_raw, np.float64)
            frac = (raw / np.maximum(per_sent, 1))[sent_of_pair]
            pending.append(np.concatenate([pairs.astype(np.float64),
                                           frac[None, :]]))
            pending_count += pairs.shape[1]
        chunk, chunk_raw, chunk_n = [], [], 0

    def drain_full_batches():
        nonlocal pending, pending_count
        while pending_count >= batch_size:
            flat = np.concatenate(pending, axis=1)
            yield PairBatch(flat[0, :batch_size].astype(np.int32),
                            flat[1, :batch_size].astype(np.int32),
                            batch_size,
                            float(flat[2, :batch_size].sum()))
            rest = flat[:, batch_size:]
            pending = [rest] if rest.shape[1] else []
            pending_count = rest.shape[1]

    for ids, raw_words in iter_sentences(dictionary, corpus_path,
                                         subsample, seed):
        chunk.append(ids)
        chunk_raw.append(raw_words)
        chunk_n += ids.size
        if chunk_n < chunk_words:
            continue
        flush_chunk()
        yield from drain_full_batches()
    flush_chunk()
    yield from drain_full_batches()
    if pending_count:
        flat = np.concatenate(pending, axis=1)
        centers = np.zeros(batch_size, np.int32)
        contexts = np.zeros(batch_size, np.int32)
        centers[:pending_count] = flat[0].astype(np.int32)
        contexts[:pending_count] = flat[1].astype(np.int32)
        yield PairBatch(centers, contexts, pending_count,
                        float(flat[2].sum()))


def chunk_sentence_pairs(ids_list: List[np.ndarray], window: int,
                         rng: np.random.Generator):
    """Vectorized (center, context) expansion for MANY sentences at once:
    the sentences concatenate into one flat array with a per-position
    sentence id; a context position is valid when it stays inside the
    flat array, inside the SAME sentence, and within the center's shrunk
    window. Returns (int32 pairs [2, k], sentence index per pair [k])."""
    flat = np.concatenate(ids_list)
    n = flat.size
    if n == 0:
        return np.zeros((2, 0), np.int32), np.zeros(0, np.int64)
    lengths = np.fromiter((a.size for a in ids_list), np.int64,
                          count=len(ids_list))
    sent_id = np.repeat(np.arange(len(ids_list)), lengths)
    shrink = rng.integers(1, window + 1, size=n)
    offsets = np.concatenate([np.arange(-window, 0),
                              np.arange(1, window + 1)])
    pos = np.arange(n)[:, None] + offsets[None, :]  # [n, 2w]
    inside = (pos >= 0) & (pos < n)
    pos_c = np.clip(pos, 0, n - 1)
    valid = inside & (np.abs(offsets)[None, :] <= shrink[:, None]) \
        & (sent_id[pos_c] == sent_id[:, None])
    center_idx, off_idx = np.nonzero(valid)
    pairs = np.stack([flat[center_idx],
                      flat[pos_c[center_idx, off_idx]]]).astype(np.int32)
    return pairs, sent_id[center_idx]


def sentence_pairs(ids: np.ndarray, window: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Vectorized (center, context) expansion for one sentence: offsets
    -window..window per position, masked by the per-center shrunk window
    and sentence bounds. Returns int32 [2, k]."""
    n = ids.size
    shrink = rng.integers(1, window + 1, size=n)
    offsets = np.concatenate([np.arange(-window, 0),
                              np.arange(1, window + 1)])
    pos = np.arange(n)[:, None] + offsets[None, :]  # [n, 2w]
    valid = (np.abs(offsets)[None, :] <= shrink[:, None]) \
        & (pos >= 0) & (pos < n)
    center_idx, off_idx = np.nonzero(valid)
    return np.stack([ids[center_idx],
                     ids[pos[center_idx, off_idx]]]).astype(np.int32)


def _iter_cbow(dictionary, corpus_path, batch_size, window, subsample,
               rng, seed) -> Iterator[CbowBatch]:
    width = 2 * window
    win = np.full((batch_size, width), -1, np.int32)
    centers = np.empty(batch_size, np.int32)
    word_fracs = np.zeros(batch_size)
    fill = 0
    for ids, raw_words in iter_sentences(dictionary, corpus_path,
                                         subsample, seed):
        n = ids.size
        shrink = rng.integers(1, window + 1, size=n)
        frac = raw_words / n
        for i in range(n):
            b = shrink[i]
            ctx = np.concatenate([ids[max(0, i - b):i],
                                  ids[i + 1:min(n, i + b + 1)]])
            if ctx.size == 0:
                continue
            win[fill, :] = -1
            win[fill, :ctx.size] = ctx[:width]
            centers[fill] = ids[i]
            word_fracs[fill] = frac
            fill += 1
            if fill == batch_size:
                yield CbowBatch(win.copy(), centers.copy(), batch_size,
                                float(word_fracs.sum()))
                fill = 0
                word_fracs[:] = 0
    if fill:
        win[fill:] = -1
        centers[fill:] = 0
        yield CbowBatch(win.copy(), centers.copy(), fill,
                        float(word_fracs[:fill].sum()))


class BlockLoader:
    """Background loader thread + bounded queue (the reference's
    BlockQueue + loader thread, ref: distributed_wordembedding.cpp:33-56)."""

    def __init__(self, batch_iter: Iterator, depth: int = 8):
        self._queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
        self._thread = thread_roles.spawn(
            thread_roles.BACKGROUND, target=self._fill,
            args=(batch_iter,), name="mv-we-blockloader")

    def _fill(self, batch_iter) -> None:
        try:
            for batch in batch_iter:
                self._queue.put(batch)
        finally:
            self._queue.put(None)

    def __iter__(self):
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            yield batch
