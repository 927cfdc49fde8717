"""Word2vec models: configuration, the local model and the PS model.

Port of ``multiverso_tpu/models/wordembedding/model.py``:

- ``Word2VecConfig`` (the reference's CLI options);
- ``build_alias`` — Vose alias tables over the unigram^0.75
  distribution, copied bit for bit;
- ``Word2Vec``, the local model: both embedding tables whole on one
  device (``cuda:0`` unless the caller names another), the output
  structures (alias or Huffman tables) beside them, the linearly
  decaying learning rate (ref: distributed_wordembedding.cpp:92-134)
  and word accounting; ``device_train.DeviceCorpusTrainer`` trains it;
- ``PSWord2Vec``: two dense matrix tables (input rows random-initialized
  server-side, output rows zero) plus the word-count KV table, with the
  push drain and word-count flush the PS device pipeline
  (``device_train.PSDeviceCorpusTrainer``) drives.

Not ported yet: the host-batch step of both models (ROADMAP B9) —
``train_batches`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ... import create_kv_table, create_matrix_table
from ...runtime.zoo import resolve_device
from .dictionary import Dictionary
from .huffman import build_huffman


class Word2VecConfig:
    """Mirror of the reference's CLI options (ref: WordEmbedding
    src/util.cpp ParseArgs: -size -window -negative -epoch -min_count
    -sample -init_learning_rate -cbow -hs ...)."""

    def __init__(self, embedding_size: int = 100, window: int = 5,
                 negative: int = 5, epochs: int = 1, min_count: int = 5,
                 sample: float = 1e-3, init_learning_rate: float = 0.025,
                 cbow: bool = False, hs: bool = False,
                 batch_size: int = 4096, seed: int = 1,
                 use_ps: bool = False, batch_group: int = 16,
                 neg_block: int = 1, per_pair: bool = False):
        self.embedding_size = embedding_size
        self.window = window
        self.negative = negative
        self.epochs = epochs
        self.min_count = min_count
        self.sample = sample
        self.init_learning_rate = init_learning_rate
        self.cbow = cbow
        self.hs = hs
        self.batch_size = batch_size
        self.seed = seed
        self.use_ps = use_ps
        # Batches per device dispatch of the host-batch loop (not ported).
        self.batch_group = batch_group
        # Device-pipeline negative sharing: one draw of K negatives per
        # block of this many consecutive centers (1 = per-center draws).
        self.neg_block = neg_block
        # Device pipelines, skip-gram: the quality mode (per-pair
        # negatives, sequential window sub-steps).
        self.per_pair = per_pair


def build_alias(probs: np.ndarray):
    """Vose's alias method: O(V) build, O(1) vectorized sampling.
    Returns (prob[V] float32, alias[V] int32): draw ``i`` uniformly, then
    take ``i`` with probability ``prob[i]`` else ``alias[i]``."""
    probs = np.asarray(probs, np.float64)
    n = probs.size
    scaled = probs * (n / probs.sum())
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = list(np.flatnonzero(scaled < 1.0)[::-1])
    large = list(np.flatnonzero(scaled >= 1.0)[::-1])
    while small and large:
        s, g = int(small.pop()), int(large.pop())
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = scaled[g] + scaled[s] - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    return prob, alias


class Word2Vec:
    """Local (single-process) model: both tables whole on one device —
    ``cuda:0`` unless ``device`` names another; a CUDA device on a host
    without a card raises, as ``mv.init`` does (no CPU fallback)."""

    def __init__(self, config: Word2VecConfig, dictionary: Dictionary,
                 device=None):
        self.config = config
        self.dictionary = dictionary
        self._dim = config.embedding_size
        self._device_arg = device
        self._out_rows = self._init_output_structures()
        self.trained_words = 0
        self.total_words = dictionary.total_count * config.epochs
        self._init_embeddings()

    def _init_output_structures(self) -> int:
        """Huffman tables (hs) or the unigram^0.75 alias tables (sgns);
        returns the output-embedding row count."""
        config, dictionary = self.config, self.dictionary
        if config.hs:
            tree = build_huffman(dictionary.counts)
            self._codes_host = np.asarray(tree.codes)
            self._points_host = np.asarray(tree.points)
            return max(tree.num_inner_nodes, 1)
        self._neg_prob_host, self._neg_alias_host = build_alias(
            dictionary.negative_table())
        return dictionary.size

    def _init_embeddings(self) -> None:
        """Both tables on the model's device. ref init: uniform
        (-0.5/dim, 0.5/dim) input, zeros output, drawn on the device (a
        host-side init would upload the whole V x D table) from a
        generator seeded with ``seed ^ 0x5EED``. The PS subclass
        overrides this with table creation (no full local copies)."""
        self.device = resolve_device(self._device_arg)
        vocab, dim = self.dictionary.size, self.config.embedding_size
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed ^ 0x5EED)
        self._emb_in = (torch.rand((vocab, dim), generator=gen,
                                   device=self.device) - 0.5) / dim
        self._emb_out = torch.zeros((self._out_rows, dim),
                                    device=self.device)
        if self.config.hs:
            self._codes_dev = torch.from_numpy(self._codes_host).to(
                self.device)
            self._points_dev = torch.from_numpy(self._points_host).to(
                self.device)
        else:
            self._neg_prob_dev = torch.from_numpy(self._neg_prob_host).to(
                self.device)
            self._neg_alias_dev = torch.from_numpy(
                self._neg_alias_host).to(self.device)

    def train_batches(self, iterator):
        raise NotImplementedError(
            "the host-batch step is not ported yet (ROADMAP B9); train "
            "with device_train.DeviceCorpusTrainer")

    @property
    def embeddings(self) -> np.ndarray:
        """The input table as a numpy array on the host."""
        return self._emb_in.cpu().numpy()

    def save_embeddings(self, path: str) -> None:
        """word2vec text format (ref rank-0 save,
        distributed_wordembedding.cpp:231-236)."""
        from ...io import StreamFactory
        emb = self.embeddings
        with StreamFactory.get_stream(path, "w") as stream:
            stream.write(f"{emb.shape[0]} {emb.shape[1]}\n".encode())
            for word, row in zip(self.dictionary.words, emb):
                vec = " ".join(f"{x:.6f}" for x in row)
                stream.write(f"{word} {vec}\n".encode())

    # -- learning rate schedule --
    def learning_rate(self) -> float:
        remain = max(1.0 - self.trained_words / max(self.total_words, 1),
                     1e-4)
        return self.config.init_learning_rate * remain

    def _account_words(self, words: float) -> None:
        self.trained_words += words


class PSWord2Vec(Word2Vec):
    """Distributed trainer over row-sharded matrix tables — the
    reference's block protocol (ref: Applications/WordEmbedding/src/
    communicator.cpp:117-249, distributed_wordembedding.cpp:203-224):
    row deltas ``(new - old) / num_workers`` push back asynchronously,
    acks drained before any barrier or full-table read; the global word
    count for the learning-rate schedule rides a KV table, synced every
    ``_WC_SYNC`` blocks (ref: communicator.cpp:251-259)."""

    _WC_SYNC = 16  # blocks between global word-count syncs

    def __init__(self, config: Word2VecConfig, dictionary: Dictionary,
                 num_workers: Optional[int] = None):
        self._num_workers_override = num_workers
        super().__init__(config, dictionary)
        self._wc_pending = 0.0
        self._batches_done = 0
        self._pending_pushes: List = []

    def _init_embeddings(self) -> None:
        """No full local matrices: the input table is random-initialized
        SERVER-side (the reference's random-init server ctor,
        ref: matrix_table.cpp:372-384)."""
        config = self.config
        vocab, dim = self.dictionary.size, config.embedding_size
        bound = 0.5 / dim
        self._in_table = create_matrix_table(
            vocab, dim, updater_type="default",
            random_init=(-bound, bound), seed=config.seed)
        self._out_table = create_matrix_table(self._out_rows, dim,
                                              updater_type="default")
        self._wc_table = create_kv_table()
        zoo = self._in_table.zoo
        self._num_workers = max(
            zoo.num_workers if self._num_workers_override is None
            else self._num_workers_override, 1)
        # Every server shard lives in this process: the pull -> step ->
        # push loop stays on the card (device keys, device deltas).
        self._device_path = zoo.servers_in_process

    def train_batches(self, iterator):
        raise NotImplementedError(
            "the host-batch PS step is not ported yet (ROADMAP B9); train "
            "with device_train.PSDeviceCorpusTrainer")

    def _drain_pushes(self) -> None:
        """Wait every outstanding Add ack: a barrier alone orders only
        controller traffic, not worker->server adds still in flight."""
        for table, msg_id in self._pending_pushes:
            table.wait(msg_id)
        self._pending_pushes.clear()

    def _flush_word_count(self) -> None:
        if self._wc_pending:
            self._wc_table.add_async([0], [self._wc_pending])
            self._wc_pending = 0.0

    def _account_words(self, words: float) -> None:
        """Global word count for the lr schedule via the KV table, synced
        every _WC_SYNC blocks (the reference keeps it off the hot path on
        a side thread, ref: distributed_wordembedding.cpp:92-134)."""
        self.trained_words += words
        self._wc_pending += words
        self._batches_done += 1
        if self._batches_done % self._WC_SYNC == 0:
            self._flush_word_count()
            global_words = self._wc_table.get([0])[0]
            # Take the max: the global clock includes our own pushes and
            # every peer's; between syncs we advance locally.
            self.trained_words = max(self.trained_words, int(global_words))

    @property
    def embeddings(self) -> np.ndarray:
        self._drain_pushes()
        return self._in_table.get()
