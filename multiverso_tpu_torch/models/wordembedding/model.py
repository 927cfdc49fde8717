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
  (``device_train.PSDeviceCorpusTrainer``) drives;
- the host-batch trainer of both (``train_batch``, ``train_batches``,
  ``prepared``; the app's ``-device_pipeline=false``): batches of
  (center, context) ids shipped from the host (``data.iter_pair_batches``)
  train in every mode — skip-gram or CBOW, each with negative sampling
  (K9 ``pairlist_ns_grad``) or hierarchical softmax (K10
  ``pairlist_hs_grad``), K3 scatter-adding the gradients. The local
  model reads the whole tables by global id and draws its negatives on
  the card; the PS model prepares each batch on the host (``prepare`` →
  ``CompactBatch``: the unique rows it touches and slot maps into them,
  the negatives drawn with numpy), pulls the rows with device replies,
  steps on the pulled buffers and pushes ``-lr/num_workers * grad``.
  Its host-buffer arm (``_device_path`` False: the arm of a worker whose
  servers are in another process, or set by a caller) pulls the real
  unique rows into host buffers, uploads them for the same step and
  pushes the host deltas, which ``-one_bit_push`` quantizes; with the
  client cache on (``-max_get_staleness``) ``train_batches`` prefetches
  batch i+1's rows while batch i steps.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ... import create_kv_table, create_matrix_table
from ...kernels.pairlist import pairlist_hs_grad, pairlist_ns_grad
from ...kernels.rows import row_scatter_add
from ...runtime.zoo import current_zoo, resolve_device
from ...tables import client_cache
from ...util.dashboard import monitor
from .data import CbowBatch
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
        # Batches per device dispatch of the reference's local
        # host-batch loop. Ignored: the port launches batch by batch
        # (the same lr and draws); kept for the reference's signature
        # and CLI.
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


def _alias_draw_np(prob: np.ndarray, alias: np.ndarray,
                   rng: np.random.Generator, shape) -> np.ndarray:
    idx = rng.integers(0, prob.size, size=shape).astype(np.int32)
    keep = rng.random(size=shape) < prob[idx]
    return np.where(keep, idx, alias[idx])


def draw_negs(neg_prob: torch.Tensor, neg_alias: torch.Tensor,
              idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Alias-table negatives on the device: candidate ``idx`` kept with
    probability ``neg_prob[idx]``, else its alias. Returns int32 like
    ``idx``."""
    lookup = idx.to(torch.int64)
    keep_draw = u < neg_prob[lookup]
    return torch.where(keep_draw, idx, neg_alias[lookup])


def _unique_rows_and_remap(ids_list, num_rows: int):
    """Sorted unique ids over ``ids_list`` plus a remap array such that
    ``remap[id] = compact slot``. Bitmap-based — O(num_rows + K) —
    falling back to the sort path when the table is huge relative to
    the batch (the O(num_rows) sweep would dominate)."""
    total = sum(a.size for a in ids_list)
    if num_rows > max(1 << 22, 32 * total):
        rows = np.unique(np.concatenate(
            [a.reshape(-1) for a in ids_list])).astype(np.int32)
        return rows, None
    mark = np.zeros(num_rows, bool)
    for a in ids_list:
        mark[a.reshape(-1)] = True
    rows = np.flatnonzero(mark).astype(np.int32)
    # Absent ids map to slot 0 (zeros, not empty): CBOW/HS paths look up
    # pad id 0 even when word 0 is not in the batch — the result is
    # masked downstream, but it must still be deterministic memory.
    remap = np.zeros(num_rows, np.int32)
    remap[rows] = np.arange(rows.size, dtype=np.int32)
    return rows, remap


def _slot_map(rows: np.ndarray, remap, ids: np.ndarray) -> np.ndarray:
    """Compact slot of every id: remap gather when available, else
    binary search over the sorted unique rows."""
    if remap is not None:
        return remap[ids]
    return np.searchsorted(rows, ids).astype(np.int32)


def _pad_rows(rows: np.ndarray, minimum: int = 8) -> np.ndarray:
    """Pad a sorted unique row-id set to the next power of two by
    repeating the last id. Padded slots are never referenced by the
    compact index maps, so they receive zero gradient; PS delta pushes
    carry exact zeros there."""
    n = max(int(rows.size), 1)
    target = max(minimum, 1 << (n - 1).bit_length())
    if rows.size == 0:
        return np.zeros(target, np.int32)
    if rows.size == target:
        return rows
    return np.concatenate(
        [rows, np.full(target - rows.size, rows[-1], np.int32)])


class CompactBatch:
    """Host-prepared batch: unique touched rows + compact index maps.

    ``rows_in``/``rows_out`` are the real (unpadded) sorted unique row
    sets; ``rows_in_p``/``rows_out_p`` the power-of-two padded versions
    the device step uses; ``in_args``/``out_args`` index into the padded
    compact arrays."""

    __slots__ = ("rows_in", "rows_out", "rows_in_p", "rows_out_p",
                 "in_args", "out_args", "count", "words", "size")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _ids_on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host ids (int32, or uint16 slot maps, widened) as int32 on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


class Word2Vec:
    """Local (single-process) model: both tables whole on one device —
    ``cuda:0`` unless ``device`` names another; a CUDA device on a host
    without a card raises, as ``mv.init`` does (no CPU fallback).

    ``draws``: the host-batch step's negative draws; None draws them on
    the model's device from a ``torch.Generator`` seeded with the
    config's seed. A provider has ``batch_draws(counter, shape, V)`` ->
    (candidate ids int32 in [0, V), alias uniforms float32), ``counter``
    advancing once per real batch as the reference's key fold does."""

    def __init__(self, config: Word2VecConfig, dictionary: Dictionary,
                 device=None, draws=None):
        self.config = config
        self.dictionary = dictionary
        self._dim = config.embedding_size
        self._device_arg = device
        self._out_rows = self._init_output_structures()
        self._rng = np.random.default_rng(config.seed + 13)
        self.trained_words = 0
        self.total_words = dictionary.total_count * config.epochs
        # Row-set pad minimums (see _pad_rows): the local path lets them
        # float per batch; the PS path freezes them to one bucket per
        # table.
        self._pad_in_min = 8
        self._pad_out_min = 8
        self.draws = draws
        self._full_masks = {}
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
        # The host-batch step's negatives: one generator on the device;
        # the counter advances once per real batch.
        self._neg_gen = torch.Generator(device=self.device)
        self._neg_gen.manual_seed(self.config.seed)
        self._batch_counter = 0

    # -- host preparation: batch -> compact row sets + index maps --
    def prepare(self, batch) -> CompactBatch:
        """Compute the rows this batch touches and remap its indices to
        compact slots (the reference's per-block row collection,
        ref: communicator.cpp:117-155). Pure numpy — run it in the
        loader thread to overlap with device steps."""
        config = self.config
        vocab = self.dictionary.size
        if isinstance(batch, CbowBatch):
            win, targets = batch.window, batch.centers
            real = win[win >= 0]
            if real.size:
                rows_in, remap = _unique_rows_and_remap([real], vocab)
            else:
                rows_in, remap = np.zeros(1, np.int32), None
            win_l = np.clip(_slot_map(rows_in, remap, np.maximum(win, 0)),
                            0, rows_in.size - 1).astype(np.int32)
            in_args = (win_l, (win >= 0).astype(np.float32))
            size = batch.centers.shape[0]
        else:
            centers, targets = batch.centers, batch.contexts
            rows_in, remap = _unique_rows_and_remap([centers], vocab)
            in_args = (_slot_map(rows_in, remap, centers),)
            size = centers.shape[0]

        if config.hs:
            points = self._points_host[targets]  # [B, L], -1 padded
            real = points[points >= 0]
            if real.size:
                rows_out, remap = _unique_rows_and_remap(
                    [real], self._out_rows)
            else:
                rows_out, remap = np.zeros(1, np.int32), None
            points_l = np.clip(
                _slot_map(rows_out, remap, np.maximum(points, 0)),
                0, rows_out.size - 1).astype(np.int32)
            out_args = (points_l, self._codes_host[targets])
        else:
            k = config.negative
            # neg_block pairs share one K-draw (expected gradient
            # unchanged). An odd caller-supplied size falls back to the
            # nearest divisor.
            nb = max(int(getattr(config, "neg_block", 1)), 1)
            while targets.size % nb:
                nb //= 2
            neg = _alias_draw_np(self._neg_prob_host,
                                 self._neg_alias_host, self._rng,
                                 (targets.size // nb, k)).astype(np.int32)
            rows_out, remap = _unique_rows_and_remap([targets, neg], vocab)
            out_args = (_slot_map(rows_out, remap, targets),
                        _slot_map(rows_out, remap, neg))

        rows_in_p = _pad_rows(rows_in, self._pad_in_min)
        rows_out_p = _pad_rows(rows_out, self._pad_out_min)
        # Slot maps index the padded pulled buffers; when a buffer has
        # <= 65536 slots they fit uint16 (the upload widens them to
        # int32 for the kernels).
        if rows_in_p.size <= 65536 and not config.cbow:
            in_args = tuple(a.astype(np.uint16) for a in in_args)
        if rows_out_p.size <= 65536 and not config.hs:
            out_args = tuple(a.astype(np.uint16) for a in out_args)
        return CompactBatch(
            rows_in=rows_in, rows_out=rows_out,
            rows_in_p=rows_in_p, rows_out_p=rows_out_p,
            in_args=in_args, out_args=out_args,
            count=batch.count, words=batch.words, size=size)

    # -- the host-batch step on row buffers (K9/K10 -> K3) --
    def _pair_mask_for(self, count: int, size: int,
                       device: torch.device) -> torch.Tensor:
        if count == size:
            mask = self._full_masks.get(size)
            if mask is None or mask.device != device:
                mask = torch.ones(size, dtype=torch.float32, device=device)
                self._full_masks[size] = mask
            return mask
        return (torch.arange(size, device=device) < count).to(torch.float32)

    def _step_grads(self, ein: torch.Tensor, eout: torch.Tensor, in_ids,
                    win_mask, out_args, pair_mask, scale: float):
        """K9 or K10 over the row buffers ``ein``/``eout`` with the row
        lists ``in_ids`` (and the CBOW ``win_mask``) and ``out_args`` —
        (targets, negatives) or (path rows, codes), int32 on the card.
        Returns (d_in, in row list, d_out, out row list, loss): the
        per-position gradients times ``scale`` and the flat rows K3 adds
        them into."""
        if self.config.hs:
            points, codes = out_args
            d_in, d_out, loss, _ = pairlist_hs_grad(
                ein, eout, in_ids, win_mask, points, codes, pair_mask,
                scale)
            out_rows = points.reshape(-1)
        else:
            targets, negs = out_args
            d_in, d_out, loss, _ = pairlist_ns_grad(
                ein, eout, in_ids, win_mask, targets, negs, pair_mask,
                scale)
            out_rows = torch.cat([targets, negs.reshape(-1)])
        return d_in, in_ids.reshape(-1), d_out, out_rows, loss

    def _negatives(self, counter: int, shape) -> torch.Tensor:
        """Alias-table negatives [shape] for batch ``counter``, on the
        card."""
        vocab = int(self._neg_prob_dev.shape[0])
        if self.draws is not None:
            idx, u = self.draws.batch_draws(counter, shape, vocab)
            idx, u = idx.to(self.device), u.to(self.device)
        else:
            idx = torch.randint(0, vocab, shape, generator=self._neg_gen,
                                device=self.device, dtype=torch.int32)
            u = torch.rand(shape, generator=self._neg_gen,
                           device=self.device)
        return draw_negs(self._neg_prob_dev, self._neg_alias_dev, idx, u)

    def _batch_args(self, batch):
        """One shipped batch as the step's row lists on the card (ref:
        _make_step_core): (in_ids, win_mask, out_args, pair_mask) with
        global ids — CBOW windows' -1 holes masked and read as row 0,
        HS targets' paths ``max(path, 0)``, or the targets and this
        batch's negatives. Advances the batch counter."""
        counter = self._batch_counter
        self._batch_counter += 1
        cbow = isinstance(batch, CbowBatch)
        dev = self.device
        in_ids = _ids_on(batch.window if cbow else batch.centers, dev)
        targets = _ids_on(batch.centers if cbow else batch.contexts, dev)
        size = targets.shape[0]
        win_mask = None
        if cbow:
            win_mask = (in_ids >= 0).to(torch.float32)
            in_ids = torch.clamp(in_ids, min=0)
        if self.config.hs:
            t64 = targets.to(torch.int64)
            out_args = (torch.clamp(self._points_dev[t64], min=0),
                        self._codes_dev[t64])
        else:
            out_args = (targets, self._negatives(
                counter, (size, self.config.negative)))
        return (in_ids, win_mask, out_args,
                self._pair_mask_for(batch.count, size, dev))

    def _host_step(self, batch, lr: float) -> torch.Tensor:
        """One batch on the live tables: K9/K10 read the rows of the
        WHOLE tables by global id — all gradients come from rows read
        before this step's update — and K3 scatter-adds ``-lr`` times
        them back in place (standing in for the reference's donated
        buffers). Returns the device loss."""
        d_in, in_rows, d_out, out_rows, loss = self._step_grads(
            self._emb_in, self._emb_out, *self._batch_args(batch),
            float(-np.float32(lr)))
        # Global ids of every pair: they repeat (and HS pads its path
        # nodes to row 0), so K3 sorts them.
        row_scatter_add(self._emb_in, in_rows, d_in)
        row_scatter_add(self._emb_out, out_rows, d_out)
        return loss

    # -- public API --
    def train_batch_async(self, batch) -> torch.Tensor:
        """Launch one training step WITHOUT synchronizing; returns the
        device scalar loss."""
        loss = self._host_step(batch, self.learning_rate())
        self.trained_words += batch.words
        return loss

    def train_batch(self, batch) -> float:
        loss = self.train_batch_async(batch)
        return float(loss) / max(batch.count, 1)  # display per-pair loss

    def train_batches(self, iterator) -> Tuple[float, int]:
        """Drive a whole batch stream; returns (loss_sum, pair_count).
        Each batch's lr and negative draws are taken exactly as the
        reference's scanned groups of ``batch_group`` take them (whose
        padded tail slots are no-ops); here a group needs no dispatch of
        its own, so batches launch one after another with no host sync
        and their device losses sum into one scalar, read once at the
        end."""
        acc = None
        pairs = 0
        for batch in iterator:
            loss = self.train_batch_async(batch)
            acc = loss if acc is None else acc + loss
            pairs += batch.count
        return 0.0 if acc is None else float(acc), pairs

    def prepared(self, batches):
        """Adapter for the loader thread. Local mode needs no host
        preparation (negatives are drawn on the card) — identity; the PS
        subclass overrides with CompactBatch preparation."""
        return batches

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


class _Prep:
    """One batch's prepared pull: the CompactBatch plus the in-flight
    async Get requests and, on the host-buffer arm, their destination
    buffers."""

    __slots__ = ("compact", "buf_in", "buf_out", "mid_in", "mid_out")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _Launched:
    __slots__ = ("prep", "delta_in", "delta_out", "loss")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class PSWord2Vec(Word2Vec):
    """Distributed trainer over row-sharded matrix tables — the
    reference's block protocol (ref: Applications/WordEmbedding/src/
    communicator.cpp:117-249, distributed_wordembedding.cpp:203-224):
    row deltas ``(new - old) / num_workers`` push back asynchronously,
    acks drained before any barrier or full-table read; the global word
    count for the learning-rate schedule rides a KV table, synced every
    ``_WC_SYNC`` blocks (ref: communicator.cpp:251-259). The host-batch
    loop (``train_batches``) pipelines: batch i+1's pull is serviced by
    the server actors while batch i steps on the card; on the host-buffer
    arm with the client cache on, batch i+1's rows are also prefetched
    into the cache while batch i steps."""

    _WC_SYNC = 16  # blocks between global word-count syncs

    def __init__(self, config: Word2VecConfig, dictionary: Dictionary,
                 num_workers: Optional[int] = None):
        self._num_workers_override = num_workers
        super().__init__(config, dictionary)
        if self._in_table is None:  # server-only rank: tables hosted
            return
        zoo = self._in_table.zoo
        self._rng = np.random.default_rng(
            config.seed + 97 * max(zoo.worker_id, 0))
        self._wc_pending = 0.0
        self._batches_done = 0
        self._pending_pushes: List = []
        # Get prefetch (-max_get_staleness > 0, host-buffer arm only):
        # while the card computes step i, step i+1's rows are prefetched
        # into the client cache, so _prepare's pull hits locally or
        # joins the fetch in flight. The device arm keeps the whole loop
        # on the card: nothing to hide there.
        self._use_prefetch = (client_cache.cache_enabled()
                              and not self._device_path)

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
        if self._in_table is None:
            # Server-only rank (a LocalCluster role "server"): it hosts
            # its table shards and idles — the reference runs the same
            # binary on every rank and lets role decide (src/zoo.cpp:
            # 29-35). No worker-side step or bucket state to build.
            zoo = current_zoo()
            self._device_path = zoo.servers_in_process
            self._num_workers = max(zoo.num_workers, 1)
            self.device = zoo.device
            return
        zoo = self._in_table.zoo
        self._num_workers = max(
            zoo.num_workers if self._num_workers_override is None
            else self._num_workers_override, 1)
        # Every server shard lives in this process: the pull -> step ->
        # push loop stays on the card (device replies, device deltas).
        self._device_path = zoo.servers_in_process
        self.device = zoo.device
        # FROZEN row buckets: each batch's unique row count is bounded
        # by what the batch can touch; padding every request to that one
        # bound keeps one buffer shape per table.
        from ...updater.engine import bucket_size
        batch = config.batch_size
        in_cap = batch * (2 * config.window if config.cbow else 1)
        if config.hs:
            out_cap = batch * int(self._points_host.shape[1])
        else:
            nb = max(int(getattr(config, "neg_block", 1)), 1)
            out_cap = batch + batch * config.negative // nb
        self._pad_in_min = bucket_size(min(in_cap, vocab))
        self._pad_out_min = bucket_size(min(out_cap, self._out_rows))

    # -- phase 1: row-set preparation + async pull --
    def _prepare(self, batch) -> _Prep:
        compact = batch if isinstance(batch, CompactBatch) \
            else self.prepare(batch)
        if self._device_path:
            # Device pull of the PADDED row sets (the result is already
            # step-shaped on the card).
            return _Prep(
                compact=compact, buf_in=None, buf_out=None,
                mid_in=self._in_table.get_rows_device_async(
                    compact.rows_in_p),
                mid_out=self._out_table.get_rows_device_async(
                    compact.rows_out_p))
        # Host-buffer arm: pull only the REAL unique rows into the head
        # of the padded buffer (the step's slot maps never reference the
        # tail and its deltas are sliced off before the push, so the
        # tail only needs to be finite). Requesting the padded ids would
        # ship copies of the last row both ways.
        n_in, n_out = compact.rows_in.size, compact.rows_out.size
        buf_in = np.empty((compact.rows_in_p.size, self._dim), np.float32)
        buf_out = np.empty((compact.rows_out_p.size, self._dim),
                           np.float32)
        buf_in[n_in:] = 0.0
        buf_out[n_out:] = 0.0
        return _Prep(
            compact=compact, buf_in=buf_in, buf_out=buf_out,
            mid_in=self._in_table.get_rows_async(compact.rows_in,
                                                 out=buf_in[:n_in]),
            mid_out=self._out_table.get_rows_async(compact.rows_out,
                                                   out=buf_out[:n_out]))

    # -- phase 2: wait the pull, launch the step (async) --
    def _launch(self, prep: _Prep) -> _Launched:
        """K9/K10 on the pulled buffers with the slot maps as row lists,
        then K3 scatter-adds the per-position gradients into zeroed
        delta buffers of the pulled shape: ``-lr/num_workers * grad``
        (the reference's ``(new - old) / num_workers`` with one local
        step, ref: communicator.cpp:157-249)."""
        compact = prep.compact
        with monitor("PS_GET_STALL"):
            # The pull stall: request latency the pipeline did not hide
            # (cache hits and completed prefetches shorten it).
            self._in_table.wait(prep.mid_in)
            self._out_table.wait(prep.mid_out)
        if self._device_path:
            old_in = self._in_table.take_device_rows()
            old_out = self._out_table.take_device_rows()
        else:
            old_in = torch.from_numpy(prep.buf_in).to(self.device)
            old_out = torch.from_numpy(prep.buf_out).to(self.device)
        lr_scaled = np.float32(self.learning_rate() / self._num_workers)
        d_in, in_rows, d_out, out_rows, loss = self._step_grads(
            old_in, old_out, *self._compact_args(compact, old_in.device),
            float(-lr_scaled))
        delta_in = torch.zeros_like(old_in)
        delta_out = torch.zeros_like(old_out)
        # Slots of the pulled buffers, one a pair position: they repeat
        # (HS pads its path nodes to slot 0), so K3 sorts them.
        row_scatter_add(delta_in, in_rows, d_in)
        row_scatter_add(delta_out, out_rows, d_out)
        return _Launched(prep=prep, delta_in=delta_in,
                         delta_out=delta_out, loss=loss)

    def _compact_args(self, compact: CompactBatch, dev: torch.device):
        """A CompactBatch's slot maps (uint16 ones widened) as the
        step's row lists into the pulled buffers, on ``dev``: (in_ids,
        win_mask, out_args, pair_mask)."""
        win_mask = torch.from_numpy(compact.in_args[1]).to(dev) \
            if self.config.cbow else None
        return (_ids_on(compact.in_args[0], dev), win_mask,
                tuple(_ids_on(a, dev) for a in compact.out_args),
                self._pair_mask_for(compact.count, compact.size, dev))

    # -- phase 3: push deltas, account words --
    def _finish(self, launched: _Launched) -> torch.Tensor:
        """Push this batch's deltas and return the batch loss as a
        DEVICE scalar. The device arm pushes from the card: padded slots
        carry exact-zero deltas, so the padded sets' duplicate trailing
        ids add zeros. The host-buffer arm pushes the real rows' host
        deltas (1-bit encoded by the table under ``-one_bit_push``)."""
        compact = launched.prep.compact
        if self._device_path:
            push_in, rows_in = launched.delta_in, compact.rows_in_p
            push_out, rows_out = launched.delta_out, compact.rows_out_p
        else:
            push_in = launched.delta_in[:compact.rows_in.size].cpu() \
                .numpy()
            rows_in = compact.rows_in
            push_out = launched.delta_out[:compact.rows_out.size].cpu() \
                .numpy()
            rows_out = compact.rows_out
        self._pending_pushes.append(
            (self._in_table, self._in_table.add_rows_async(rows_in,
                                                           push_in)))
        self._pending_pushes.append(
            (self._out_table, self._out_table.add_rows_async(rows_out,
                                                             push_out)))
        self._account_words(compact.words)
        return launched.loss

    def prepared(self, batches):
        """Generator adapter: raw batches -> CompactBatch (run inside a
        BlockLoader so host row preparation overlaps device steps)."""
        for batch in batches:
            yield self.prepare(batch)

    def train_batch(self, batch) -> float:
        launched = self._launch(self._prepare(batch))
        loss = self._finish(launched)
        self._drain_pushes()
        return float(loss) / max(launched.prep.compact.count, 1)

    def train_batch_async(self, batch) -> torch.Tensor:
        return torch.tensor(self.train_batch(batch), dtype=torch.float32)

    def _prefetched(self, batches):
        """Double-buffer adapter: prepare batch i+1 and PREFETCH its row
        sets into the client cache before yielding batch i, so the real
        pull in ``_prepare`` overlaps the step instead of serializing
        behind it."""
        held = None
        for batch in batches:
            compact = batch if isinstance(batch, CompactBatch) \
                else self.prepare(batch)
            self._in_table.prefetch_rows_async(compact.rows_in)
            self._out_table.prefetch_rows_async(compact.rows_out)
            if held is not None:
                yield held
            held = compact
        if held is not None:
            yield held

    def train_batches(self, iterator) -> Tuple[float, int]:
        """Pipelined loop: batch i+1's row pull is serviced by the server
        actors while batch i steps on the card and its deltas push
        (ref overlap: distributed_wordembedding.cpp:203-224). Losses
        accumulate as device scalars — one host read at the end. With
        the client cache on, the host-buffer arm also prefetches batch
        i+1's rows during batch i's step (``_prefetched``)."""
        acc = None
        pairs = 0
        launched: Optional[_Launched] = None
        if self._use_prefetch:
            iterator = self._prefetched(iterator)
        for batch in iterator:
            prep = self._prepare(batch)  # async pull in flight
            if launched is not None:
                loss = self._finish(launched)
                acc = loss if acc is None else acc + loss
                pairs += launched.prep.compact.count
            launched = self._launch(prep)
        if launched is not None:
            loss = self._finish(launched)
            acc = loss if acc is None else acc + loss
            pairs += launched.prep.compact.count
        # Every push acked, trailing word count published, then the
        # barrier: a peer's post-barrier read sees all of our updates.
        self._drain_pushes()
        self._flush_word_count()
        self._in_table.zoo.barrier()
        return 0.0 if acc is None else float(acc), pairs

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
