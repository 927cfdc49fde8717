"""Device-resident corpus training: the word2vec data pipeline on the
card.

Port of ``multiverso_tpu/models/wordembedding/device_train.py``: the
TOKENIZED CORPUS is uploaded to the card once, and per epoch and per
step everything the reference's reader/trainer pipeline does —
subsampling, sentence-bounded shrunk windows, negative sampling, the
update — runs on the card
(ref: Applications/WordEmbedding/src/reader.cpp — subsample-as-you-read;
wordembedding.cpp — per-center shrunk window + SGNS). The host's only
per-step work is the learning-rate scalar; per epoch it reads the
post-subsampling length once after the compaction (K1).

Two trainers:

- ``DeviceCorpusTrainer`` drives a local ``Word2Vec`` (both tables whole
  on the card) through the reference's full mode matrix — {skip-gram,
  CBOW} x {negative sampling, hierarchical softmax} plus the per-pair
  skip-gram quality mode. Each step gathers its rows (K2), computes the
  gradients on one hand-written kernel (K4 SGNS, K5 CBOW, K6/K7 HS, K8
  per pair) and scatter-adds ``-lr * grad`` back into the live tables
  (K3).
- ``PSDeviceCorpusTrainer`` drives a ``PSWord2Vec`` through the same
  mode matrix: per dispatch of G blocks it pulls the rows with device
  keys through the worker and server actors (K2), runs the step kernel
  of the mode on the pulled rows (K4-K8; the per-pair mode's 2W
  sub-steps train local copies) and pushes ``-lr * grad / num_workers``
  back (K3). Over tables of several servers the device keys either go
  to every server, which gathers (K15) and adds (K16) only its own rows
  (broadcast), or, with ``segment_keys=True`` (B11), are sorted on the
  card and cut into one calibrated segment a server (K18), whose replies
  K17 puts back in place.

``_ma_group_fn`` is the model-average (``-ma``) group over a mesh of
replica slots (B16): each slot runs the local SGNS steps on its own
replica and corpus shard, then K19 averages the replicas.

The BANDED formulation is the reference's: the contexts of C
consecutive centers all lie in ``kept[base-W : base+C+W]``, so a step
gathers those C+2W rows once and forms the 2W context logits as shifted
slices; ``neg_block`` B shares one draw of K negatives across each
block of B consecutive centers.

Random draws are kept out of the deterministic math: ``_prep``'s
uniforms, the shrunk windows and the negative draws come from a draw
provider (``TorchDraws`` by default: one ``torch.Generator`` on the
device, seeded per epoch), so the tests can replay the reference's
``jax.random`` draws and compare ids bit for bit. The ids work
(``_band_former``, ``model.draw_negs``, the Huffman path lookups) is
plain torch.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from ...kernels.cbow import banded_cbow_grad
from ...kernels.hs import banded_hs_sg_grad, hs_cbow_grad
from ...kernels.mesh import mesh_allreduce
from ...kernels.objective import offsets
from ...kernels.pair import pair_offset_grad, pair_offset_grad_
from ...kernels.rows import row_gather, row_scatter_add
from ...kernels.segments import segment_merge, segment_split
from ...kernels.sgns import banded_sgns_grad
from ...kernels.subsample import subsample_compact
from ...runtime import device_lock
from ...sharding import mesh as meshlib
from ...util.dashboard import monitor
from .data import TokenizedCorpus
from .model import draw_negs


class TorchDraws:
    """The pipeline's random draws from ONE ``torch.Generator``,
    reseeded at every epoch from the epoch seed. The generator lives on
    the trainer's device unless ``draw_device`` names another (a CPU
    generator gives the same draws to a CPU and a CUDA run of the same
    input); each method returns fresh tensors on ``device``."""

    def __init__(self, device: torch.device, draw_device=None):
        self.device = torch.device(device)
        self.draw_device = torch.device(draw_device) \
            if draw_device is not None else self.device
        self.generator = torch.Generator(device=self.draw_device)

    def epoch_uniforms(self, seed: int, n_tokens: int) -> torch.Tensor:
        """The subsampling uniforms u[T] of one epoch."""
        self.generator.manual_seed(int(seed))
        return torch.rand(n_tokens, generator=self.generator,
                          device=self.draw_device).to(self.device)

    def step_draws(self, seed: int, step: int, C: int, W: int,
                   neg_shape: Optional[Tuple[int, ...]], V: int):
        """(shrink int32[C] in [1, W], negative candidates int32
        [neg_shape] in [0, V), their alias uniforms float32[neg_shape])
        for step ``step`` of the local pipeline; with ``neg_shape`` None
        (hierarchical softmax) only the shrink draw, the others None."""
        g, dev = self.generator, self.draw_device
        shrink = torch.randint(1, W + 1, (C,), generator=g, device=dev,
                               dtype=torch.int32).to(self.device)
        if neg_shape is None:
            return shrink, None, None
        idx = torch.randint(0, V, neg_shape, generator=g, device=dev,
                            dtype=torch.int32)
        u = torch.rand(neg_shape, generator=g, device=dev)
        return shrink, idx.to(self.device), u.to(self.device)

    def group_draws(self, seed: int, block: int, G: int, C: int, W: int,
                    neg_shape: Optional[Tuple[int, ...]], V: int):
        """The draws of the G blocks of one PS dispatch starting at
        ``block``: a list of G ``step_draws`` tuples."""
        return [self.step_draws(seed, block + i, C, W, neg_shape, V)
                for i in range(G)]


def _pad_stream(C: int, W: int, kept: torch.Tensor, ksent: torch.Tensor):
    """Pad the compacted stream so banded slices never run off an end:
    W on the left, C+W on the right. Padding carries sentence -2, which
    never matches a real sentence, so every padded position is masked
    out."""
    def pad(x, value):
        left = torch.full((W,), value, dtype=x.dtype, device=x.device)
        right = torch.full((C + W,), value, dtype=x.dtype, device=x.device)
        return torch.cat([left, x, right])

    return pad(kept, 0), pad(ksent, -2)


@functools.lru_cache(maxsize=None)
def _offsets_on(W: int, device: torch.device) -> torch.Tensor:
    """The 2W window offsets as an int64 tensor on ``device``, made once
    (a per-block host-to-device copy would cost more than the mask)."""
    return torch.tensor(offsets(W), dtype=torch.int64, device=device)


def _band_former(C: int, W: int, n_kept: int, kept_pad: torch.Tensor,
                 ksent_pad: torch.Tensor, shrink: torch.Tensor, base: int):
    """The banded window former: C consecutive kept positions as centers;
    their contexts all lie in the contiguous band
    ``kept[base-W : base+C+W]`` (C+2W tokens), and the per-(center,
    offset) validity — in-stream, same sentence, within the per-center
    shrunk window — is a mask over shifted slices of the band, formed
    for all 2W offsets at once (column j is offset ``offsets(W)[j]``).
    Returns (centers[C], band[C+2W], pmask[C,2W] float32)."""
    dev = kept_pad.device
    offs = _offsets_on(W, dev)
    idx = base + torch.arange(C, dtype=torch.int64, device=dev)
    centers = kept_pad[base + W:base + W + C]
    csent = ksent_pad[base + W:base + W + C]
    band = kept_pad[base:base + C + 2 * W]
    # ctx_sent[c, j] = sentence of band position c + W + offs[j].
    windows = ksent_pad[base:base + C + 2 * W].unfold(0, C, 1)
    ctx_sent = windows[W + offs].T
    pos = idx[:, None] + offs[None, :]
    pmask = ((pos >= 0) & (pos < n_kept) & (ctx_sent == csent[:, None])
             & (offs.abs()[None, :] <= shrink[:, None])
             & ((idx < n_kept) & (csent >= 0))[:, None])
    return centers, band, pmask.to(torch.float32)


def _block_ids(config, tables, C: int, B: int, per_pair: bool, draws,
               kept_pad, ksent_pad, n_kept: int, base: int, lr, inv_w):
    """One PS block (port of ``_block_ids_fn``/``_block_ids_fn_hs`` and
    ``_block_step_fn``/``_block_step_fn_hs``): (in_ids, out_ids, step)
    with ``step(v, u)`` -> (push deltas ``-lr * grad * inv_w`` for the
    pulled rows ``v = in[in_ids]``, ``u = out[out_ids]``, loss,
    examples). The ids and the kernel are those of the local step
    (``_plan``); the per-pair mode pulls [band | every sub-step's
    negatives] once and steps on local copies (``_pair_block_step``)."""
    if not per_pair:
        # The scale in float32 as the reference forms it (lr *
        # inv_workers, negated).
        subs, _ = _plan(config, tables, C, B, False, draws, kept_pad,
                        ksent_pad, n_kept, base, float(-(lr * inv_w)))
        in_ids, out_ids, kernel, args = subs[0]
        return in_ids, out_ids, lambda v, u: kernel(v, u, *args)
    shrink, idx, u = draws
    centers, band, pmask = _band_former(C, config.window, n_kept, kept_pad,
                                        ksent_pad, shrink, base)
    negs = draw_negs(tables[0], tables[1], idx, u)
    return centers, torch.cat([band, negs.reshape(-1)]), functools.partial(
        _pair_block_step, config, C, pmask, lr, inv_w)


def _pair_block_step(config, C: int, pmask, lr, inv_w, v, u):
    """The per-pair mode's PS step: its 2W sub-steps (K8's in-place form)
    with the RAW lr against LOCAL copies of the pulled rows, the band
    slice and the offset's negatives taking their gradients in place;
    the push is the net change times ``inv_w`` (ref: _block_step_fn
    per_pair, communicator.cpp:157-249)."""
    W, K = config.window, config.negative
    scale = float(-lr)
    v_cur, u_cur = v.clone(), u.clone()
    u_negs = u_cur[C + 2 * W:].view(2 * W, C * K, v.shape[1])
    pm_cols = pmask.T.contiguous()
    loss = None
    for j, off in enumerate(offsets(W)):
        sub_loss, _ = pair_offset_grad_(v_cur, u_cur[W + off:W + off + C],
                                        u_negs[j], pm_cols[j], K, scale)
        loss = sub_loss if loss is None else loss + sub_loss
    return (v_cur - v) * inv_w, (u_cur - u) * inv_w, loss, pmask.sum()


class _CorpusOnDevice:
    """Upload of a ``TokenizedCorpus``: the flat id stream, its per-token
    sentence ids and the subsample keep probabilities — one transfer,
    reused every epoch."""

    def __init__(self, model, tokenized: TokenizedCorpus,
                 device: torch.device):
        config = model.config
        flat = np.asarray(tokenized.flat, np.int32)
        lengths = np.diff(tokenized.offsets).astype(np.int64)
        sent = np.repeat(np.arange(lengths.size, dtype=np.int32), lengths)
        self.n_tokens = int(flat.size)
        self.flat = torch.from_numpy(flat).to(device)
        self.sent = torch.from_numpy(sent).to(device)
        self.keep = torch.from_numpy(np.asarray(
            model.dictionary.subsample_keep_prob(config.sample),
            np.float32)).to(device)

    def prep_epoch(self, u: torch.Tensor):
        """Subsample + stable compaction on K1: (kept, ksent, n_kept)."""
        return subsample_compact(self.flat, self.sent, self.keep, u)


class _ModeTrainer:
    """What both trainers share: the corpus on the card, the mode's
    fields — the output structures ``_tables`` ((points, codes) for
    hierarchical softmax, else the alias tables), the centers a step
    (HS capped by ``_hs_center_cap``), ``neg_block``, the per-pair flag
    — and the draw provider."""

    def _init_mode(self, model, tokenized: TokenizedCorpus,
                   centers_per_step: int, tables, draws) -> None:
        config = model.config
        self.model = model
        self.config = config
        self._C = int(centers_per_step)
        self._corpus = _CorpusOnDevice(model, tokenized, self.device)
        self._n_tokens = self._corpus.n_tokens
        self._tables = tables
        self._B, self._per_pair, self._vocab = 1, False, 0
        if config.hs:
            # Banded HS rows are [C+2W, L, D] (L = max Huffman path):
            # cap C so the gathered path rows and their gradient stay
            # within ~1.5 GB; a larger centers_per_step is cut to the cap.
            path_len = max(int(tables[0].shape[1]), 1)
            self._C = min(self._C, _hs_center_cap(
                path_len, int(config.embedding_size)))
        else:
            self._B = max(int(getattr(config, "neg_block", 1)), 1)
            if self._C % self._B:
                raise ValueError("neg_block must divide centers_per_step")
            self._per_pair = bool(getattr(config, "per_pair", False))
            if self._per_pair and config.cbow:
                raise ValueError("per_pair is a skip-gram quality mode")
            self._vocab = int(tables[0].shape[0])
        self._draws = draws if draws is not None \
            else TorchDraws(self.device)
        # Post-subsampling tokens actually trained (centers), across
        # epochs — the exact basis for utilization accounting.
        self.kept_words_trained = 0

    def _neg_shape(self):
        C, W, K = self._C, self.config.window, self.config.negative
        if self.config.hs:
            return None
        if self._per_pair:
            return (2 * W, C, K)
        return (C // self._B, K)


class PSDeviceCorpusTrainer(_ModeTrainer):
    """Drives a ``PSWord2Vec`` from a device-resident corpus: every block
    pulls its rows through the full worker/server actor stack (device-key
    Gets), trains, and pushes ``-lr*grad/num_workers`` deltas back
    (device-key Adds). Nothing but learning-rate scalars crosses the host
    boundary per block (the reference's block protocol,
    ref: Applications/WordEmbedding/src/communicator.cpp:117-249, with
    the row list living on the card)."""

    def __init__(self, model, tokenized: TokenizedCorpus,
                 centers_per_step: int = 32768,
                 blocks_per_dispatch: int = 1,
                 segment_keys: bool = False, draws=None):
        """``blocks_per_dispatch`` (G) takes G blocks' ids in ONE pull,
        step and push round trip: the G blocks read the same table state
        before their deltas land (the reference's bounded-staleness
        trade); G=1 keeps exact per-block semantics. A draw provider has
        ``epoch_uniforms(seed, T)`` and ``group_draws(seed, block, G, C,
        W, neg_shape, V)``; ``TorchDraws`` by default."""
        config = model.config
        if not getattr(model, "_device_path", False):
            raise ValueError("PS device pipeline needs in-process "
                             "servers (device path)")
        self._G = max(int(blocks_per_dispatch), 1)
        self.device = model._in_table.zoo.device
        # PSWord2Vec keeps its output structures host-side (its batch
        # path prepares row sets on the host); upload them once.
        host = (model._points_host, model._codes_host) if config.hs \
            else (model._neg_prob_host, model._neg_alias_host)
        self._init_mode(model, tokenized, centers_per_step,
                        tuple(torch.from_numpy(a).to(self.device)
                              for a in host), draws)
        self.last_loss: Optional[torch.Tensor] = None
        # Segmented keys need several servers: on one they are a no-op.
        self._segment_keys = bool(segment_keys) \
            and model._in_table._num_server > 1
        self._seg_ids: Optional[Tuple[_Segmenter, _Segmenter]] = None
        self._overflow: Optional[torch.Tensor] = None

    def _build_segment_programs(self, in_ids, out_ids) -> None:
        """One-time calibration of the segmented form: read the first
        group's per-server id counts back ONCE (set-up, one readback) and
        fix static per-server capacities with 2x slack (``_segment_caps``)
        for the input and the output ids."""
        in_table, out_table = self.model._in_table, self.model._out_table
        offsets = tuple(in_table._offsets)
        if tuple(out_table._offsets) != offsets \
                or in_table.num_row != out_table.num_row:
            raise ValueError("segment mode expects same-shape in/out "
                             "tables")
        self._seg_ids = tuple(
            _Segmenter.calibrate(ids, offsets, in_table.num_row)
            for ids in (in_ids, out_ids))

    def train_epoch(self, seed: int, block_hook=None,
                    max_steps: int = 0) -> Tuple[float, float]:
        """One epoch: per group of G blocks, ids on the card ->
        device-key pulls -> the mode's step on each block -> device-key
        delta pushes, all launched without a host sync (losses
        accumulate as device scalars; pushes are fire-and-forget until
        the trailing drain). Returns (loss_sum, examples) — fetched ONCE
        at epoch end. ``block_hook(words)`` is called after each group
        with the raw-word count it covered; ``max_steps`` truncates the
        epoch (in blocks)."""
        model, config = self.model, self.config
        C, G, B = self._C, self._G, self._B
        W = config.window
        in_table, out_table = model._in_table, model._out_table
        with monitor("PS_EPOCH_PREP"):
            u = self._draws.epoch_uniforms(seed, self._n_tokens)
            kept, ksent, n_kept_dev = self._corpus.prep_epoch(u)
            # Pad ONCE per epoch; the per-block ids slice the padded
            # stream.
            kept_pad, ksent_pad = _pad_stream(C, W, kept, ksent)
            # The one host read per epoch.
            n_kept = int(device_lock.settle(n_kept_dev))
        steps = max(math.ceil(n_kept / C), 1)
        if max_steps:
            steps = min(steps, max_steps)
        self.kept_words_trained += min(steps * C, n_kept)
        # The lr schedule decays in RAW corpus words (subsample-dropped
        # words count): spread the epoch's raw words over its blocks.
        raw_per_step = self._n_tokens / max(math.ceil(n_kept / C), 1)
        inv_w = np.float32(1.0 / model._num_workers)
        loss_acc = None
        pair_acc = None
        for g0 in range(0, steps, G):
            # The reference's padded tail blocks (lr 0, no valid center)
            # are no-ops and are not run.
            real = min(G, steps - g0)
            lrs = []
            for _ in range(real):
                lrs.append(np.float32(model.learning_rate()))
                model._account_words(raw_per_step)
            with monitor("PS_BLOCK_IDS"):
                draws = self._draws.group_draws(seed, g0, G, C, W,
                                                self._neg_shape(),
                                                self._vocab)
                blocks = [_block_ids(config, self._tables, C, B,
                                     self._per_pair, draws[i], kept_pad,
                                     ksent_pad, n_kept, (g0 + i) * C,
                                     lrs[i], inv_w) for i in range(real)]
                in_ids = _cat([b[0] for b in blocks])
                out_ids = _cat([b[1] for b in blocks])
            seg_in = seg_out = None   # broadcast keys
            if self._segment_keys:
                if self._seg_ids is None:
                    self._build_segment_programs(in_ids, out_ids)
                with monitor("PS_SEGMENT_IDS"):
                    seg_in, seg_out = (
                        seg.prep(ids) for seg, ids in
                        zip(self._seg_ids, (in_ids, out_ids)))
                    ovf = seg_in.overflow | seg_out.overflow
                    self._overflow = ovf if self._overflow is None \
                        else self._overflow | ovf
            with monitor("PS_GET_STALL"):
                # One pull a table for the whole group: the device-key
                # round trip through the worker and server actors; the
                # replies are tensors on the card (no host sync).
                mid_in = _pull_async(in_table, in_ids, seg_in)
                mid_out = _pull_async(out_table, out_ids, seg_out)
                in_table.wait(mid_in)
                out_table.wait(mid_out)
            v_all = _take_rows(in_table, seg_in)
            u_all = _take_rows(out_table, seg_out)
            with monitor("PS_STEP"):
                # Each block steps on its slice of the shared pulled
                # state; losses and examples sum.
                d_v, d_u, loss, pairs = [], [], None, None
                n_in, n_out = blocks[0][0].numel(), blocks[0][1].numel()
                for i, (_, _, step) in enumerate(blocks):
                    dv, du, blk_loss, blk_pairs = step(
                        v_all[i * n_in:(i + 1) * n_in],
                        u_all[i * n_out:(i + 1) * n_out])
                    d_v.append(dv)
                    d_u.append(du)
                    loss = blk_loss if loss is None else loss + blk_loss
                    pairs = blk_pairs if pairs is None \
                        else pairs + blk_pairs
            with monitor("PS_PUSH"):
                # Fire-and-forget pushes; the trailing drain bounds the
                # epoch.
                model._pending_pushes.append((in_table, _push_async(
                    in_table, in_ids, _cat(d_v), seg_in)))
                model._pending_pushes.append((out_table, _push_async(
                    out_table, out_ids, _cat(d_u), seg_out)))
            loss_acc = loss if loss_acc is None else loss_acc + loss
            pair_acc = pairs if pair_acc is None else pair_acc + pairs
            self.last_loss = loss  # device scalar; timing sync point
            if block_hook is not None:
                block_hook(raw_per_step * real)
        with monitor("PS_EPOCH_DRAIN"):
            model._drain_pushes()
            model._flush_word_count()
            if self._overflow is not None:
                # One readback an epoch (the drain already synced): a
                # segment that outgrew its calibrated capacity means some
                # ids never reached their owner — fail loud, never train
                # silently wrong.
                overflow, self._overflow = int(self._overflow), None
                if overflow:
                    raise RuntimeError(
                        "segmented device keys overflowed a calibrated "
                        "per-server capacity (id distribution shifted "
                        ">2x from the calibration sample). Overflowed "
                        "blocks pulled zero rows and pushed corrupted "
                        "deltas THIS epoch — the tables are polluted: "
                        "restore from a checkpoint (or reinit), then "
                        "rebuild the trainer to recalibrate or pass "
                        "segment_keys=False")
            in_table.zoo.barrier()
        return (0.0 if loss_acc is None else float(loss_acc),
                0.0 if pair_acc is None else float(pair_acc))


def _segment_caps(counts, total: int) -> tuple:
    """Static per-server segment capacities from one calibration
    sample: 2x slack + headroom, power-of-two bucketed, clamped to the
    full id count (a capacity beyond that cannot help) — copied from the
    reference."""
    from ...updater.engine import bucket_size
    cap_total = bucket_size(total)
    return tuple(min(bucket_size(int(c) * 2 + 64), cap_total)
                 for c in counts)


class _Segmented:
    """One id set of a group, segmented: the per-server ``segments``
    (int32, padded with the ``oor`` sentinel), the sort's ``order`` and
    ``inv`` (int64), the cut ``bounds`` [S + 1] (int32) and the
    ``overflow`` flag (int32 0-d), all on the card."""

    __slots__ = ("segments", "order", "inv", "bounds", "overflow", "caps")

    def __init__(self, segments, order, inv, bounds, overflow, caps):
        self.segments, self.order, self.inv = segments, order, inv
        self.bounds, self.overflow, self.caps = bounds, overflow, caps

    def merge(self, parts) -> torch.Tensor:
        """The per-server reply rows back in the ids' places (K17)."""
        return segment_merge(parts, self.bounds, self.inv, self.caps)

    def split(self, delta: torch.Tensor):
        """The ids' rows ``delta`` cut per server, in sorted order
        (K18)."""
        return segment_split(delta, self.order, self.bounds, self.caps)


class _Segmenter:
    """The per-server segmentation of one id set at calibrated
    capacities (port of ``_segmented_ids_fn``'s ``prep``): sort the ids
    stably, invert the permutation by a scatter, ``searchsorted`` the
    servers' row offsets for the cut bounds (torch, on the card), and cut
    one fixed-capacity slice a server (K18); a segment longer than its
    capacity raises the overflow flag, which the trainer accumulates on
    the card and reads at the end of the epoch. Slice slack needs no
    masking: an entry past its server's bound belongs to the NEXT
    server, whose own slice also carries it — the owner applies it,
    every other server masks it out of its window."""

    def __init__(self, offsets, caps, oor: int, device):
        self.caps = tuple(int(c) for c in caps)
        self.oor = int(oor)
        self._offs = torch.tensor(list(offsets)[1:-1], dtype=torch.int32,
                                  device=device)
        self._caps = torch.tensor(self.caps, dtype=torch.int32,
                                  device=device)

    @classmethod
    def calibrate(cls, ids: torch.Tensor, offsets, oor: int):
        """Capacities from the per-server counts of ``ids`` (one
        readback)."""
        flat = np.sort(ids.reshape(-1).cpu().numpy())
        counts = np.diff(np.searchsorted(flat, np.asarray(offsets)))
        return cls(offsets, _segment_caps(counts, flat.size), oor,
                   ids.device)

    def prep(self, ids: torch.Tensor) -> _Segmented:
        flat = ids.reshape(-1)
        n = flat.numel()
        sorted_ids, order = torch.sort(flat, stable=True)
        # Inverse permutation by scatter (one pass) — a second sort
        # would pay a full sort for what is just order[j] -> j.
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, dtype=order.dtype, device=flat.device))
        bounds = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=flat.device),
            torch.searchsorted(sorted_ids, self._offs, out_int32=True),
            torch.full((1,), n, dtype=torch.int32, device=flat.device)])
        segments = segment_split(flat, order, bounds, self.caps,
                                 fill=self.oor)
        overflow = ((bounds[1:] - bounds[:-1]) > self._caps).any().to(
            torch.int32)
        return _Segmented(segments, order, inv, bounds, overflow, self.caps)


def _pull_async(table, ids, seg: Optional[_Segmented]) -> int:
    """A group's device-key pull: the ids to every server (broadcast), or
    each server's segment to it alone."""
    if seg is None:
        return table.get_rows_device_async(ids)
    return table.get_rows_device_segments_async(seg.segments)


def _take_rows(table, seg: Optional[_Segmented]) -> torch.Tensor:
    """The pulled rows in the ids' places: the servers' broadcast replies
    summed, or their segments' replies put back in place (K17)."""
    if seg is None:
        return table.take_device_rows()
    return seg.merge(table.take_device_row_parts())


def _push_async(table, ids, delta: torch.Tensor,
                seg: Optional[_Segmented]) -> int:
    """A group's device-key push: ids and deltas to every server, or each
    server's segment of them, re-sliced by K18, to it alone."""
    if seg is None:
        return table.add_rows_async(ids, delta)
    return table.add_rows_device_segments_async(seg.segments,
                                                seg.split(delta))


def _cat(parts):
    """One tensor from a group's per-block parts (no copy for one)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _plan(config, tables, C: int, B: int, per_pair: bool, draws,
          kept_pad, ksent_pad, n_kept: int, base: int, scale: float):
    """The step kernels' work for the C centers from ``base``: (sub-
    steps, pmask). A sub-step is ``(in_ids, out_ids, kernel, args)``, run
    as ``kernel(emb_in[in_ids], emb_out[out_ids], *args)``; one sub-step
    a step, except the per-pair mode's 2W (ref: _apply_step,
    _seq_pair_step, _group_fn_hs). ``tables``: (points, codes) for
    hierarchical softmax, else (neg_prob, neg_alias), on the card."""
    W, K = config.window, config.negative
    shrink, idx, u = draws
    centers, band, pmask = _band_former(C, W, n_kept, kept_pad, ksent_pad,
                                        shrink, base)
    if config.hs:
        # B8: the center row against the Huffman paths of the band's
        # words, gathered once per band position (K6), or the window
        # mean against the center's own path (K7).
        points, codes = tables
        ids = (centers if config.cbow else band).to(torch.int64)
        path, code = points[ids], codes[ids]
        out_ids = torch.clamp(path, min=0).reshape(-1)
        if config.cbow:
            return [(band, out_ids, hs_cbow_grad,
                     (path, code, pmask, W, scale))], pmask
        return [(centers, out_ids, banded_hs_sg_grad,
                 (path, code, pmask, W, scale))], pmask
    negs = draw_negs(tables[0], tables[1], idx, u)
    if per_pair:
        # B7: 2W sequential sub-steps in offset order, each with its own
        # K negatives a pair (K8).
        pm_cols = pmask.T.contiguous()
        return [(centers, torch.cat([band[W + off:W + off + C],
                                     negs[j].reshape(-1)]),
                 pair_offset_grad, (pm_cols[j], K, scale))
                for j, off in enumerate(offsets(W))], pmask
    if config.cbow:
        # B6: the window (input table) predicts [center | negatives]
        # (output table) (K5).
        return [(band, torch.cat([centers, negs.reshape(-1)]),
                 banded_cbow_grad, (pmask, W, K, B, scale))], pmask
    # B5: banded skip-gram with negative sampling (K4).
    return [(centers, torch.cat([band, negs.reshape(-1)]),
             banded_sgns_grad, (pmask, W, K, B, scale))], pmask


def _run_subs(emb_in, emb_out, subs):
    """Run a step's sub-steps (``_plan``) on the tables ``emb_in`` and
    ``emb_out``: (loss, examples) as device scalars."""
    D = emb_in.shape[1]
    loss, examples = None, None
    for in_ids, out_ids, kernel, args in subs:
        # Each sub-step gathers from the live tables after the previous
        # one's scatter (one stream, launch order) and scatter-adds
        # scale * grad (scale = -lr) straight back IN PLACE: the
        # reference donates the table buffers to its group program and
        # gets new ones back; updating in place stands in for that
        # donation.
        d_in, d_out, sub_loss, sub_examples = kernel(
            row_gather(emb_in, in_ids, D),
            row_gather(emb_out, out_ids, D), *args)
        # Both id lists repeat (centers; the band and the negatives, the
        # Zipf head thousands of times): K3's sorted form, which sums a
        # row's duplicates in the same order on every run.
        row_scatter_add(emb_in, in_ids, d_in)
        row_scatter_add(emb_out, out_ids, d_out)
        if loss is None:
            loss, examples = sub_loss, sub_examples
        else:
            loss, examples = loss + sub_loss, examples + sub_examples
    return loss, examples


def _ma_group_fn(mesh, C: int, W: int, K: int, neg_block: int = 1):
    """Model-average (``-ma``) word2vec over a mesh of replica slots
    (port of the reference's ``_ma_group_fn``, B16): each slot runs G
    local SGNS steps against its own REPLICA of the embedding tables on
    its own CORPUS SHARD, then K19 averages the replicas — the
    reference's MA mode (train locally, MV_Aggregate; ref:
    src/zoo.cpp:24,49, src/multiverso.cpp:53-56) with the aggregate a
    reduction over the slot axis.

    Arguments of the returned function: ``emb_in/emb_out`` [V, D] on
    the mesh's device (not modified); ``kept/ksent`` [n_slots *
    n_local], slot s's shard at ``[s * n_local, (s + 1) * n_local)``;
    ``neg_prob/neg_alias`` the alias tables; ``draws`` one draw
    provider a slot, each asked ``step_draws(s, i, C, W, (C //
    neg_block, K), V)`` for step i of slot s — a provider advances in
    place, so chained groups draw fresh windows (the reference passes
    and returns one PRNG key a device); ``bases/lrs`` [G] (a padded step
    has base ``n_kept`` and lr 0); ``n_kept_local`` per-slot kept
    counts [n_slots]. Returns (averaged emb_in, averaged emb_out, loss,
    pairs): the mean tables [V, D], and the loss and pair counts summed
    over each slot's steps, then over the slots in slot order (0-d
    tensors)."""
    n = meshlib.device_count(mesh)
    sgns = SimpleNamespace(window=W, negative=K, hs=False, cbow=False)
    neg_shape = (C // neg_block, K)

    def group(emb_in, emb_out, kept, ksent, neg_prob, neg_alias, draws,
              bases, lrs, n_kept_local):
        if len(draws) != n or kept.numel() % n:
            raise ValueError(f"{n} slots: one draw provider a slot and a "
                             f"kept stream that splits evenly")
        V, D = emb_in.shape
        n_local = kept.numel() // n
        n_kept_local = [int(x) for x in n_kept_local]
        lrs = np.asarray(lrs, np.float32)
        # The replicated tables, one replica a slot: [n, V, D].
        reps = [t.unsqueeze(0).expand(n, V, D).clone()
                for t in (emb_in, emb_out)]
        sums = []
        for s in range(n):
            kept_pad, ksent_pad = _pad_stream(
                C, W, kept[s * n_local:(s + 1) * n_local],
                ksent[s * n_local:(s + 1) * n_local])
            steps = []
            for i, (base, lr) in enumerate(zip(bases, lrs)):
                subs, _ = _plan(sgns, (neg_prob, neg_alias), C, neg_block,
                                False, draws[s].step_draws(
                                    s, i, C, W, neg_shape, V),
                                kept_pad, ksent_pad, n_kept_local[s],
                                int(base), float(-lr))
                steps.append(_run_subs(reps[0][s], reps[1][s], subs))
            sums.append([sum(x[1:], x[0]) for x in zip(*steps)])
        loss, pairs = (sum(x[1:], x[0]) for x in zip(*sums))
        # MV_Aggregate: the mean of the trained replicas (the
        # reference's pmean, out_specs=P()).
        avg = [mesh_allreduce(r.view(n, V * D), mean=True).view(V, D)
               for r in reps]
        return avg[0], avg[1], loss, pairs

    return group


def _hs_center_cap(path_len: int, dim: int) -> int:
    """Centers-per-step bound for the HS pipelines: the banded path rows
    are [C+2W, L, D] plus their gradient — cap C so they stay within
    ~1.5 GB of device memory (the reference's cap, copied)."""
    return max((3 << 29) // (3 * max(path_len, 1) * dim * 4), 64)


class DeviceCorpusTrainer(_ModeTrainer):
    """Drives a local ``Word2Vec`` model's tables straight from a
    device-resident ``TokenizedCorpus``. Covers the FULL mode matrix:
    {skip-gram, CBOW} x {negative sampling, hierarchical softmax}
    (ref: wordembedding.h:95-125 trains every combination through its
    one hot loop), plus the per-pair skip-gram quality mode."""

    def __init__(self, model, tokenized: TokenizedCorpus,
                 centers_per_step: int = 32768,
                 steps_per_dispatch: int = 8, draws=None):
        self._G = int(steps_per_dispatch)
        self.device = model.device
        tables = (model._points_dev, model._codes_dev) if model.config.hs \
            else (model._neg_prob_dev, model._neg_alias_dev)
        self._init_mode(model, tokenized, centers_per_step, tables, draws)

    def _plan(self, seed: int, step: int, kept_pad, ksent_pad,
              n_kept: int, scale: float):
        """Step ``step``'s work: (sub-steps, pmask), see ``_plan``."""
        draws = self._draws.step_draws(seed, step, self._C,
                                       self.config.window,
                                       self._neg_shape(), self._vocab)
        return _plan(self.config, self._tables, self._C, self._B,
                     self._per_pair, draws, kept_pad, ksent_pad, n_kept,
                     step * self._C, scale)

    def _step(self, seed: int, step: int, kept_pad, ksent_pad,
              n_kept: int, scale: float):
        """One training step on the live tables; (loss, examples) as
        device scalars."""
        subs, _ = self._plan(seed, step, kept_pad, ksent_pad, n_kept,
                             scale)
        return _run_subs(self.model._emb_in, self.model._emb_out, subs)

    def train_epoch(self, seed: int, group_hook=None,
                    max_steps: int = 0) -> Tuple[float, float]:
        """One full epoch on the card. ``group_hook(words)`` is called
        after each group of ``steps_per_dispatch`` steps with the
        raw-word count it covered; ``max_steps`` truncates the epoch.
        Returns (loss_sum, examples) as floats — fetched ONCE at epoch
        end. ``examples`` counts (center, context) pairs in skip-gram
        mode and trained centers in CBOW mode."""
        model, C, G = self.model, self._C, self._G
        u = self._draws.epoch_uniforms(seed, self._n_tokens)
        kept, ksent, n_kept_dev = self._corpus.prep_epoch(u)
        kept_pad, ksent_pad = _pad_stream(C, self.config.window, kept,
                                          ksent)
        n_kept = int(device_lock.settle(n_kept_dev))  # one host read
        steps = max(math.ceil(n_kept / C), 1)
        if max_steps:
            steps = min(steps, max_steps)
        self.kept_words_trained += min(steps * C, n_kept)
        # lr schedule decays in RAW corpus words (subsample-dropped words
        # count, ref: distributed_wordembedding.cpp:92-134): spread the
        # epoch's raw words uniformly over its steps.
        raw_per_step = self._n_tokens / max(math.ceil(n_kept / C), 1)
        loss_acc = None
        ex_acc = None
        # Groups of G steps with no host sync inside; the reference's
        # padded tail steps (lr 0, no valid center) are no-ops and are
        # not run.
        for g0 in range(0, steps, G):
            real = min(G, steps - g0)
            for step in range(g0, g0 + real):
                scale = float(-np.float32(model.learning_rate()))
                model._account_words(raw_per_step)
                loss, examples = self._step(seed, step, kept_pad,
                                            ksent_pad, n_kept, scale)
                loss_acc = loss if loss_acc is None else loss_acc + loss
                ex_acc = examples if ex_acc is None else ex_acc + examples
            if group_hook is not None:
                group_hook(raw_per_step * real)
        return (0.0 if loss_acc is None else float(loss_acc),
                0.0 if ex_acc is None else float(ex_acc))
