"""Device-resident corpus training through the parameter server.

Port of ``multiverso_tpu/models/wordembedding/device_train.py`` for the
PS pipeline: the TOKENIZED CORPUS is uploaded to the card once, and per
epoch and per block everything the reference's reader/trainer pipeline
does — subsampling, sentence-bounded shrunk windows, negative sampling,
the SGNS update — runs on the card
(ref: Applications/WordEmbedding/src/reader.cpp — subsample-as-you-read;
wordembedding.cpp — per-center shrunk window + SGNS). Per block
``PSDeviceCorpusTrainer`` computes the ids on the card, pulls the rows
with device keys through the worker and server actors (row gather,
K2), runs the banded SGNS step on the pulled rows (K4) and pushes
``-lr * grad / num_workers`` back (row scatter-add, K3). The host's
only per-block work is the learning-rate scalar; per epoch it reads the
post-subsampling length once after the compaction (K1).

The BANDED formulation is the reference's: the contexts of C
consecutive centers all lie in ``kept[base-W : base+C+W]``, so the
block pulls those C+2W output rows once and forms the 2W context
logits as shifted slices; ``neg_block`` B shares one draw of K
negatives across each block of B consecutive centers.

Random draws are kept out of the deterministic math: ``_prep``'s
uniforms, the shrunk windows and the negative draws come from a draw
provider (``TorchDraws`` by default: one ``torch.Generator`` on the
device, seeded per epoch), so the tests can replay the reference's
``jax.random`` draws and compare ids bit for bit. The ids work
(``_band_former``, ``_draw_negs``) is plain torch over ~53K-entry
vectors.

Ported: skip-gram with negative sampling, one block per dispatch
(``blocks_per_dispatch=1``), broadcast keys (``segment_keys=False``).
CBOW (B6), hierarchical softmax (B8), the per-pair quality mode (B7),
grouped dispatch (B10 G>1), segmented keys (B11) and the local
``DeviceCorpusTrainer`` (B5) raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ...kernels.sgns import banded_sgns_grad, offsets
from ...kernels.subsample import subsample_compact
from ...runtime import device_lock
from ...util.dashboard import monitor
from .data import TokenizedCorpus


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

    def block_draws(self, seed: int, block: int, C: int, W: int, nb: int,
                    K: int, V: int):
        """(shrink int32[C] in [1, W], negative candidates int32[nb, K]
        in [0, V), their alias uniforms float32[nb, K]) for one block."""
        g, dev = self.generator, self.draw_device
        shrink = torch.randint(1, W + 1, (C,), generator=g, device=dev,
                               dtype=torch.int32)
        idx = torch.randint(0, V, (nb, K), generator=g, device=dev,
                            dtype=torch.int32)
        u = torch.rand((nb, K), generator=g, device=dev)
        return tuple(x.to(self.device) for x in (shrink, idx, u))


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


def _draw_negs(neg_prob: torch.Tensor, neg_alias: torch.Tensor,
               idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Alias-table negatives: candidate ``idx`` kept with probability
    ``neg_prob[idx]``, else its alias. Returns int32 like ``idx``."""
    lookup = idx.to(torch.int64)
    keep_draw = u < neg_prob[lookup]
    return torch.where(keep_draw, idx, neg_alias[lookup])


def _block_ids(C: int, W: int, kept_pad, ksent_pad, neg_prob, neg_alias,
               draws, base: int, n_kept: int):
    """One PS block's ids (port of ``_block_ids_fn`` skip-gram branch):
    in = centers [C], out = [band (C+2W) | negs (C//B*K)], pmask."""
    shrink, idx, u = draws
    centers, band, pmask = _band_former(C, W, n_kept, kept_pad, ksent_pad,
                                        shrink, base)
    negs = _draw_negs(neg_prob, neg_alias, idx, u)
    return centers, torch.cat([band, negs.reshape(-1)]), pmask


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


class PSDeviceCorpusTrainer:
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
        config = model.config
        if not getattr(model, "_device_path", False):
            raise ValueError("PS device pipeline needs in-process "
                             "servers (device path)")
        if int(blocks_per_dispatch) != 1:
            raise NotImplementedError("grouped PS dispatch (G > 1) is not "
                                      "ported yet (ROADMAP B10)")
        if segment_keys:
            raise NotImplementedError("segmented device keys are not "
                                      "ported yet (ROADMAP B11)")
        if config.hs:
            raise NotImplementedError("hierarchical softmax is not ported "
                                      "yet (ROADMAP B8)")
        if config.cbow:
            raise NotImplementedError("CBOW is not ported yet (ROADMAP B6)")
        if getattr(config, "per_pair", False):
            raise NotImplementedError("the per-pair quality mode is not "
                                      "ported yet (ROADMAP B7)")
        self.model = model
        self.config = config
        self._C = int(centers_per_step)
        self._B = max(int(getattr(config, "neg_block", 1)), 1)
        if self._C % self._B:
            raise ValueError("neg_block must divide centers_per_step")
        self.device = model._in_table.zoo.device
        self._corpus = _CorpusOnDevice(model, tokenized, self.device)
        self._n_tokens = self._corpus.n_tokens
        self._neg_prob = torch.from_numpy(model._neg_prob_host).to(
            self.device)
        self._neg_alias = torch.from_numpy(model._neg_alias_host).to(
            self.device)
        self._draws = draws if draws is not None \
            else TorchDraws(self.device)
        self.kept_words_trained = 0
        self.last_loss: Optional[torch.Tensor] = None

    def train_epoch(self, seed: int, block_hook=None,
                    max_steps: int = 0) -> Tuple[float, float]:
        """One epoch: per block, ids on the card -> device-key pulls ->
        the SGNS step -> device-key delta pushes, all launched without a
        host sync (losses accumulate as device scalars; pushes are
        fire-and-forget until the trailing drain). Returns (loss_sum,
        pairs) — fetched ONCE at epoch end. ``block_hook(words)`` is
        called after each block with the raw-word count it covered;
        ``max_steps`` truncates the epoch."""
        model, C, B = self.model, self._C, self._B
        W, K = self.config.window, self.config.negative
        nb = C // B
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
        vocab = int(self._neg_prob.shape[0])
        loss_acc = None
        pair_acc = None
        for g0 in range(steps):
            lr = np.float32(model.learning_rate())
            model._account_words(raw_per_step)
            with monitor("PS_BLOCK_IDS"):
                draws = self._draws.block_draws(seed, g0, C, W, nb, K,
                                                vocab)
                in_ids, out_ids, pmask = _block_ids(
                    C, W, kept_pad, ksent_pad, self._neg_prob,
                    self._neg_alias, draws, g0 * C, n_kept)
            with monitor("PS_GET_STALL"):
                # Device-key pulls ride the worker->server actor round
                # trip; the replies are tensors on the card (no host
                # sync).
                mid_in = in_table.get_rows_device_async(in_ids)
                mid_out = out_table.get_rows_device_async(out_ids)
                in_table.wait(mid_in)
                out_table.wait(mid_out)
            v = in_table.take_device_rows()
            u_rows = out_table.take_device_rows()
            with monitor("PS_STEP"):
                # -lr * grad / num_workers, the scale in float32 as the
                # reference forms it (lr * inv_workers, negated).
                scale = float(-(lr * inv_w))
                d_v, d_u, loss, pairs = banded_sgns_grad(
                    v, u_rows, pmask, W, K, B, scale)
            with monitor("PS_PUSH"):
                # Fire-and-forget pushes; the trailing drain bounds the
                # epoch.
                model._pending_pushes.append(
                    (in_table, in_table.add_rows_async(in_ids, d_v)))
                model._pending_pushes.append(
                    (out_table, out_table.add_rows_async(out_ids, d_u)))
            loss_acc = loss if loss_acc is None else loss_acc + loss
            pair_acc = pairs if pair_acc is None else pair_acc + pairs
            self.last_loss = loss  # device scalar; timing sync point
            if block_hook is not None:
                block_hook(raw_per_step)
        with monitor("PS_EPOCH_DRAIN"):
            model._drain_pushes()
            model._flush_word_count()
            in_table.zoo.barrier()
        return (0.0 if loss_acc is None else float(loss_acc),
                0.0 if pair_acc is None else float(pair_acc))


class DeviceCorpusTrainer:
    """The local (non-PS) device trainer of the reference; not ported
    yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the local DeviceCorpusTrainer (fused "
                                  "banded step, B5) is not ported yet "
                                  "(ROADMAP A7)")
